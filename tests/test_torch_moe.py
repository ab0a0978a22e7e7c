"""The MoE family in the port against the JAX package: the sort-based
dispatch (``models/moe``), the expert-batched projection in its three
modes (``layers.expert_project``), the expert-batched crossbar container
(``core.tiled_analog.analog_project`` on an (E, K, N) stack), the registry's expert
rows (capacity, tape shape, layout, the flattening hoist), the expert
write, and the llama4-scout-17b-a16e smoke model (16 -> 8 experts, top-1,
one shared expert) in digital, fakequant and device mode and one
training step each in device and fakequant (QAT) mode.

Every test feeds the same inputs, made with numpy from a seed or drawn
by the reference at ``PRNGKey``s and carried across with
``convert.params_from_numpy``, through the reference and the port.  The
reference runs op by op (``jax.disable_jit``) where its reads are
recorded or its ADC codes must be the op-by-op ones (the device-mode
forward, the expert projections, reads and writes); elsewhere it runs
jitted (every per-op compilation of its eager mode costs time, and at
these seeds the jitted step and dispatch flip no code).

Tolerances:
  * the dispatch, the gates, the aux loss and the digital and fakequant
    forward: 1e-5 (float32 products taken in another order);
  * device-mode reads: the registry's dynamic-range class (1e-6 of a
    read's largest output, or a one-lsb code flip per K tile); logits
    1e-5 with the reference's reads replayed;
  * the write: bit-equal in the exact class (operands on power-of-two
    grids, a linear device, the reference's own noise fields fed in),
    4 float32 ulp on TaOx with the counter PRNG;
  * the device-mode step: the loss within 1e-5, every container's
    update within 1e-3 (2-norm, per layer) of the reference's; the QAT
    step as ``tests/test_torch_qat.py`` holds lm100m's.
"""
import contextlib
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.tiled_analog as JT
import repro_torch.core.tiled_analog as TT
from repro.configs import get_config as jax_config
from repro.core import analog_registry as jreg
from repro.core import device as jdev
from repro.data import synthetic as jsyn
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import moe as JMoE
from repro.train import analog_lm as JA
from repro.train import optimizer as JO
from repro.train import train_loop as JLoop
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import CrossbarConfig, DeviceConfig
from repro_torch.core import analog_registry as treg
from repro_torch.core.tiled_analog import (analog_project,
                                           crossbar_from_model, make_tapes)
from repro_torch.core.xbar_ops import vmm as torch_vmm
from repro_torch.kernels import xbar_update as U
from repro_torch.models import layers as TL
from repro_torch.models import model as M
from repro_torch.models import moe as TMoE
from repro_torch.train import analog_lm as TA
from repro_torch.train import optimizer as TO
from repro_torch.train import train_loop as TLoop
from test_torch_forward_flips import _one_lsb_per_k_tile

ARCH = "llama4-scout-17b-a16e"
F32 = dict(dtype="float32")
MODES = {
    "digital": F32,
    "fakequant": dict(F32, analog=True, analog_mode="fakequant",
                      analog_rows=16),
    "device": dict(F32, analog=True, analog_mode="device",
                   analog_device="taox-nonoise", analog_rows=16,
                   analog_cols=16),
}
TRAIN = dict(F32, analog=True, analog_mode="device", analog_device="taox",
             analog_rows=16, analog_cols=16)
LR = 0.1
ULP4 = 4 * 2.0 ** -24
EXPERT_PATH = ("layers", "moe", "experts", "w_up")

_rng = np.random.default_rng(0)
TOKENS = _rng.integers(0, 256, (2, 8)).astype(np.int32)


def _np(tree):
    return jax.tree.map(np.array, tree)


def _cfgs(top_k=None, **kw):
    """The smoke config of both packages (float32, ``kw`` applied)."""
    kw = {**F32, **kw, **({} if top_k is None else {"top_k": top_k})}
    return (jax_config(ARCH, True).replace(**kw),
            get_config(ARCH, True).replace(**kw))


def _j_moe_apply(jp, x, jcfg):
    return jax.jit(JMoE.moe_apply, static_argnums=2)(jp, jnp.asarray(x),
                                                       jcfg)


def _moe_params(jcfg, seed=0):
    """The reference's MoE block at ``PRNGKey(seed)`` and its port copy."""
    jp = JMoE.moe_init(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_numpy(_np(jp), "cpu")


def _x(shape, seed=1, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape)
            .astype(np.float32) * scale)


@contextlib.contextmanager
def _no_remat():
    """``REPRO_REMAT=none`` keeps the reference's layer scan concrete so
    its reads can be recorded; it changes no value."""
    prev = os.environ.get("REPRO_REMAT")
    os.environ["REPRO_REMAT"] = "none"
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("REPRO_REMAT")
        else:
            os.environ["REPRO_REMAT"] = prev


# ------------------------------------------------------------------ configs

def test_moe_config_fields_match_reference():
    for smoke in (False, True):
        got, want = get_config(ARCH, smoke), jax_config(ARCH, smoke)
        for f in ("n_experts", "top_k", "n_shared_experts", "d_ff_expert",
                  "capacity_factor", "family"):
            assert getattr(got, f) == getattr(want, f), f
    assert get_config(ARCH, True).n_experts == 8


# ---------------------------------------------------------------- dispatch

@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_apply_matches_reference(top_k):
    """``moe_apply`` and ``moe_dense_reference`` against the reference's
    on the same block and tokens (top-1 and top-2): output and aux within
    1e-5, and the port's dispatch against its own dense oracle."""
    jcfg, cfg = _cfgs(top_k)
    jp, tp = _moe_params(jcfg)
    x = _x((2, 16, cfg.d_model))
    jy, jaux = _j_moe_apply(jp, x, jcfg)
    jdense = jax.jit(JMoE.moe_dense_reference, static_argnums=2)(
        jp, jnp.asarray(x), jcfg)
    with torch.no_grad():
        y, aux = TMoE.moe_apply(tp, torch.from_numpy(x), cfg)
        dense = TMoE.moe_dense_reference(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(dense.numpy(), np.asarray(jdense), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(y.numpy(), dense.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert abs(float(aux) - float(jaux)) <= 1e-5 * abs(float(jaux))


def test_capacity_drops_match_reference():
    """Past an expert's capacity a token keeps only the shared path: with
    64 tokens over 8 experts at capacity factor 0.5 (8 slots an expert)
    some tokens drop, and the port drops exactly the reference's."""
    jcfg, cfg = _cfgs(capacity_factor=0.5)
    jp, tp = _moe_params(jcfg)
    x = _x((4, 16, cfg.d_model), seed=3)
    xt = torch.from_numpy(x).reshape(-1, cfg.d_model)
    _, _, top_i = TMoE.route(tp, xt, cfg)
    counts = torch.bincount(top_i[:, 0], minlength=cfg.n_experts)
    cap = treg.expert_capacity(xt.shape[0], cfg)
    assert cap == 8 and int(torch.clamp(counts - cap, min=0).sum()) > 0
    jy, _ = _j_moe_apply(jp, x, jcfg)
    with torch.no_grad():
        y, _ = TMoE.moe_apply(tp, torch.from_numpy(x), cfg)
        shared = TL.ffn(tp["shared"], xt, cfg).reshape(x.shape)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    dropped = (y - shared).abs().amax(-1).reshape(-1) == 0
    assert int(dropped.sum()) == int(torch.clamp(counts - cap, min=0).sum())


def test_aux_loss_matches_reference_under_skew():
    """The Switch aux loss with a router skewed towards one expert: far
    above 1, equal to the reference's."""
    jcfg, cfg = _cfgs()
    jp, _ = _moe_params(jcfg)
    w = np.array(jp["router"]["w"])
    w[:, 3] += 0.5
    jp = {**jp, "router": {"w": jnp.asarray(w)}}
    tp = params_from_numpy(_np(jp), "cpu")
    x = _x((2, 16, cfg.d_model), seed=4) + np.float32(0.1)
    _, jaux = _j_moe_apply(jp, x, jcfg)
    with torch.no_grad():
        _, aux = TMoE.moe_apply(tp, torch.from_numpy(x), cfg)
    assert float(aux) > 2.0
    assert abs(float(aux) - float(jaux)) <= 1e-5 * float(jaux)


def test_gradients_through_dispatch_match_reference():
    """d/d(x, router, experts, shared) of ``sum(y * r) + 0.01 aux`` at
    top-2: the port's autograd against ``jax.grad``, 1e-5 relative in
    2-norm per leaf."""
    jcfg, cfg = _cfgs(2)
    jp, _ = _moe_params(jcfg)
    x = _x((2, 8, cfg.d_model), seed=5)
    r = _x((2, 8, cfg.d_model), seed=6, scale=1.0)

    def jloss(p, xx):
        y, aux = JMoE.moe_apply(p, xx, jcfg)
        return jnp.sum(y * r) + 0.01 * aux
    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a))
                      .requires_grad_(True), jp)
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = TMoE.moe_apply(tp, tx, cfg)
    (torch.sum(y * torch.from_numpy(r)) + 0.01 * aux).backward()
    pairs = [(tx.grad, jgx)] + [(t.grad, g) for t, g in zip(
        jax.tree.leaves(tp), jax.tree.leaves(jgp))]
    for got, want in pairs:
        want = np.asarray(want)
        err = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
        assert err <= 1e-5, err


def test_grouped_dispatch_is_not_ported():
    """``REPRO_MOE_GROUPS=2`` (ported since the multi-device slice; the
    name is kept) dispatches within two batch groups, each with its own
    capacity, as the reference's vmapped grouped dispatch: output and aux
    loss within 1e-5; the aux loss is the groups' mean, not the flat
    dispatch's."""
    jcfg, cfg = _cfgs()
    jp, tp = _moe_params(jcfg)
    x = _x((4, 8, cfg.d_model))
    _, flat_aux = TMoE.moe_apply(tp, torch.from_numpy(x), cfg)
    os.environ["REPRO_MOE_GROUPS"] = "2"
    try:
        jy, jaux = JMoE.moe_apply(jp, jnp.asarray(x), jcfg)
        y, aux = TMoE.moe_apply(tp, torch.from_numpy(x), cfg)
    finally:
        os.environ.pop("REPRO_MOE_GROUPS")
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    assert abs(float(aux) - float(jaux)) <= 1e-5 * abs(float(jaux))
    assert float(aux) != float(flat_aux)


# --------------------------------------------------- the expert projection

def _expert_operands(e=4, t=8, k=64, n=24, seed=7):
    """(E, T, K) drives with experts of very different magnitudes (1e-3 to
    1e2) and expert 1 all zero; (E, K, N) weights."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((e, t, k)).astype(np.float32)
    x *= np.float32([1e-3, 0.0, 1.0, 1e2][:e])[:, None, None]
    w = (rng.standard_normal((e, k, n)) / np.sqrt(k)).astype(np.float32)
    return x, w


@pytest.mark.parametrize("mode", list(MODES))
def test_expert_project_matches_reference(mode):
    """``expert_project`` in each mode on a raw (E, K, N) stack (digital,
    fakequant) or its programmed container (device), experts of very
    different magnitudes and an all-zero one: within 1e-5 of the
    reference's, and the all-zero expert's output exactly 0."""
    jcfg, cfg = _cfgs(**MODES[mode])
    x, w = _expert_operands()
    jw = jnp.asarray(w)
    if mode == "device":
        jw = JT.program_stacked(jw, JT.crossbar_from_model(jcfg))
    with jax.disable_jit():
        want = np.asarray(JL.expert_project(jw, jnp.asarray(x), jcfg))
    with torch.no_grad():
        got = TL.expert_project(params_from_numpy(_np(jw), "cpu"),
                                torch.from_numpy(x), cfg).numpy()
    scale = np.abs(want).max(axis=(1, 2), keepdims=True) + 1e-30
    assert (np.abs(got - want) <= 1e-5 * scale + 1e-12).all()
    assert np.all(got[1] == 0) and np.isfinite(got).all()


def test_analog_project_batched_per_expert_scales_and_tapes():
    """The expert-batched container, forward and backward, against the
    reference: the read within 1e-6 of each expert's largest output (one
    DAC full scale per expert), the transpose read alike, and the tapes
    (the write drivers' x_q and d_q, quantised per expert) equal to the
    reference's cotangents within 1 ulp; the all-zero expert reads and
    tapes exact zeros; the code scales are per expert."""
    jcfg, cfg = _cfgs(**MODES["device"])
    x, w = _expert_operands()
    dy = _x((4, 8, 24), seed=8, scale=1.0)
    dy[3] *= 1e-4
    jp = JT.program_stacked(jnp.asarray(w), JT.crossbar_from_model(jcfg))
    jp = {**jp, "x_tape": jnp.zeros(x.shape), "d_tape": jnp.zeros(dy.shape)}

    def jf(p, xx):
        return jnp.sum(JT.analog_project_batched(
            p, xx, JT.crossbar_from_model(jcfg)) * dy)
    with jax.disable_jit():
        jy = JT.analog_project_batched(jp, jnp.asarray(x),
                                       JT.crossbar_from_model(jcfg))
        jgp, jgx = jax.grad(jf, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = params_from_numpy(_np({k: jp[k] for k in ("g", "ref",
                                                   "w_scale")}), "cpu")
    tp.update(make_tapes(tp, (8,)))
    tx = torch.from_numpy(x).requires_grad_(True)
    y = analog_project(tp, tx, crossbar_from_model(cfg))
    (y * torch.from_numpy(dy)).sum().backward()
    for got, want in ((y.detach().numpy(), np.asarray(jy)),
                      (tx.grad.numpy(), np.asarray(jgx))):
        scale = np.abs(want).max(axis=(1, 2), keepdims=True) + 1e-30
        assert (np.abs(got - want) <= 1e-6 * scale).all()
    for leaf in ("x_tape", "d_tape"):
        want = np.asarray(jgp[leaf])
        np.testing.assert_allclose(tp[leaf].numpy(), want, rtol=2 ** -23,
                                   atol=0)
        assert np.all(tp[leaf].numpy()[1 if leaf == "x_tape" else 0]
                      [..., :] == want[1 if leaf == "x_tape" else 0])
    assert np.all(y.detach().numpy()[1] == 0)
    assert np.all(tp["x_tape"].numpy()[1] == 0)
    xs = tp["x_tape_scale"].numpy()
    ref_xs = np.maximum(np.abs(x).max(axis=(1, 2)), 1e-12) / np.float32(127)
    np.testing.assert_array_equal(xs, ref_xs.astype(np.float32))
    assert xs[3] / xs[0] > 1e4
    with pytest.raises(ValueError):
        analog_project(tp, tx[:3], crossbar_from_model(cfg))


# ---------------------------------------------------------------- registry

def test_expert_capacity_and_tape_lead_match_reference():
    jcfg, cfg = _cfgs()
    full_j, full = jax_config(ARCH), get_config(ARCH)
    for n in (1, 4, 16, 64, 100, 2048, 4096):
        assert treg.expert_capacity(n, cfg) == \
            jreg.expert_capacity(n, jcfg)
        assert treg.expert_capacity(n, full) == \
            jreg.expert_capacity(n, full_j)
        for path in (EXPERT_PATH, ("layers", "attn", "wqkv"),
                     ("layers", "moe", "shared", "w_down")):
            assert treg.tape_lead(path, cfg, n, (1, n)) == \
                jreg.tape_lead(path, jcfg, n, (1, n))
    assert treg.expert_capacity(2048, full) == 160
    assert treg.expert_capacity(4, full) == 8
    assert treg.tape_lead(EXPERT_PATH, full, 2048) == (160,)


def test_leaf_layout_and_hoist_match_reference():
    for kind in treg.KINDS:
        for ndim in (2, 3, 4):
            assert treg.hoist_axis(kind, ndim) == jreg.hoist_axis(kind, ndim)
            for leaf in ("g", "ref", "x_tape", "d_tape", "w_scale"):
                nd = ndim - 2 if leaf == "w_scale" else ndim
                assert treg.leaf_layout(kind, nd, leaf, 16, 16) == \
                    jreg.leaf_layout(kind, nd, leaf, 16, 16), (kind, leaf)


@pytest.mark.parametrize("lead", [(3,), (2, 3)])
def test_flatten_lead_expert_hoist_round_trip(lead):
    """``flatten_lead`` of an expert stack (E,) and a layer-stacked one
    (L, E): the flattened g, tapes, scales and noise field bit-equal to
    the reference's (expert dim outermost), the tape code scales
    flattened as the scale is, and ``unflatten`` the exact inverse."""
    rng = np.random.default_rng(9)
    k, n, t = 16, 12, 5
    arrs = {"g": (*lead, k, n), "x_tape": (*lead, t, k),
            "d_tape": (*lead, t, n), "noise": (*lead, k, n)}
    arrs = {a: rng.standard_normal(s).astype(np.float32)
            for a, s in arrs.items()}
    scale = rng.standard_normal(lead).astype(np.float32)
    kind = treg.classify(EXPERT_PATH)
    assert kind == treg.EXPERT_BATCHED == jreg.classify(EXPERT_PATH)
    jout = jreg.flatten_lead(kind, *(jnp.asarray(arrs[a]) for a in
                                     ("g", "x_tape", "d_tape")),
                             jnp.asarray(scale), jnp.asarray(arrs["noise"]))
    g3, x3, d3, s1, c1, unflatten = treg.flatten_lead(
        kind, *(torch.from_numpy(arrs[a]) for a in ("g", "x_tape",
                                                    "d_tape")),
        torch.from_numpy(scale), torch.from_numpy(scale * 2))
    # a noise field flattens as g does
    n3 = treg.flatten_lead(kind, torch.from_numpy(arrs["noise"]),
                           *(torch.from_numpy(arrs[a]) for a in
                             ("x_tape", "d_tape")),
                           torch.from_numpy(scale))[0]
    for got, want in zip((g3, x3, d3, s1, n3), jout[:5]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(c1.numpy(), 2 * s1.numpy())
    np.testing.assert_array_equal(unflatten(g3).numpy(), arrs["g"])
    if len(lead) == 2:      # expert e of layer l is flattened index e*L+l
        np.testing.assert_array_equal(g3[1 * 2 + 0].numpy(),
                                      arrs["g"][0, 1])


# ------------------------------------------------------------------- write

def _pow2_write(lyr=2, e=3, t=8, k=32, n=24, seed=10):
    rng = np.random.default_rng(seed)
    g = (rng.integers(64, 192, (lyr, e, k, n)) / 256.0).astype(np.float32)
    x = (rng.integers(-127, 128, (lyr, e, t, k)) * 2.0 ** -7
         ).astype(np.float32)
    d = (rng.integers(-7, 8, (lyr, e, t, n)) * 2.0 ** -12).astype(np.float32)
    x[0, 1] = 0.0               # an expert that received no token
    d[0, 1] = 0.0
    scale = -(2.0 ** -rng.integers(0, 3, (lyr, e))).astype(np.float32)
    return g, x, d, scale


def test_expert_write_matches_reference_per_expert_update():
    """One write of an (L, E, K, N) expert stack through ``flatten_lead``
    (expert dim outermost) and one launch's worth of the layer-batched
    update, with the reference's own noise fields fed in (host noise,
    the linear device with write noise), against the reference's
    per-expert ``apply_update`` of ``scale * x^T d`` drawn with the same
    keys: bit-equal (power-of-two operands and scales, every product and
    sum exact); the expert with no token moves no cell."""
    g, x, d, scale = _pow2_write()
    lyr, e = scale.shape
    dev = jdev.DeviceConfig(kind="linearized", write_noise=0.3)
    keys = {(l_, e_): jax.random.fold_in(jax.random.PRNGKey(5), l_ * e + e_)
            for l_ in range(lyr) for e_ in range(e)}
    noise = np.stack([np.stack([np.asarray(jax.random.normal(
        keys[l_, e_], g.shape[2:], jnp.float32)) for e_ in range(e)])
        for l_ in range(lyr)])
    with jax.disable_jit():
        want = np.stack([np.stack([np.asarray(jdev.apply_update(
            jnp.asarray(g[l_, e_]),
            jnp.asarray(scale[l_, e_]) * jnp.einsum(
                "bk,bn->kn", jnp.asarray(x[l_, e_]), jnp.asarray(d[l_, e_])),
            dev, keys[l_, e_])) for e_ in range(e)]) for l_ in range(lyr)])
    xcfg = CrossbarConfig(rows=16, cols=16,
                          device=DeviceConfig(kind="linearized",
                                              write_noise=0.3))
    g3, x3, d3, s1, unflatten = treg.flatten_lead(
        treg.EXPERT_BATCHED, *(torch.from_numpy(a) for a in (g, x, d)),
        torch.from_numpy(scale))
    n3 = treg.flatten_lead(treg.EXPERT_BATCHED, torch.from_numpy(noise),
                           torch.from_numpy(x), torch.from_numpy(d),
                           torch.from_numpy(scale))[0]
    got = unflatten(U.xbar_outer_update(g3, x3, d3, s1, xcfg, noise=n3,
                                        noise_mode="host")).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, 1], g[0, 1])


def test_expert_container_update_matches_reference_step():
    """The train step's write of an (L, E, K, N) container (TaOx, write
    noise from the counter PRNG keyed by the container's path) against
    the reference step's: the same hoist puts each expert's noise field
    on the same flattened layer index, so every cell agrees within 4
    float32 ulp (the Box-Muller normals' libm); the per-expert code
    scales ride along."""
    g, x, d, scale = _pow2_write(seed=11)
    jcfg, cfg = _cfgs(**TRAIN)
    lyr, e = scale.shape
    w_scale = np.full((lyr, e), 0.5, np.float32)
    seed_base = 0xC0FFEE11
    jstep = JA.AnalogTrainStep(jcfg, lr=LR)
    jp = {"g": jnp.asarray(g), "ref": jnp.asarray(g),
          "w_scale": jnp.asarray(w_scale)}
    with jax.disable_jit():
        want = np.asarray(jstep._update_container(
            jp, {"x_tape": jnp.asarray(x), "d_tape": jnp.asarray(d)}, None,
            jnp.uint32(seed_base), EXPERT_PATH, [])["g"])
    step = TA.AnalogTrainStep(cfg, lr=LR)
    tp = params_from_numpy(_np(jp), "cpu")
    tapes = {"x_tape": torch.from_numpy(x), "d_tape": torch.from_numpy(d),
             "x_tape_scale": torch.full((lyr, e), 2.0 ** -7),
             "d_tape_scale": torch.full((lyr, e), 2.0 ** -12)}
    got = step._update_container(tp, tapes, seed_base, EXPERT_PATH,
                                 [])["g"].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ULP4)
    assert np.abs(got - g).max() > 1e-3


# ----------------------------------------------------------- smoke model

@pytest.fixture(scope="module")
def reference():
    """Per mode: the reference's llama4-scout smoke tree at PRNGKey(0),
    its op-by-op logits and, in device mode, every read (operands and
    result: the four dense containers' and the three expert stacks' per
    layer) and the routing of every layer."""
    out = {}
    params = JM.init_params(jax.random.PRNGKey(0),
                            jax_config(ARCH, True).replace(**F32))
    for mode, kw in MODES.items():
        jcfg = jax_config(ARCH, True).replace(**kw)
        tree = JM.program_digital(params, jcfg) if mode == "device" \
            else params
        reads = []
        vmm_any = JT._vmm_any

        def recorded(x, g, ref, ws, cfg, meta=None):
            y = vmm_any(x, g, ref, ws, cfg, meta)
            reads.append(tuple(np.array(a) for a in (x, g, ref, ws, y)))
            return y

        JT._vmm_any = recorded
        try:
            # the device reads are recorded op by op; the other modes
            # read nothing and run jitted
            ctx = jax.disable_jit() if mode == "device" \
                else contextlib.nullcontext()
            with _no_remat(), ctx:
                logits = JM.forward(tree, {"tokens": jnp.asarray(TOKENS)},
                                    jcfg)[0]
        finally:
            JT._vmm_any = vmm_any
        out[mode] = {"params": _np(tree), "logits": np.array(logits),
                     "reads": reads}
    return out


def _port_forward(run, cfg, monkeypatch, replay=None):
    mine = []

    def recorded(x, g, ref, ws, xcfg, **kw):
        y = torch_vmm(x, g, ref, ws, xcfg, **kw)
        mine.append(y.numpy().copy())
        return torch.from_numpy(replay[len(mine) - 1]) if replay else y

    monkeypatch.setattr(TT, "vmm", recorded)
    with torch.no_grad():
        logits = M.forward(params_from_numpy(run["params"], "cpu"),
                           {"tokens": torch.from_numpy(TOKENS).long()},
                           cfg)[0].numpy()
    return logits, mine


@pytest.mark.parametrize("mode", list(MODES))
def test_smoke_logits_match_reference_op_by_op(mode, reference,
                                               monkeypatch):
    """The llama4-scout smoke model's logits in each mode against the
    op-by-op reference, within 1e-5; device mode reads 7 containers a
    layer (wqkv, wo, the shared w_upgate and w_down, the three expert
    stacks) and each read agrees on the reference's own operands."""
    run = reference[mode]
    cfg = get_config(ARCH, smoke=True).replace(**MODES[mode])
    logits, mine = _port_forward(run, cfg, monkeypatch)
    assert len(mine) == len(run["reads"]) \
        == (7 * cfg.n_layers if mode == "device" else 0)
    np.testing.assert_allclose(logits, run["logits"], rtol=1e-5, atol=1e-5)
    xcfg = crossbar_from_model(cfg) if mode == "device" else None
    for i, (x, g, ref, ws, out) in enumerate(run["reads"]):
        ops = [torch.from_numpy(a) for a in (x, g, ref, ws)]
        err = np.abs(torch_vmm(*ops, xcfg).numpy() - out)
        off = err > 1e-6 * np.abs(out).max()
        if off.any():
            assert (err <= _one_lsb_per_k_tile(*ops, xcfg) + 1e-6).all(), i
            assert off.mean() < 0.01, i


def test_smoke_device_logits_with_replayed_reads(reference, monkeypatch):
    run = reference["device"]
    cfg = get_config(ARCH, smoke=True).replace(**MODES["device"])
    replay = [r[4] for r in run["reads"]]
    logits, _ = _port_forward(run, cfg, monkeypatch, replay=replay)
    np.testing.assert_allclose(logits, run["logits"], rtol=1e-5, atol=1e-5)


def test_params_from_numpy_carries_expert_containers(reference):
    tree = reference["device"]["params"]
    tp = params_from_numpy(tree, "cpu")
    c = tp["layers"]["moe"]["experts"]["w_down"]
    assert c["g"].shape == (2, 8, 64, 64) and c["w_scale"].shape == (2, 8)
    for leaf in ("g", "ref", "w_scale"):
        np.testing.assert_array_equal(
            c[leaf].numpy(), tree["layers"]["moe"]["experts"]["w_down"][leaf])
    cfg = get_config(ARCH, smoke=True).replace(**MODES["device"])
    back = M.readout_digital(tp, cfg)
    assert back["layers"]["moe"]["experts"]["w_down"].shape == (2, 8, 64, 64)
    assert set(back["layers"]["moe"]["shared"]["w_down"]) == {"w"}


# ------------------------------------------------------------ training

def _batch(cfg, b=4, s=16):
    return jsyn.batch_tokens(jsyn.make_token_stream(4096, cfg.vocab), b, s,
                             0)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_device_train_step_matches_reference():
    """One device-mode step (TaOx, lr 0.1, 4 x 16 tokens: capacity 16 an
    expert, tapes (L, E, 16, K)) against the reference's step with its
    seed_base: the loss and aux within 1e-5, ``ref`` and ``w_scale``
    bit-equal, every container's update within 1e-3 (2-norm) per layer,
    the digital leaves' likewise, every expert stack moved."""
    jcfg = jax_config(ARCH, True).replace(**TRAIN)
    cfg = get_config(ARCH, True).replace(**TRAIN)
    state = JA.init_state(jax.random.PRNGKey(0), jcfg)
    init = _np(state)
    ks = jax.random.split(jax.random.PRNGKey(1))[1]
    x, y = _batch(jcfg)
    new, mets = JA.make_analog_sgd_step(jcfg, lr=LR)(
        jax.tree.map(jnp.copy, state),
        {"tokens": jnp.asarray(x), "labels": jnp.asarray(y)}, ks)
    seed_base = int(jax.random.bits(ks, (), jnp.uint32))
    got_state, got = TA.make_analog_sgd_step(cfg, lr=LR)(
        params_from_numpy(init, "cpu"),
        {"tokens": torch.from_numpy(x).long(),
         "labels": torch.from_numpy(y).long()}, seed_base)
    assert abs(float(got["loss"]) - float(mets["loss"])) <= 1e-5
    assert abs(float(got["aux"]) - float(mets["aux"])) <= 1e-5
    n_containers = 0
    for path, want in _leaves(_np(new["params"])):
        mine = _get(got_state["params"], path).numpy()
        g0 = _get(init["params"], path)
        if path[-1] in ("ref", "w_scale"):
            np.testing.assert_array_equal(mine, want)
            continue
        if path[-1] == "g":
            n_containers += 1
            for lyr in range(cfg.n_layers):
                err = np.linalg.norm(mine[lyr] - want[lyr]) / max(
                    np.linalg.norm(want[lyr] - g0[lyr]), 1e-30)
                assert err <= 1e-3, (path, lyr, err)
            if "experts" in path:
                assert np.abs(mine - g0).max() > 0, path
            continue
        err = np.linalg.norm(mine - want) / max(
            np.linalg.norm(want - g0), 1e-30)
        assert err <= 1e-3, (path, err)
    assert n_containers == 7


def test_fakequant_adamw_step_matches_reference():
    """QAT on MoE: one ``make_train_step(cfg, adamw(3e-4))`` step of the
    smoke model in fakequant mode (the expert stacks read per expert) on
    2 x 8 tokens, against the reference's step: loss and
    gradient norm within 1e-5, parameters within 1e-5 but where a
    gradient of rounding size flips a sign (under 1e-3 of the elements).
    At 4 x 16 tokens an ADC code flips in layer 0's experts instead (see
    :func:`test_fakequant_forward_flip_is_one_code_flip`)."""
    jcfg = jax_config(ARCH, True).replace(**MODES["fakequant"])
    cfg = get_config(ARCH, True).replace(**MODES["fakequant"])
    params = JM.init_params(jax.random.PRNGKey(0), jcfg)
    opt = JO.adamw(3e-4)
    state = {"params": params, "opt": opt.init(params),
             "step": jnp.zeros((), jnp.int32), "err_fb": ()}
    x, y = _batch(jcfg, 2, 8)
    new_j, mets_j = jax.jit(JLoop.make_train_step(jcfg, opt))(
        state, {"tokens": jnp.asarray(x), "labels": jnp.asarray(y)})
    new_t, mets_t = TLoop.make_train_step(cfg, TO.adamw(3e-4))(
        params_from_numpy(_np(state), "cpu"),
        {"tokens": torch.from_numpy(x).long(),
         "labels": torch.from_numpy(y).long()})
    for k in ("loss", "grad_norm", "aux"):
        want = float(mets_j[k])
        assert abs(float(mets_t[k]) - want) <= 1e-5 * abs(want) + 1e-6, k
    n = off = 0
    for path, want in _leaves(_np(new_j["params"])):
        mine = _get(new_t["params"], path).numpy()
        bad = np.abs(mine - want) > 1e-5 * np.abs(want) + 1e-6
        grad_j = _get(_np(new_j["opt"]["m"]), path) / 0.1
        assert np.all(np.abs(grad_j[bad]) < 1e-6), path
        off += int(bad.sum())
        n += want.size
    assert off <= 1e-3 * n


def test_fakequant_forward_flip_is_one_code_flip(monkeypatch):
    """At 4 x 16 tokens the fakequant model's loss may differ from the
    reference's by up to about 1e-3: the attention's outputs differ by
    float32 ulp (products in another order), which can move an expert's
    fakequant ADC code across a rounding boundary.  Fed the port's own
    input, each layer's MoE agrees with the reference's within 1e-6, so
    a difference comes from such a flip, not from the dispatch; the loss
    stays within 1e-2 of the reference's."""
    jcfg = jax_config(ARCH, True).replace(**MODES["fakequant"])
    cfg = get_config(ARCH, True).replace(**MODES["fakequant"])
    params = JM.init_params(jax.random.PRNGKey(0), jcfg)
    x, y = _batch(jcfg)
    seen = []
    moe_apply = TMoE.moe_apply

    def recorded(p, xx, c):
        out = moe_apply(p, xx, c)
        seen.append((p, xx.numpy().copy(), out[0].numpy().copy()))
        return out
    monkeypatch.setattr(TMoE, "moe_apply", recorded)
    tp = params_from_numpy(_np(params), "cpu")
    with torch.no_grad():
        loss, _ = M.loss_fn(tp, {"tokens": torch.from_numpy(x).long(),
                                 "labels": torch.from_numpy(y).long()}, cfg)
    assert len(seen) == cfg.n_layers
    for lyr, (p, xx, got) in enumerate(seen):
        jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), p)
        ref = np.asarray(_j_moe_apply(jp, xx, jcfg)[0])
        assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max(), lyr
    want = float(jax.jit(JM.loss_fn, static_argnums=2)(
        params, {"tokens": jnp.asarray(x), "labels": jnp.asarray(y)},
        jcfg)[0])
    assert abs(float(loss) - want) < 1e-2


def test_moe_model_cost_matches_reference():
    """The hwmodel inventory of llama4-scout at full size: the same
    projections (expert stacks counted layers x experts, active top_k /
    n_experts)."""
    from repro.hwmodel import arch_cost as JC
    from repro_torch.hwmodel import arch_cost as TC
    got = {p.name: dataclasses.astuple(p)
           for p in TC.model_projections(get_config(ARCH))}
    want = {p.name: dataclasses.astuple(p)
            for p in JC.model_projections(jax_config(ARCH))}
    assert got == want
    assert got["layers/moe/experts/w_up"][3:] == (768, 1 / 16)
