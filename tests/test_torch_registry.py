"""The registry's dense family in the port against the JAX package (the
fields of all 11 configs are held here too; the other families' models
in ``tests/test_torch_moe.py``, ``tests/test_torch_mla.py``,
``tests/test_torch_ssm.py``, ``tests/test_torch_hybrid.py``,
``tests/test_torch_vlm.py`` and ``tests/test_torch_audio.py``):
gemma-2b (MQA, GeGLU, head_dim 256, tied embeddings), stablelm-3b
(head_dim 80 at full size), starcoder2-3b (GQA kv=2, GELU, not gated,
rope_theta 1e5) and granite-20b (MQA, GELU, not gated), each as its
``SMOKE`` reduction.

The reference initialises each model at ``PRNGKey(0)`` (and programs it
for device mode); ``params_from_numpy`` carries the tree across.  The
forward runs in three modes: float32 digital, fakequant (16-row tiles,
8-bit DAC/ADC) and device (``taox-nonoise``, 16x16 tiles, 8-bit
DAC/ADC, dynamic ADC range), against the reference evaluated op by op.
One device-mode training step each (``taox``, lr 0.1, write noise from
the counter PRNG keyed by the reference's ``seed_base``) runs against the
reference's op-by-op step.

Tolerances:
  * logits: 1e-5, as ``tests/test_torch_serve.py`` holds lm100m;
  * starcoder2-3b in device mode at ``PRNGKey(0)`` flips an 8-bit ADC code
    (the two packages' dynamic ranges differ by a few float32 ulp), and
    the flip cascades into the logits.  It is held read by read, as
    ``tests/test_torch_forward_flips.py`` holds lm100m at ``PRNGKey(2)``:
    every reference read on its own operands within 1e-6 (of the read's
    largest output) but for one-lsb-per-K-tile code flips under 1% of the
    elements, the first free-running read that differs within one lsb per
    K tile, and the logits within 1e-5 with the reference's reads
    replayed.  The other three do not flip at this seed and are held to
    1e-5 free-running as well;
  * the training step, as ``tests/test_torch_train.py`` holds lm100m:
    the loss within 1e-5 (2e-3 where the forward flips), the last layer's
    conductances within 4 float32 ulp, every other update within 25% in
    2-norm per container and digital leaf.
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
from repro.configs import base as jbase
from repro.configs import get_config as jax_config
from repro.configs.registry import ARCHS as J_ARCHS
from repro.data import synthetic as jsyn
from repro.models import model as JM
from repro.train import analog_lm as JA
from repro_torch.configs import ARCHS, get_config, make_smoke
from repro_torch.convert import params_from_numpy
from repro_torch.core.tiled_analog import crossbar_from_model
from repro_torch.core.xbar_ops import vmm as torch_vmm
from repro_torch.models import model as M
from repro_torch.train import analog_lm as TA
from test_torch_forward_flips import _one_lsb_per_k_tile

DENSE = ["gemma-2b", "stablelm-3b", "starcoder2-3b", "granite-20b"]
MOE = ["llama4-scout-17b-a16e", "deepseek-v2-lite-16b"]
#: the SSM and hybrid configs (their models in ``tests/test_torch_ssm.py``
#: and ``tests/test_torch_hybrid.py``)
SSM = ["mamba2-1.3b", "zamba2-1.2b"]
#: the cross-attention configs (their models in ``tests/test_torch_vlm.py``
#: and ``tests/test_torch_audio.py``)
CROSS = ["llama-3.2-vision-90b", "whisper-medium"]
# the (arch, mode) pairs whose forward flips an ADC code at PRNGKey(0)
FLIPS = {("starcoder2-3b", "device")}
MODES = {
    "digital": dict(dtype="float32"),
    "fakequant": dict(dtype="float32", analog=True, analog_mode="fakequant",
                      analog_rows=16),
    "device": dict(dtype="float32", analog=True, analog_mode="device",
                   analog_device="taox-nonoise", analog_rows=16,
                   analog_cols=16),
}
TRAIN = dict(dtype="float32", analog=True, analog_mode="device",
             analog_device="taox", analog_rows=16, analog_cols=16)
LR = 0.1
ULP4 = 4 * 2.0 ** -24

_rng = np.random.default_rng(0)
TOKENS = _rng.integers(0, 256, (2, 8)).astype(np.int32)


def _np(tree):
    return jax.tree.map(np.array, tree)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


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

@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", DENSE + MOE + SSM + CROSS + ["lm100m"])
def test_config_matches_reference(arch, smoke):
    got, want = get_config(arch, smoke), jax_config(arch, smoke)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert sorted(ARCHS) == sorted(J_ARCHS) == sorted(
        DENSE + MOE + SSM + CROSS + ["lm100m"])


def test_make_smoke_matches_reference_with_overrides():
    for arch in DENSE + MOE + SSM + CROSS:
        got = make_smoke(get_config(arch), n_layers=1, vocab=512)
        want = jbase.make_smoke(jax_config(arch), n_layers=1, vocab=512)
        for f in dataclasses.fields(got):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert make_smoke(get_config("gemma-2b")).n_kv_heads == 1
    assert make_smoke(get_config("starcoder2-3b")).n_kv_heads == 2
    assert make_smoke(get_config("stablelm-3b")).n_kv_heads == 4
    moe = make_smoke(get_config("llama4-scout-17b-a16e"), top_k=2)
    j_moe = jbase.make_smoke(jax_config("llama4-scout-17b-a16e"), top_k=2)
    assert (moe.n_experts, moe.top_k, moe.d_ff_expert) == (8, 2, 64)
    for f in dataclasses.fields(moe):
        assert getattr(moe, f.name) == getattr(j_moe, f.name), f.name


# ------------------------------------------------------------------ forward

@pytest.fixture(scope="module")
def reference():
    """Per (arch, mode): the reference's tree, op-by-op logits and, in
    device mode, every forward read (operands and result)."""
    out = {}
    for arch in DENSE:
        params = JM.init_params(jax.random.PRNGKey(0),
                                jax_config(arch, True).replace(
                                    **MODES["digital"]))
        for mode, kw in MODES.items():
            jcfg = jax_config(arch, True).replace(**kw)
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
                with _no_remat(), jax.disable_jit():
                    logits = JM.forward(tree, {"tokens": jnp.asarray(TOKENS)},
                                        jcfg)[0]
            finally:
                JT._vmm_any = vmm_any
            out[arch, mode] = {"params": _np(tree), "logits": np.array(logits),
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
@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_reference_op_by_op(arch, mode, reference,
                                            monkeypatch):
    run = reference[arch, mode]
    cfg = get_config(arch, smoke=True).replace(**MODES[mode])
    logits, mine = _port_forward(run, cfg, monkeypatch)
    assert len(mine) == len(run["reads"]) \
        == (4 * cfg.n_layers if mode == "device" else 0)
    if (arch, mode) in FLIPS:
        assert np.abs(logits - run["logits"]).max() > 1e-5
        return          # held read by read below
    np.testing.assert_allclose(logits, run["logits"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", DENSE)
def test_device_reads_agree_on_reference_operands(arch, reference):
    """Every forward read of the reference, fed to the port on its own
    operands: within 1e-6, or (code flips) one lsb per K tile."""
    cfg = get_config(arch, smoke=True).replace(**MODES["device"])
    xcfg = crossbar_from_model(cfg)
    flipped = 0
    for i, (x, g, ref, ws, out) in enumerate(reference[arch, "device"]
                                             ["reads"]):
        ops = [torch.from_numpy(a) for a in (x, g, ref, ws)]
        err = np.abs(torch_vmm(*ops, xcfg).numpy() - out)
        off = err > 1e-6 * np.abs(out).max()
        if off.any():
            bound = _one_lsb_per_k_tile(*ops, xcfg)
            assert (err <= bound + 1e-6).all(), i
            assert off.mean() < 0.01, i
            flipped += int(off.sum())
    assert flipped <= 4


@pytest.mark.parametrize("arch", DENSE)
def test_device_logits_with_replayed_reads(arch, reference, monkeypatch):
    """With the reference's read results replayed, the logits agree within
    1e-5; where the forward flips, its first differing free-running read
    is within one lsb per K tile of the reference's."""
    run = reference[arch, "device"]
    cfg = get_config(arch, smoke=True).replace(**MODES["device"])
    replay = [r[4] for r in run["reads"]]
    logits, _ = _port_forward(run, cfg, monkeypatch, replay=replay)
    np.testing.assert_allclose(logits, run["logits"], rtol=1e-5, atol=1e-5)
    if (arch, "device") not in FLIPS:
        return
    _, mine = _port_forward(run, cfg, monkeypatch)
    xcfg = crossbar_from_model(cfg)
    for i, ((x, g, ref, ws, out), y) in enumerate(zip(run["reads"], mine)):
        if np.abs(y - out).max() > 1e-6 * np.abs(out).max():
            bound = _one_lsb_per_k_tile(*(torch.from_numpy(a) for a in
                                          (x, g, ref, ws)), xcfg)
            assert (np.abs(y - out) <= bound + 1e-6).all(), i
            return
    raise AssertionError("no read flips, yet the logits differ")


# --------------------------------------------------------- training step

def _batch(cfg):
    return jsyn.batch_tokens(jsyn.make_token_stream(4096, cfg.vocab), 2, 8,
                             0)


@pytest.fixture(scope="module")
def reference_steps():
    out = {}
    for arch in DENSE:
        jcfg = jax_config(arch, True).replace(**TRAIN)
        state = JA.init_state(jax.random.PRNGKey(0), jcfg)
        init = _np(state)
        ks = jax.random.split(jax.random.PRNGKey(1))[1]
        x, y = _batch(jcfg)
        with _no_remat(), jax.disable_jit():
            new, mets = JA.make_analog_sgd_step(jcfg, lr=LR)._step_impl(
                state, {"tokens": jnp.asarray(x), "labels": jnp.asarray(y)},
                ks)
        out[arch] = {"init": init, "state": _np(new),
                     "loss": float(mets["loss"]),
                     "seed_base": int(jax.random.bits(ks, (), jnp.uint32))}
    return out


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("arch", DENSE)
def test_device_train_step_matches_reference(arch, reference_steps):
    run = reference_steps[arch]
    cfg = get_config(arch, smoke=True).replace(**TRAIN)
    x, y = _batch(cfg)
    state, mets = TA.make_analog_sgd_step(cfg, lr=LR)(
        params_from_numpy(run["init"], "cpu"),
        {"tokens": torch.from_numpy(x).long(),
         "labels": torch.from_numpy(y).long()}, run["seed_base"])
    flips = (arch, "device") in FLIPS
    assert abs(float(mets["loss"]) - run["loss"]) <= (2e-3 if flips
                                                      else 1e-5)
    assert int(state["step"]) == 1
    init, want = run["init"]["params"], run["state"]["params"]
    n_containers = 0
    for path, ref_leaf in _leaves(want):
        got = _get(state["params"], path).numpy()
        g0 = _get(init, path)
        if path[-1] in ("ref", "w_scale"):
            np.testing.assert_array_equal(got, ref_leaf)
            continue
        if path[-1] == "g":
            n_containers += 1
            if not flips:       # no transpose read precedes its update
                np.testing.assert_allclose(got[-1], ref_leaf[-1], rtol=0,
                                           atol=ULP4)
            for lyr in range(cfg.n_layers):
                err = np.linalg.norm(got[lyr] - ref_leaf[lyr]) / max(
                    np.linalg.norm(ref_leaf[lyr] - g0[lyr]), 1e-30)
                assert err <= 0.25, (path, lyr, err)
            continue
        err = np.linalg.norm(got - ref_leaf) / max(
            np.linalg.norm(ref_leaf - g0), 1e-30)
        assert err <= 0.25, (path, err)
    assert n_containers == 4
