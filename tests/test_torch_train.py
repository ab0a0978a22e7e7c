"""The port's training slice against the JAX package: the taped matmul,
the registry rows, the loss, the data copy and the in-situ analog SGD step
on the lm100m smoke model (``taox``, 16x16 tiles, 8-bit DAC/ADC, dynamic
ADC range, float32, lr 0.1, write noise from the counter PRNG).

The reference runs op by op (``jax.disable_jit``): its jitted step moves
ADC codes at rounding boundaries (ROADMAP.md, "jitted vs op-by-op").  The
reference's initial state, batches and per-step ``seed_base`` draws
(``jax.random.bits``) are carried across into the port.

Tolerances, and why:

  * the taped matmul (``y``, ``dx``, ``x_q``, ``d_q``): 1e-6 — one
    container read by the same float32 operations in another order;
  * one step: the loss within 1e-5 (the forward is the same float32
    arithmetic); the last layer's conductances within 4 float32 ulp
    (2.4e-7), because its backward runs before any transpose read and so
    sees the reference's operands to rounding;
  * every other conductance and digital leaf, and all of them after 3
    steps: the port's update ``G_port - G_0`` within 25% (in the 2-norm,
    per container) of the reference's ``G_ref - G_0``, the loss within
    2e-2.  The autograd formulas of the two packages round differently
    (a few float32 ulp); where an 8-bit ADC code of a transpose read sits
    at a rounding boundary, that flips it by one lsb and the flip
    cascades into the earlier layers' error signals and 4-bit column
    drives.  :func:`test_step_divergence_starts_at_a_transpose_read_flip`
    shows that this, and not the port, is the source: every transpose
    read of the reference's step, fed to the port on the reference's own
    operands, agrees within 1e-6.  A sign error, a wrong seed, a missing
    noise term or a wrong learning rate moves the update by 50-200%.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.tiled_analog as JT
from repro.configs import get_config as jax_config
from repro.core import CrossbarConfig as JXbar
from repro.core import TAOX as J_TAOX
from repro.core import analog_registry as jreg
from repro.data import synthetic as jsyn
from repro.models import model as JM
from repro.train import analog_lm as JA
import repro_torch.core.tiled_analog as TT
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import TAOX, CrossbarConfig
from repro_torch.core import analog_registry as treg
from repro_torch.core.tiled_analog import crossbar_from_model
from repro_torch.core.xbar_ops import mvm as torch_mvm
from repro_torch.data import synthetic as tsyn
from repro_torch.models import model as M
from repro_torch.train import analog_lm as TA

DEVICE_MODE = dict(dtype="float32", analog=True, analog_mode="device",
                   analog_device="taox", analog_rows=16, analog_cols=16)
J_CFG = jax_config("lm100m", smoke=True).replace(**DEVICE_MODE)
CFG = get_config("lm100m", smoke=True).replace(**DEVICE_MODE)
LR = 0.1
BATCH, SEQ, STEPS = 2, 8, 3
CONTAINERS = [("attn", "wqkv"), ("attn", "wo"), ("ffn", "w_upgate"),
              ("ffn", "w_down")]
ULP4 = 4 * 2.0 ** -24


def _np(tree):
    return jax.tree.map(np.array, tree)


def _batch(i):
    x, y = jsyn.batch_tokens(jsyn.make_token_stream(4096, CFG.vocab), BATCH,
                             SEQ, i)
    return x, y


@pytest.fixture(scope="module")
def reference():
    """Three op-by-op reference steps from ``init_state(PRNGKey(0))``,
    with each step's batch, ``seed_base`` and resulting state, and the
    transpose reads of step 1 (operands and results).

    ``REPRO_REMAT=none`` (the reference's own knob for smoke-scale CPU
    runs) leaves the layer scan un-rematerialised, so the reads are
    concrete arrays that can be recorded; it does not change a value.
    """
    prev = os.environ.get("REPRO_REMAT")
    os.environ["REPRO_REMAT"] = "none"
    reads = []
    mvm_any = JT._mvm_any

    def recorded(d, g, ref, ws, cfg, meta=None):
        out = mvm_any(d, g, ref, ws, cfg, meta)
        if len(reads) < 4 * CFG.n_layers:
            reads.append(tuple(np.array(a) for a in (d, g, ref, ws, out)))
        return out

    JT._mvm_any = recorded
    try:
        state = JA.init_state(jax.random.PRNGKey(0), J_CFG)
        step = JA.make_analog_sgd_step(J_CFG, lr=LR)
        key = jax.random.PRNGKey(1)
        run = {"init": _np(state), "states": [], "losses": [],
               "seed_bases": [], "reads": reads}
        for i in range(STEPS):
            x, y = _batch(i)
            key, ks = jax.random.split(key)
            run["seed_bases"].append(int(jax.random.bits(ks, (),
                                                         jnp.uint32)))
            with jax.disable_jit():
                state, mets = step._step_impl(
                    state, {"tokens": jnp.asarray(x),
                            "labels": jnp.asarray(y)}, ks)
            run["states"].append(_np(state))
            run["losses"].append(float(mets["loss"]))
    finally:
        JT._mvm_any = mvm_any
        if prev is None:
            os.environ.pop("REPRO_REMAT")
        else:
            os.environ["REPRO_REMAT"] = prev
    return run


def _port_steps(reference, n, record=None):
    state = params_from_numpy(reference["init"], "cpu")
    step = TA.make_analog_sgd_step(CFG, lr=LR)
    losses, metrics = [], []
    for i in range(n):
        x, y = _batch(i)
        state, mets = step(state, {"tokens": torch.from_numpy(x).long(),
                                   "labels": torch.from_numpy(y).long()},
                           reference["seed_bases"][i])
        losses.append(float(mets["loss"]))
        metrics.append(mets)
    return state, losses, metrics


def _rel_update_err(port, ref, init):
    return (np.linalg.norm(port - ref)
            / max(np.linalg.norm(ref - init), 1e-30))


def _digital_leaves(tree, path=()):
    if isinstance(tree, dict):
        if "g" in tree:
            return
        for k, v in tree.items():
            yield from _digital_leaves(v, path + (k,))
    else:
        yield path


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_steps_match_op_by_op_reference(reference, n_steps):
    state, losses, metrics = _port_steps(reference, n_steps)
    ref_state = reference["states"][n_steps - 1]
    init = reference["init"]["params"]
    assert int(state["step"]) == n_steps
    assert abs(losses[0] - reference["losses"][0]) <= 1e-5
    np.testing.assert_allclose(losses, reference["losses"][:n_steps],
                               rtol=0, atol=2e-2)
    for m in metrics:
        assert set(m) == {"loss", "ce", "aux", "g_rail_frac"}
        assert 0.0 <= float(m["g_rail_frac"]) < 1e-2
    for blk, name in CONTAINERS:
        port = state["params"]["layers"][blk][name]["g"].numpy()
        ref = ref_state["params"]["layers"][blk][name]["g"]
        g0 = init["layers"][blk][name]["g"]
        if n_steps == 1:   # the last layer sees no transpose-read flip
            np.testing.assert_allclose(port[-1], ref[-1], rtol=0,
                                       atol=ULP4)
        for lyr in range(CFG.n_layers):
            err = _rel_update_err(port[lyr], ref[lyr], g0[lyr])
            assert err <= 0.25, (blk, name, lyr, err)
        for leaf in ("ref", "w_scale"):
            np.testing.assert_array_equal(
                state["params"]["layers"][blk][name][leaf].numpy(),
                ref_state["params"]["layers"][blk][name][leaf])
    for path in _digital_leaves(init):
        port = _get(state["params"], path).numpy()
        ref = _get(ref_state["params"], path)
        err = _rel_update_err(port, ref, _get(init, path))
        assert err <= 0.25, (path, err)
    if n_steps == 1:   # the final norm's gradient precedes every read
        np.testing.assert_allclose(state["params"]["final_ln"]["scale"],
                                   ref_state["params"]["final_ln"]["scale"],
                                   rtol=0, atol=1e-6)


def _one_lsb_per_n_tile(d, g, ref, ws, cfg):
    """Per output of a transpose read, the sum over its N tiles of one ADC
    lsb (times the read's rescale): what one code flip per tile can move
    it by."""
    from repro_torch.core.adc import integrator_saturation, quantize_input
    d_int, d_scale = quantize_input(d, cfg.adc)
    k, n = g.shape
    diff = torch.nn.functional.pad(g - ref, (0, (-n) % cfg.cols,
                                             0, (-k) % cfg.rows))
    tk, tn = diff.shape[0] // cfg.rows, diff.shape[1] // cfg.cols
    d_int = torch.nn.functional.pad(d_int, (0, diff.shape[1] - n))
    q = torch.einsum("btc,krtc->bktr",
                     d_int.reshape(-1, tn, cfg.cols),
                     diff.reshape(tk, cfg.rows, tn, cfg.cols))
    _, sat = integrator_saturation(q, cfg.adc, cfg.cols, cfg.device.gmax,
                                   reduce_axes=(0, 3))
    lsb = sat[0, :, :, 0] / cfg.adc.out_levels * (d_scale / ws)   # (tk, tn)
    return lsb.sum(1).repeat_interleave(cfg.rows)[:k].numpy()


def test_step_divergence_starts_at_a_transpose_read_flip(reference,
                                                         monkeypatch):
    """Every transpose read of the reference's first step, fed to the port
    on the reference's own operands, agrees within 1e-6; and the first of
    the port's own free-running reads that differs from the reference's
    by more than 1e-6 stays within one ADC lsb per N tile of it (a code
    flip per tile).  A difference between the free-running steps thus
    starts with operands that differ by float32 rounding and land on
    either side of an ADC code boundary, not with the port's read."""
    xcfg = crossbar_from_model(CFG)
    mine = []
    mvm = TT.mvm

    def recorded(d, g, ref, ws, cfg, **kw):
        out = mvm(d, g, ref, ws, cfg, **kw)
        mine.append(out.numpy().copy())
        return out

    monkeypatch.setattr(TT, "mvm", recorded)
    _port_steps(reference, 1)
    reads = reference["reads"]
    assert len(reads) == len(mine) == 4 * CFG.n_layers
    first = None
    for i, ((d, g, ref, ws, out), port_out) in enumerate(zip(reads, mine)):
        ops = [torch.from_numpy(a) for a in (d, g, ref, ws)]
        same = torch_mvm(*ops, xcfg).numpy()
        assert np.abs(same - out).max() <= 1e-6 * np.abs(out).max(), i
        if first is None and \
                np.abs(port_out - out).max() > 1e-6 * np.abs(out).max():
            first = i
            # the first read that differs differs by code flips only; the
            # later ones see the flips' effect in their operands
            bound = _one_lsb_per_n_tile(*ops, xcfg)
            assert (np.abs(port_out - out) <= bound + 1e-6).all(), i

def test_taped_matmul_matches_reference():
    """``y``, ``dx`` and the tapes (``x_q``, ``d_q``) of one container."""
    rng = np.random.default_rng(0)
    k, n, t = 40, 36, 10
    g = rng.uniform(0.3, 0.7, (k, n)).astype(np.float32)
    ref = np.full((k, n), 0.5, np.float32)
    ws = np.float32(1.7)
    x = rng.standard_normal((t, k)).astype(np.float32)
    dy = rng.standard_normal((t, n)).astype(np.float32)
    jcfg = JXbar(rows=16, cols=16, device=J_TAOX)
    tcfg = CrossbarConfig(rows=16, cols=16, device=TAOX)

    def jf(xx, xt, dt):
        p = {"g": jnp.asarray(g), "ref": jnp.asarray(ref),
             "w_scale": jnp.asarray(ws), "x_tape": xt, "d_tape": dt}
        return JT.analog_project(p, xx, jcfg)

    with jax.disable_jit():
        y, vjp = jax.vjp(jf, jnp.asarray(x), jnp.zeros((t, k)),
                         jnp.zeros((t, n)))
        dx, x_q, d_q = vjp(jnp.asarray(dy))
    p = {"g": torch.from_numpy(g), "ref": torch.from_numpy(ref),
         "w_scale": torch.tensor(ws), **TT.make_tapes(
             {"g": torch.from_numpy(g)}, t)}
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = TT.analog_project(p, xt, tcfg)
    yt.backward(torch.from_numpy(dy))
    for port, want in ((yt.detach(), y), (xt.grad, dx),
                       (p["x_tape"], x_q), (p["d_tape"], d_q)):
        np.testing.assert_allclose(port.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
    # no gradient reaches the conductances: none is ever formed
    for leaf in ("g", "ref", "w_scale"):
        assert p[leaf].grad is None and not p[leaf].requires_grad


def test_container_leaves_that_require_grad_raise():
    g = torch.full((16, 16), 0.5)
    p = {"g": g.clone().requires_grad_(True), "ref": g,
         "w_scale": torch.tensor(1.0)}
    with pytest.raises(ValueError, match="requires grad"):
        TT.analog_project(p, torch.ones((2, 16)), CrossbarConfig(
            rows=16, cols=16))


def test_split_merge_pop_push_tapes_round_trip():
    tp = params_from_numpy(_np(JM.init_params(jax.random.PRNGKey(0),
                                              J_CFG)), "cpu")
    diff, frozen = TT.split_tapes(tp, 16)
    wqkv = diff["layers"]["attn"]["wqkv"]
    assert set(wqkv) == {"x_tape", "d_tape", "x_tape_scale", "d_tape_scale"}
    assert wqkv["x_tape"].shape == (CFG.n_layers, 16, CFG.d_model)
    assert wqkv["x_tape_scale"].shape == (CFG.n_layers,)
    assert frozen["embed"] is None and "g" in frozen["layers"]["ffn"]["w_down"]
    merged = TT.merge_tapes(diff, frozen)
    clean, tapes, found = TT.pop_tapes(merged)
    assert found and not set(TT.TAPE_LEAVES) & set(
        clean["layers"]["attn"]["wo"])
    back = TT.push_tapes(clean, tapes)
    assert back["layers"]["attn"]["wo"]["d_tape"] is \
        merged["layers"]["attn"]["wo"]["d_tape"]
    assert clean["layers"]["attn"]["wo"]["g"] is tp["layers"]["attn"]["wo"]["g"]


def test_registry_dense_rows_match_reference():
    shapes = {"g": (2, 48, 32), "x_tape": (2, 5, 48), "d_tape": (2, 5, 32)}
    for path in (("layers", "attn", "wqkv"), ("layers", "ffn", "w_down")):
        kind = treg.classify(path)
        assert kind == jreg.classify(path)
        assert treg.tape_lead(path, CFG, 16, (2, 8)) == \
            jreg.tape_lead(path, J_CFG, 16, (2, 8))
        for leaf in ("g", "ref", "w_scale", "x_tape", "d_tape"):
            ndim = 1 if leaf == "w_scale" else 3
            assert treg.leaf_layout(kind, ndim, leaf, 16, 16) == \
                jreg.leaf_layout(kind, ndim, leaf, 16, 16)
        rng = np.random.default_rng(1)
        arrs = {k: rng.standard_normal(s).astype(np.float32)
                for k, s in shapes.items()}
        scale = np.float32([0.5, 2.0])
        jout = jreg.flatten_lead(kind, *(jnp.asarray(arrs[k]) for k in
                                         ("g", "x_tape", "d_tape")),
                                 jnp.asarray(scale))
        tout = treg.flatten_lead(kind, *(torch.from_numpy(arrs[k]) for k in
                                         ("g", "x_tape", "d_tape")),
                                 torch.from_numpy(scale))
        for a, b in zip(jout[:4], tout[:4]):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        np.testing.assert_array_equal(tout[4](tout[0]).numpy(), arrs["g"])
    # an expert-batched container tapes its capacity, as the reference's
    moe = get_config("llama4-scout-17b-a16e", smoke=True)
    j_moe = jax_config("llama4-scout-17b-a16e", smoke=True)
    for n in (16, 2048):
        assert treg.tape_lead(("layers", "moe", "experts", "w_up"), moe,
                              n) == jreg.tape_lead(
            ("layers", "moe", "experts", "w_up"), j_moe, n) \
            == (treg.expert_capacity(n, moe),)


def test_validate_device_params_rejects_digital_projections():
    tp = params_from_numpy(_np(JM.init_params(jax.random.PRNGKey(0),
                                              J_CFG)), "cpu")
    treg.validate_device_params(tp, CFG)
    bad = {**tp, "layers": {**tp["layers"], "attn": {
        **tp["layers"]["attn"], "wo": {"w": torch.zeros((2, 64, 64))}}}}
    with pytest.raises(ValueError, match="layers/attn/wo"):
        treg.validate_device_params(bad, CFG)
    with pytest.raises(ValueError, match="layers/attn/wo"):
        TA.make_analog_sgd_step(CFG, lr=LR)(
            {"params": bad, "step": torch.zeros((), dtype=torch.int32)},
            {"tokens": torch.zeros((1, 4), dtype=torch.long),
             "labels": torch.zeros((1, 4), dtype=torch.long)}, 0)


def test_loss_fn_matches_reference(reference):
    """The reference step's loss is ``loss_fn`` of its initial parameters
    on batch 0 (op by op); the port's ``loss_fn`` on the same parameters."""
    x, y = _batch(0)
    loss, m = M.loss_fn(params_from_numpy(reference["init"]["params"],
                                          "cpu"),
                        {"tokens": torch.from_numpy(x).long(),
                         "labels": torch.from_numpy(y).long()}, CFG)
    assert abs(float(loss) - reference["losses"][0]) <= 1e-5
    assert float(m["ce"]) == float(loss) and float(m["aux"]) == 0.0


def test_synthetic_data_copy_is_bit_equal():
    for seed, order_noise in ((0, 0.15), (3, 0.5)):
        a = jsyn.make_token_stream(3000, 97, seed, order_noise)
        b = tsyn.make_token_stream(3000, 97, seed, order_noise)
        np.testing.assert_array_equal(a, b)
        for step in (0, 7, 1000):
            for ja, tb in zip(jsyn.batch_tokens(a, 3, 11, step),
                              tsyn.batch_tokens(b, 3, 11, step)):
                np.testing.assert_array_equal(ja, tb)


def test_params_from_numpy_carries_a_train_state():
    state = _np(JA.init_state(jax.random.PRNGKey(0), J_CFG))
    ts = params_from_numpy(state, "cpu")
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 0
    np.testing.assert_array_equal(
        ts["params"]["layers"]["ffn"]["w_down"]["g"].numpy(),
        state["params"]["layers"]["ffn"]["w_down"]["g"])


def test_container_seed_matches_reference_mix():
    seed_base = 0xC0FFEE11
    for path in (("layers", "attn", "wqkv"), ("layers", "ffn", "w_down")):
        import zlib
        from repro.kernels.xbar_update import _mix32
        want = int(_mix32(jnp.uint32(seed_base) ^ jnp.uint32(
            zlib.crc32("/".join(path).encode()))))
        assert TA.container_seed(seed_base, path) == want


def test_inexact_step_on_one_device_is_the_exact_step():
    """``exact=False`` (the reference's GSPMD read, ported in
    ``kernels.xbar_vmm.manual_collective_read``) changes only how a
    sharded read sums its reduction tiles: on one device the step is the
    exact step, bit for bit (the mesh cases are in
    ``tests/test_torch_tensor_parallel.py``)."""
    state = TA.init_state(0, CFG, device="cpu")
    x, y = _batch(0)
    batch = {"tokens": torch.from_numpy(x).long(),
             "labels": torch.from_numpy(y).long()}
    outs = []
    for exact in (True, False):
        step = TA.make_analog_sgd_step(CFG, lr=LR, exact=exact)
        assert step.exact is exact
        outs.append(step(state, batch, 1234))
    (a, ma), (b, mb) = outs
    assert float(ma["loss"]) == float(mb["loss"])
    for path, leaf in _flat_leaves(a["params"]):
        assert torch.equal(leaf, _get_leaf(b["params"], path)), path


def _flat_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_leaves(v, path + (k,))
    else:
        yield path, tree


def _get_leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_noisy_step_takes_a_generator_or_its_seed_base():
    """A noisy device needs ``rng``; a Generator and the integer
    ``seed_base`` drawn from an identical Generator write the same G."""
    state = TA.init_state(0, CFG, device="cpu")
    x, y = _batch(0)
    batch = {"tokens": torch.from_numpy(x).long(),
             "labels": torch.from_numpy(y).long()}
    step = TA.make_analog_sgd_step(CFG, lr=LR)
    with pytest.raises(ValueError, match="rng"):
        step(state, batch)
    new, mets = step(state, batch, torch.Generator().manual_seed(0))
    assert torch.isfinite(mets["loss"])
    seed_base = int(torch.randint(0, 2 ** 32, (),
                                  generator=torch.Generator().manual_seed(0)))
    again, _ = step(state, batch, seed_base)
    g0 = state["params"]["layers"]["attn"]["wo"]["g"]
    g1 = new["params"]["layers"]["attn"]["wo"]["g"]
    assert not torch.equal(g1, g0)
    assert torch.equal(again["params"]["layers"]["attn"]["wo"]["g"], g1)
