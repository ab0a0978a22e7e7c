"""The rank-k write's code contract, which lets the card's write run on the
tensor cores, against the JAX package.

The training step's write operands are integer codes times one scale per
lead matrix (``core.xbar_ops.quantize_update_codes``): the backward pass
of ``TapedMatmul`` writes the scales beside the tapes, the train step
hands them to ``xbar_outer_update(..., x_scale=, d_scale=)``, and on the
card that takes the tensor-core instance, which sums the codes exactly
and scales the sum once: ``acc = fl(sum_t cx cd) * fl(x_scale d_scale)``.
The CUDA kernel runs only on the card (``chip_smoke.py`` phases 6, 7, 12
and 13 hold it against the plain version there); here a numpy emulation
of its arithmetic is held against the reference's ``_fused_update``.

Parity classes:

  * the tapes and their scales: bit-equal to the reference's ``x_q`` /
    ``d_q``, and ``codes * scale == tape`` bit for bit;
  * the plain version with and without scales: bit-equal (it ignores
    them);
  * the emulation, ideal device, power-of-two scales: bit-equal (every
    product and sum is exact in both);
  * the emulation, lm100m's regime (TaOx, counter-PRNG noise): outer,
    ``chip_smoke.tc_write_agrees`` — the ``update_bound`` rule (4 float32
    ulp plus 1e-5 of the move) on every cell but the sum-rounding ties,
    where the exact code sum is zero and the reference's float32 sum is
    its own rounding residual; pulse-train, ``chip_smoke.pulse_agrees``,
    where a pulse count may flip only at a tie.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.tiled_analog as JT
from repro.core import CrossbarConfig as JXbar
from repro.core import device as jdev
from repro.kernels import xbar_update as JU
import repro_torch.core.tiled_analog as TT
from repro_torch.configs import get_config
from repro_torch.core import AdcConfig, CrossbarConfig, DeviceConfig
from repro_torch.core.xbar_ops import quantize_update_codes
from repro_torch.kernels import xbar_update as U
from repro_torch.train import analog_lm as TA

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

DEVICES = {"ideal": dict(kind="ideal", write_noise=0.0),
           "taox": dict(kind="taox")}


def _dev(name):
    return (jdev.DeviceConfig(**DEVICES[name]),
            DeviceConfig(**DEVICES[name]))


def _xbar(tile, dev, mode):
    return (JXbar(rows=tile[0], cols=tile[1], device=dev[0],
                  update_mode=mode),
            CrossbarConfig(rows=tile[0], cols=tile[1], device=dev[1],
                           update_mode=mode))


def _codes(lyr, t, k, n, seed):
    """Integer codes inside the lm100m coders' levels (8-bit rows, 4-bit
    columns) and the g they write."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.05, 0.95, (lyr, k, n)).astype(np.float32)
    cx = rng.integers(-127, 128, (lyr, t, k)).astype(np.float32)
    cd = rng.integers(-7, 8, (lyr, t, n)).astype(np.float32)
    return g, cx, cd


def _scaled(cx, cd, sx, sd):
    """x_q, d_q as the write drivers form them: codes times the float32
    scale of their lead matrix."""
    return ((cx * sx[:, None, None]).astype(np.float32),
            (cd * sd[:, None, None]).astype(np.float32))


def _tc_emulation(g, cx, cd, sx, sd, scale, tcfg, seed=None):
    """The tensor-core instance's arithmetic: the exact integer sums, then
    one float32 multiply by fl(sx sd), then the plain version's epilogue
    (the kernel's is its operation-for-operation twin)."""
    ci, di = cx.astype(np.int64), cd.astype(np.int64)
    sxd = (sx * sd).astype(np.float32)[:, None, None]
    acc = np.einsum("ltk,ltn->lkn", ci, di).astype(np.float32) * sxd
    noise = None
    if seed is not None:
        noise = U.field_normals(seed, g.shape, tcfg)
    tg, m = torch.from_numpy(g), torch.from_numpy(scale)[:, None, None]
    if tcfg.update_mode == "pulse_train":
        a_abs = np.einsum("ltk,ltn->lkn", np.abs(ci),
                          np.abs(di)).astype(np.float32) * sxd
        out = U._pulse_epilogue(tg, torch.from_numpy(acc),
                                torch.from_numpy(a_abs), m, noise,
                                tcfg.device)
    else:
        out = U._device_epilogue(tg, m * torch.from_numpy(acc), noise,
                                 tcfg.device)
    return out, noise


def _reference(g, x_q, d_q, scale, jcfg, seed=None):
    """The reference's ``_fused_update`` (its ``impl="fused"`` path)."""
    return np.array(JU.xbar_outer_update(
        jnp.asarray(g), jnp.asarray(x_q), jnp.asarray(d_q),
        jnp.asarray(scale), jcfg, impl="fused",
        noise_mode="none" if seed is None else "kernel",
        seed=None if seed is None else jnp.uint32(seed)))


# ------------------------------------------------- the tapes and their scales


def _check_codes(tape, scale, levels):
    codes = torch.round(tape / scale)
    assert torch.equal(codes * scale, tape)
    assert codes.abs().max() <= levels
    return codes


def test_taped_backward_writes_codes_and_scales():
    """One container: the tapes equal the reference's x_q / d_q bit for
    bit, and each is its integer codes times the scale the backward wrote
    beside it."""
    rng = np.random.default_rng(0)
    k, n, t = 40, 36, 10
    g = rng.uniform(0.3, 0.7, (k, n)).astype(np.float32)
    ref = np.full((k, n), 0.5, np.float32)
    ws = np.float32(1.7)
    x = rng.standard_normal((t, k)).astype(np.float32)
    dy = (rng.standard_normal((t, n)) * 1e-2).astype(np.float32)
    jcfg, tcfg = _xbar((16, 16), _dev("taox"), "outer")

    def jf(xx, xt, dt):
        p = {"g": jnp.asarray(g), "ref": jnp.asarray(ref),
             "w_scale": jnp.asarray(ws), "x_tape": xt, "d_tape": dt}
        return JT.analog_project(p, xx, jcfg)

    with jax.disable_jit():
        _, vjp = jax.vjp(jf, jnp.asarray(x), jnp.zeros((t, k)),
                         jnp.zeros((t, n)))
        _, x_q, d_q = vjp(jnp.asarray(dy))
    p = {"g": torch.from_numpy(g), "ref": torch.from_numpy(ref),
         "w_scale": torch.tensor(ws),
         **TT.make_tapes({"g": torch.from_numpy(g)}, t)}
    assert p["x_tape_scale"].shape == () and float(p["x_tape_scale"]) == 1.0
    xt = torch.from_numpy(x).requires_grad_(True)
    TT.analog_project(p, xt, tcfg).backward(torch.from_numpy(dy))
    np.testing.assert_array_equal(p["x_tape"].numpy(), np.asarray(x_q))
    np.testing.assert_array_equal(p["d_tape"].numpy(), np.asarray(d_q))
    lx, ld = U.update_levels(tcfg)
    assert (lx, ld) == (127, 7)
    cx = _check_codes(p["x_tape"], p["x_tape_scale"], lx)
    cd = _check_codes(p["d_tape"], p["d_tape_scale"], ld)
    assert cx.abs().max() == lx and cd.abs().max() == ld   # full scale
    xi, xs, di, ds = quantize_update_codes(torch.from_numpy(x),
                                           torch.from_numpy(dy), tcfg)
    assert torch.equal(p["x_tape_scale"], xs)
    assert torch.equal(p["d_tape_scale"], ds)
    assert torch.equal(cx, xi) and torch.equal(cd, di)


def test_stacked_tapes_get_one_scale_per_layer():
    """A scan-stacked container applied layer by layer (``tree_index``
    views, as the model applies it): each layer's scale slot holds that
    layer's own full scale."""
    rng = np.random.default_rng(1)
    lyr, k, n, t = 3, 24, 20, 6
    g = torch.from_numpy(rng.uniform(0.3, 0.7, (lyr, k, n))
                         .astype(np.float32))
    p = {"g": g, "ref": torch.full_like(g, 0.5),
         "w_scale": torch.full((lyr,), 1.3), **TT.make_tapes({"g": g}, t)}
    assert p["d_tape_scale"].shape == (lyr,)
    _, tcfg = _xbar((16, 16), _dev("taox"), "outer")
    for i in range(lyr):
        x = torch.from_numpy(rng.standard_normal((t, k)).astype(np.float32)
                             * (i + 1)).requires_grad_(True)
        dy = torch.from_numpy(rng.standard_normal((t, n)).astype(np.float32)
                              * 10.0 ** -i)
        TT.analog_project({key: v[i] for key, v in p.items()}, x,
                          tcfg).backward(dy)
        _, xs, _, ds = quantize_update_codes(x.detach(), dy, tcfg)
        assert torch.equal(p["x_tape_scale"][i], xs)
        assert torch.equal(p["d_tape_scale"][i], ds)
        _check_codes(p["x_tape"][i], p["x_tape_scale"][i], 127)
        _check_codes(p["d_tape"][i], p["d_tape_scale"][i], 7)


def test_train_step_hands_the_scales_to_the_write(monkeypatch):
    """Every write of a CPU train step gets (L,) scales with which its
    tapes are codes times scale, and a config whose write takes the
    tensor-core instance on the card."""
    cfg = get_config("lm100m", smoke=True).replace(
        dtype="float32", analog=True, analog_mode="device",
        analog_device="taox", analog_rows=16, analog_cols=16)
    seen = []
    write = TA.xbar_outer_update

    def recorded(g, x_q, d_q, scale, xcfg, **kw):
        seen.append((x_q, d_q, kw["x_scale"], kw["d_scale"], xcfg))
        return write(g, x_q, d_q, scale, xcfg, **kw)

    monkeypatch.setattr(TA, "xbar_outer_update", recorded)
    state = TA.init_state(0, cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 8),
                           generator=torch.Generator().manual_seed(0))
    TA.make_analog_sgd_step(cfg, lr=0.1)(
        state, {"tokens": tokens, "labels": tokens}, 7)
    assert len(seen) == 4
    for x_q, d_q, xs, ds, xcfg in seen:
        assert xs.shape == ds.shape == (cfg.n_layers,)
        _check_codes(x_q, xs[:, None, None], 127)
        _check_codes(d_q, ds[:, None, None], 7)
        assert U.update_instance(x_q.shape[1], xcfg, True) == "tensor_core"


# ------------------------------------------------------------- the write


@pytest.mark.parametrize("mode", ["outer", "pulse_train"])
def test_plain_write_ignores_the_scales(mode):
    g, cx, cd = _codes(2, 9, 40, 37, seed=2)
    sx = np.float32([3 / 127, 2 / 127])
    sd = np.float32([2e-4 / 7, 3e-4 / 7])
    x_q, d_q = _scaled(cx, cd, sx, sd)
    _, tcfg = _xbar((16, 16), _dev("taox"), mode)
    args = [torch.from_numpy(a) for a in (g, x_q, d_q)]
    scale = torch.tensor([-0.15, -0.2])
    plain = U.xbar_outer_update(*args, scale, tcfg, seed=5)
    before = dict(U.LAUNCHES)
    with_scales = U.xbar_outer_update(*args, scale, tcfg, seed=5,
                                      x_scale=torch.from_numpy(sx),
                                      d_scale=torch.from_numpy(sd))
    assert torch.equal(with_scales, plain) and U.LAUNCHES == before
    single = U.xbar_outer_update(*(a[0] for a in args), scale[0], tcfg,
                                 seed=5, x_scale=float(sx[0]),
                                 d_scale=float(sd[0]))
    assert single.shape == g.shape[1:]


@pytest.mark.parametrize("mode", ["outer", "pulse_train"])
@pytest.mark.parametrize("tile", [(16, 16), (16, 15)])
def test_tensor_core_arithmetic_bitwise_ideal_pow2(mode, tile):
    """Power-of-two scales, ideal device: the emulation equals the
    reference's float32 write bit for bit."""
    g, cx, cd = _codes(3, 64, 40, 37, seed=3)
    sx = np.full((3,), 2.0 ** -7, np.float32)
    sd = np.full((3,), 2.0 ** -12, np.float32)
    x_q, d_q = _scaled(cx, cd, sx, sd)
    scale = np.full((3,), -0.25 if mode == "pulse_train" else -2.0 ** -6,
                    np.float32)
    jcfg, tcfg = _xbar(tile, _dev("ideal"), mode)
    got, _ = _tc_emulation(g, cx, cd, sx, sd, scale, tcfg)
    want = _reference(g, x_q, d_q, scale, jcfg)
    np.testing.assert_array_equal(got.numpy(), want)
    # the write moved G (pulse-train: by whole events)
    moved = tcfg.device.pulse_dg if mode == "pulse_train" else 1e-4
    assert np.abs(want - g).max() > moved


def _plant_zero_sums(cx, cd, cells, seed):
    """Make the code sums of ``cells`` (distinct rows and columns) exactly
    zero with non-zero terms: token pairs cx1 cd1 = cd1 cd2 r = cx2 cd2
    enter with opposite signs.  Their float32 products round apart, so
    the plain version's sum there is a rounding residual."""
    rng = np.random.default_rng(seed)
    half = cx.shape[1] // 2
    for lyr, k, n in cells:
        c1, c2 = rng.integers(1, 8, half), rng.integers(1, 8, half)
        r = rng.integers(1, 127 // 7 + 1, half)
        sign = rng.choice([-1, 1], half)
        cx[lyr, 0::2, k], cd[lyr, 0::2, n] = c2 * r * sign, c1
        cx[lyr, 1::2, k], cd[lyr, 1::2, n] = c1 * r * sign, -c2


@pytest.mark.parametrize("tile", [(16, 16), (16, 15)])
def test_tensor_core_arithmetic_outer_lm100m_regime(tile):
    """lm100m's regime (T = 2048, row scale 3/127, column scale 2e-4/7,
    lr 0.1 times w_scale about 1.7), TaOx with counter-PRNG noise, with
    zero code sums planted on 30 cells of each layer: in
    ``chip_smoke.tc_write_agrees``'s class against the reference, the
    rule the card holds the kernel to (``update_bound`` against the port's
    twin of this arithmetic on every cell; against the reference on every
    cell but the sum-rounding ties, which the planted cells produce)."""
    g, cx, cd = _codes(2, 2048, 40, 37, seed=4)
    cells = [(lyr, i, i) for lyr in range(2) for i in range(30)]
    _plant_zero_sums(cx, cd, cells, seed=5)
    sx = np.float32([3 / 127, 2.2 / 127])
    sd = np.float32([2e-4 / 7, 1.3e-4 / 7])
    x_q, d_q = _scaled(cx, cd, sx, sd)
    scale = np.float32([-0.17, -0.15])
    jcfg, tcfg = _xbar(tile, _dev("taox"), "outer")
    got, z = _tc_emulation(g, cx, cd, sx, sd, scale, tcfg, seed=0xC0DE)
    want = torch.from_numpy(_reference(g, x_q, d_q, scale, jcfg,
                                       seed=0xC0DE))
    ops = [torch.from_numpy(a) for a in (g, x_q, d_q, scale)]
    twin = U._update_tc_plain(*ops, None, 0xC0DE, tcfg, "kernel",
                              torch.from_numpy(sx), torch.from_numpy(sd))
    ok, err, over_twin, share = chip_smoke.tc_write_agrees(
        got, want, twin, *ops[:3], ops[3], tcfg, z)
    assert ok and share < chip_smoke.SUM_TIE_SHARE, (err, over_twin, share)
    assert torch.equal(got, twin)           # two emulations, one arithmetic
    bound = chip_smoke.update_bound(want, ops[0])
    assert ((got - want).abs() > bound).any() and share > 0
    assert (want - torch.from_numpy(g)).abs().max() > 1e-3
    # the planted cells move by no request in the exact sum ...
    idx = tuple(np.array(cells).T)
    ideal = U._device_epilogue(ops[0], torch.zeros_like(ops[0]), z,
                               tcfg.device)
    assert torch.equal(got[idx], ideal[idx])
    # ... and by the plain float32 sum's residual in the reference
    acc = np.einsum("ltk,ltn->lkn", x_q, d_q)
    assert (acc[idx] != 0).any()


@pytest.mark.parametrize("tile", [(16, 16), (16, 15)])
def test_tensor_core_arithmetic_pulse_lm100m_regime(tile):
    """Pulse-train in lm100m's regime with counter-PRNG noise: in
    ``chip_smoke.pulse_agrees``'s class, where a pulse count may differ
    only where its rail sits at a tie."""
    g, cx, cd = _codes(2, 256, 40, 37, seed=5)
    sx = np.float32([3 / 127, 2.2 / 127])
    sd = np.float32([2e-4 / 7, 1.3e-4 / 7])
    x_q, d_q = _scaled(cx, cd, sx, sd)
    scale = np.float32([-0.6, -0.45])     # a few events per cell
    jcfg, tcfg = _xbar(tile, _dev("taox"), "pulse_train")
    got, z = _tc_emulation(g, cx, cd, sx, sd, scale, tcfg, seed=0xBEEF)
    want = torch.from_numpy(_reference(g, x_q, d_q, scale, jcfg,
                                       seed=0xBEEF))
    ok, err, _, share = chip_smoke.pulse_agrees(
        got, want, torch.from_numpy(g), torch.from_numpy(x_q),
        torch.from_numpy(d_q), torch.from_numpy(scale), tcfg, z)
    assert ok, (err, share)
    assert (want - torch.from_numpy(g)).abs().max() > 2 * tcfg.device.pulse_dg


def test_code_planes_plain_twin():
    """The pre-pass's plain version recovers the codes exactly in bf16,
    zero-padded to the planes' dims (one line of torch here)."""
    g, cx, cd = _codes(2, 37, 200, 72, seed=6)
    sx = np.float32([3 / 127, 0.7 / 127])
    sd = np.float32([2e-4 / 7, 5e-3 / 7])
    x_q, d_q = _scaled(cx, cd, sx, sd)
    _, tcfg = _xbar((48, 63), _dev("taox"), "outer")
    px, pd = U._update_codes_plain(torch.from_numpy(x_q),
                                   torch.from_numpy(d_q),
                                   torch.from_numpy(sx), torch.from_numpy(sd),
                                   tcfg)
    tp, kp, np_ = U.update_code_dims(37, 200, 72)
    assert (tp, kp, np_) == (64, 256, 128)
    assert px.shape == (2, tp, kp) and pd.shape == (2, tp, np_)
    assert px.dtype == pd.dtype == torch.bfloat16
    for plane, codes, q, s in ((px, cx, x_q, sx), (pd, cd, d_q, sd)):
        t, f = codes.shape[1:]
        assert torch.equal(plane[:, :t, :f].float(), torch.from_numpy(codes))
        twin = torch.round(torch.from_numpy(q)
                           / torch.from_numpy(s)[:, None, None])
        assert torch.equal(plane[:, :t, :f].float(), twin)
        assert not plane[:, t:].any() and not plane[:, :, f:].any()
    planes = U.code_planes(torch.cat([px.reshape(-1), pd.reshape(-1)]), 2,
                           37, 200, 72)
    assert torch.equal(planes[0], px) and torch.equal(planes[1], pd)


# --------------------------------------------------------------- dispatch


def test_update_instance_by_operand_class():
    cfg = CrossbarConfig()
    assert U.update_instance(2048, cfg, True) == "tensor_core"
    assert U.update_instance(2048, cfg, False) == "fp32"
    # the largest T whose sums of 8-bit x 4-bit codes stay below 2^24
    t_max = (2 ** 24 - 1) // (127 * 7)
    assert U.update_instance(t_max, cfg, True) == "tensor_core"
    assert U.update_instance(t_max + 1, cfg, True) == "fp32"
    wide = cfg.replace(upd_col_bits=9)          # 255 column levels
    assert U.update_instance(256, wide, True) == "tensor_core"
    assert U.update_instance(1024, wide, True) == "fp32"
    dac10 = cfg.replace(adc=AdcConfig(in_bits=10))   # 511 levels
    assert U.update_instance(16, dac10, True) == "fp32"


def test_dispatch_raises_on_cpu_cuda_and_bad_scales():
    g, cx, cd = _codes(2, 5, 20, 12, seed=7)
    sx = np.float32([0.1, 0.2])
    sd = np.float32([0.01, 0.02])
    x_q, d_q = _scaled(cx, cd, sx, sd)
    args = [torch.from_numpy(a) for a in (g, x_q, d_q)]
    scale = torch.tensor([-0.1, -0.1])
    xs, ds = torch.from_numpy(sx), torch.from_numpy(sd)
    cfg = CrossbarConfig(rows=16, cols=16)
    with pytest.raises(ValueError, match="CUDA"):
        U.xbar_outer_update(*args, scale, cfg, seed=1, impl="cuda",
                            x_scale=xs, d_scale=ds)
    with pytest.raises(ValueError, match="CUDA"):
        U._update_cuda(*args, scale, None, 1, cfg, "kernel", xs, ds)
    with pytest.raises(ValueError, match="CUDA"):
        U._update_prepare_cuda(args[1], args[2], xs, ds, cfg)
    with pytest.raises(ValueError, match="together"):
        U.xbar_outer_update(*args, scale, cfg, seed=1, x_scale=xs)
    for bad in (torch.ones(3), torch.ones((2, 1)), torch.ones((1, 2))):
        with pytest.raises(ValueError, match="x_scale"):
            U.xbar_outer_update(*args, scale, cfg, seed=1, x_scale=bad,
                                d_scale=ds)
    with pytest.raises(ValueError, match="d_scale"):
        U.xbar_outer_update(*args, scale, cfg, seed=1, x_scale=xs,
                            d_scale=torch.ones(4))


def test_tensor_core_source():
    """The tensor-core instance: bf16 mma.sync fed by a cp.async ring and
    ldmatrix, both modes from one template, the pre-pass rounding half to
    even, and no library product on the write path."""
    src = U.SOURCE.read_text()
    for needle in ("tc_update_kernel", "update_prepare_kernel",
                   "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32",
                   "cp.async.cg.shared.global", "ldmatrix.sync.aligned",
                   "xbar_tc_update", "xbar_update_prepare", "rintf("):
        assert needle in src, needle
    assert "cublas" not in src.lower()
    py = Path(U.__file__).read_text()
    for call in ("torch.matmul", "torch.bmm", "torch.compile"):
        assert call not in py
