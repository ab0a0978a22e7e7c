"""The port's pulse-train writes, periodic carry and numeric baseline
against the JAX package: the pulse-train plain version of the rank-k
write, the device's pulse-train host twins, ``carry_fold`` and the carry
sweep, one in-situ training step with carry and pulse-train writes on the
lm100m smoke model (16x16 tiles, TaOx, 8-bit DAC/ADC), and one step of
the numeric ``train_loop``.

Parity classes, and why:

  * exact — ideal device, no noise, operands on power-of-two grids: every
    product and sum of both accumulators is exact, so the event counts
    are too: bit-equal;
  * float — TaOx with host or counter-PRNG noise on arbitrary operands:
    the accumulators are float32 sums taken in another order, so a rail's
    ``mag / pulse_dg`` can land on the other side of a half-integer and
    flip its count by one.  Every cell lies within 4 float32 ulp plus
    1e-5 of its own move, or it is a tie cell (``mag / pulse_dg`` within
    1e-4 relative of a half-integer) within one event
    (``pulse_dg * max(up, dn)``) plus the sigma change plus that slack;
    fewer than 1e-3 of the cells use the tie allowance;
  * carry sweep — elementwise: bit-equal, or one ADC code apart where
    ``v / lsb`` sits at a rounding boundary; the sweep conserves
    ``effective_g`` within 1e-6;
  * numeric step — loss, grad norm and every leaf within 1e-5 relative
    plus 1e-6 (float32 autograd of two frameworks).

The inputs are made with numpy from a seed and handed to both packages;
draws of ``jax.random`` (initial weights, noise fields, ``seed_base``)
are taken from the reference and carried across.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import CrossbarConfig as JXbar
from repro.core import device as jdev
from repro.core.periodic_carry import carry_fold as jax_carry_fold
from repro.core.tiled_analog import effective_g as jax_effective_g
from repro.data import synthetic as jsyn
from repro.kernels import xbar_update as JU
from repro.models import model as JM
from repro.train import analog_lm as JA
from repro.train import optimizer as JO
from repro.train import train_loop as JL
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import CrossbarConfig, DeviceConfig
from repro_torch.core import device as tdev
from repro_torch.core.periodic_carry import carry_fold
from repro_torch.core.tiled_analog import crossbar_from_model, effective_g
from repro_torch.kernels import xbar_update as U
from repro_torch.train import analog_lm as TA
from repro_torch.train import optimizer as TO
from repro_torch.train import train_loop as TL

ULP4 = 4 * 2.0 ** -24          # 4 float32 ulp of a conductance in [0.5, 1)
DEVICES = {
    "ideal": dict(kind="ideal", write_noise=0.0),
    "taox": dict(kind="taox"),
    "taox_asym": dict(kind="taox", nu_set=3.0, nu_reset=6.0, gain_set=1.3,
                      gain_reset=0.7),
    "linearized": dict(kind="linearized"),
}
CARRY_MODE = dict(dtype="float32", analog=True, analog_mode="device",
                  analog_device="taox", analog_rows=16, analog_cols=16,
                  analog_in_bits=8, analog_out_bits=8, analog_carry=True,
                  carry_period=2, analog_carry_base=4.0,
                  analog_update_mode="pulse_train")
J_CFG = jax_config("lm100m", smoke=True).replace(**CARRY_MODE)
CFG = get_config("lm100m", smoke=True).replace(**CARRY_MODE)
LR = 0.1
BATCH, SEQ = 2, 8
CONTAINERS = [("attn", "wqkv"), ("attn", "wo"), ("ffn", "w_upgate"),
              ("ffn", "w_down")]


def _dev(name):
    return (jdev.DeviceConfig(**DEVICES[name]),
            DeviceConfig(**DEVICES[name]))


def _np(tree):
    return jax.tree.map(np.array, tree)


def _pulse_operands(lyr, t, k, n, pow2, seed):
    """Operands of a pulse-train write.  ``pow2``: x on a 2^-7 grid, d on
    2^-6 and scale -2^-2, so both accumulators and the rails are exact.
    Otherwise the drives lean positive (rows) and negative (columns), so
    the SET and RESET rails differ."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.05, 0.95, (lyr, k, n)).astype(np.float32)
    if pow2:
        x_q = rng.integers(-127, 128, (lyr, t, k)) * 2.0 ** -7
        d_q = rng.integers(-7, 8, (lyr, t, n)) * 2.0 ** -6
        scale = np.full((lyr,), -0.25)
    else:
        x_q = rng.integers(-60, 128, (lyr, t, k)) * (2.6 / 127)
        d_q = rng.integers(-7, 5, (lyr, t, n)) * (0.03 / 7)
        scale = -rng.uniform(0.4, 0.8, lyr)
    return tuple(a.astype(np.float32) for a in (g, x_q, d_q, scale))


def _xbar(tile, dev, mode="pulse_train"):
    return (JXbar(rows=tile[0], cols=tile[1], device=dev[0],
                  update_mode=mode),
            CrossbarConfig(rows=tile[0], cols=tile[1], device=dev[1],
                           update_mode=mode))


def _reference_write(ops, jcfg, jimpl="fused", noise_mode="none", seed=None,
                     noise=None):
    g, x_q, d_q, scale = (jnp.asarray(a) for a in ops)
    return np.array(JU.xbar_outer_update(
        g, x_q, d_q, scale, jcfg, impl=jimpl, noise_mode=noise_mode,
        seed=None if seed is None else jnp.uint32(seed),
        noise=None if noise is None else jnp.asarray(noise)))


def _port_write(ops, tcfg, noise_mode="none", seed=None, noise=None):
    g, x_q, d_q, scale = (torch.from_numpy(a) for a in ops)
    return U.xbar_outer_update(
        g, x_q, d_q, scale, tcfg, noise_mode=noise_mode, seed=seed,
        noise=None if noise is None else torch.from_numpy(noise)).numpy()


def pulse_float_class(got, want, ops, tcfg, z):
    """Check ``got`` against ``want`` (two pulse-train writes of ``ops``)
    in the float class; returns the share of cells that used the tie
    allowance.  The rails are recomputed by the port's plain version;
    ``z`` is the write's standard-normal field (zeros if noiseless)."""
    g, x_q, d_q, scale = (torch.from_numpy(a) for a in ops)
    dev = tcfg.device
    m = scale[:, None, None]
    acc = torch.einsum("lbk,lbn->lkn", x_q, d_q)
    a_abs = torch.einsum("lbk,lbn->lkn", x_q.abs(), d_q.abs())
    rails = [(0.5 * (a_abs * m.abs() + sgn * acc * m)).clamp(min=0)
             / dev.pulse_dg for sgn in (1, -1)]
    tie = torch.zeros_like(g, dtype=torch.bool)
    for v in rails:
        tie |= (v - torch.floor(v) - 0.5).abs() <= 1e-4 * v.abs()
    n = sum(torch.round(v) for v in rails)
    if dev.kind in ("ideal", "linearized"):
        event = torch.full_like(g, dev.pulse_dg)
    else:
        up, dn = U._updown_factors(g, dev)
        event = dev.pulse_dg * torch.maximum(up, dn)
    dsig = dev.write_noise * dev.pulse_dg * torch.maximum(
        torch.sqrt(n + 1) - torch.sqrt(n),
        torch.sqrt(n) - torch.sqrt(torch.clamp(n - 1, min=0)))
    got, want = torch.from_numpy(got), torch.from_numpy(want)
    slack = ULP4 + 1e-5 * (want - g).abs()
    err = (got - want).abs()
    close = err <= slack
    flipped = ~close
    assert bool((tie | close).all()), "a cell off its bound is not a tie"
    assert bool((err[flipped] <= (event + dsig * torch.from_numpy(z).abs()
                                  + slack)[flipped]).all())
    share = flipped.float().mean().item()
    assert share < 1e-3, share
    return share


# --------------------------------------------------- pulse-train write


@pytest.mark.parametrize("jimpl", ["fused", "interpret"])
@pytest.mark.parametrize("tile", [(16, 16), (16, 15)])
def test_pulse_plain_exact_class_bit_equal(jimpl, tile):
    ops = _pulse_operands(2, 9, 40, 37, pow2=True, seed=1)
    jcfg, tcfg = _xbar(tile, _dev("ideal"))
    ref = _reference_write(ops, jcfg, jimpl)
    port = _port_write(ops, tcfg)
    np.testing.assert_array_equal(port, ref)
    assert np.abs(port - ops[0]).max() > 4 / 256        # several events


@pytest.mark.parametrize("dev", ["taox", "taox_asym"])
@pytest.mark.parametrize("noise_mode", ["host", "kernel"])
def test_pulse_plain_float_class(dev, noise_mode):
    ops = _pulse_operands(2, 9, 40, 37, pow2=False, seed=2)
    jcfg, tcfg = _xbar((16, 16), _dev(dev))
    noise = seed = None
    if noise_mode == "host":
        noise = np.random.default_rng(3).standard_normal(
            ops[0].shape).astype(np.float32)
        z = noise
    else:
        seed = 0xA5A5F00D
        z = U.field_normals(seed, ops[0].shape, tcfg).numpy()
    ref = _reference_write(ops, jcfg, "fused", noise_mode, seed, noise)
    port = _port_write(ops, tcfg, noise_mode, seed, noise)
    pulse_float_class(port, ref, ops, tcfg, z)
    assert np.abs(port - ops[0]).max() > 1e-2
    # a sign slip swaps the rails: far outside the class on this device
    swapped = _port_write((ops[0], ops[1], -ops[2], ops[3]), tcfg,
                          noise_mode, seed, noise)
    assert np.abs(swapped - ref).max() > 1e-2


def test_pulse_kernel_noise_reference_paths_agree():
    """The reference's interpreted kernel, in the float class too (its
    accumulate runs in token blocks)."""
    ops = _pulse_operands(2, 9, 40, 37, pow2=False, seed=4)
    jcfg, tcfg = _xbar((16, 16), _dev("taox_asym"))
    z = U.field_normals(77, ops[0].shape, tcfg).numpy()
    ref = _reference_write(ops, jcfg, "interpret", "kernel", 77)
    port = _port_write(ops, tcfg, "kernel", 77)
    pulse_float_class(port, ref, ops, tcfg, z)


@pytest.mark.parametrize("name", list(DEVICES))
def test_pulse_train_host_twins_match_reference(name):
    """``core.device.pulse_train_counts`` / ``apply_pulse_train``: the
    reference draws its field from a key, the port takes the field."""
    jd, td = _dev(name)
    rng = np.random.default_rng(5)
    shape = (24, 20)
    g = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    g.flat[:3] = [0.0, 1.0, 0.5]
    s_mag = (rng.uniform(0, 0.05, shape)).astype(np.float32)
    r_mag = (rng.uniform(0, 0.05, shape)).astype(np.float32)
    s_mag.flat[3:6] = [0.0, 2.5 / 256, 0.9]       # zero, a tie, the rail
    key = jax.random.PRNGKey(9)
    j_counts = jdev.pulse_train_counts(jnp.asarray(s_mag),
                                       jnp.asarray(r_mag), jd)
    t_counts = tdev.pulse_train_counts(torch.from_numpy(s_mag),
                                       torch.from_numpy(r_mag), td)
    for a, b in zip(j_counts, t_counts):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert float(t_counts[0].flatten()[4]) == 2.0   # half to even
    ref = np.asarray(jdev.apply_pulse_train(
        jnp.asarray(g), jnp.asarray(s_mag), jnp.asarray(r_mag), jd,
        key if jd.write_noise > 0 else None))
    noise = np.array(jax.random.normal(key, shape, dtype=jnp.float32))
    port = tdev.apply_pulse_train(
        torch.from_numpy(g), torch.from_numpy(s_mag),
        torch.from_numpy(r_mag), td, torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(port, ref, rtol=0, atol=ULP4)


def test_pulse_quantisation_bound_and_outer_equivalence():
    """Ideal noiseless device, mid-window conductances: the pulse-train
    write equals the requested update ``m * acc`` up to one pulse_dg of
    count quantisation, and the outer write within the same pulse_dg."""
    g, x_q, d_q, scale = _pulse_operands(2, 9, 40, 37, pow2=False, seed=6)
    g = np.full_like(g, 0.5)
    scale = np.full_like(scale, 0.1)
    ops = (g, x_q, d_q, scale)
    _, tcfg = _xbar((16, 16), _dev("ideal"))
    pulse = _port_write(ops, tcfg)
    outer = _port_write(ops, tcfg.replace(update_mode="outer"))
    req = scale[:, None, None] * np.einsum("lbk,lbn->lkn", x_q, d_q)
    pdg = tcfg.device.pulse_dg
    assert np.abs(pulse - g - req).max() <= pdg + 1e-6
    assert np.abs(pulse - outer).max() <= pdg + 1e-6
    assert np.abs(pulse - g).max() > 2 * pdg


def test_pulse_differs_from_outer_on_taox():
    """On a nonlinear device the per-train response is not the aggregate
    response: the two modes must not coincide."""
    ops = _pulse_operands(2, 9, 40, 37, pow2=False, seed=7)
    dev = DeviceConfig(**DEVICES["taox"]).replace(write_noise=0.0)
    tcfg = CrossbarConfig(rows=16, cols=16, device=dev,
                          update_mode="pulse_train")
    a = _port_write(ops, tcfg)
    b = _port_write(ops, tcfg.replace(update_mode="outer"))
    assert np.abs(a - b).max() > 1e-4


# --------------------------------------------------------- periodic carry


def _carry_container(seed, shape=(2, 40, 37)):
    """A container mid-training: primary conductances across the window
    (some at the rails, where the fold clamps), carry cells spread over
    their whole window."""
    rng = np.random.default_rng(seed)
    ref = np.full(shape, 0.5, np.float32)
    g = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    g.reshape(-1)[:6] = [0.0, 1.0, 0.999, 0.001, 0.5, 0.75]
    gc = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    return {"g": g, "ref": ref, "g_carry": gc,
            "w_scale": np.full(shape[:1], 1.7, np.float32)}


def _code_flips(port, ref, lsb):
    """Cells that differ, and whether each differs by at most one ADC code
    (plus float32 rounding of the values the code lands in)."""
    diff = np.abs(port - ref)
    return diff > 0, bool((diff <= lsb + ULP4).all())


def test_carry_fold_matches_reference():
    p = _carry_container(10)
    jstep = JA.make_analog_sgd_step(J_CFG, lr=LR)
    tstep = TA.make_analog_sgd_step(CFG, lr=LR)
    xcfg = crossbar_from_model(CFG)
    lsb = xcfg.w_swing / xcfg.adc.out_levels
    for quantize in (False, True):
        jt, jinc = jax_carry_fold(
            jnp.asarray(p["g_carry"]), jnp.asarray(p["g"]),
            jnp.asarray(p["ref"]), 4.0, jstep.xcfg,
            quantize=jstep._carry_readout if quantize else None)
        tt, tinc = carry_fold(
            torch.from_numpy(p["g_carry"]), torch.from_numpy(p["g"]),
            torch.from_numpy(p["ref"]), 4.0, xcfg,
            quantize=tstep._carry_readout if quantize else None)
        for port, ref in ((tt, jt), (tinc, jinc)):
            ref = np.asarray(ref)
            if quantize:
                moved, ok = _code_flips(port.numpy(), ref, lsb)
                assert ok and moved.mean() < 1e-3
            else:
                np.testing.assert_array_equal(port.numpy(), ref)
        # the closed-loop pair conserves the stack's value exactly
        np.testing.assert_array_equal((4.0 * tinc).numpy(), tt.numpy())


def test_carry_sweep_matches_reference_and_conserves():
    p = _carry_container(11)
    jstep = JA.make_analog_sgd_step(J_CFG, lr=LR)
    tstep = TA.make_analog_sgd_step(CFG, lr=LR)
    xcfg = crossbar_from_model(CFG)
    lsb = xcfg.w_swing / xcfg.adc.out_levels
    tree = {"layers": {"ffn": {"w_down": p}}, "final_ln": {
        "scale": np.ones(8, np.float32)}}
    jout = _np(jstep._carry_sweep(jax.tree.map(jnp.asarray, tree)))
    tp = params_from_numpy(tree, "cpu")
    tout = tstep._carry_sweep(tp)
    for leaf in ("g", "g_carry"):
        port = tout["layers"]["ffn"]["w_down"][leaf].numpy()
        ref = jout["layers"]["ffn"]["w_down"][leaf]
        moved, ok = _code_flips(port, ref, lsb / 4 if leaf == "g" else lsb)
        assert ok and moved.mean() < 1e-3, leaf
    assert tout["final_ln"]["scale"] is tp["final_ln"]["scale"]
    before = effective_g(tp["layers"]["ffn"]["w_down"], xcfg)
    after = effective_g(tout["layers"]["ffn"]["w_down"], xcfg)
    np.testing.assert_allclose(after.numpy(), before.numpy(), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(jax_effective_g(jout["layers"]["ffn"]["w_down"],
                                   jstep.xcfg)), before.numpy(), rtol=0,
        atol=1e-6)
    g_new = tout["layers"]["ffn"]["w_down"]["g"]
    assert float((g_new - tp["layers"]["ffn"]["w_down"]["g"]).abs().max()) \
        > 0.05


def _batch(i):
    stream = jsyn.make_token_stream(4096, CFG.vocab)
    x, y = jsyn.batch_tokens(stream, BATCH, SEQ, i)
    return x, y


def _torch_batch(i):
    x, y = _batch(i)
    return {"tokens": torch.from_numpy(x).long(),
            "labels": torch.from_numpy(y).long()}


def test_carry_schedule_and_conservation():
    """carry_period=2: step 1 writes only the carry arrays, step 2's sweep
    moves the primaries and conserves every container's effective
    conductances (replayed on the pre-sweep state) within 1e-6."""
    xcfg = crossbar_from_model(CFG)
    state = TA.init_state(0, CFG, device="cpu")
    step = TA.make_analog_sgd_step(CFG, lr=LR)
    swept = []
    sweep = step._carry_sweep

    def recorded(p):
        swept.append(p)
        return sweep(p)

    step._carry_sweep = recorded
    g0 = {n: state["params"]["layers"][b][n]["g"] for b, n in CONTAINERS}
    s1, _ = step(state, _torch_batch(0), 1)
    assert not swept
    for b, n in CONTAINERS:
        c = s1["params"]["layers"][b][n]
        assert torch.equal(c["g"], g0[n])
        assert float((c["g_carry"] - c["ref"]).abs().max()) > 0
    s2, mets = step(s1, _torch_batch(1), 2)
    assert len(swept) == 1 and torch.isfinite(mets["loss"])
    lsb = xcfg.w_swing / xcfg.adc.out_levels
    for b, n in CONTAINERS:
        pre = swept[0]["layers"][b][n]
        post = s2["params"]["layers"][b][n]
        assert float((post["g"] - g0[n]).abs().max()) > 0      # it fired
        # the carry keeps at most half an lsb of readout residual
        assert float((post["g_carry"] - post["ref"]).abs().max()) \
            <= 0.5 * lsb + 1e-6
        np.testing.assert_allclose(effective_g(post, xcfg).numpy(),
                                   effective_g(pre, xcfg).numpy(), rtol=0,
                                   atol=1e-6)
    s3, _ = step(s2, _torch_batch(2), 3)
    assert len(swept) == 1 and int(s3["step"]) == 3


# ------------------------------------------- one step with carry and pulse


@pytest.fixture(scope="module")
def reference_step():
    """One reference step with carry and pulse-train writes from
    ``init_state(PRNGKey(0))``: its ``seed_base``, the tapes its backward
    pass gave each container and the state its write made of them.  The
    backward pass is jitted and then the write runs as the reference's
    step runs it (``_update``); op by op it would take a minute."""
    from repro.core import analog_registry as jreg
    from repro.core.tiled_analog import merge_tapes, split_tapes
    state = jax.jit(lambda k: JA.init_state(k, J_CFG))(jax.random.PRNGKey(0))
    step = JA.make_analog_sgd_step(J_CFG, lr=LR)
    ks = jax.random.split(jax.random.PRNGKey(1))[1]
    seed_base = jax.random.bits(ks, (), jnp.uint32)
    x, y = _batch(0)
    batch = {"tokens": jnp.asarray(x), "labels": jnp.asarray(y)}
    n = x.size
    diff, frozen = split_tapes(
        state["params"], n, tokens_for=lambda path, shape: jreg.tape_lead(
            path, J_CFG, n, x.shape))
    (loss, _), tapes = jax.jit(jax.value_and_grad(
        lambda d: JM.loss_fn(merge_tapes(d, frozen), batch, J_CFG),
        has_aux=True))(diff)
    new = jax.jit(lambda p, t, k, s: step._update(p, t, k, s, (), []))(
        state["params"], tapes, ks, seed_base)
    writes = {("layers", b, c): _np(tapes["layers"][b][c])
              for b, c in CONTAINERS}
    return {"init": _np(state), "params": _np(new), "loss": float(loss),
            "seed_base": int(seed_base), "writes": writes}


def test_params_from_numpy_carries_a_carry_state(reference_step):
    init = reference_step["init"]
    ts = params_from_numpy(init, "cpu")
    for b, n in CONTAINERS:
        jc = init["params"]["layers"][b][n]
        tc = ts["params"]["layers"][b][n]
        assert set(tc) == set(jc) == {"g", "ref", "w_scale", "g_carry"}
        for leaf in jc:
            assert tc[leaf].dtype == torch.float32
            np.testing.assert_array_equal(tc[leaf].numpy(), jc[leaf])


def test_carry_pulse_step_matches_reference(reference_step):
    """The port's step from the reference's state: every primary
    untouched, and every container's write — fed the reference's own
    tapes — in the float class of the reference's new carry array.  The
    loss within 5e-3 of the reference's jitted one: its jitted forward
    moves ADC codes at rounding boundaries (ROADMAP.md), and
    ``test_torch_train`` holds the same forward op by op within 1e-5."""
    init = params_from_numpy(reference_step["init"], "cpu")
    step = TA.make_analog_sgd_step(CFG, lr=LR)
    seed_base = reference_step["seed_base"]
    new, mets = step(init, _torch_batch(0), seed_base)
    assert abs(float(mets["loss"]) - reference_step["loss"]) <= 5e-3
    ref_state = reference_step["params"]
    xcfg = crossbar_from_model(CFG)
    assert xcfg.update_mode == "pulse_train" and xcfg.carry
    for b, n in CONTAINERS:
        path = ("layers", b, n)
        p = init["params"]["layers"][b][n]
        assert torch.equal(new["params"]["layers"][b][n]["g"], p["g"])
        tapes = {k: torch.from_numpy(v)
                 for k, v in reference_step["writes"][path].items()}
        before = dict(U.LAUNCHES)
        out = step._update_container(p, tapes, seed_base, path, [])
        assert U.LAUNCHES == before            # the CPU runs the plain one
        want = ref_state["layers"][b][n]["g_carry"]
        got = out["g_carry"].numpy()
        scale = (np.float32(-LR) * p["w_scale"].numpy()) * np.float32(4.0)
        ops = (p["g_carry"].numpy(), tapes["x_tape"].numpy(),
               tapes["d_tape"].numpy(), scale.astype(np.float32))
        seed = TA.container_seed(seed_base, path)
        z = U.field_normals(seed, p["g"].shape, xcfg).numpy()
        pulse_float_class(got, want, ops, xcfg, z)
        assert np.abs(got - ops[0]).max() > 1e-3


# --------------------------------------------------- the numeric baseline


def test_numeric_train_step_matches_reference():
    """One ``make_train_step(sgd(lr))`` step of the digital model, from the
    analog init read back out (as the nonideality study starts it)."""
    dig_j, dig_t = J_CFG.digital(), CFG.digital()
    params = JM.readout_digital(JM.init_params(jax.random.PRNGKey(0),
                                               J_CFG), J_CFG)
    opt_j = JO.sgd(LR)
    state_j = {"params": params, "opt": opt_j.init(params),
               "step": jnp.zeros((), jnp.int32), "err_fb": ()}
    state_t = params_from_numpy(_np(state_j), "cpu")
    assert state_t["opt"] == () and state_t["err_fb"] == ()
    x, y = _batch(0)
    new_j, mets_j = jax.jit(JL.make_train_step(dig_j, opt_j))(
        state_j, {"tokens": jnp.asarray(x), "labels": jnp.asarray(y)})
    new_t, mets_t = TL.make_train_step(dig_t, TO.sgd(LR))(
        state_t, _torch_batch(0))
    for k in ("loss", "grad_norm"):
        want = float(mets_j[k])
        assert abs(float(mets_t[k]) - want) <= 1e-5 * abs(want) + 1e-6, k
    assert float(mets_t["grad_norm"]) > 1.0     # the clip was active
    assert int(new_t["step"]) == 1
    ref = dict(jax.tree_util.tree_flatten_with_path(_np(new_j["params"]))[0])
    n = 0
    for path, want in ref.items():
        leaf = new_t["params"]
        for k in path:
            leaf = leaf[k.key]
        np.testing.assert_allclose(leaf.numpy(), want, rtol=1e-5,
                                   atol=1e-6)
        n += 1
    assert n == len(TO.tree_leaves(new_t["params"]))


def test_optimizers_and_clip_match_reference():
    """SGD with momentum and AdamW, two updates each, and the global-norm
    clip, on the same numpy tree."""
    rng = np.random.default_rng(12)
    tree = {"a": rng.standard_normal((5, 3)).astype(np.float32),
            "b": {"c": rng.standard_normal(4).astype(np.float32)}}
    grads = [jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(
        np.float32), tree) for _ in range(2)]
    for make in (lambda m: m.sgd(0.1, momentum=0.9),
                 lambda m: m.adamw(1e-2, weight_decay=0.1)):
        jo, to = make(JO), make(TO)
        jp, tp = jax.tree.map(jnp.asarray, tree), params_from_numpy(tree,
                                                                    "cpu")
        js, ts = jo.init(jp), to.init(tp)
        for gr in grads:
            jp, js = jo.update(jax.tree.map(jnp.asarray, gr), js, jp)
            tp, ts = to.update(params_from_numpy(gr, "cpu"), ts, tp)
        for want, got in zip(jax.tree.leaves(_np(jp)), TO.tree_leaves(tp)):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-7)
    jc, jn = JO.clip_by_global_norm(jax.tree.map(jnp.asarray, grads[0]), 1.0)
    tc, tn = TO.clip_by_global_norm(params_from_numpy(grads[0], "cpu"), 1.0)
    assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
    for want, got in zip(jax.tree.leaves(_np(jc)), TO.tree_leaves(tc)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_train_loop_init_eval_and_unported_compression():
    opt = TO.sgd(LR, momentum=0.9)
    state = TL.init_state(0, CFG.digital(), opt, device="cpu")
    assert set(state) == {"params", "opt", "step", "err_fb"}
    assert TO.tree_leaves(state["opt"])[0].abs().max() == 0
    mets = TL.make_eval_step(CFG.digital())(state["params"],
                                            _torch_batch(0))
    assert torch.isfinite(mets["loss"]) and not mets["loss"].requires_grad
    # int8 compression (ported since the multi-device slice; the name is
    # kept): the step starts its error feedback from zeros and carries
    # the residual, one leaf per parameter
    step = TL.make_train_step(CFG.digital(), opt, grad_compress=True)
    new, mets = step(state, _torch_batch(0))
    assert torch.isfinite(mets["loss"])
    fb = TO.tree_leaves(new["err_fb"])
    assert len(fb) == len(TO.tree_leaves(state["params"]))
    assert any(float(e.abs().max()) > 0 for e in fb)
