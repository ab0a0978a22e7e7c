"""The port's device models (``repro_torch.core.device``) against
``repro.core.device``: the cases of ``tests/test_device.py`` and
``tests/test_device_properties.py`` with both packages fed the same
inputs, and ``kind="lut"`` through the three writes.

Parity classes:

  * an ideal device, or a linear one (``nu`` 0) without noise — bit-equal:
    every step is one IEEE operation in the same order;
  * the TaOx slope (``exp``, the noise's multiply-add that XLA fuses) —
    within 4 float32 ulp of conductances in [0, 1] (``ULP4``), as
    ``tests/test_torch_xbar_update.py`` holds it; where a small ``nu``
    makes the slope cancel, ``ULP4`` plus 1e-5 of the request at the
    slope's largest value (``_rail_bound``);
  * ``kind="lut"`` — bit-equal to ``kind="taox"`` in each package (both
    take the analytic TaOx slope), so within ``ULP4`` of the reference;
  * ``LutDevice.apply_update`` on the same tables — bit-equal (the
    interpolation's fused multiply-add emulated in float64);
  * ``lut_from_analytic``'s tables — within 4 float32 ulp of the table's
    largest entry (the ``exp`` of two libms, one ulp apart, ahead of a
    cancellation near the rail); ``lut_from_pulse_train`` — bit-equal
    (numpy in float64 on both sides);
  * ``VoltageModel`` — within 4 ulp (``delta_g``: ``exp`` then ``- 1``)
    and 1 ulp (``voltage_for``: ``log1p``).

The reference draws its write noise from a key; the port takes the same
field (``jax.random.normal(key, shape)``) as input.
"""
import dataclasses

import pytest

pytest.importorskip("hypothesis")

import hypothesis.strategies as st  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis.extra import numpy as hnp  # noqa: E402

from repro.core import CrossbarConfig as JXbar  # noqa: E402
from repro.core import device as jd  # noqa: E402
from repro.core import endurance as je  # noqa: E402
from repro.kernels import xbar_update as JU  # noqa: E402
from repro_torch.core import CrossbarConfig  # noqa: E402
from repro_torch.core import device as td  # noqa: E402
from repro_torch.core import endurance as te  # noqa: E402
from repro_torch.kernels import xbar_update as U  # noqa: E402

KEY = jax.random.PRNGKey(0)
ULP4 = 4 * 2.0 ** -24


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _normal(key, shape):
    return np.array(jax.random.normal(key, shape, dtype=jnp.float32))


def _both(kw):
    return jd.DeviceConfig(**kw), td.DeviceConfig(**kw)


def _rail_bound(mag, nu):
    """The TaOx class where the slope's cancellation shows: ``ULP4`` plus
    1e-5 of the rails' request at the slope's largest value.  At a small
    ``nu`` the factor ``(exp(-nu x) - e^-nu) / (1 - e^-nu)`` divides an
    ulp of ``exp`` by ``1 - e^-nu`` (0.095 at ``nu`` 0.1)."""
    f0 = float(td.set_factor(torch.zeros(()), nu))
    return ULP4 + 1e-5 * f0 * mag


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


def test_ideal_update_exact_inside_window():
    g, dg = [0.2, 0.5, 0.8], [0.1, -0.2, 0.05]
    ref = np.asarray(jd.apply_update(jnp.asarray(g), jnp.asarray(dg),
                                     jd.IDEAL))
    port = td.apply_update(_t(g), _t(dg), td.IDEAL).numpy()
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_allclose(port, np.add(g, dg), rtol=1e-6)


def test_update_clips_to_window():
    port = td.apply_update(_t([0.05, 0.95]), _t([-0.5, 0.5]),
                           td.IDEAL).numpy()
    np.testing.assert_array_equal(port, [0.0, 1.0])


_G8 = hnp.arrays(np.float32, (8,), elements=st.floats(0, 1, width=32))


@settings(deadline=None, max_examples=50)
@given(g=_G8, dg=hnp.arrays(np.float32, (8,),
                            elements=st.floats(-2, 2, width=32)),
       nu=st.floats(0.1, 10.0), noise=st.floats(0.0, 2.0))
def test_aggregate_update_stays_in_window(g, dg, nu, noise):
    """In the window, no NaN, and within the TaOx class of the reference's
    write with the reference's field (:func:`_rail_bound`)."""
    jc, tc = _both(dict(kind="taox", nu_set=nu, nu_reset=nu,
                        write_noise=noise))
    ref = np.asarray(jd.apply_update(jnp.asarray(g), jnp.asarray(dg), jc,
                                     key=KEY))
    port = td.apply_update(_t(g), _t(dg), tc,
                           _t(_normal(KEY, g.shape))).numpy()
    assert np.all((port >= 0.0) & (port <= 1.0)) and not np.isnan(port).any()
    assert np.all(np.abs(port - ref) <= _rail_bound(np.abs(dg), nu))


@settings(deadline=None, max_examples=50)
@given(g=_G8, s=_G8, r=_G8, nu=st.floats(0.1, 10.0),
       noise=st.floats(0.0, 2.0))
def test_pulse_train_stays_in_window(g, s, r, nu, noise):
    jc, tc = _both(dict(kind="taox", nu_set=nu, nu_reset=nu,
                        write_noise=noise))
    ref = np.asarray(jd.apply_pulse_train(jnp.asarray(g), jnp.asarray(s),
                                          jnp.asarray(r), jc, key=KEY))
    port = td.apply_pulse_train(_t(g), _t(s), _t(r), tc,
                                _t(_normal(KEY, g.shape))).numpy()
    assert np.all((port >= 0.0) & (port <= 1.0)) and not np.isnan(port).any()
    assert np.all(np.abs(port - ref) <= _rail_bound(s + r, nu))


def test_set_factor_shape_and_mirror():
    x = np.linspace(0, 1, 101).astype(np.float32)
    f = td.set_factor(_t(x), 5.0).numpy()
    ref = np.asarray(jd.set_factor(jnp.asarray(x), 5.0))
    np.testing.assert_allclose(f, ref, rtol=0, atol=4 * 2.0 ** -24 * 16)
    np.testing.assert_allclose(f[50], 1.0, atol=1e-5)
    np.testing.assert_allclose(f[-1], 0.0, atol=1e-6)
    assert np.all(np.diff(f) < 0) and f[0] > 5.0
    x = np.linspace(0, 1, 11).astype(np.float32)
    np.testing.assert_allclose(td.reset_factor(_t(x), 3.0).numpy(),
                               td.set_factor(_t(1 - x), 3.0).numpy(),
                               rtol=1e-6)


def test_nonlinearity_attenuates_near_rails():
    cfg = td.DeviceConfig(kind="taox", write_noise=0.0)
    g = _t([0.9])
    up = td.apply_update(g, _t([0.01]), cfg) - g
    dn = g - td.apply_update(g, _t([-0.01]), cfg)
    assert float(dn[0]) > 5 * float(up[0])


def test_stochasticity_reproducible_and_zero_mean():
    """The same field gives the same write, another field another; the
    mean change matches the request; the reference's write with the key
    the field came from agrees (a linearized device: bit-equal but for
    the noise's fused multiply-add, within ``ULP4``)."""
    jc, tc = _both(dict(kind="linearized", write_noise=1.0))
    g, dg = np.full((2000,), 0.5, np.float32), np.full((2000,), 0.02,
                                                        np.float32)
    z0 = _t(_normal(KEY, g.shape))
    a = td.apply_update(_t(g), _t(dg), tc, z0)
    assert torch.equal(a, td.apply_update(_t(g), _t(dg), tc, z0.clone()))
    c = td.apply_update(_t(g), _t(dg), tc,
                        _t(_normal(jax.random.PRNGKey(1), g.shape)))
    assert float((a - c).abs().max()) > 0.0
    np.testing.assert_allclose(float((a - _t(g)).mean()), 0.02, atol=2e-3)
    ref = np.asarray(jd.apply_update(jnp.asarray(g), jnp.asarray(dg), jc,
                                     key=KEY))
    np.testing.assert_allclose(a.numpy(), ref, rtol=0, atol=ULP4)


def test_noisy_write_without_a_field_raises():
    with pytest.raises(ValueError, match="noise"):
        td.apply_update(_t([0.5]), _t([0.01]), td.TAOX)
    with pytest.raises(ValueError, match="noise"):
        td.apply_pulse_train(_t([0.5]), _t([0.01]), _t([0.0]), td.TAOX)


@settings(deadline=None, max_examples=50)
@given(gain_set=st.floats(0.2, 3.0), gain_reset=st.floats(0.2, 3.0),
       nu=st.floats(0.5, 8.0))
def test_gain_asymmetry_documented_sign(gain_set, gain_reset, nu):
    jc, tc = _both(dict(kind="taox", nu_set=nu, nu_reset=nu,
                        gain_set=gain_set, gain_reset=gain_reset,
                        write_noise=0.0))
    d = np.asarray([0.01, -0.01], np.float32)
    g = np.full((2,), 0.5, np.float32)
    port = td.apply_update(_t(g), _t(d), tc).numpy()
    ref = np.asarray(jd.apply_update(jnp.asarray(g), jnp.asarray(d), jc))
    np.testing.assert_allclose(port, ref, rtol=0, atol=ULP4)
    assert port[0] - 0.5 == pytest.approx(gain_set * 0.01, rel=1e-4)
    assert 0.5 - port[1] == pytest.approx(gain_reset * 0.01, rel=1e-4)


@settings(deadline=None, max_examples=50)
@given(gain_set=st.floats(0.2, 3.0), gain_reset=st.floats(0.2, 3.0))
def test_pulse_train_rails_use_their_own_gain(gain_set, gain_reset):
    jc, tc = _both(dict(kind="taox", nu_set=3.0, nu_reset=3.0,
                        gain_set=gain_set, gain_reset=gain_reset,
                        write_noise=0.0))
    g = np.full((2,), 0.5, np.float32)
    mag = 8 * tc.pulse_dg
    s, r = np.asarray([mag, 0.0], np.float32), np.asarray([0.0, mag],
                                                         np.float32)
    port = td.apply_pulse_train(_t(g), _t(s), _t(r), tc).numpy()
    ref = np.asarray(jd.apply_pulse_train(jnp.asarray(g), jnp.asarray(s),
                                          jnp.asarray(r), jc))
    np.testing.assert_allclose(port, ref, rtol=0, atol=ULP4)
    assert port[0] - 0.5 == pytest.approx(mag * gain_set, rel=1e-4)
    assert 0.5 - port[1] == pytest.approx(mag * gain_reset, rel=1e-4)


@settings(deadline=None, max_examples=50)
@given(dg=st.floats(1e-3, 0.5), k=st.floats(1.5, 16.0),
       w=st.floats(0.01, 2.0))
def test_write_noise_sigma_random_walk_law(dg, k, w):
    """sigma grows as sqrt(|dg|); within 2 ulp of the reference's (one
    product, a division by a power of two and a sqrt, which XLA's CPU
    code may take through its own approximation)."""
    jc, tc = _both(dict(write_noise=w))
    x = np.asarray([dg, dg * k], np.float32)
    s = td.write_noise_sigma(_t(x), tc).numpy()
    assert _ulps(s, np.asarray(jd.write_noise_sigma(jnp.asarray(x), jc))) \
        <= 2
    assert s[1] > s[0] > 0.0
    assert s[1] / s[0] == pytest.approx(np.sqrt(k), rel=1e-3)


@settings(deadline=None, max_examples=100)
@given(s=st.floats(0.0, 0.5), r=st.floats(0.0, 0.5))
def test_pulse_counts_quantise_within_one_event(s, r):
    """Integer event counts, bit-equal to the reference's; the net
    request lands within one ``pulse_dg``."""
    n_s, n_r = td.pulse_train_counts(_t(s), _t(r), td.TAOX)
    j_s, j_r = jd.pulse_train_counts(jnp.float32(s), jnp.float32(r),
                                     jd.TAOX)
    assert (float(n_s), float(n_r)) == (float(j_s), float(j_r))
    assert float(n_s) == round(float(n_s))
    net = td.TAOX.pulse_dg * (float(n_s) - float(n_r))
    assert abs(net - (s - r)) <= td.TAOX.pulse_dg + 1e-6


@settings(deadline=None, max_examples=25)
@given(a0=st.floats(0.0, 1e6), span=st.floats(1.0, 1e7),
       frac=st.floats(0.0, 1.0), nu=st.floats(1e-3, 0.5))
def test_drift_monotone_composable_and_matching(a0, span, frac, nu):
    """drift_factor in (0, 1], non-increasing in the end age, composable
    across a split, and within 1e-6 of the reference's (float32 pow)."""
    jspec, tspec = je.RetentionSpec(nu=nu), te.RetentionSpec(nu=nu)
    a1, a2 = a0 + frac * span, a0 + span
    f = [float(te.drift_factor(a, b, tspec))
         for a, b in ((a0, a1), (a1, a2), (a0, a2))]
    assert 0.0 < f[2] <= f[0] <= 1.0
    assert f[0] * f[1] == pytest.approx(f[2], rel=1e-5)
    assert f[2] == pytest.approx(float(je.drift_factor(a0, a2, jspec)),
                                 rel=1e-6)


def test_drift_composes_with_per_cell_exponents():
    spec = te.RetentionSpec(nu=0.05, nu_sigma=0.5, seed=123)
    nu = te.cell_nu(spec, (4, 6), salt=3)
    for frac in (0.0, 0.3, 1.0):
        a0, a2 = 100.0, 1e5
        a1 = a0 + frac * (a2 - a0)
        whole = te.drift_factor(a0, a2, spec, nu=nu).numpy()
        split = (te.drift_factor(a0, a1, spec, nu=nu)
                 * te.drift_factor(a1, a2, spec, nu=nu)).numpy()
        np.testing.assert_allclose(split, whole, rtol=1e-5)


# ----------------------------------------------------------- ΔG(V) model

def test_voltage_model_eq6():
    kw = dict(d1=4.0, d2=3.0, vmin_p=0.8, vmin_n=-0.7)
    jv, tv = jd.VoltageModel(**kw), td.VoltageModel(**kw)
    v = np.linspace(-2, 2, 201).astype(np.float32)
    dg = tv.delta_g(_t(v)).numpy()
    assert _ulps(dg, np.asarray(jv.delta_g(jnp.asarray(v)))) <= 4
    dead = (v > tv.vmin_n) & (v < tv.vmin_p)
    assert np.all(dg[dead] == 0) and np.all(np.diff(dg) >= 0)
    want = np.asarray([0.01, 0.1, 1.0, 5.0], np.float32)
    for direction, sign in ((+1, 1.0), (-1, -1.0)):
        vv = tv.voltage_for(_t(want), direction)
        assert _ulps(vv.numpy(), np.asarray(
            jv.voltage_for(jnp.asarray(want), direction))) <= 1
        np.testing.assert_allclose(tv.delta_g(vv).numpy(), sign * want,
                                   rtol=1e-4)


# ------------------------------------------------------ lookup-table device

@pytest.mark.parametrize("n_bins", [64, 256])
@pytest.mark.parametrize("kw", [dict(), dict(nu_set=3.0, nu_reset=6.0,
                                             gain_set=1.2, gain_reset=0.8),
                                dict(nu_set=0.0)])
def test_lut_from_analytic_tables(n_bins, kw):
    """The tables, dtype for dtype (float32 where the reference's exp ran
    with 64-bit JAX off, float64 for a linear side and the std): within 4
    float32 ulp of each table's largest entry."""
    ref = jd.lut_from_analytic(jd.TAOX.replace(**kw), n_bins)
    port = td.lut_from_analytic(td.TAOX.replace(**kw), n_bins)
    for f in dataclasses.fields(jd.LutDevice):
        a, b = getattr(ref, f.name), getattr(port, f.name)
        if isinstance(a, float):
            assert a == b
            continue
        assert a.dtype == b.dtype, f.name
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=ULP4 * np.abs(a).max())


def test_lut_matches_analytic():
    """The LUT applies n small pulses at the initial state; the analytic
    model one scaled step: equal to first order.  The port's LUT apply on
    the reference's tables (carried field by field) is bit-equal."""
    ref = jd.lut_from_analytic(jd.TAOX_NONOISE, n_bins=256)
    lut = td.LutDevice(**dataclasses.asdict(ref))
    g = np.linspace(0.1, 0.9, 33).astype(np.float32)
    dg = np.full_like(g, 4 * td.TAOX.pulse_dg)
    b = lut.apply_update(_t(g), _t(dg), pulse_dg=td.TAOX.pulse_dg).numpy()
    np.testing.assert_array_equal(b, np.asarray(ref.apply_update(
        jnp.asarray(g), jnp.asarray(dg), pulse_dg=td.TAOX.pulse_dg)))
    a = td.apply_update(_t(g), _t(dg), td.TAOX_NONOISE).numpy()
    np.testing.assert_allclose(a, b, atol=2e-3)


@pytest.mark.parametrize("noisy", [False, True])
def test_lut_apply_update_bit_equal(noisy):
    """Off-window states (both clamped ends), both signs, with the
    reference's field or none: bit-equal on the same tables."""
    ref = jd.lut_from_analytic(jd.TAOX, n_bins=64)
    lut = td.LutDevice(**dataclasses.asdict(ref))
    rng = np.random.default_rng(5)
    g = rng.uniform(-0.05, 1.05, (40, 30)).astype(np.float32)
    dg = (rng.standard_normal((40, 30)) * 0.02).astype(np.float32)
    key = jax.random.PRNGKey(3) if noisy else None
    want = np.asarray(ref.apply_update(jnp.asarray(g), jnp.asarray(dg),
                                       key=key))
    got = lut.apply_update(_t(g), _t(dg), noise=_t(_normal(key, g.shape))
                           if noisy else None).numpy()
    np.testing.assert_array_equal(got, want)


def test_lut_from_pulse_train_recovers_shape():
    """The paper's measurement protocol on the analytic device (the
    trace made by the reference): the port's LUT is bit-equal to the
    reference's and recovers the state-dependent mean update."""
    cfg = jd.TAOX.replace(write_noise=0.05)
    key = jax.random.PRNGKey(42)
    g = jnp.full((30,), 0.5)
    row = [g]
    for sign in (1.0, -1.0):
        for _ in range(200):
            key, k = jax.random.split(key)
            g = jd.apply_update(g, jnp.full_like(g, sign * cfg.pulse_dg),
                                cfg, key=k)
            row.append(g)
    trace = np.stack([np.asarray(r) for r in row], axis=1)
    ref = jd.lut_from_pulse_train(trace, n_bins=32)
    lut = td.lut_from_pulse_train(trace, n_bins=32)
    for f in dataclasses.fields(jd.LutDevice):
        np.testing.assert_array_equal(getattr(lut, f.name),
                                      getattr(ref, f.name))
    mid = np.argmin(np.abs(lut.centers - 0.5))
    assert lut.mean_set[mid] == pytest.approx(cfg.pulse_dg, rel=1.0)
    assert lut.mean_set[mid] > 0 and lut.mean_reset[mid] < 0
    hi = np.argmin(np.abs(lut.centers - 0.9))
    lo = np.argmin(np.abs(lut.centers - 0.6))
    assert lut.mean_set[hi] < lut.mean_set[lo]


# ------------------------------------------------------------ kind="lut"

def _writes(kind, nu=5.0, noise=0.3, seed=0):
    """The three writes of one device kind in both packages."""
    kw = dict(kind=kind, nu_set=nu, nu_reset=nu, write_noise=noise)
    jc, tc = _both(kw)
    rng = np.random.default_rng(seed)
    g = rng.uniform(0, 1, (24, 20)).astype(np.float32)
    dg = (rng.standard_normal(g.shape) * 0.01).astype(np.float32)
    s, r = (np.abs(rng.standard_normal(g.shape) * 0.02).astype(np.float32)
            for _ in range(2))
    key = jax.random.PRNGKey(7)
    z = _t(_normal(key, g.shape))
    ref = [np.asarray(jd.apply_update(jnp.asarray(g), jnp.asarray(dg), jc,
                                      key)),
           np.asarray(jd.apply_pulse_train(jnp.asarray(g), jnp.asarray(s),
                                           jnp.asarray(r), jc, key))]
    port = [td.apply_update(_t(g), _t(dg), tc, z).numpy(),
            td.apply_pulse_train(_t(g), _t(s), _t(r), tc, z).numpy()]
    return ref, port


@pytest.mark.parametrize("write", ["apply_update", "apply_pulse_train"])
def test_kind_lut_writes_as_taox(write):
    i = ("apply_update", "apply_pulse_train").index(write)
    ref_lut, port_lut = (w[i] for w in _writes("lut"))
    ref_taox, port_taox = (w[i] for w in _writes("taox"))
    np.testing.assert_array_equal(ref_lut, ref_taox)
    np.testing.assert_array_equal(port_lut, port_taox)
    np.testing.assert_allclose(port_lut, ref_lut, rtol=0, atol=ULP4)


def test_kind_lut_linear_noiseless_bit_equal():
    """A linear (``nu`` 0), noiseless ``lut`` device takes no exp and no
    fused multiply-add: bit-equal to the reference."""
    ref, port = _writes("lut", nu=0.0, noise=0.0)
    for a, b in zip(ref, port):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("mode", ["outer", "pulse_train"])
@pytest.mark.parametrize("noise_mode", ["kernel", "host"])
def test_kind_lut_through_xbar_outer_update(mode, noise_mode):
    """``kind="lut"`` through the write's plain version: bit-equal to the
    port's ``taox`` write, within ``ULP4`` of the reference's ``lut``
    write (itself bit-equal to its ``taox`` write)."""
    rng = np.random.default_rng(9)
    g = rng.uniform(0, 1, (2, 40, 37)).astype(np.float32)
    x_q = (rng.integers(-127, 128, (2, 9, 40)) * (2.6 / 127)).astype(
        np.float32)
    d_q = (rng.integers(-7, 8, (2, 9, 37)) * (0.03 / 7)).astype(np.float32)
    scale = np.asarray([-0.1, -0.15], np.float32)
    noise = rng.standard_normal(g.shape).astype(np.float32)
    seed = 0x2468ACE1
    out = {}
    for kind in ("lut", "taox"):
        dev = dict(kind=kind)
        jcfg = JXbar(rows=16, cols=16, update_mode=mode,
                     device=jd.DeviceConfig(**dev))
        tcfg = CrossbarConfig(rows=16, cols=16, update_mode=mode,
                              device=td.DeviceConfig(**dev))
        host = noise_mode == "host"
        out["ref", kind] = np.asarray(JU.xbar_outer_update(
            jnp.asarray(g), jnp.asarray(x_q), jnp.asarray(d_q),
            jnp.asarray(scale), jcfg, impl="fused", noise_mode=noise_mode,
            seed=None if host else jnp.uint32(seed),
            noise=jnp.asarray(noise) if host else None))
        out["port", kind] = U.xbar_outer_update(
            _t(g), _t(x_q), _t(d_q), _t(scale), tcfg, noise_mode=noise_mode,
            seed=None if host else seed,
            noise=_t(noise) if host else None).numpy()
    np.testing.assert_array_equal(out["ref", "lut"], out["ref", "taox"])
    np.testing.assert_array_equal(out["port", "lut"], out["port", "taox"])
    np.testing.assert_allclose(out["port", "lut"], out["ref", "lut"],
                               rtol=0, atol=ULP4)
    assert np.abs(out["port", "lut"] - g).max() > 1e-3    # the write moved


def test_kind_lut_kernel_constants_are_taox():
    """The card's constants for ``lut`` are the TaOx ones, field for
    field (the kernel takes its slope from them)."""
    for nu in ((5.0, 5.0), (3.0, 6.0)):
        a = U.device_params(td.TAOX.replace(kind="lut", nu_set=nu[0],
                                            nu_reset=nu[1]), "kernel")
        b = U.device_params(td.TAOX.replace(nu_set=nu[0], nu_reset=nu[1]),
                            "kernel")
        assert [getattr(a, f) for f in U._PARAM_FIELDS] \
            == [getattr(b, f) for f in U._PARAM_FIELDS]
