"""The port's kernel oracles (``repro_torch.kernels.ref``) against the
JAX package's (``repro.kernels.ref``) on the same numpy inputs, and the
bit-plane temporal-coding oracle against the integer product and the
port's plain read.

Parity classes: the reads are bit-equal at a fixed ADC range with a
power-of-two lsb (every ADC output and partial sum exact) and within
1e-5 at a dynamic range (the per-tile range is a float sum in another
order); the bit-plane oracle is bit-equal on integer drive levels and
conductances on a 1/8 grid (every partial sum exact); the write through
the device model, fed the same N(0, 1) field, within 4 float32 ulp of
the conductance window's top (1.0) per cell.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import AdcConfig as JAdc
from repro.core import CrossbarConfig as JXbar
from repro.core import IDEAL as J_IDEAL
from repro.core import TAOX as J_TAOX
from repro.core.adc import quantize_input as j_quantize_input
from repro.kernels import ref as JREF
from repro_torch.core import IDEAL, TAOX, AdcConfig, CrossbarConfig
from repro_torch.core.adc import quantize_input
from repro_torch.kernels import ref as REF
from repro_torch.kernels import xbar_vmm as K

POW2_ADC = dict(in_bits=8, out_bits=8, range_mode="fixed", sat_frac=0.03125)
ULP1 = float(np.spacing(np.float32(1.0)))


def _cfgs(adc, tile=16, jdev=J_IDEAL, dev=IDEAL):
    return (JXbar(rows=tile, cols=tile, device=jdev, adc=JAdc(**adc)),
            CrossbarConfig(rows=tile, cols=tile, device=dev,
                           adc=AdcConfig(**adc)))


@pytest.mark.parametrize("adc", [POW2_ADC, dict(in_bits=8, out_bits=8)],
                         ids=["pow2", "dynamic"])
@pytest.mark.parametrize("kp,np_,b", [(32, 48, 4), (64, 32, 6)])
def test_vmm_mvm_ref_match_reference(adc, kp, np_, b):
    jcfg, tcfg = _cfgs(adc)
    rng = np.random.default_rng(kp + b)
    diff = (rng.standard_normal((kp, np_)) * 0.1).astype(np.float32)
    if adc is POW2_ADC:   # conductances on the device's pulse grid
        diff = np.round(diff * 256) / 256
    for transpose, jf, tf in ((False, JREF.vmm_ref, REF.vmm_ref),
                              (True, JREF.mvm_ref, REF.mvm_ref)):
        x = rng.integers(-127, 128, (b, np_ if transpose else kp)) \
            .astype(np.float32)
        want = np.asarray(jf(jnp.asarray(x), jnp.asarray(diff), jcfg))
        got = tf(torch.from_numpy(x), torch.from_numpy(diff), tcfg).numpy()
        assert got.shape == want.shape
        if adc is POW2_ADC:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("device", ["ideal", "taox"])
def test_outer_update_ref_matches_reference(device):
    jdev, dev = (J_IDEAL, IDEAL) if device == "ideal" else (J_TAOX, TAOX)
    jcfg, tcfg = _cfgs(dict(in_bits=8, out_bits=8), jdev=jdev, dev=dev)
    rng = np.random.default_rng(3)
    k, n, b = 40, 24, 8
    g = rng.uniform(0.1, 0.9, (k, n)).astype(np.float32)
    xq = np.round(rng.standard_normal((b, k)) * 20).astype(np.float32) / 64
    dq = np.round(rng.standard_normal((b, n)) * 20).astype(np.float32) / 64
    noise = rng.standard_normal((k, n)).astype(np.float32)
    scale = np.float32(-0.01)
    want = np.asarray(JREF.outer_update_ref(
        jnp.asarray(g), jnp.asarray(xq), jnp.asarray(dq), scale, jcfg,
        noise=jnp.asarray(noise)))
    got = REF.outer_update_ref(torch.from_numpy(g), torch.from_numpy(xq),
                               torch.from_numpy(dq), float(scale), tcfg,
                               noise=torch.from_numpy(noise)).numpy()
    assert not np.array_equal(got, g)          # the write moved cells
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * ULP1)


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_bitplanes_match_reference_and_integer_product(bits):
    """As ``tests/test_kernels.py``'s oracle test: drive levels from the
    DAC, normal conductances; then bit for bit on a 1/8 grid."""
    rng = np.random.default_rng(12 + bits)
    jcfg, tcfg = _cfgs(dict(in_bits=bits))
    x = rng.standard_normal((4, 32)).astype(np.float32)
    diff = (rng.standard_normal((32, 24)) * 0.1).astype(np.float32)
    x_int = quantize_input(torch.from_numpy(x), tcfg.adc)[0]
    jx_int = np.asarray(j_quantize_input(jnp.asarray(x), jcfg.adc)[0])
    np.testing.assert_array_equal(x_int.numpy(), jx_int)
    q = REF.vmm_bitplanes(x_int, torch.from_numpy(diff), tcfg)
    np.testing.assert_allclose(q.numpy(), (x_int @ torch.from_numpy(diff))
                               .numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        q.numpy(), np.asarray(JREF.vmm_bitplanes(
            jnp.asarray(jx_int), jnp.asarray(diff), jcfg)),
        rtol=1e-6, atol=1e-6)
    grid = (rng.integers(-4, 5, (32, 24)) / 8).astype(np.float32)
    q = REF.vmm_bitplanes(x_int, torch.from_numpy(grid), tcfg)
    np.testing.assert_array_equal(
        q.numpy(), (x_int.double() @ torch.from_numpy(grid).double())
        .float().numpy())
    np.testing.assert_array_equal(q.numpy(), np.asarray(
        JREF.vmm_bitplanes(jnp.asarray(jx_int), jnp.asarray(grid), jcfg)))


def _phase25_cfg(bits):
    """``chip_smoke.py`` phase 25(a)'s read: 64x64 tiles, an ideal device,
    a 16-bit ADC at a fixed range whose lsb is 1/8."""
    adc = AdcConfig(in_bits=bits, out_bits=16, range_mode="fixed")
    return CrossbarConfig(rows=64, cols=64, device=IDEAL, adc=AdcConfig(
        in_bits=bits, out_bits=16, range_mode="fixed",
        sat_frac=0.125 * adc.out_levels / (adc.in_levels * 64 * IDEAL.gmax)))


@pytest.mark.parametrize("bits", [2, 4, 8, 9])
@pytest.mark.parametrize("transpose", [False, True], ids=["vmm", "mvm"])
def test_plain_read_at_fixed_16bit_range_equals_bitplanes(bits, transpose):
    """The port's plain read (the kernels' plain version) on phase 25(a)'s
    operands, at a ragged and a container shape: bit-equal to the
    bit-plane oracle, as the kernels must be on the card."""
    cfg = _phase25_cfg(bits)
    lsb = np.float32(cfg.adc.sat_frac * cfg.adc.in_levels * 64) \
        / np.float32(cfg.adc.out_levels)
    assert lsb == np.float32(0.125)
    lv = cfg.adc.in_levels
    gen = torch.Generator().manual_seed(bits)
    for k, n in ((200, 72), (768, 192)):
        x = torch.randint(-lv, lv + 1, (1, 3, n if transpose else k),
                          generator=gen).float()
        x[0, 0, 0] = lv
        g = 0.5 + torch.randint(-4, 5, (1, k, n), generator=gen).float() / 8
        ref = torch.full_like(g, 0.5)
        sc = K.read_scales(x, torch.ones(1), lv)
        assert torch.equal(sc, torch.ones_like(sc))
        y = K._read_plain(x, g, ref, sc, cfg, transpose)
        diff = (g - ref)[0]
        oracle = REF.vmm_bitplanes(x[0], diff.T if transpose else diff, cfg)
        assert torch.equal(y[0], oracle)
