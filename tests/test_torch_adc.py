"""The port's DAC / integrator / ADC (``repro_torch.core.adc``) against
``repro.core.adc`` on the same numpy inputs.

Fixed range: bit-equal (the bound is one float32 constant, and every
step is a single IEEE operation).  Dynamic range: the rms is a float
reduction summed in another order, so a few ulp (rtol 1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adc as jadc
from repro_torch.core import adc as tadc

CASES = [dict(in_bits=8, out_bits=8, range_mode="fixed", sat_frac=0.03125),
         dict(in_bits=8, out_bits=8, range_mode="fixed", sat_frac=0.03),
         dict(in_bits=4, out_bits=6, range_mode="fixed", sat_frac=0.1),
         dict(in_bits=8, out_bits=8, range_mode="dynamic", sat_sigmas=4.0),
         dict(in_bits=14, out_bits=14, range_mode="dynamic",
              sat_sigmas=8.0)]


def _pair(kw):
    return jadc.AdcConfig(**kw), tadc.AdcConfig(**kw)


@pytest.mark.parametrize("kw", CASES)
def test_quantize_input_bitwise(kw):
    jcfg, tcfg = _pair(kw)
    x = np.random.default_rng(0).standard_normal((7, 33)).astype(np.float32)
    xj, sj = jadc.quantize_input(jnp.asarray(x), jcfg)
    xt, st = tadc.quantize_input(torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    assert st.item() == float(sj)


def test_quantize_input_rounds_half_to_even():
    cfg = tadc.AdcConfig(in_bits=8)
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 127.0])
    xi, _ = tadc.quantize_input(x, cfg, scale=torch.tensor(1.0))
    assert xi.tolist() == [0.0, 2.0, 2.0, -0.0, -2.0, 127.0]


@pytest.mark.parametrize("kw", CASES)
def test_saturation_and_adc(kw):
    jcfg, tcfg = _pair(kw)
    rng = np.random.default_rng(1)
    q = (40.0 * rng.standard_normal((4, 3, 2, 16))).astype(np.float32)
    q[0, 0, 0, :5] = 0.0  # zero charges are left out of the dynamic rms
    qj, satj = jadc.integrator_saturation(jnp.asarray(q), jcfg, n_rows=16,
                                          reduce_axes=(0, 3))
    qt, satt = tadc.integrator_saturation(torch.from_numpy(q), tcfg,
                                          n_rows=16, reduce_axes=(0, 3))
    yj = np.asarray(jadc.adc_quantize(qj, satj, jcfg))
    yt = tadc.adc_quantize(qt, satt, tcfg).numpy()
    if kw["range_mode"] == "fixed":
        np.testing.assert_array_equal(satt.numpy(), np.asarray(satj))
        np.testing.assert_array_equal(yt, yj)
    else:
        np.testing.assert_allclose(satt.numpy(), np.asarray(satj),
                                   rtol=1e-6)
        np.testing.assert_allclose(yt, yj, rtol=1e-6, atol=1e-6)


def test_fixed_saturation_is_one_float32_rounding():
    cfg = tadc.AdcConfig(range_mode="fixed", sat_frac=0.03)
    expect = np.float32(0.03 * (127 * 64 * 1.0))
    assert tadc.fixed_saturation(cfg, 64, 1.0) == float(expect)


def test_quantize_dequantize_matches():
    jcfg, tcfg = _pair(CASES[0])
    x = np.random.default_rng(2).standard_normal((5, 9)).astype(np.float32)
    np.testing.assert_array_equal(
        tadc.quantize_dequantize(torch.from_numpy(x), tcfg).numpy(),
        np.asarray(jadc.quantize_dequantize(jnp.asarray(x), jcfg)))


def test_stochastic_rounding_is_not_ported():
    """The flag as the reference runs it (the name is the refusal this
    test held before the port took the flag): without a field the
    quantiser rounds half to even, bit-equal to the reference's call
    without a key; with ``u`` drawn as the reference's keyed call draws
    it (``jax.random.uniform(key, shape)``), bit-equal to that call."""
    kw = dict(in_bits=6, stochastic_round=True)
    jcfg, tcfg = _pair(kw)
    x = np.random.default_rng(3).standard_normal((6, 21)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    xj, _ = jadc.quantize_input(jnp.asarray(x), jcfg)
    xt, _ = tadc.quantize_input(torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(
        xt.numpy(), tadc.quantize_input(torch.from_numpy(x),
                                        _pair({"in_bits": 6})[1])[0].numpy())
    u = np.array(jax.random.uniform(key, x.shape, dtype=jnp.float32))
    xj, sj = jadc.quantize_input(jnp.asarray(x), jcfg, key=key)
    xt, st = tadc.quantize_input(torch.from_numpy(x), tcfg,
                                 u=torch.from_numpy(u))
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    assert st.item() == float(sj)
    assert not np.array_equal(xt.numpy(), np.asarray(
        jadc.quantize_input(jnp.asarray(x), jcfg)[0]))   # u was used
