"""The port's fused reads — forward (VMM) and transpose (MVM) — (plain
version and dispatch) against the JAX package's read chain and its
interpret-mode Pallas kernels.

Parity classes (the reference's contract, ``repro/kernels/xbar_vmm.py``):

  * fixed ADC range with a power-of-two lsb — bit-equal: every ADC output
    is an exact multiple of a power of two and every partial sum is exact;
  * dynamic range — the per-tile range is a float reduction summed in a
    different order, so ``rtol = atol = 1e-5`` (as the reference's own
    interpret-vs-chain test, ``tests/test_read_fusion.py``).

The inputs are made with numpy from a seed and handed to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import AdcConfig as JAdc
from repro.core import CrossbarConfig as JXbar
from repro.core import IDEAL as J_IDEAL
from repro.core.xbar_ops import mvm as jax_mvm
from repro.core.xbar_ops import vmm as jax_vmm
from repro_torch.core import IDEAL, AdcConfig, CrossbarConfig
from repro_torch.core.xbar_ops import mvm as torch_mvm
from repro_torch.core.xbar_ops import vmm as torch_vmm
from repro_torch.kernels import xbar_vmm as K

POW2_ADC = dict(in_bits=8, out_bits=8, range_mode="fixed", sat_frac=0.03125)
SHAPES = [(16, 16, 4), (40, 24, 6), (64, 48, 8)]


def _operands(k, n, b, lead=(), seed=0):
    """Conductances programmed from normal weights (window [0, 1], ref at
    the midpoint) and normal activations, as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((*lead, k, n)) / np.sqrt(k)
    w_max = np.abs(w).max(axis=(-2, -1), keepdims=True)
    g = (0.5 + w * (0.5 / w_max)).astype(np.float32)
    ref = np.full(g.shape, 0.5, np.float32)
    ws = np.asarray(0.5 / w_max[..., 0, 0], np.float32)
    x = rng.standard_normal((*lead, b, k)).astype(np.float32)
    return x, g, ref, ws


def _configs(adc, tile=16):
    return (JXbar(rows=tile, cols=tile, device=J_IDEAL, adc=JAdc(**adc)),
            CrossbarConfig(rows=tile, cols=tile, device=IDEAL,
                           adc=AdcConfig(**adc)))


def _both(x, g, ref, ws, adc, jimpl, tile=16):
    jcfg, tcfg = _configs(adc, tile)
    y_jax = np.asarray(jax_vmm(jnp.asarray(x), jnp.asarray(g),
                               jnp.asarray(ref), jnp.asarray(ws), jcfg,
                               impl=jimpl))
    y_port = torch_vmm(torch.from_numpy(x), torch.from_numpy(g),
                       torch.from_numpy(ref), torch.from_numpy(ws), tcfg,
                       impl="eager").numpy()
    return y_jax, y_port


@pytest.mark.parametrize("jimpl", ["chain", "interpret"])
@pytest.mark.parametrize("k,n,b", SHAPES)
def test_plain_read_bitwise_fixed_pow2(jimpl, k, n, b):
    y_jax, y_port = _both(*_operands(k, n, b), POW2_ADC, jimpl)
    np.testing.assert_array_equal(y_port, y_jax)


@pytest.mark.parametrize("jimpl", ["chain", "interpret"])
@pytest.mark.parametrize("k,n,b", SHAPES)
def test_plain_read_dynamic_close(jimpl, k, n, b):
    y_jax, y_port = _both(*_operands(k, n, b, seed=1),
                          {"range_mode": "dynamic"}, jimpl)
    np.testing.assert_allclose(y_port, y_jax, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("range_mode", ["fixed", "dynamic"])
def test_plain_read_lead_dims(range_mode):
    """A scan-stacked (L, K, N) container: one DAC scale per matrix."""
    adc = POW2_ADC if range_mode == "fixed" else {"range_mode": "dynamic"}
    y_jax, y_port = _both(*_operands(40, 24, 5, lead=(3,), seed=2), adc,
                          "chain")
    assert y_port.shape == (3, 5, 24)
    if range_mode == "fixed":
        np.testing.assert_array_equal(y_port, y_jax)
    else:
        np.testing.assert_allclose(y_port, y_jax, rtol=1e-5, atol=1e-5)


def test_port_chain_equals_plain_read():
    """The port's own oracle (``impl="chain"``) and the kernel's plain
    version compute the same function."""
    x, g, ref, ws = (torch.from_numpy(a) for a in _operands(40, 24, 6))
    _, tcfg = _configs({"range_mode": "dynamic"})
    y_chain = torch_vmm(x, g, ref, ws, tcfg, impl="chain")
    y_plain = torch_vmm(x, g, ref, ws, tcfg, impl="eager")
    torch.testing.assert_close(y_plain, y_chain, rtol=1e-6, atol=1e-6)


def test_dispatch_cpu_tensor_takes_plain_version():
    x, g, ref, ws = (torch.from_numpy(a) for a in _operands(16, 16, 4))
    _, tcfg = _configs(POW2_ADC)
    before = dict(K.LAUNCHES)
    y_auto = K.xbar_fused_read(x, g, ref, ws, tcfg)
    y_eager = K.xbar_fused_read(x, g, ref, ws, tcfg, impl="eager")
    torch.testing.assert_close(y_auto, y_eager, rtol=0, atol=0)
    assert K.LAUNCHES == before


def test_cuda_impl_on_cpu_tensor_raises():
    """No fallback: asking for the kernel without CUDA tensors raises."""
    x, g, ref, ws = (torch.from_numpy(a) for a in _operands(16, 16, 4))
    _, tcfg = _configs(POW2_ADC)
    with pytest.raises(ValueError, match="CUDA"):
        K.xbar_fused_read(x, g, ref, ws, tcfg, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        K.xbar_fused_read(x, g, ref, ws, tcfg, impl="pallas")


def test_kernel_operand_checks_reject_cpu_tensors():
    x, g, ref, _ = (torch.from_numpy(a) for a in _operands(16, 16, 4))
    sc = torch.ones((1, 2))
    with pytest.raises(ValueError, match="CUDA"):
        K._read_cuda(x[None], g[None], ref[None], sc,
                     _configs(POW2_ADC)[1])


def test_kernel_source_is_built_for_hopper():
    """The build line targets sm_90a and keeps IEEE division and sqrt."""
    from repro_torch.kernels import _nvcc
    assert "arch=compute_90a,code=sm_90a" in _nvcc.NVCC_FLAGS
    assert "--use_fast_math" not in _nvcc.NVCC_FLAGS
    assert K.SOURCE.exists()
    src = K.SOURCE.read_text()
    assert "_fused_vmm_kernel" in src and "__fdiv_rn" in src


@pytest.mark.parametrize("adc", [POW2_ADC, {"range_mode": "dynamic"}],
                         ids=["fixed_pow2", "dynamic"])
def test_carry_container_read_matches_reference(adc):
    """A container with a periodic-carry array reads ``g + (g_carry -
    ref) / carry_base`` in both packages (``effective_g``)."""
    from repro.core.tiled_analog import analog_project as jax_project
    from repro_torch.core.tiled_analog import analog_project

    x, g, ref, ws = _operands(40, 24, 6)
    rng = np.random.default_rng(1)
    g_carry = (ref + rng.uniform(-0.25, 0.25, ref.shape)).astype(np.float32)
    jcfg, tcfg = _configs(adc)
    jcfg = jcfg.replace(carry=True, carry_base=4.0)
    tcfg = tcfg.replace(carry=True, carry_base=4.0)
    leaves = {"g": g, "ref": ref, "w_scale": ws, "g_carry": g_carry}
    y_jax = np.asarray(jax_project(
        {k: jnp.asarray(v) for k, v in leaves.items()}, jnp.asarray(x),
        jcfg))
    y_port = analog_project({k: torch.from_numpy(v)
                             for k, v in leaves.items()},
                            torch.from_numpy(x), tcfg).numpy()
    np.testing.assert_allclose(y_port, y_jax, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# The transpose read (MVM)
# --------------------------------------------------------------------------

MVM_SHAPES = [((), 16, 16, 4), ((), 40, 24, 6), ((3,), 40, 36, 5),
              ((2,), 64, 48, 8)]


def _both_mvm(lead, k, n, b, adc, jimpl, seed):
    """The transpose read of (lead, B, N) errors through (lead, K, N)
    conductances in both packages."""
    x, g, ref, ws = _operands(k, n, b, lead=lead, seed=seed)
    d = np.random.default_rng(seed + 10).standard_normal(
        (*lead, b, n)).astype(np.float32)
    jcfg, tcfg = _configs(adc)
    y_jax = np.asarray(jax_mvm(jnp.asarray(d), jnp.asarray(g),
                               jnp.asarray(ref), jnp.asarray(ws), jcfg,
                               impl=jimpl))
    y_port = torch_mvm(torch.from_numpy(d), torch.from_numpy(g),
                       torch.from_numpy(ref), torch.from_numpy(ws), tcfg,
                       impl="eager").numpy()
    assert y_port.shape == (*lead, b, k)
    return y_jax, y_port


@pytest.mark.parametrize("jimpl", ["chain", "interpret"])
@pytest.mark.parametrize("lead,k,n,b", MVM_SHAPES)
def test_plain_transpose_read_bitwise_fixed_pow2(jimpl, lead, k, n, b):
    y_jax, y_port = _both_mvm(lead, k, n, b, POW2_ADC, jimpl, seed=3)
    np.testing.assert_array_equal(y_port, y_jax)


@pytest.mark.parametrize("jimpl", ["chain", "interpret"])
@pytest.mark.parametrize("lead,k,n,b", MVM_SHAPES)
def test_plain_transpose_read_dynamic_close(jimpl, lead, k, n, b):
    y_jax, y_port = _both_mvm(lead, k, n, b, {"range_mode": "dynamic"},
                              jimpl, seed=4)
    np.testing.assert_allclose(y_port, y_jax, rtol=1e-5, atol=1e-5)


def test_port_chain_equals_plain_transpose_read():
    x, g, ref, ws = (torch.from_numpy(a) for a in _operands(40, 24, 6))
    d = torch.randn((6, 24), generator=torch.Generator().manual_seed(0))
    _, tcfg = _configs({"range_mode": "dynamic"})
    y_chain = torch_mvm(d, g, ref, ws, tcfg, impl="chain")
    y_plain = torch_mvm(d, g, ref, ws, tcfg, impl="eager")
    torch.testing.assert_close(y_plain, y_chain, rtol=1e-6, atol=1e-6)


def test_transpose_dispatch_cpu_takes_plain_version_and_cuda_raises():
    x, g, ref, ws = (torch.from_numpy(a) for a in _operands(16, 16, 4))
    _, tcfg = _configs(POW2_ADC)
    before = dict(K.LAUNCHES)
    y = K.xbar_fused_read(x, g, ref, ws, tcfg, transpose=True)
    assert y.shape == (4, 16) and K.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        K.xbar_fused_read(x, g, ref, ws, tcfg, impl="cuda", transpose=True)
    with pytest.raises(ValueError, match="CUDA"):
        K._read_cuda(x[None], g[None], ref[None], torch.ones((1, 2)),
                     tcfg, transpose=True)
    with pytest.raises(ValueError, match="does not match"):
        K.xbar_fused_read(torch.ones((4, 24)), g, ref, ws, tcfg,
                          transpose=True)


def test_transpose_kernel_source_contracts_the_stored_columns():
    src = K.SOURCE.read_text()
    assert "_fused_mvm_kernel" in src and "kTranspose" in src
    assert set(K.LAUNCHES) == {
        "fused_vmm", "fused_mvm", "fakequant", "fakequant_lead",
        "fakequant_split", "fakequant_tiles",
        "fakequant_scale", "fakequant_prepare", "fakequant_fp32",
        "fakequant_tc", "fakequant_epilogue",
        *(f"{name}_{d}" for d in ("vmm", "mvm")
          for name in ("read_tile", "reduce_tiles", "read_prepare",
                       "read_range", "tc_read"))}


# --------------------------------------------------------------------------
# The tensor-core instance's arithmetic (what the kernel computes on the
# card, checked here in plain torch)
# --------------------------------------------------------------------------

def _pairs(kind, seed=5):
    """Conductance pairs (g, ref) as float32 tensors."""
    rng = np.random.default_rng(seed)
    if kind == "taox_window":       # random pairs in the [0, 1] window
        g = rng.uniform(0.0, 1.0, 4096)
        ref = rng.uniform(0.0, 1.0, 4096)
    elif kind == "near_zero":       # g within a few float32 ulp of ref
        ref = rng.uniform(0.25, 0.75, 4096).astype(np.float32)
        ulps = rng.integers(-40, 41, 4096)
        g = ref.astype(np.float32).view(np.int32) + ulps
        g = g.astype(np.int32).view(np.float32)
    elif kind == "both_signs":      # wide magnitudes of either sign
        mag = 10.0 ** rng.uniform(-6, 0, 4096)
        ref = np.full(4096, 0.5)
        g = ref + np.where(rng.random(4096) < 0.5, -1, 1) * mag * 0.5
    else:                           # the device's 1/256 pulse grid
        g = rng.integers(0, 257, 4096) / 256.0
        ref = np.full(4096, 0.5)
    return (torch.from_numpy(np.asarray(g, np.float32)),
            torch.from_numpy(np.asarray(ref, np.float32)))


@pytest.mark.parametrize("kind", ["taox_window", "near_zero", "both_signs",
                                  "pulse_grid"])
def test_bf16x3_split_reconstructs_the_pair_exactly(kind):
    """hi + mid + lo == g - ref bit for bit, each part a bf16 value; on the
    pulse grid mid and lo are zero (the exact class)."""
    g, ref = _pairs(kind)
    d = g - ref
    hi, mid, lo = K.split_bf16x3(d)
    for part in (hi, mid, lo):
        assert torch.equal(part.to(torch.bfloat16).float(), part)
    np.testing.assert_array_equal(
        (hi.double() + mid.double() + lo.double()).numpy(),
        d.double().numpy())
    assert torch.equal((hi + mid) + lo, d)
    if kind == "pulse_grid":
        assert not mid.any() and not lo.any()


@pytest.mark.parametrize("bits", range(2, 10))
def test_code_times_part_products_are_exact(bits):
    """Every product of a DAC code (|code| <= in_levels) and a bf16 part is
    exact in float32, so the tensor cores' products equal the float64
    ones."""
    levels = AdcConfig(in_bits=bits).in_levels
    g, ref = _pairs("taox_window", seed=bits)
    parts = torch.cat(K.split_bf16x3(g - ref))
    codes = torch.arange(-levels, levels + 1, dtype=torch.float32)
    prod32 = codes[:, None] * parts[None, :]
    prod64 = codes.double()[:, None] * parts.double()[None, :]
    np.testing.assert_array_equal(prod32.double().numpy(), prod64.numpy())
    assert torch.equal(codes.to(torch.bfloat16).float(), codes)


@pytest.mark.parametrize("batch,bits,instance", [
    (1, 8, "fp32"), (4, 8, "fp32"), (16, 8, "fp32"), (17, 8, "tensor_core"),
    (2048, 8, "tensor_core"), (2048, 2, "tensor_core"),
    (2048, 9, "tensor_core"), (2048, 10, "fp32"), (2048, 12, "fp32")])
def test_read_instance_is_chosen_from_batch_and_dac_levels(batch, bits,
                                                           instance):
    levels = AdcConfig(in_bits=bits).in_levels
    assert K.read_instance(batch, levels) == instance


def _tensor_core_read(x, g, ref, sc, cfg, transpose=False):
    """The tensor-core instance's algorithm in plain torch: DAC codes once,
    each tile's charge as the sum of the three bf16 parts' products, the
    tile's range from its charges, ADC per tile, tiles summed in order."""
    from repro_torch.core.adc import adc_quantize, integrator_saturation
    levels = float(cfg.adc.in_levels)
    codes = torch.clamp(torch.round(x / sc[:, 0, None, None]),
                        -levels, levels)[0]
    diff = (g - ref)[0]
    rows, cols = cfg.rows, cfg.cols
    if transpose:
        rows, cols, diff = cols, rows, diff.T
    n_red, n_out = diff.shape
    y = None
    for r0 in range(0, n_red, rows):
        charges = torch.zeros((codes.shape[0], n_out))
        for part in K.split_bf16x3(diff[r0:r0 + rows]):
            charges = charges + codes[:, r0:r0 + rows] @ part
        p = torch.empty_like(charges)
        for c0 in range(0, n_out, cols):
            q, sat = integrator_saturation(
                charges[:, c0:c0 + cols], cfg.adc, rows, cfg.device.gmax)
            p[:, c0:c0 + cols] = adc_quantize(q, sat, cfg.adc)
        y = p if y is None else y + p
    return (y * sc[0, 1])[None]


@pytest.mark.parametrize("transpose", [False, True], ids=["vmm", "mvm"])
@pytest.mark.parametrize("cls", ["pow2", "dynamic"])
def test_tensor_core_algorithm_matches_plain_read(cls, transpose):
    """Exact class bit-equal; float class within the reference's 1e-5
    (ragged 40 x 36 with 16-line tiles, 24 rows)."""
    adc = POW2_ADC if cls == "pow2" else {"range_mode": "dynamic"}
    _, tcfg = _configs(adc)
    x, g, ref, ws = (torch.from_numpy(a)
                     for a in _operands(40, 36, 24, lead=(1,), seed=6))
    if cls == "pow2":
        g = torch.round(g * 256.0) / 256.0
    if transpose:
        x = torch.from_numpy(np.random.default_rng(7).standard_normal(
            (1, 24, 36)).astype(np.float32))
    sc = K.read_scales(x, ws, tcfg.adc.in_levels)
    y_tc = _tensor_core_read(x, g, ref, sc, tcfg, transpose)
    y_plain = K._read_plain(x, g, ref, sc, tcfg, transpose)
    if cls == "pow2":
        assert torch.equal(y_tc, y_plain)
    else:
        torch.testing.assert_close(y_tc, y_plain, rtol=1e-5, atol=1e-5)


def test_kernel_sources_use_tensor_cores():
    """The large-batch read issues bf16 mma.sync products on three parts,
    and keeps its FP32 instance for decode and wide DACs."""
    src = K.SOURCE.read_text()
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
    for name in ("read_prepare_kernel", "tc_range_kernel", "tc_read_kernel",
                 "fused_read_tile_kernel", "reduce_tiles_kernel"):
        assert name in src
    assert f"kTcMaxLevels = {K.TC_MAX_LEVELS}" in src
