"""The fakequant read's tensor-core arithmetic, checked in plain torch on
the CPU: the exact three-part bf16 split of W, the plain twin of the
tensor-core instance (``kernels.xbar_vmm._fakequant_tc_plain``: DAC codes,
the split, ``sc * sum over parts``) against the JAX package's jnp path and
interpret-mode Pallas kernel (``repro.kernels.ops.fakequant_project``),
the instance choice, the lifted column cap and the CUDA source's
contract.

Parity classes, as in ``tests/test_torch_fakequant.py``: the exact class
(integer drives with ``max|x| = 127``, so the DAC scale is 1, and sparse
{-1, 0, 1} weights: mid = lo = 0 and every sum an exact float32 integer)
is bit-equal to the jnp path and, for one row tile, to the interpret
kernel; float32 normal operands agree within ``rtol = atol = 1e-5`` (the
products are exact, the sums are float32 sums in other orders).

The inputs are made with numpy from a seed and handed to both packages.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.adc import AdcConfig as JAdc
from repro.kernels.ops import fakequant_project as jax_fakequant
from repro_torch.core.adc import AdcConfig
from repro_torch.kernels import _nvcc
from repro_torch.kernels import xbar_vmm as K

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

# T, K, N, rows: one tile, several tiles, ragged T and K, a 32-row tile
CASES = [(8, 16, 24, 16), (8, 64, 24, 16), (7, 40, 24, 16),
         (5, 37, 20, 16), (33, 100, 48, 32)]
EXACT_CASES = [(8, 16, 32, 16), (8, 40, 64, 16), (5, 37, 16, 16),
               (33, 100, 128, 32)]


def _float_operands(t, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    return x, w


def _exact_operands(t, k, n, seed=0):
    """Drives in [-2, 2] with one at 127 (the scale is then 1), weights in
    {-1, 0, 1} with three in four zero."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-2, 3, (t, k)).astype(np.float32)
    x[0, 0] = 127.0
    w = (rng.integers(-1, 2, (k, n))
         * (rng.random((k, n)) < 0.25)).astype(np.float32)
    q = np.abs(x).astype(np.float64) @ np.abs(w)
    assert (q * q).sum(-1).max() < 2 ** 24
    return x, w


def _reference(x, w, rows, jimpl, **adc):
    return np.asarray(jax_fakequant(jnp.asarray(x), jnp.asarray(w),
                                    JAdc(**adc), rows, impl=jimpl))


def _twin(x, w, rows, **adc):
    cfg = AdcConfig(**adc)
    xt = torch.from_numpy(x)
    sc = K.fakequant_scale(xt, cfg.in_levels)
    return K._fakequant_tc_plain(xt, torch.from_numpy(w), sc, cfg,
                                 rows).numpy()


def _split_values():
    """Signed float32 values: normal draws, every binade from 2^-110 to
    2^100 with random significands, and exact bf16 values."""
    rng = np.random.default_rng(7)
    normal = rng.standard_normal(4096)
    exps = rng.integers(-110, 101, 4096)
    binades = np.ldexp(1.0 + rng.random(4096), exps)
    coarse = np.ldexp(rng.integers(-128, 128, 256), -7)
    v = np.concatenate([normal, binades, coarse]).astype(np.float32)
    return v * np.where(rng.random(v.size) < 0.5, -1, 1).astype(np.float32)


def test_three_part_split_is_exact():
    """hi + mid + lo == w bit for bit, each part a bf16 value, |mid| and
    |lo| at most half an ulp of the part before."""
    w = torch.from_numpy(_split_values())
    hi, mid, lo = K.split_bf16x3(w)
    for part in (hi, mid, lo):
        assert torch.equal(part.to(torch.bfloat16).float(), part)
    assert torch.equal(hi + mid + lo, w)
    assert torch.equal((hi + mid) + lo, w)
    assert (mid.abs() <= hi.abs() * 2.0 ** -8).all()
    assert (lo.abs() <= mid.abs() * 2.0 ** -8).all()


def test_three_part_split_below_its_range():
    """Under 2^-110 (and for float32 subnormals) bf16's least subnormal,
    2^-133, bounds what the split loses; zero and signed zero split into
    zeros."""
    rng = np.random.default_rng(8)
    v = np.ldexp(1.0 + rng.random(512), rng.integers(-149, -110, 512))
    w = torch.from_numpy(np.concatenate([v, -v, [0.0, -0.0]])
                         .astype(np.float32))
    hi, mid, lo = K.split_bf16x3(w)
    err = (hi.double() + mid.double() + lo.double() - w.double()).abs()
    assert (err <= 2.0 ** -133).all()
    zeros = torch.tensor([0.0, -0.0])
    assert all(torch.equal(p.abs(), torch.zeros(2))
               for p in K.split_bf16x3(zeros))


@pytest.mark.parametrize("t,k,n,rows", EXACT_CASES)
def test_tc_twin_exact_class_is_bit_equal(t, k, n, rows):
    x, w = _exact_operands(t, k, n)
    got = _twin(x, w, rows)
    np.testing.assert_array_equal(got, _reference(x, w, rows, "jnp"))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    sc = K.fakequant_scale(xt, 127)
    assert sc.item() == 1.0
    np.testing.assert_array_equal(
        got, K._fakequant_plain(xt, wt, sc, AdcConfig(), rows).numpy())
    if k <= rows:
        np.testing.assert_array_equal(got,
                                      _reference(x, w, rows, "interpret"))


@pytest.mark.parametrize("jimpl", ["jnp", "interpret"])
@pytest.mark.parametrize("t,k,n,rows", CASES)
def test_tc_twin_matches_reference(jimpl, t, k, n, rows):
    x, w = _float_operands(t, k, n)
    np.testing.assert_allclose(_twin(x, w, rows),
                               _reference(x, w, rows, jimpl), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("bits", [4, 9])
def test_tc_twin_other_dac_widths(bits):
    """A 4-bit and a 9-bit DAC (256 levels, the widest the tensor-core
    instance takes): the codes stay exact in bf16."""
    x, w = _float_operands(9, 40, 24, seed=1)
    np.testing.assert_allclose(_twin(x, w, 16, in_bits=bits),
                               _reference(x, w, 16, "jnp", in_bits=bits),
                               rtol=1e-5, atol=1e-5)


def test_codes_are_exact_in_bf16():
    x = torch.from_numpy(_float_operands(16, 64, 8, seed=3)[0] * 50)
    for levels in (7, 127, 255, 256):
        codes = K.fakequant_codes(x, K.fakequant_scale(x, levels), levels)
        assert torch.equal(codes, torch.round(codes))
        assert codes.abs().max().item() == levels
        assert torch.equal(codes.to(torch.bfloat16).float(), codes)


@pytest.mark.parametrize("tokens", [1, 4, 16, 17, 64, 143, 144, 2048])
@pytest.mark.parametrize("bits", [4, 8, 9, 10, 12])
def test_fakequant_instance(tokens, bits):
    """The tensor cores from 144 tokens (the measured crossover) with DACs
    of up to 9 bits; the FP32 instance below it and for wider DACs."""
    levels = AdcConfig(in_bits=bits).in_levels
    want = "tensor_core" if tokens >= 144 and levels <= 256 else "fp32"
    assert K.fakequant_instance(tokens, levels) == want


def test_wide_projection_takes_no_column_cap():
    """N = 32768 (gemma-2b's w_upgate) reads on the plain path, and no
    column cap is left in the wrapper or the source."""
    x, w = _float_operands(3, 64, 32768, seed=4)
    y = K.fakequant_read(torch.from_numpy(x), torch.from_numpy(w),
                         AdcConfig(), 32)
    assert y.shape == (3, 32768) and torch.isfinite(y).all()
    np.testing.assert_allclose(y.numpy(), _reference(x, w, 32, "jnp"),
                               rtol=1e-5, atol=1e-5)
    assert not hasattr(K, "FAKEQUANT_MAX_COLUMNS")
    assert "kMaxColumns" not in K.FAKEQUANT_SOURCE.read_text()


def test_tc_instance_needs_exact_codes():
    """A tensor-core read with DAC codes beyond bf16's exact integers, or
    an unknown instance, raises before anything launches; a CPU tensor
    never reaches the kernel (no fallback)."""
    x, w = (torch.from_numpy(a) for a in _float_operands(20, 16, 8))
    with pytest.raises(ValueError, match="at most 256 levels"):
        K._fakequant_cuda(x, w, AdcConfig(in_bits=12), 16,
                          instance="tensor_core")
    with pytest.raises(ValueError, match="instance"):
        K._fakequant_cuda(x, w, AdcConfig(), 16, instance="bf16")
    for inst in (None, "fp32", "tensor_core"):
        with pytest.raises(ValueError, match="CUDA"):
            K._fakequant_cuda(x, w, AdcConfig(), 16, instance=inst)


def test_fakequant_source_contract():
    """Both instances in the source: mma.sync bf16 products, IEEE division
    and sqrt, no library GEMM, a cooperative pre-pass for the tensor
    cores; the wrapper counts each kernel."""
    src = K.FAKEQUANT_SOURCE.read_text()
    assert "xbar_vmm.py:247" in src and "_fakequant_kernel" in src
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
    assert "__fdiv_rn" in src and "__fsqrt_rn" in src
    assert "#include <cublas" not in src and "cublasCreate" not in src
    for kernel in ("fakequant_scale_kernel", "fakequant_prepare_kernel",
                   "fakequant_fp32_kernel", "fakequant_tc_kernel",
                   "fakequant_epilogue_kernel", "cudaLaunchCooperativeKernel"):
        assert kernel in src
    assert "--use_fast_math" not in _nvcc.NVCC_FLAGS
    # the wrapper's counts follow the source's launch record, slot by slot
    slots = src[src.index("enum LaunchSlot {"):].split("}")[0]
    assert [w.strip() for w in slots.split("{")[1].split(",")][:-1] == [
        "kSlotScale", "kSlotPrepare", "kSlotFp32", "kSlotTc", "kSlotEpilogue"]
    assert K.FQ_KERNEL_COUNTS == ("fakequant_scale", "fakequant_prepare",
                                  "fakequant_fp32", "fakequant_tc",
                                  "fakequant_epilogue")
    assert {"fakequant", *K.FQ_KERNEL_COUNTS} <= set(K.LAUNCHES)


def test_cpu_read_counts_no_launch():
    x, w = (torch.from_numpy(a) for a in _float_operands(20, 40, 24))
    before = dict(K.LAUNCHES)
    K.fakequant_read(x, w, AdcConfig(), 16)
    assert K.LAUNCHES == before


@pytest.mark.parametrize("levels,ok", [(1, True), (2, False)])
def test_fq_agrees_at_a_plain_code_of_zero(levels, ok):
    """``chip_smoke.fq_agrees`` where the plain version's code is 0: a
    kernel code of one level, with the kernel's lsb one float32 ulp above
    the plain version's (its range sum taken in another order), passes;
    two levels fail."""
    x, w = (torch.from_numpy(a) for a in _float_operands(6, 40, 512, seed=9))
    adc = AdcConfig()
    sc = K.fakequant_scale(x, adc.in_levels)
    y_p = K._fakequant_plain(x, w, sc, adc, 64)
    lsb = chip_smoke.fq_tile_lsb(x, w, sc, adc, 64)[:, 0]
    t, c = (int(i) for i in (y_p == 0).nonzero()[0])
    y_k = y_p.clone()
    y_k[t, c] = levels * torch.nextafter(lsb[t], torch.tensor(np.inf))
    assert chip_smoke.fq_agrees(y_k, y_p, x, w, sc, adc, 64)[0] is ok
