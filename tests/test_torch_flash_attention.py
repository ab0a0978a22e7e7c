"""The port's flash attention (``kernels.flash_attention``: the plain
version ``flash_attention_ref`` and the dispatch of ``flash_attention``)
against the JAX package's oracle and its interpret-mode Pallas kernel, on
the cases of ``tests/test_flash_attention.py``.

Tolerances, as the reference's own test: 1e-4 in float32 (the softmax and
the products are float32 sums taken in other orders, and the online
softmax rescales where the full-matrix oracle does not); 3e-2 for
bfloat16 inputs (the output rounds to bfloat16, one ulp of which is 2^-8
relative, and the two frameworks may round an element either way).

The inputs are made with numpy from a seed and handed to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention import flash_attention_ref as jax_ref
from repro_torch.kernels import flash_attention as FA

CASES = [
    # b, sq, skv, h, kvh, hd, bq, bk
    (2, 64, 64, 4, 2, 16, 16, 16),     # GQA, square
    (1, 128, 128, 8, 8, 32, 32, 64),   # MHA, uneven blocks
    (2, 32, 64, 4, 1, 16, 32, 16),     # MQA, cross lengths
    (1, 64, 64, 2, 2, 64, 64, 64),     # single block
]


def _inputs(b, sq, skv, h, kvh, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, hd)).astype(np.float32),
            rng.standard_normal((b, skv, kvh, hd)).astype(np.float32),
            rng.standard_normal((b, skv, kvh, hd)).astype(np.float32))


def _port(q, k, v, causal, dtype=torch.float32, **kw):
    t = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    return FA.flash_attention(*t, causal=causal, **kw).float().numpy()


@pytest.mark.parametrize("b,sq,skv,h,kvh,hd,bq,bk", CASES)
@pytest.mark.parametrize("causal", [True, False])
def test_matches_reference(b, sq, skv, h, kvh, hd, bq, bk, causal):
    """Causal cases with Sq != Skv use the top-left alignment of both
    packages' oracles."""
    q, k, v = _inputs(b, sq, skv, h, kvh, hd)
    got = _port(q, k, v, causal, block_q=bq, block_k=bk)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    oracle = np.asarray(jax_ref(jq, jk, jv, causal=causal))
    np.testing.assert_allclose(got, oracle, rtol=1e-4, atol=1e-4)
    if not (causal and sq != skv):
        kernel = np.asarray(jax_flash(jq, jk, jv, causal=causal, block_q=bq,
                                      block_k=bk, interpret=True))
        np.testing.assert_allclose(got, kernel, rtol=1e-4, atol=1e-4)


def test_bf16_inputs():
    q, k, v = _inputs(2, 64, 64, 4, 2, 16)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    got = FA.flash_attention(*(torch.from_numpy(a).to(torch.bfloat16)
                               for a in (q, k, v)), block_q=32, block_k=32)
    assert got.dtype == torch.bfloat16
    kernel = jax_flash(jq, jk, jv, block_q=32, block_k=32, interpret=True)
    for want in (kernel, jax_ref(jq, jk, jv)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=3e-2, atol=3e-2)


def test_causality():
    """Perturbing future keys must not change past outputs."""
    q, k, v = _inputs(1, 64, 64, 2, 2, 16)
    o1 = _port(q, k, v, True, block_q=16, block_k=16)
    k2, v2 = k.copy(), v.copy()
    k2[:, 40:] = 9.0
    v2[:, 40:] = -9.0
    o2 = _port(q, k2, v2, True, block_q=16, block_k=16)
    np.testing.assert_allclose(o1[:, :40], o2[:, :40], rtol=1e-5, atol=1e-5)
    assert float(np.abs(o1[:, 41:] - o2[:, 41:]).max()) > 0.1


def test_rejects_misaligned_blocks():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 60, 60, 2, 2, 16))
    with pytest.raises(ValueError, match="divide"):
        FA.flash_attention(q, k, v, block_q=16, block_k=16)
    with pytest.raises(ValueError, match="KVH"):
        FA.flash_attention(q, k[:, :, :1].expand(1, 60, 3, 16).contiguous(),
                           v[:, :, :1].expand(1, 60, 3, 16).contiguous())


def test_dispatch_cpu_takes_plain_version_and_cuda_raises():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 64, 64, 2, 2, 64))
    before = dict(FA.LAUNCHES)
    got = FA.flash_attention(q, k, v)
    torch.testing.assert_close(got, FA.flash_attention_ref(q, k, v),
                               rtol=0, atol=0)
    assert FA.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        FA._flash_cuda(q, k, v, True)


def test_kernel_source_is_built_for_hopper():
    """The build line targets sm_90a without fast math; the source names
    the TPU kernel it replaces, masks with -1e30 and covers the registry's
    head dims."""
    from repro_torch.kernels import _nvcc
    assert "arch=compute_90a,code=sm_90a" in _nvcc.NVCC_FLAGS
    assert "--use_fast_math" not in _nvcc.NVCC_FLAGS
    src = FA.SOURCE.read_text()
    assert "flash_attention.py:29" in src and "_fa_kernel" in src
    assert "-1e30f" in src and "__expf" not in src.replace("(expf, not "
                                                           "__expf)", "")
    for hd in FA.HEAD_DIMS:
        assert f"case {hd}:" in src
    assert set(FA.LAUNCHES) == {"flash_attention"}


# --------------------------------------------------------------------------
# The tensor-core kernel's arithmetic (what it computes on the card,
# checked here in plain torch)
# --------------------------------------------------------------------------

def _attention(q, k, v, causal, qk, pv):
    """The plain version's steps with the two products given: ``qk(q, k)``
    the scores, ``pv(p, v)`` the output (float32 (B, S, H, hd))."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    kr = k.repeat_interleave(h // kvh, dim=2)
    vr = v.repeat_interleave(h // kvh, dim=2)
    s = qk(q.transpose(1, 2), kr.transpose(1, 2)) / np.sqrt(hd)
    if causal:
        mask = torch.tril(torch.ones((sq, k.shape[1]), dtype=torch.bool))
        s = s.masked_fill(~mask, FA.NEG_INF)
    p = torch.softmax(s, dim=-1)
    return pv(p, vr.transpose(1, 2)).transpose(1, 2)


def _mm(a, b):
    return a @ b.transpose(-1, -2)


def test_bf16_rounded_p_stays_within_bf16_tolerance():
    """lm100m's heads (12 of 64), causal, S = 256: rounding P to bf16 before
    ``P @ V`` (the bf16 kernel, and the reference's default-precision dot
    on the TPU) stays within the 3e-2 bfloat16 tolerance of float32."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16).float()
               for a in _inputs(1, 256, 256, 12, 12, 64, seed=3))
    full = FA.flash_attention_ref(q, k, v, True)
    rounded = _attention(
        q, k, v, True, _mm,
        lambda p, vv: p.to(torch.bfloat16).float() @ vv)
    torch.testing.assert_close(rounded, full, rtol=3e-2, atol=3e-2)
    assert (rounded - full).abs().max() > 0  # the rounding did something


def _split_tf32(x):
    """The float32 kernel's operand split (as it forms it on the card):
    ``hi = tf32(x)``, ``lo = tf32(x - hi)`` (``cvt.rna``: round to nearest,
    ties away from zero), both returned in float32."""
    def tf32(t):
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    hi = tf32(x.float())
    return hi, tf32(x.float() - hi)


def test_3xtf32_split_reproduces_float32_products():
    """a_lo b_hi + a_hi b_lo + a_hi b_hi is within 1e-6 relative of a b,
    and hi + lo rebuilds x within 2^-21 relative."""
    rng = np.random.default_rng(4)
    a, b = (torch.from_numpy(rng.standard_normal(100_000).astype(np.float32)
                             * 10.0 ** rng.uniform(-3, 3, 100_000)
                             .astype(np.float32)) for _ in range(2))
    (ah, al), (bh, bl) = _split_tf32(a), _split_tf32(b)
    for x, (hi, lo) in ((a, (ah, al)), (b, (bh, bl))):
        assert torch.equal(_split_tf32(hi)[0], hi)  # 10-bit mantissas
        assert torch.equal(_split_tf32(lo)[0], lo)
        rel = ((hi.double() + lo.double() - x.double()).abs()
               / x.double().abs())
        assert rel.max() <= 2.0 ** -21
    prod = (al.double() * bh.double() + ah.double() * bl.double()
            + ah.double() * bh.double())
    exact = a.double() * b.double()
    assert ((prod - exact).abs() / exact.abs()).max() <= 1e-6


def _mm_3xtf32(a, b):
    (ah, al), (bh, bl) = _split_tf32(a), _split_tf32(b)
    return (_mm(al, bh) + _mm(ah, bl)) + _mm(ah, bh)


@pytest.mark.parametrize("causal", [True, False])
def test_3xtf32_attention_within_float32_tolerance(causal):
    """Both products of the float32 kernel in 3xTF32 stay within the 1e-4
    float32 tolerance of the plain version (GQA, hd 80)."""
    q, k, v = (torch.from_numpy(a)
               for a in _inputs(1, 128, 128, 4, 2, 80, seed=5))
    got = _attention(q, k, v, causal, _mm_3xtf32,
                     lambda p, vv: _mm_3xtf32(p, vv.transpose(-1, -2)))
    torch.testing.assert_close(got, FA.flash_attention_ref(q, k, v, causal),
                               rtol=1e-4, atol=1e-4)


def test_kernel_source_uses_tensor_cores():
    """bf16 inputs on m16n8k16 bf16 mma.sync, float32 on m16n8k8 TF32 in
    three products, V through ldmatrix.trans, K/V copied with cp.async."""
    src = FA.SOURCE.read_text()
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in src
    assert "cvt.rna.tf32.f32" in src and "ldmatrix" in src
    assert "cp.async" in src
