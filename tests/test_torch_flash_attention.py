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
