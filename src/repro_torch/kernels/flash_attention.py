"""Flash attention, forward, causal or full, with grouped-query heads: the
CUDA kernel, its plain torch version and the dispatch between them.

Port of ``repro.kernels.flash_attention``.  The kernel in
``csrc/flash_attention.cu`` replaces the TPU kernel ``_fa_kernel``: online
softmax over key/value blocks with the running max, sum and accumulator
in float32, masked scores at -1e30 (top-left causal alignment), the
result ``acc / max(l, 1e-30)`` in q's dtype.  Its products run on the
tensor cores (``mma.sync``): bf16 for bfloat16 inputs, with P rounded to
bf16 for ``P @ V`` as the reference's own default-precision dot does on
the TPU; 3xTF32 for float32 inputs (each operand split into ``hi =
tf32(x)`` and ``lo = tf32(x - hi)``, each product formed as ``a_lo b_hi +
a_hi b_lo + a_hi b_hi``).  Like the
reference, nothing on the model path calls it:
``models.layers.attention`` computes its own attention in plain tensor
ops.

A CUDA tensor launches the kernel or the call raises; a CPU tensor takes
the plain version, :func:`flash_attention_ref`.
``LAUNCHES["flash_attention"]`` counts the launches.  The kernel is built
at first use (see ``kernels._nvcc``).
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import _nvcc, outputs

Tensor = torch.Tensor

NEG_INF = -1e30
#: Head dims the kernel is built for (the registry's).
HEAD_DIMS = (64, 80, 128, 256)

#: Launches of the kernel; only the wrapper adds to it.
LAUNCHES = {"flash_attention": 0}

SOURCE = _nvcc.CSRC / "flash_attention.cu"


def flash_attention_ref(q: Tensor, k: Tensor, v: Tensor,
                        causal: bool = True) -> Tensor:
    """Plain attention with the full score matrix (port of the reference's
    oracle): q (B, Sq, H, hd), k/v (B, Skv, KVH, hd) → (B, Sq, H, hd) in
    q's dtype; computed in float32."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    scale = 1.0 / np.sqrt(hd)
    qg = q.reshape(b, sq, kvh, group, hd).float()
    s = torch.einsum("bqkgd,bskd->bqkgs", qg, k.float()) * scale
    if causal:
        mask = torch.tril(torch.ones((sq, skv), dtype=torch.bool,
                                     device=q.device))
        s = s.masked_fill(~mask[None, :, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqkgs,bskd->bqkgd", p, v.float())
    return o.reshape(b, sq, h, hd).to(q.dtype)


_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _nvcc.load(SOURCE)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                                            i, f, p]
        lib.flash_attention_fwd.restype = ctypes.c_int
        _lib = lib
    return _lib


def _flash_cuda(q: Tensor, k: Tensor, v: Tensor, causal: bool) -> Tensor:
    """Launch the kernel on contiguous CUDA tensors of one dtype (float32
    or bfloat16)."""
    for name, t in {"q": q, "k": k, "v": v}.items():
        if not t.is_cuda or not t.is_contiguous() or t.dtype != q.dtype \
                or t.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"{name} must be a contiguous float32 or "
                             f"bfloat16 CUDA tensor of q's dtype, got "
                             f"{t.dtype} on {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} is not one the kernel is built "
                         f"for {HEAD_DIMS}")
    lib = _library()
    o = outputs.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, sq, skv,
        h, kvh, hd, int(causal), int(q.dtype == torch.bfloat16),
        1.0 / math.sqrt(hd), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err} "
                           f"(q {tuple(q.shape)}, k {tuple(k.shape)}, "
                           f"{q.dtype})")
    LAUNCHES["flash_attention"] += 1
    return o


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    block_q: int = 512, block_k: int = 512) -> Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Skv, KVH, hd) with H % KVH == 0.

    Returns (B, Sq, H, hd) in q's dtype.  ``block_q``/``block_k`` keep the
    reference's contract: the sequence lengths must divide
    ``min(block, length)``, else ``ValueError``; the kernel's own tiles
    are internal.
    """
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    if k.shape != (b, skv, kvh, hd) or v.shape != k.shape or h % kvh:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} are not (B, Sq, H, hd) and "
                         "(B, Skv, KVH, hd) with H % KVH == 0")
    bq, bk = min(block_q, sq), min(block_k, skv)
    if sq % bq or skv % bk:
        raise ValueError("sequence lengths must divide the block sizes")
    if q.is_cuda:
        return _flash_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal)
    return flash_attention_ref(q, k, v, causal)
