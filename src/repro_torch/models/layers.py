"""Transformer building blocks (port of ``repro.models.layers``: self-
and cross-attention, MLA, gated FFN and the MoE expert projection, with
digital, fakequant and device-mode projections).

Conventions, as in the reference:
  * params are nested dicts of float32 tensors; compute casts to the
    config's dtype,
  * every function takes (params, inputs, cfg),
  * attention is computed in plain tensor ops that mirror the
    reference's einsums (q-chunked prefill, kv-chunked flash-decoding for
    one token, cached attention for chunked prefill).

KV caches are updated in place: ``attention`` (and ``mla_attention``,
its latent cache) writes the new keys and values into the cache tensors
it is given and returns them with the new lengths (the reference
returns fresh arrays and its engines donate the old ones).

Under the numeric step's tensor parallelism
(``core.shardctx.numeric_context``, ``launch.sharding.NumericParallel``)
every family's ``attention`` (a cross-attention's one fused read too),
``mla_attention`` and ``ffn`` (the MoE's shared experts, the hybrid's
shared block) get this rank's blocks: ``wqkv``, ``wq`` /
``wkv_b`` and ``w_upgate`` / ``w_up`` column-parallel (this rank's
heads, its ff slice), ``wo`` and ``w_down`` row-parallel (or, where the
plan keeps them whole, the heads' outputs gathered first); :func:`project`'s
``tp`` reads a split leaf: a digital row split sums its ranks' partial
outputs over ``model``, the fakequant read takes its split form.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import (AnalogMode, ModelConfig,
                                      resolve_analog_mode)
from repro_torch.core import shardctx
from repro_torch.core.adc import AdcConfig
from repro_torch.core.tiled_analog import (analog_project,
                                           crossbar_from_model,
                                           is_analog_container,
                                           program_stacked, readout)
from repro_torch.kernels.ops import _adc_fake_quant as _kernels_adc_fake_quant
from repro_torch.kernels.ops import (fakequant_expert_project,
                                     fakequant_project,
                                     fakequant_split_project)

Tensor = torch.Tensor

# Number of kv chunks of the flash-decoding attention (reference value).
DECODE_KV_CHUNKS = 16
# Query chunk for the chunked prefill attention.
Q_CHUNK = 512


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# --------------------------------------------------------------------------
# Initialisers (torch.Generator draws; not the reference's jax.random draws)
# --------------------------------------------------------------------------

def _trunc_normal(shape, generator: torch.Generator, device) -> Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                       generator=generator)


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               device=None) -> Tensor:
    return _trunc_normal((d_in, d_out), generator, device) / np.sqrt(d_in)


def embed_init(generator: torch.Generator, vocab: int, d: int,
               device=None) -> Tensor:
    return _trunc_normal((vocab, d), generator, device)


def proj_from_weights(w: Tensor, cfg: ModelConfig) -> dict:
    """Wrap explicit weights as projection params: a digital ``{"w"}``
    dict, or in device mode the weights programmed onto a crossbar
    container (one tile grid and calibration per stacked matrix)."""
    if resolve_analog_mode(cfg) is AnalogMode.DEVICE:
        return program_stacked(w, crossbar_from_model(cfg))
    return {"w": w}


def proj_init(generator: torch.Generator, d_in: int, d_out: int,
              cfg: ModelConfig, device=None) -> dict:
    return proj_from_weights(dense_init(generator, d_in, d_out, device), cfg)


def proj_readout(p: dict, cfg: ModelConfig) -> dict:
    """Digital serial read of a projection back to a weight dict."""
    if is_analog_container(p):
        return {"w": readout(p, crossbar_from_model(cfg))}
    return p


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

def rmsnorm_init(d: int, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(p: dict, x: Tensor, eps: float = 1e-5) -> Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * p["scale"]).to(dt)


# --------------------------------------------------------------------------
# Projection
# --------------------------------------------------------------------------

#: :func:`project`'s ``tp`` for a whole leaf read on a sequence chunk.
SEQ = ("seq",)


def project(p: dict, x: Tensor, cfg: ModelConfig, tp=None) -> Tensor:
    """Linear layer.  A crossbar container is read in-array (VMM through
    the fused read); a digital ``{"w"}`` dict is a plain matmul, or in
    fakequant mode the matmul with the crossbar's I/O quantisation (the
    fakequant read: the CUDA kernel on the card).  ``tp`` (``("col",
    whole width, block order)`` or ``("row", width)``) marks this rank's
    part of a tensor-parallel leaf over the numeric context's ``model``
    axis: a column split returns this rank's columns, a row split the
    whole output (this rank's sequence chunk under sequence
    parallelism).  The fakequant read then takes its split form
    (``kernels.ops.FakequantSplitRead``; a row split gathers every
    rank's tiles, so its output is one device's), a digital row split
    sums the ranks' partial products.  In a numeric-parallel step every
    fakequant read's DAC scale is the max over the data ranks' tokens,
    as the reference's over its one global batch.  ``tp`` :data:`SEQ`
    marks a whole leaf read on ``x`` that is this rank's chunk of the
    sequence when sequence parallelism is on (``NumericParallel.sp_on``;
    otherwise a plain read): its DAC scale is then the max over
    ``model`` too and its kernel instance the whole sequence's, so its
    rows are the whole read's bit for bit."""
    if is_analog_container(p):
        return analog_project(p, x, crossbar_from_model(cfg))
    w = p["w"].to(x.dtype)
    npar = shardctx.numeric_context()
    seq = tp is not None and tp[0] == SEQ[0]
    chunk = seq and npar is not None and npar.sp_on
    tp = None if seq else tp
    row = tp is not None and tp[0] == "row"
    if resolve_analog_mode(cfg) is AnalogMode.DIGITAL:
        return npar.row_output(x @ w) if row else x @ w
    adc = AdcConfig(in_bits=cfg.analog_in_bits,
                    out_bits=cfg.analog_out_bits)
    if npar is not None and w.ndim == 2 \
            and (npar.fsdp or tp is not None or chunk):
        # one global batch over the data ranks: one DAC scale over them
        # (and over the ``model`` ranks' chunks of its sequences)
        col = tp is not None and tp[0] == "col"
        tokens = x.numel() // x.shape[-1] * npar.m if chunk else None
        y = fakequant_split_project(
            x, w, adc, cfg.analog_rows, npar.mesh, npar.tp if col else (),
            npar.fsdp + (npar.tp if row or chunk else ()),
            tp[1] if tp is not None else w.shape[-1],
            tp[2] if col else None, npar.tp if row else (), tokens)
        return npar.row_whole(y.to(x.dtype)) if row else y.to(x.dtype)
    y = fakequant_project(x.float(), w.float(), adc, cfg.analog_rows)
    return y.to(x.dtype)


def expert_project(p, x: Tensor, cfg: ModelConfig,
                   tokens: Optional[int] = None) -> Tensor:
    """Expert-batched linear layer: ``x`` (E, T, K) -> (E, T, N).

    ``p`` is a raw (E, K, N) weight stack (digital and fakequant MoE) or
    an expert-batched crossbar container (device mode: each expert's
    matrix on its own tile grid, one read of the whole stack,
    ``core.tiled_analog.analog_project``).  In fakequant mode the
    per-expert products carry the crossbar's I/O quantisation, each
    expert with its own DAC scale, as the reference's ``vmap`` gives it:
    on the card one fakequant read of the whole stack (the kernel with
    its lead dim), under autograd through ``kernels.ops.FakequantRead``
    so QAT's gradient is the reference's.

    ``tokens``, in a numeric-parallel step over data ranks: ``x`` holds
    this rank's rows of each expert's buffer of ``tokens`` rows (the
    global dispatch, ``models.moe``); each expert's DAC scale is then
    the max over the data ranks' rows and the read takes the whole
    buffer's kernel instance (``kernels.ops.fakequant_expert_project``),
    so its rows are the whole read's.
    """
    if is_analog_container(p):
        return analog_project(p, x, crossbar_from_model(cfg))
    if resolve_analog_mode(cfg) is AnalogMode.DIGITAL:
        return torch.einsum("etk,ekn->etn", x, p.to(x.dtype))
    adc = AdcConfig(in_bits=cfg.analog_in_bits,
                    out_bits=cfg.analog_out_bits)
    npar = shardctx.numeric_context()
    if npar is not None and npar.fsdp and tokens is not None:
        y = fakequant_expert_project(x, p, adc, cfg.analog_rows, npar.mesh,
                                     npar.fsdp, tokens)
        return y.to(x.dtype)
    y = fakequant_project(x.float(), p.float(), adc, cfg.analog_rows)
    return y.to(x.dtype)


# The fakequant math lives with the kernels (``kernels.ops``); the
# reference keeps this name as an alias.
_adc_fake_quant = _kernels_adc_fake_quant


# --------------------------------------------------------------------------
# Rotary embeddings
# --------------------------------------------------------------------------

def rope_freqs(dim: int, theta: float, device=None) -> Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    dt = x.dtype
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(dt)


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------

def attn_init(generator: torch.Generator, cfg: ModelConfig,
              device=None) -> dict:
    """Self-attention projections with q/k/v on one column-concatenated
    ``wqkv`` (one crossbar sweep drives all three)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    w = torch.cat([dense_init(generator, d, cfg.n_heads * hd, device),
                   dense_init(generator, d, cfg.n_kv_heads * hd, device),
                   dense_init(generator, d, cfg.n_kv_heads * hd, device)],
                  dim=1)
    wo = proj_init(generator, cfg.n_heads * hd, cfg.d_model, cfg, device)
    return {"wqkv": proj_from_weights(w, cfg), "wo": wo}


def _split_heads(x: Tensor, n: int) -> Tensor:
    return x.reshape(*x.shape[:-1], n, x.shape[-1] // n)


def _chunked_sdpa(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                  q_offset: int = 0) -> Tensor:
    """Softmax attention over query chunks.  q: (B, Sq, H, hd); k/v:
    (B, Skv, KVH, hd); the head group folds into the einsum (GQA)."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    scale = 1.0 / np.sqrt(hd)
    qg = q.reshape(b, sq, kvh, group, hd)
    n_chunks = max(1, sq // Q_CHUNK) if sq % Q_CHUNK == 0 else 1
    cq = sq // n_chunks
    kv_pos = torch.arange(skv, device=q.device)
    k32, v32 = k.float(), v.float()
    outs = []
    for idx in range(n_chunks):
        qi = qg[:, idx * cq:(idx + 1) * cq].float()
        s = torch.einsum("bqkgd,bskd->bqkgs", qi, k32) * scale
        if causal:
            q_pos = q_offset + idx * cq + torch.arange(cq, device=q.device)
            mask = kv_pos[None, :] <= q_pos[:, None]
            s = s.masked_fill(~mask[None, :, None, None, :], -1e30)
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bqkgs,bskd->bqkgd", p, v32))
    out = torch.cat(outs, dim=1).reshape(b, sq, h, v.shape[-1])
    return out.to(q.dtype)


def _decode_sdpa(q: Tensor, k: Tensor, v: Tensor, kv_len: Tensor) -> Tensor:
    """One-token attention against the cache, flash-decoding style: the
    cache is viewed as DECODE_KV_CHUNKS chunks whose partial softmax
    statistics combine exactly.  q: (B, 1, H, hd); k/v: (B, S, KVH, hd)."""
    b, _, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    scale = 1.0 / np.sqrt(hd)
    c = DECODE_KV_CHUNKS if s % DECODE_KV_CHUNKS == 0 else 1
    sl = s // c
    kc = k.reshape(b, c, sl, kvh, hd)
    vc = v.reshape(b, c, sl, kvh, v.shape[-1])
    qg = q.reshape(b, kvh, group, hd)
    scores = torch.einsum("bkgd,bcskd->bckgs", qg.float(),
                          kc.float()) * scale
    pos = torch.arange(s, device=q.device).reshape(c, sl)
    valid = pos[None, :, :] < kv_len[:, None, None]           # (b, c, sl)
    scores = scores.masked_fill(~valid[:, :, None, None, :], -1e30)
    m_c = torch.amax(scores, dim=-1)                           # (b,c,kvh,g)
    e = torch.exp(scores - m_c[..., None])
    l_c = torch.sum(e, dim=-1)
    o_c = torch.einsum("bckgs,bcskd->bckgd", e, vc.float())
    m = torch.amax(m_c, dim=1, keepdim=True)                   # (b,1,kvh,g)
    w = torch.exp(m_c - m) * l_c                               # (b,c,kvh,g)
    o = torch.sum(o_c * torch.exp(m_c - m)[..., None], dim=1) \
        / torch.clamp(torch.sum(w, dim=1), min=1e-30)[..., None]
    return o.reshape(b, 1, h, v.shape[-1]).to(q.dtype)


def _cached_sdpa(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor) -> Tensor:
    """Chunk attention against a partially filled cache (chunked
    prefill).  Cache slot s is visible to the query at position p iff
    s <= p.  q: (B, Sq, H, hd); k/v: (B, S, KVH, hd); q_pos: (B, Sq)."""
    b, sq, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    scale = 1.0 / np.sqrt(hd)
    qg = q.reshape(b, sq, kvh, group, hd)
    scores = torch.einsum("bqkgd,bskd->bqkgs", qg.float(), k.float()) * scale
    mask = torch.arange(s, device=q.device)[None, None, :] \
        <= q_pos[:, :, None]                                   # (b, sq, s)
    scores = scores.masked_fill(~mask[:, :, None, None, :], -1e30)
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bqkgs,bskd->bqkgd", p, v.float())
    return o.reshape(b, sq, h, v.shape[-1]).to(q.dtype)


def attention(p: dict, x: Tensor, cfg: ModelConfig, *, causal: bool = True,
              positions: Optional[Tensor] = None,
              cache: Optional[dict] = None,
              x_kv: Optional[Tensor] = None,
              use_rope: bool = True) -> Tuple[Tensor, Optional[dict]]:
    """Self- or cross-attention with rotary embeddings and an optional KV
    cache.

    cache = {"k": (B, S, KVH, hd), "v": ..., "len": (B,)}.  Append mode
    (one token, or a chunk with explicit ``positions``) writes the new
    keys and values at each row's ``len`` and attends to the filled
    prefix.  A cache with ``positions=None`` and sq > 1 is a fresh full
    prefill, which overwrites the cache from position 0.  ``causal`` and
    ``use_rope`` off give the audio encoder's attention.

    Cross-attention (``x_kv`` (B, Skv, d), a second token stream): ONE
    application of the fused ``wqkv`` reads both streams concatenated
    along tokens; q comes from the first ``sq`` rows, k and v from the
    rest.  It is never split into two reads: in device mode the DAC scale
    and each output tile's ADC range span every row of a read, and a
    training step's tape takes one operand block per container (the
    unused column blocks of each stream carry zero cotangents).  No rope,
    no causal mask, and the cache is not touched.
    """
    npar = shardctx.numeric_context()
    tp = npar is not None and npar.attn and cache is None
    q, k, v = fused_qkv(p, x, cfg, tp, x_kv)
    b, sq = q.shape[0], q.shape[1]   # the whole sequence under ``seq``
    append = cache is not None and x_kv is None and (
        sq == 1 or positions is not None)
    if positions is None:
        positions = torch.arange(sq, device=x.device).expand(b, sq)
    if use_rope and x_kv is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    new_cache = None
    if append:
        idx = cache["len"]
        rows = torch.arange(b, device=x.device)[:, None]
        slots = idx.long()[:, None] + torch.arange(sq, device=x.device)
        cache["k"][rows, slots] = k.to(cache["k"].dtype)
        cache["v"][rows, slots] = v.to(cache["v"].dtype)
        if sq == 1:
            o = _decode_sdpa(q, cache["k"], cache["v"], idx + 1)
        else:
            o = _cached_sdpa(q, cache["k"], cache["v"], positions)
        new_cache = {"k": cache["k"], "v": cache["v"], "len": idx + sq}
    else:
        o = _chunked_sdpa(q, k, v, causal=causal and x_kv is None)
        if cache is not None and x_kv is None:  # prefill fills the cache
            cache["k"][:, :sq] = k.to(cache["k"].dtype)
            cache["k"][:, sq:] = 0
            cache["v"][:, :sq] = v.to(cache["v"].dtype)
            cache["v"][:, sq:] = 0
            new_cache = {"k": cache["k"], "v": cache["v"],
                         "len": torch.full((b,), sq, dtype=torch.int32,
                                           device=x.device)}
    o = o.reshape(b, sq, -1)
    return _out_project(p, o, cfg, npar if tp else None), new_cache


def fused_qkv(p: dict, x: Tensor, cfg: ModelConfig, tp: bool,
              x_kv: Optional[Tensor] = None
              ) -> Tuple[Tensor, Tensor, Tensor]:
    """q, k and v (B, S, heads, hd) of one read of the fused ``wqkv``: of
    ``x``, or for a cross-attention q of ``x`` and k and v of ``x_kv``
    from one read of the two streams concatenated along the tokens (see
    :func:`attention`).  ``tp`` (the numeric step's ``attn`` plan): this
    rank's heads, a column-parallel read of its q, k and v columns in
    the split-range form (one DAC scale and one range a token over both
    streams, as the whole read's); under MQA k and v whole on every rank,
    their gradient summed over ``model``.  Under sequence parallelism
    ``x`` is this rank's chunk: its whole sequence is gathered before
    the stream joins it (``[x_whole, x_kv]``, the one-device read's rows),
    and the stream's cotangent from this rank's heads is summed over
    ``model`` by a ``copy_to`` (the stream is whole on every rank)."""
    hd = cfg.resolved_head_dim
    n_h, n_kvh = cfg.n_heads, cfg.n_kv_heads
    wqkv, col = p["wqkv"], None
    npar = shardctx.numeric_context() if tp else None
    sp = npar is not None and npar.sp_on
    if sp:      # the whole sequence first, then the stream after it
        x = npar.col_input(x)
    sq = x.shape[1]
    if x_kv is not None:
        kv = x_kv.to(x.dtype)
        if sp:  # this rank's heads' share of its cotangent, summed once
            kv = shardctx.copy_to(kv, npar.mesh, npar.tp)
        x = torch.cat([x, kv], dim=1)
    if tp:
        if not sp:
            x = npar.col_input(x)
        n_h //= npar.m
        col = ("col", (cfg.n_heads + 2 * cfg.n_kv_heads) * hd,
               npar.blocks.get("wqkv"))
        if npar.kv_split:
            n_kvh //= npar.m
        else:   # MQA: k and v whole on every rank, their gradient summed
            w = wqkv["w"]
            wqkv = {"w": torch.cat([w[..., :n_h * hd], shardctx.copy_to(
                w[..., n_h * hd:], npar.mesh, npar.tp)], dim=-1)}
    nq, nkv = n_h * hd, n_kvh * hd
    qkv = project(wqkv, x, cfg, tp=col)
    q_rows, kv_rows = (slice(None), slice(None)) if x_kv is None \
        else (slice(None, sq), slice(sq, None))
    return (_split_heads(qkv[:, q_rows, :nq], n_h),
            _split_heads(qkv[:, kv_rows, nq:nq + nkv], n_kvh),
            _split_heads(qkv[:, kv_rows, nq + nkv:], n_kvh))


def _out_project(p: dict, o: Tensor, cfg: ModelConfig, npar) -> Tensor:
    """``wo`` of the heads' outputs ``o``: read whole outside tensor
    parallelism (``npar`` None), row-parallel under the plan's
    ``attn_row``, else after this rank's heads are gathered."""
    if npar is None:
        return project(p["wo"], o, cfg)
    if npar.attn_row:
        return project(p["wo"], o, cfg, tp=("row", cfg.d_model))
    return project(p["wo"], npar.gather_heads(o), cfg)


def make_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> dict:
    hd = cfg.resolved_head_dim
    shape = (batch, max_len, cfg.n_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=cdtype(cfg), device=device),
            "v": torch.zeros(shape, dtype=cdtype(cfg), device=device),
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


# --------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# --------------------------------------------------------------------------

def mla_init(generator: torch.Generator, cfg: ModelConfig,
             device=None) -> dict:
    """MLA projections: ``wq`` (all heads' nope + rope queries), ``wkv_a``
    (the latent and the one shared rope key), ``kv_norm`` on the latent,
    ``wkv_b`` (latent to per-head nope keys and values), ``wo``."""
    d, h, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    qk_dim = cfg.qk_nope_dim + cfg.qk_rope_dim
    return {
        "wq": proj_init(generator, d, h * qk_dim, cfg, device),
        "wkv_a": proj_init(generator, d, r + cfg.qk_rope_dim, cfg, device),
        "kv_norm": rmsnorm_init(r, device),
        "wkv_b": proj_init(generator, r,
                           h * (cfg.qk_nope_dim + cfg.v_head_dim), cfg,
                           device),
        "wo": proj_init(generator, h * cfg.v_head_dim, d, cfg, device),
    }


def _mla_absorbed(p: dict, x: Tensor, cfg: ModelConfig, q_nope: Tensor,
                  q_rope: Tensor, c_all: Tensor, kr_all: Tensor,
                  kv_len: Tensor) -> Tensor:
    """The absorbed MLA decode (DeepSeek-V2 §2.1.2, the reference's
    ``REPRO_MLA_ABSORB``): ``wkv_b``'s key block folds into the query and
    its value block into the output, so attention runs in the latent
    space.  It reads ``wkv_b``'s digital weights directly (no fakequant
    read of ``wkv_b``), as the reference does."""
    b, h = x.shape[0], cfg.n_heads
    r, dn, dv = cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.v_head_dim
    wkv = p["wkv_b"]["w"].float().reshape(r, h, dn + dv)
    wkb, wvb = wkv[..., :dn], wkv[..., dn:]
    scale = 1.0 / np.sqrt(dn + cfg.qk_rope_dim)
    q_abs = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].float(), wkb)
    c32 = c_all.float()
    scores = (torch.einsum("bhr,btr->bht", q_abs, c32)
              + torch.einsum("bhd,btd->bht", q_rope[:, 0].float(),
                             kr_all.float())) * scale
    valid = torch.arange(c_all.shape[1], device=x.device)[None, :] \
        < kv_len[:, None]
    scores = scores.masked_fill(~valid[:, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bht,btr->bhr", probs, c32)
    o = torch.einsum("bhr,rhd->bhd", ctx, wvb)[:, None].to(x.dtype)
    return project(p["wo"], o.reshape(b, 1, -1), cfg)


def mla_attention(p: dict, x: Tensor, cfg: ModelConfig, *,
                  positions: Optional[Tensor] = None,
                  cache: Optional[dict] = None
                  ) -> Tuple[Tensor, Optional[dict]]:
    """Multi-head latent attention.  The cache holds the normalised latent
    (``kv_lora_rank`` wide) and the one shared rope key, MLA's memory
    saving: cache = {"c_kv": (B, S, r), "k_rope": (B, S, rope), "len":
    (B,)}, updated in place as :func:`attention` updates its cache.

    Append mode (one token, or a chunk with explicit ``positions``)
    writes at each row's ``len`` and re-expands the WHOLE cache, zero
    slots included, through ``wkv_b``: in device mode that read's DAC
    scale and per-tile ranges span all B x S rows, as the reference's
    do.  A fresh prefill (cache given, no positions) expands the freshly
    computed latent and pads it into the cache.  The softmax scale is
    1/sqrt(qk_nope + qk_rope), the query's head dim; the values are
    ``v_head_dim`` wide.

    Under the numeric step's ``mla`` plan (training: no cache) ``wq`` and
    ``wkv_b`` are column-parallel by whole heads, ``wkv_a`` and
    ``kv_norm`` replicated (every rank forms the whole latent), ``wo``
    row-parallel over the heads' values (or read whole after the heads'
    outputs are gathered, where the plan keeps it whole).  Under sequence
    parallelism ``x`` is this rank's chunk: ``wq`` reads the gathered
    whole sequence, ``wkv_a`` (its DAC scale shared over ``model``,
    :data:`SEQ`), ``kv_norm`` and the shared rope key act on the chunk
    at its positions, and the latent and the rope key are gathered
    before ``wkv_b``."""
    npar = shardctx.numeric_context()
    tp = npar is not None and npar.mla and cache is None
    sp = tp and npar.sp_on
    b, sq = x.shape[0], x.shape[1] * (npar.m if sp else 1)
    h = cfg.n_heads
    r, dn, dr = cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim
    append = cache is not None and (sq == 1 or positions is not None)
    if positions is None:
        positions = torch.arange(sq, device=x.device).expand(b, sq)
    col = {}
    if tp:      # this rank's heads of wq and wkv_b (head-major columns)
        h //= npar.m
        col = {k: ("col", cfg.n_heads * width, npar.blocks.get(k))
               for k, width in (("wq", dn + dr),
                                ("wkv_b", dn + cfg.v_head_dim))}
    q = _split_heads(project(p["wq"], npar.col_input(x) if tp else x, cfg,
                             tp=col.get("wq")), h)       # (b, s, h, dn+dr)
    q_nope = q[..., :dn]
    q_rope = apply_rope(q[..., dn:], positions, cfg.rope_theta)
    kv_a = project(p["wkv_a"], x, cfg, tp=SEQ)
    c_kv = rmsnorm(p["kv_norm"], kv_a[..., :r], cfg.norm_eps)
    own = positions.narrow(1, npar.seq_offset(x.shape[1]), x.shape[1]) \
        if sp else positions
    k_rope = apply_rope(kv_a[..., None, r:], own,
                        cfg.rope_theta)[:, :, 0]         # one shared head

    new_cache, kv_len = None, None
    if append:
        idx = cache["len"]
        rows = torch.arange(b, device=x.device)[:, None]
        slots = idx.long()[:, None] + torch.arange(sq, device=x.device)
        cache["c_kv"][rows, slots] = c_kv.to(cache["c_kv"].dtype)
        cache["k_rope"][rows, slots] = k_rope.to(cache["k_rope"].dtype)
        c_all, kr_all = cache["c_kv"], cache["k_rope"]
        kv_len = idx + sq
        new_cache = {"c_kv": c_all, "k_rope": kr_all, "len": kv_len}
    else:
        c_all, kr_all = c_kv, k_rope
        if cache is not None:   # prefill fills the cache
            for key, val in (("c_kv", c_kv), ("k_rope", k_rope)):
                cache[key][:, :sq] = val.to(cache[key].dtype)
                cache[key][:, sq:] = 0
            new_cache = {"c_kv": cache["c_kv"], "k_rope": cache["k_rope"],
                         "len": torch.full((b,), sq, dtype=torch.int32,
                                           device=x.device)}

    if cache is not None and sq == 1 and "w" in p["wkv_b"] \
            and os.environ.get("REPRO_MLA_ABSORB"):
        out = _mla_absorbed(p, x, cfg, q_nope, q_rope, c_all, kr_all,
                            kv_len)
        return out, new_cache

    # expand the latent to per-head keys and values (under ``mla`` this
    # rank's heads: the latent and the shared rope key feed every rank's
    # heads, their gradients summed over ``model``)
    c_in = c_all.to(x.dtype)
    if tp:
        c_in = npar.col_input(c_in)
        kr_all = npar.col_input(kr_all)
    kv = project(p["wkv_b"], c_in, cfg, tp=col.get("wkv_b"))
    kv = kv.reshape(b, -1, h, dn + cfg.v_head_dim)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    k_rope_b = kr_all[:, :, None, :].to(x.dtype).expand(
        b, k_nope.shape[1], h, dr)
    k_full = torch.cat([k_nope, k_rope_b], dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    if append and sq == 1:
        o = _decode_sdpa(q_full, k_full, v, kv_len)
    elif append:
        o = _cached_sdpa(q_full, k_full, v, positions)
    else:
        o = _chunked_sdpa(q_full, k_full, v, causal=True)
    o = o.reshape(b, sq, -1)
    return _out_project(p, o, cfg, npar if tp else None), new_cache


def make_mla_cache(cfg: ModelConfig, batch: int, max_len: int,
                   device=None) -> dict:
    dt = cdtype(cfg)
    return {"c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                                dtype=dt, device=device),
            "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim),
                                  dtype=dt, device=device),
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


# --------------------------------------------------------------------------
# FFN
# --------------------------------------------------------------------------

def ffn_init(generator: torch.Generator, cfg: ModelConfig,
             device=None, d_ff: int = 0) -> dict:
    """Gated FFNs lay up and gate out on one column-concatenated
    ``w_upgate`` (both halves share the row drives).  ``d_ff`` overrides
    the config's width (MoE's shared expert)."""
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    if cfg.gated:
        up = dense_init(generator, d, ff, device)
        down = proj_init(generator, ff, d, cfg, device)
        gate = dense_init(generator, d, ff, device)
        return {"w_upgate": proj_from_weights(torch.cat([up, gate], dim=1),
                                              cfg),
                "w_down": down}
    return {"w_up": proj_init(generator, d, ff, cfg, device),
            "w_down": proj_init(generator, ff, d, cfg, device)}


def ffn(p: dict, x: Tensor, cfg: ModelConfig) -> Tensor:
    act = (lambda t: F.gelu(t, approximate="tanh")) if cfg.act == "gelu" \
        else F.silu
    npar = shardctx.numeric_context()
    tp = npar is not None and npar.ffn
    if tp:
        x = npar.col_input(x)
    if "w_upgate" in p:
        col = ("col", 2 * npar.d_ff, npar.blocks.get("w_upgate")) if tp \
            else None
        up, gate = torch.chunk(project(p["w_upgate"], x, cfg, tp=col), 2,
                               dim=-1)
        up = act(gate) * up
    else:
        up = act(project(p["w_up"], x, cfg, tp=(
            "col", npar.d_ff, npar.blocks.get("w_up")) if tp else None))
    if not tp:
        return project(p["w_down"], up, cfg)
    if npar.ffn_row:
        return project(p["w_down"], up, cfg, tp=("row", cfg.d_model))
    return project(p["w_down"], npar.gather_heads(up), cfg)
