"""Layer stacks of every family (port of ``repro.models.transformer``):
the dense and MoE decoders (MoE with MLA attention), the VLM's groups of
a gated cross-attention block and ``cross_attn_every - 1`` self blocks,
the audio encoder-decoder, and the SSM and hybrid stacks.

Per-layer parameters are stacked along a leading (L, ...) dim, as the
reference's scan expects; the stack runs as a Python loop over the
stacked tensors.  Caches (and SSM states) use the same stacked layout and
are updated in place (see ``layers.attention``).  The MoE blocks' aux
losses are summed over the layers, as the reference's scan carries them.

The hybrid (Zamba-2) stack runs groups of ``attn_every`` SSD layers, a
shared attention block after each group (ONE weight set applied
``n_layers // attn_every`` times) and the trailing layers.  In a training
step each application of the shared block deposits its write operands in
its own slot of the containers' tapes (the reference scans over the
tapes' leading dim).

Per-layer remat (:func:`_remat`, the reference's ``REPRO_REMAT``) wraps
the same blocks as the reference's scans: the dense, MoE and MLA
decoder blocks, the audio encoder and decoder blocks, the VLM's self
blocks and the SSM / hybrid SSD layers; not the VLM's cross blocks nor
the hybrid's shared block, whose group bodies the reference leaves
un-rematerialised.

Under the numeric step's FSDP and tensor parallelism
(``core.shardctx.numeric_context``) every layer's leaves are gathered
just before its block runs (:func:`_layered`, inside the remat boundary:
a rematted block's backward gathers again instead of keeping the layer
alive), and so is every leaf outside the stacks at its use (the splits
the plan keeps left in place: the hybrid's shared block's).  The
embedding is then vocab-split (each rank looks up its rows, the partial
embeddings summed over ``model``) and the head vocab-parallel;
``REPRO_SEQ_SHARD`` splits every family's activations along the sequence
between blocks (the tokens from the embedding's sum on, whisper's frames
from the encoder's entry to its final norm, whose output is gathered
once for the decoder), and ``REPRO_EMBED_BF16`` casts the table before
the lookup (the reference's flags).

The cross-attention families take a second token stream (the stub
frontends' ``(B, n_vision_tokens | n_audio_frames, d_model)`` inputs).
Every cross-attention reads its fused ``wqkv`` once over the decoder
tokens and the stream concatenated (``layers.attention``), so a training
step tapes n_tokens + B x stream rows for it
(``analog_registry.operand_rows``).
"""
from __future__ import annotations

import os
from functools import partial
from typing import Any, Callable, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.core import shardctx
from repro_torch.core.shardctx import ShardMeta
from repro_torch.core.tiled_analog import pop_tapes, push_tapes, stack_trees

from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import (SEQ, _chunked_sdpa, _out_project, _split_heads,
                     attention, attn_init, cdtype, dense_init, embed_init,
                     ffn, ffn_init, fused_qkv, mla_attention, mla_init,
                     proj_init, project, rmsnorm, rmsnorm_init)

Tensor = torch.Tensor


def tree_index(tree, i: int):
    """Leaf-wise ``tree[i]`` (views) of a stacked dict tree."""
    if isinstance(tree, dict):
        return {k: tree_index(v, i) for k, v in tree.items()}
    if isinstance(tree, ShardMeta):  # a sharded container's, every layer's
        return tree
    return tree[i]


#: The ops whose outputs ``REPRO_REMAT=dots`` saves: the matmuls without
#: batch dims (``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims``).
DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def remat_policy() -> str:
    """``REPRO_REMAT`` as the reference reads it: ``none``, ``dots``, and
    anything else (the default included) ``full``."""
    pol = os.environ.get("REPRO_REMAT", "full")
    return pol if pol in ("none", "dots") else "full"


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(f: Callable) -> Callable:
    """Per-layer remat (the reference's ``_remat``): ``f`` called through
    ``torch.utils.checkpoint`` under the policy ``REPRO_REMAT`` names when
    the call is made.

    * ``full`` (the default): ``checkpoint(f, ..., use_reentrant=False)``;
      only the block's inputs are kept, and the backward replays the
      whole block.
    * ``dots``: the same call with a selective-checkpoint context that
      saves the outputs of ``aten.mm`` and ``aten.addmm`` (the matmuls
      without batch dims) and recomputes every other op.  Recomputed as
      under ``full``: ``bmm`` (the attention scores, the expert stacks),
      the analog reads inside ``core.tiled_analog.TapedMatmul`` and the
      fakequant kernel inside ``kernels.ops.FakequantRead``, none of which
      is a dot without batch dims in the reference either.
    * ``none``: ``f`` as it is.

    Remat changes only differentiation, so a call with grad disabled
    (serving) runs ``f`` bare under every policy.  The recomputed forward
    reads the same conductances and deposits nothing: the tape slots are
    written only by the original ``TapedMatmul`` node's backward, and no
    block draws a random number.  Callers thread no caches or states
    through a rematted block: their in-place updates would be replayed.
    """
    def run(*args):
        pol = remat_policy()
        if pol == "none" or not torch.is_grad_enabled():
            return f(*args)
        kw = {}
        if pol == "dots":
            kw["context_fn"] = partial(create_selective_checkpoint_contexts,
                                       _save_dots)
        return checkpoint(f, *args, use_reentrant=False, **kw)
    return run


def _layered(f: Callable, stack) -> Callable:
    """``f(lp, ...)`` with the layer's leaves gathered first when a
    numeric-parallel step runs (``NumericParallel.layer`` of the stack
    ``stack``); ``f`` itself otherwise.  Wrap it in :func:`_remat`."""
    npar = shardctx.numeric_context()
    if npar is None:
        return f

    def run(lp, *args):
        # installed again for a rematted backward's replay, which runs on
        # autograd's device thread for tensors on the card
        with shardctx.numeric_parallel(npar):
            return f(npar.layer(lp, stack), *args)
    return run


def _top(p: dict, key):
    """``p[key]`` (a path for a nested leaf), gathered whole for use when
    a numeric-parallel step runs (the embedding and the head keep their
    vocab split under its ``vocab`` plan)."""
    keys = (key,) if isinstance(key, str) else tuple(key)
    t = p
    for k in keys:
        t = t[k]
    npar = shardctx.numeric_context()
    return t if npar is None else npar.top(t, keys)


def dense_block_init(generator: torch.Generator, cfg: ModelConfig,
                     device=None) -> dict:
    return {"ln1": rmsnorm_init(cfg.d_model, device),
            "attn": attn_init(generator, cfg, device),
            "ln2": rmsnorm_init(cfg.d_model, device),
            "ffn": ffn_init(generator, cfg, device)}


def dense_block(p: dict, x: Tensor, cfg: ModelConfig, positions,
                cache) -> Tuple[Tensor, Optional[dict], Optional[Tensor]]:
    h, new_cache = attention(p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps),
                             cfg, positions=positions, cache=cache)
    x = x + h
    x = x + ffn(p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps), cfg)
    return x, new_cache, None


def moe_block_init(generator: torch.Generator, cfg: ModelConfig,
                   device=None) -> dict:
    """A MoE block; its attention is MLA when ``cfg.use_mla``."""
    attn = mla_init(generator, cfg, device) if cfg.use_mla \
        else attn_init(generator, cfg, device)
    return {"ln1": rmsnorm_init(cfg.d_model, device), "attn": attn,
            "ln2": rmsnorm_init(cfg.d_model, device),
            "moe": moe_mod.moe_init(generator, cfg, device)}


def moe_block(p: dict, x: Tensor, cfg: ModelConfig, positions,
              cache) -> Tuple[Tensor, Optional[dict], Tensor]:
    attend = mla_attention if cfg.use_mla else attention
    h, new_cache = attend(p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps),
                          cfg, positions=positions, cache=cache)
    x = x + h
    y, aux = moe_mod.moe_apply(p["moe"], rmsnorm(p["ln2"], x, cfg.norm_eps),
                               cfg)
    return x + y, new_cache, aux


def cross_block_init(generator: torch.Generator, cfg: ModelConfig,
                     device=None) -> dict:
    """The gated cross-attention block: ``xattn`` in the fused ``wqkv``
    layout (one wide array driven by both token streams), the FFN, and
    the two gates, which start at 0 as the reference's do (``tanh(0)``
    hides the block until training moves them)."""
    return {"ln1": rmsnorm_init(cfg.d_model, device),
            "xattn": attn_init(generator, cfg, device),
            "ln2": rmsnorm_init(cfg.d_model, device),
            "ffn": ffn_init(generator, cfg, device),
            "gate_attn": torch.zeros((), dtype=torch.float32, device=device),
            "gate_ffn": torch.zeros((), dtype=torch.float32, device=device)}


def cross_block(p: dict, x: Tensor, kv: Tensor, cfg: ModelConfig) -> Tensor:
    """Gated cross-attention block (llama-3.2-vision style): ``tanh`` of
    each gate scales its residual branch."""
    h, _ = attention(p["xattn"], rmsnorm(p["ln1"], x, cfg.norm_eps), cfg,
                     causal=False, x_kv=kv, use_rope=False)
    x = x + torch.tanh(p["gate_attn"]).to(x.dtype) * h
    h = ffn(p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps), cfg)
    return x + torch.tanh(p["gate_ffn"]).to(x.dtype) * h


def ssm_block_init(generator: torch.Generator, cfg: ModelConfig,
                   device=None) -> dict:
    return {"ln": rmsnorm_init(cfg.d_model, device),
            "ssm": ssm_mod.ssm_init(generator, cfg, device)}


def ssm_block(p: dict, x: Tensor, cfg: ModelConfig,
              state) -> Tuple[Tensor, Optional[dict]]:
    h, new_state = ssm_mod.ssm_apply(p["ssm"],
                                     rmsnorm(p["ln"], x, cfg.norm_eps),
                                     cfg, state=state)
    return x + h, new_state


def _stack(generator, n: int, init, cfg, device) -> dict:
    """``n`` blocks from ``init``, drawn one after another and stacked
    (n, ...) leaf by leaf."""
    return stack_trees((init(generator, cfg, device) for _ in range(n)), n)


def decoder_init(generator: torch.Generator, cfg: ModelConfig,
                 device=None) -> dict:
    block_init = moe_block_init if cfg.n_experts else dense_block_init
    p = {"embed": embed_init(generator, cfg.vocab, cfg.d_model, device),
         "layers": _stack(generator, cfg.n_layers, block_init, cfg, device),
         "final_ln": rmsnorm_init(cfg.d_model, device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = {"w": dense_init(generator, cfg.d_model, cfg.vocab,
                                        device)}
    return p


def _logits(p: dict, x: Tensor, cfg: ModelConfig,
            last_only: bool = False) -> Tensor:
    """The head's logits, of every position or (``last_only``, a prefill)
    of the last one alone: the norm and the head act per position.  Under
    a numeric step's ``vocab`` plan, this rank's vocab slice of them
    (serving: gathered in vocab order, whole on every rank)."""
    if last_only:
        x = x[:, -1:]
    x = rmsnorm(_top(p, "final_ln"), x, cfg.norm_eps)
    npar = shardctx.numeric_context()
    if npar is not None and npar.vocab:
        x = npar.col_input(x)
    if cfg.tie_embeddings:
        # the scale keeps init logits O(1) (embeddings are unit-variance)
        y = x.float() @ _top(p, "embed").T / (cfg.d_model ** 0.5)
    else:
        y = (x @ _top(p, ("lm_head", "w")).to(x.dtype)).float()
    if npar is not None and npar.vocab and npar.serve:
        y = npar.gather_model(y, -1)    # served whole: the vocab blocks
    return y


def _seq_on(npar, *lengths: int) -> bool:
    """Whether a step of the numeric context ``npar`` runs sequence
    parallel: its plan's ``seq``, and every sequence of the step (the
    tokens, whisper's frames) dividing over ``model``.  One answer for the
    whole step, however many stacks it runs."""
    return bool(npar.seq) and all(n % npar.m == 0 for n in lengths)


def _embed_lookup(p: dict, tokens: Tensor, cfg: ModelConfig,
                  frames: int = 0) -> Tensor:
    """The embedding of ``tokens``.  ``REPRO_EMBED_BF16`` casts the table
    to the compute dtype before the lookup (the reference's flag: a
    vocab-split lookup's sum then moves 2 bytes an element; each output
    element has one nonzero term, so the values are the same).  Under a
    numeric step's ``vocab`` plan each rank looks up the tokens of its
    vocab slice, zeros elsewhere, and the partial embeddings are summed
    over ``model`` (split along the sequence under ``seq``; ``frames``:
    the encoder's sequence, which must divide too)."""
    table = _top(p, "embed")
    if os.environ.get("REPRO_EMBED_BF16"):
        table = table.to(cdtype(cfg))
    npar = shardctx.numeric_context()
    if npar is None or not npar.vocab:
        if npar is not None:
            npar.sp_on = False
        return table[tokens].to(cdtype(cfg))
    rows = table.shape[0]
    idx = tokens.long() - npar.vocab_offset(rows)
    mine = (idx >= 0) & (idx < rows)
    e = table[idx.clamp(0, rows - 1)]
    e = torch.where(mine[..., None], e, torch.zeros((), dtype=e.dtype,
                                                    device=e.device))
    e = e.to(cdtype(cfg))
    npar.sp_on = e.ndim == 3 and _seq_on(npar, e.shape[1], frames)
    return npar.row_output(e)


def decoder_apply(p: dict, tokens: Tensor, cfg: ModelConfig, *,
                  caches=None, positions=None, last_only: bool = False
                  ) -> Tuple[Tensor, Any, Tensor]:
    """Logits of ``tokens`` (B, S) (of the last position alone, (B, 1, V),
    with ``last_only``), the caches (updated in place) and the aux loss
    summed over the layers (0 for the dense family)."""
    x = _embed_lookup(p, tokens, cfg)
    block = _layered(moe_block if cfg.n_experts else dense_block, "layers")
    if caches is None:
        block = _remat(block)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        cache = tree_index(caches, i) if caches is not None else None
        x, new_cache, a = block(tree_index(p["layers"], i), x, cfg,
                                positions, cache)
        if a is not None:
            aux = aux + a
        if caches is not None:
            caches["len"][i] = new_cache["len"]
    return _logits(p, x, cfg, last_only), caches, aux


# --------------------------------------------------------------------------
# VLM: [cross + (g - 1) self] x n_groups   (llama-3.2-vision)
# --------------------------------------------------------------------------

def vlm_init(generator: torch.Generator, cfg: ModelConfig,
             device=None) -> dict:
    """``n_groups = n_layers // cross_attn_every`` cross blocks and
    ``n_groups * (cross_attn_every - 1)`` self blocks, the latter stored
    flat (n_self, ...)."""
    g = cfg.cross_attn_every
    n_groups = cfg.n_layers // g
    return {"embed": embed_init(generator, cfg.vocab, cfg.d_model, device),
            "self_layers": _stack(generator, n_groups * (g - 1),
                                  dense_block_init, cfg, device),
            "cross_layers": _stack(generator, n_groups, cross_block_init,
                                   cfg, device),
            "final_ln": rmsnorm_init(cfg.d_model, device),
            "lm_head": {"w": dense_init(generator, cfg.d_model, cfg.vocab,
                                        device)}}


def vlm_apply(p: dict, tokens: Tensor, vision: Tensor, cfg: ModelConfig, *,
              caches=None, positions=None, last_only: bool = False
              ) -> Tuple[Tensor, Any, Tensor]:
    """Logits of ``tokens`` (B, S) with the vision stream ``vision`` (B,
    n_vision_tokens, d_model); each group is a cross block over the
    stream and ``g - 1`` self blocks, self layer ``gi * (g - 1) + j``
    with the cache ``caches[gi, j]`` (stacked (n_groups, g - 1, B, ...),
    updated in place).  Every call re-reads each cross block's ``wqkv``
    over the tokens and the whole stream, decode steps included."""
    x = _embed_lookup(p, tokens, cfg)
    vision = vision.to(cdtype(cfg))
    inner = cfg.cross_attn_every - 1
    self_block = _layered(dense_block, "self_layers")
    if caches is None:
        self_block = _remat(self_block)
    cross = _layered(cross_block, "cross_layers")
    for gi in range(cfg.n_layers // cfg.cross_attn_every):
        x = cross(tree_index(p["cross_layers"], gi), x, vision, cfg)
        for j in range(inner):
            cache = tree_index(tree_index(caches, gi), j) \
                if caches is not None else None
            x, new_cache, _ = self_block(
                tree_index(p["self_layers"], gi * inner + j), x, cfg,
                positions, cache)
            if caches is not None:
                caches["len"][gi, j] = new_cache["len"]
    return _logits(p, x, cfg, last_only), caches, \
        torch.zeros((), dtype=torch.float32, device=x.device)


# --------------------------------------------------------------------------
# Audio encoder-decoder (whisper)
# --------------------------------------------------------------------------

def _dec_block_init(generator: torch.Generator, cfg: ModelConfig,
                    device=None) -> dict:
    return {"ln1": rmsnorm_init(cfg.d_model, device),
            "attn": attn_init(generator, cfg, device),
            "lnx": rmsnorm_init(cfg.d_model, device),
            "xattn": attn_init(generator, cfg, device),  # fused wqkv
            "ln2": rmsnorm_init(cfg.d_model, device),
            "ffn": ffn_init(generator, cfg, device)}


def audio_init(generator: torch.Generator, cfg: ModelConfig,
               device=None) -> dict:
    """The encoder (dense blocks over the frames, a learned positional
    table ``enc_pos`` kept on the digital core) and the decoder (self-
    attention, fused-``wqkv`` cross-attention, FFN per layer)."""
    enc_pos = torch.empty((cfg.n_audio_frames, cfg.d_model),
                          dtype=torch.float32, device=device)
    return {"embed": embed_init(generator, cfg.vocab, cfg.d_model, device),
            "enc_pos": 0.02 * enc_pos.normal_(generator=generator),
            "enc_layers": _stack(generator, cfg.n_encoder_layers,
                                 dense_block_init, cfg, device),
            "enc_ln": rmsnorm_init(cfg.d_model, device),
            "dec_layers": _stack(generator, cfg.n_layers, _dec_block_init,
                                 cfg, device),
            "final_ln": rmsnorm_init(cfg.d_model, device),
            "lm_head": {"w": dense_init(generator, cfg.d_model, cfg.vocab,
                                        device)}}


def _enc_block(lp: dict, x: Tensor, cfg: ModelConfig) -> Tensor:
    """An encoder block: non-causal, rope-free attention and the FFN."""
    h, _ = attention(lp["attn"], rmsnorm(lp["ln1"], x, cfg.norm_eps), cfg,
                     causal=False, use_rope=False)
    x = x + h
    return x + ffn(lp["ffn"], rmsnorm(lp["ln2"], x, cfg.norm_eps), cfg)


def audio_encode(p: dict, frames: Tensor, cfg: ModelConfig,
                 n_tokens: int = 0) -> Tensor:
    """frames: (B, n_audio_frames, d_model), the stub conv frontend's
    output; non-causal, rope-free attention.  Under a numeric step's
    sequence parallelism (the frames and the decoder's ``n_tokens``
    dividing over ``model``) the encoder runs on this rank's chunk of the
    frames, ``enc_pos``'s rows of it added, and its output is gathered
    along the frames once, so that every decoder layer's cross read sees
    the whole stream."""
    x = frames.to(cdtype(cfg))
    pos = _top(p, "enc_pos").to(cdtype(cfg))
    npar = shardctx.numeric_context()
    sp = npar is not None and _seq_on(npar, x.shape[1], n_tokens)
    if npar is not None:
        npar.sp_on = sp
    if sp:
        c = x.shape[1] // npar.m
        x = npar.seq_split(x)
        pos = pos.narrow(0, npar.seq_offset(c), c)
    x = x + pos
    block = _remat(_layered(_enc_block, "enc_layers"))
    for i in range(cfg.n_encoder_layers):
        x = block(tree_index(p["enc_layers"], i), x, cfg)
    x = rmsnorm(_top(p, "enc_ln"), x, cfg.norm_eps)
    return npar.seq_gather(x) if sp else x


def _dec_block(lp: dict, x: Tensor, enc: Optional[Tensor], cfg: ModelConfig,
               positions, c) -> Tuple[Tensor, Optional[dict]]:
    """A decoder block (see :func:`audio_decode`): cached self-attention,
    the fused cross-attention, the FFN.  Fills ``c``'s cross keys and
    values in place when ``enc`` is given; returns the new self cache."""
    nq = cfg.n_heads * cfg.resolved_head_dim
    h, nc_self = attention(lp["attn"], rmsnorm(lp["ln1"], x, cfg.norm_eps),
                           cfg, positions=positions,
                           cache=c["self"] if c is not None else None)
    x = x + h
    hn = rmsnorm(lp["lnx"], x, cfg.norm_eps)
    xp = lp["xattn"]
    npar = shardctx.numeric_context()
    tp = npar is not None and npar.attn and c is None
    if enc is None:
        ck, cv = c["ck"].to(x.dtype), c["cv"].to(x.dtype)
        q = _split_heads(project(xp["wqkv"], hn, cfg)[..., :nq], cfg.n_heads)
    else:
        q, ck, cv = fused_qkv(xp, hn, cfg, tp, enc)
        if c is not None:
            c["ck"].copy_(ck)
            c["cv"].copy_(cv)
    o = _chunked_sdpa(q, ck, cv, causal=False)
    x = x + _out_project(xp, o.reshape(*o.shape[:2], -1), cfg,
                         npar if tp else None)
    x = x + ffn(lp["ffn"], rmsnorm(lp["ln2"], x, cfg.norm_eps), cfg)
    return x, nc_self


def audio_decode(p: dict, tokens: Tensor, enc: Optional[Tensor],
                 cfg: ModelConfig, *, caches=None, positions=None,
                 last_only: bool = False) -> Tuple[Tensor, Any, Tensor]:
    """The decoder stack.  Self-attention is cached, with rope (as the
    reference, not whisper's learned positions).  Cross-attention: with
    the encoder output ``enc`` (prefill, training), one read of the fused
    ``wqkv`` over the tokens and ``enc`` gives q and the cross keys and
    values, which fill the cache's ``ck`` / ``cv``; with ``enc`` None (a
    decode step) the token alone drives the whole ``wqkv``, q is sliced
    off, and ``ck`` / ``cv`` come from the cache: no encoder container is
    read.  The caches (``{"self", "ck", "cv"}`` stacked (L, B, ...)) are
    updated in place.  Only the fused ``wqkv`` layout exists (the
    reference's split layout has no initialiser)."""
    x = _embed_lookup(p, tokens, cfg, 0 if enc is None else enc.shape[1])
    block = _layered(_dec_block, "dec_layers")
    if caches is None:
        block = _remat(block)
    for i in range(cfg.n_layers):
        c = tree_index(caches, i) if caches is not None else None
        x, nc_self = block(tree_index(p["dec_layers"], i), x, enc, cfg,
                           positions, c)
        if caches is not None:
            caches["self"]["len"][i] = nc_self["len"]
    return _logits(p, x, cfg, last_only), caches, \
        torch.zeros((), dtype=torch.float32, device=x.device)


# --------------------------------------------------------------------------
# SSM / hybrid
# --------------------------------------------------------------------------

def ssm_stack_init(generator: torch.Generator, cfg: ModelConfig,
                   device=None) -> dict:
    p = {"embed": embed_init(generator, cfg.vocab, cfg.d_model, device),
         "layers": _stack(generator, cfg.n_layers, ssm_block_init, cfg,
                          device),
         "final_ln": rmsnorm_init(cfg.d_model, device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = {"w": dense_init(generator, cfg.d_model, cfg.vocab,
                                        device)}
    if cfg.attn_every:  # the shared attention block
        p["shared_in"] = proj_init(generator, 2 * cfg.d_model, cfg.d_model,
                                   cfg, device)
        p["shared_ln"] = rmsnorm_init(cfg.d_model, device)
        p["shared_ln2"] = rmsnorm_init(cfg.d_model, device)
        p["shared_attn"] = attn_init(generator, cfg, device)
        p["shared_ffn"] = ffn_init(generator, cfg, device)
    return p


def tape_slot(tapes, i: int, reps: int):
    """Application ``i`` of ``reps``'s slot of tapes popped off a tree
    (``core.tiled_analog.pop_tapes``): every tape leaf indexed along its
    leading (reps,) dim, a view, so the backward pass writes into the
    slot.  With one application the tapes have no such dim
    (``analog_registry.tape_lead`` gives (T,)) and are the slot."""
    if reps == 1:
        return tapes
    if isinstance(tapes, dict):
        return {k: tape_slot(v, i, reps) for k, v in tapes.items()}
    return tapes[i]


def ssm_stack_apply(p: dict, tokens: Tensor, cfg: ModelConfig, *,
                    states=None, shared_caches=None, positions=None,
                    last_only: bool = False
                    ) -> Tuple[Tensor, Any, Any, Tensor]:
    """Logits of ``tokens`` (B, S), the SSM states and the hybrid's shared
    K/V caches (both updated in place) and a zero aux loss."""
    x0 = _embed_lookup(p, tokens, cfg)
    x = x0
    block = _layered(ssm_block, "layers")
    if states is None:
        block = _remat(block)
    k = cfg.attn_every
    if k:
        shared_clean, shared_tapes, has_tapes = pop_tapes(
            {"in": _top(p, "shared_in"), "attn": _top(p, "shared_attn"),
             "ffn": _top(p, "shared_ffn")})
    for i in range(cfg.n_layers):
        st = tree_index(states, i) if states is not None else None
        x, new_st = block(tree_index(p["layers"], i), x, cfg, st)
        if states is not None:
            for key, leaf in states.items():
                leaf[i].copy_(new_st[key])
        if not k or (i + 1) % k:
            continue
        # the shared block after group gi: its own tape slot, its own cache
        gi = i // k
        sp = push_tapes(shared_clean, tape_slot(shared_tapes, gi,
                                                cfg.n_layers // k)) \
            if has_tapes else shared_clean
        cache = tree_index(shared_caches, gi) \
            if shared_caches is not None else None
        h_in = project(sp["in"], torch.cat([x, x0], dim=-1), cfg, tp=SEQ)
        h1, new_cache = attention(
            sp["attn"], rmsnorm(_top(p, "shared_ln"), h_in, cfg.norm_eps),
            cfg, positions=positions, cache=cache)
        x = x + h1
        x = x + ffn(sp["ffn"], rmsnorm(_top(p, "shared_ln2"), x,
                                       cfg.norm_eps), cfg)
        if shared_caches is not None:
            shared_caches["len"][gi] = new_cache["len"]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _logits(p, x, cfg, last_only), states, shared_caches, aux
