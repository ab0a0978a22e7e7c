"""Model API over every family: the dense and MoE decoders, the VLM,
the audio encoder-decoder, the SSM (Mamba-2) and hybrid (Zamba-2) stacks
(port of ``repro.models.model``).

    params         = init_params(cfg, generator, device="cuda")
    loss, metrics  = loss_fn(params, batch, cfg)
    logits, cache  = prefill(params, batch, cfg, max_len)
    logits, cache  = decode_step(params, cache, tokens, cfg, batch_extras)
    logits, cache  = prefill_chunk(params, cache, tokens, cfg, batch_extras)
    cache          = init_cache(cfg, batch, max_len, device)
    batch          = input_specs(cfg, shape)          # meta tensors
    cache          = cache_specs(cfg, batch, max_len)  # meta tensors

``batch`` holds ``tokens`` (and ``labels`` for the loss) and, for the
cross-attention families, the stub frontends' stream: ``{"vision": (B,
n_vision_tokens, d)}`` or ``{"audio": (B, n_audio_frames, d)}``; decode
steps take it as ``batch_extras``.

A cache is the pair ``(caches, shared)`` of the reference: per-layer K/V
(or latent) caches, or SSM states, stacked (L, B, ...); the VLM's self
caches stacked (n_groups, cross_attn_every - 1, B, ...); the audio
decoder's ``{"self": K/V, "ck", "cv": cross K/V over the frames}``
stacked (L, B, ...); and the hybrid's shared-block K/V caches stacked
(n_groups, B, ...) (None for the other families).  Its tensors are
updated in place by the functions that take it, which return it for the
caller's convenience.  The SSM family has no positions (``cache_lens``
is None) and no chunked prefill.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core import shardctx
from repro_torch.core.analog_registry import (EXPERT_BATCHED, KINDS,
                                              classify, classify_param)
from repro_torch.core.tiled_analog import (crossbar_from_model,
                                           is_analog_container,
                                           program_stacked)

from . import transformer as tf
from .layers import cdtype, make_cache, make_mla_cache, proj_readout
from .ssm import make_ssm_state

Tensor = torch.Tensor


# --------------------------------------------------------------------------
# init / forward
# --------------------------------------------------------------------------

def init_params(cfg: ModelConfig,
                generator: Union[torch.Generator, int] = 0,
                device="cuda") -> dict:
    """Random parameters from ``generator`` (a torch.Generator on
    ``device``, or an int seed for one).  MoE expert stacks are drawn
    (and in device mode programmed) one expert matrix at a time.  On the
    ``meta`` device nothing is drawn (the generator is ignored): the tree
    carries the shapes and dtypes the program allocates, and nothing
    else (the dry run's abstract state)."""
    if torch.device(device).type == "meta":
        generator = None
    elif isinstance(generator, int):
        seed, generator = generator, torch.Generator(device=device)
        generator.manual_seed(seed)
    if cfg.family == "vlm":
        return tf.vlm_init(generator, cfg, device)
    if cfg.family == "audio":
        return tf.audio_init(generator, cfg, device)
    if cfg.family in ("ssm", "hybrid"):
        return tf.ssm_stack_init(generator, cfg, device)
    return tf.decoder_init(generator, cfg, device)


def readout_digital(params, cfg: ModelConfig, path=()):
    """Serial read of an analog-device model back to digital weights: every
    container becomes ``{"w": (g - ref) / w_scale}``, an expert-batched
    container the raw (E, K, N) weight stack (the registry decides which
    is which)."""
    if is_analog_container(params):
        rd = proj_readout(params, cfg)
        return rd["w"] if classify(path) == EXPERT_BATCHED else rd
    if isinstance(params, dict):
        return {k: readout_digital(v, cfg, path + (k,))
                for k, v in params.items()}
    return params


def program_digital(params, cfg: ModelConfig, path=()):
    """Inverse of :func:`readout_digital`: program a digital tree's
    crossbar-consumer projections (``{"w"}`` dicts and raw expert stacks)
    onto containers under ``cfg``'s device model, one calibration per
    matrix; digital-core matrices (embeddings, router, norms) pass
    through.  ``cfg`` must resolve to device mode."""
    if cfg.resolved_analog_mode.value != "device":
        raise ValueError(
            "program_digital needs a device-mode config (analog=True, "
            f"analog_mode='device'); got {cfg.resolved_analog_mode.value!r}")
    if isinstance(params, dict):
        if set(params) == {"w"} and classify_param(path) in KINDS:
            return program_stacked(params["w"], crossbar_from_model(cfg))
        return {k: program_digital(v, cfg, path + (k,))
                for k, v in params.items()}
    if getattr(params, "ndim", 0) >= 2 and classify_param(path) in KINDS:
        return program_stacked(params, crossbar_from_model(cfg))
    return params


def _forward(params: dict, batch: Dict[str, Tensor], cfg: ModelConfig,
             caches=None, positions=None, shared_caches=None,
             last_only: bool = False):
    """``(logits, caches, shared_caches, aux)``, as the reference's
    ``forward`` returns them: :func:`forward` with the shared caches and
    the aux loss; with ``last_only`` the logits of the last position
    alone, (B, 1, V).  An audio decode step (caches given, one token)
    skips the encoder: the cross keys and values come from the caches."""
    tokens = batch["tokens"]
    kw = dict(positions=positions, last_only=last_only)
    if cfg.family == "vlm":
        logits, caches, aux = tf.vlm_apply(params, tokens, batch["vision"],
                                           cfg, caches=caches, **kw)
        return logits, caches, None, aux
    if cfg.family == "audio":
        enc = None if caches is not None and tokens.shape[1] == 1 \
            else tf.audio_encode(params, batch["audio"], cfg,
                                 tokens.shape[1])
        logits, caches, aux = tf.audio_decode(params, tokens, enc, cfg,
                                              caches=caches, **kw)
        return logits, caches, None, aux
    if cfg.family in ("ssm", "hybrid"):
        return tf.ssm_stack_apply(params, tokens, cfg, states=caches,
                                  shared_caches=shared_caches, **kw)
    logits, caches, aux = tf.decoder_apply(params, tokens, cfg,
                                           caches=caches, **kw)
    return logits, caches, None, aux


def forward(params: dict, batch: Dict[str, Tensor], cfg: ModelConfig,
            caches=None, positions=None, shared_caches=None):
    """Returns ``(logits, caches)``; ``caches`` (and the hybrid's
    ``shared_caches``) are updated in place.  :func:`_forward` also
    returns the shared caches and the aux loss."""
    logits, caches, _, _ = _forward(params, batch, cfg, caches, positions,
                                    shared_caches)
    return logits, caches


def loss_fn(params: dict, batch: Dict[str, Tensor], cfg: ModelConfig):
    """Mean next-token cross-entropy plus ``0.01 * aux``, the MoE layers'
    Switch load-balancing loss summed over the layers (0 for the dense
    family).  Returns ``(total, {"ce", "aux"})``; cross-entropy is
    logsumexp minus the true logit."""
    logits, _, _, aux = _forward(params, batch, cfg)
    logits = logits.float()
    npar = shardctx.numeric_context()
    if npar is not None and npar.vocab:
        lse, true_logit = _vocab_parallel_ce(logits, batch["labels"], npar)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        true_logit = torch.gather(logits, -1,
                                  batch["labels"].long()[..., None])[..., 0]
    loss = torch.mean(lse - true_logit)
    return loss + 0.01 * aux, {"ce": loss, "aux": aux}


def _vocab_parallel_ce(logits: Tensor, labels: Tensor, npar):
    """``(logsumexp, true logit)`` from this rank's vocab slice of the
    logits (a numeric step's ``vocab`` plan): the max and the sum of
    exponentials all-reduced over ``model`` (the max carries no
    gradient: the logsumexp does not depend on it), the true logit
    taken from the rank that holds it and summed."""
    mesh, axes = npar.mesh, npar.tp
    m = logits.detach().amax(dim=-1)
    for a in axes:
        m = mesh.all_reduce(m, a, op="max")
    se = shardctx.reduce_from(torch.sum(torch.exp(logits - m[..., None]),
                                        dim=-1), mesh, axes)
    rows = logits.shape[-1]
    idx = labels.long() - npar.vocab_offset(rows)
    mine = (idx >= 0) & (idx < rows)
    t = torch.gather(logits, -1, idx.clamp(0, rows - 1)[..., None])[..., 0]
    t = torch.where(mine, t, torch.zeros((), device=t.device))
    return m + torch.log(se), shardctx.reduce_from(t, mesh, axes)


# --------------------------------------------------------------------------
# caches / serving
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """``(caches, shared)``: K/V caches stacked (L, B, ...) per leaf (with
    MLA the latent ``c_kv`` and the shared rope key ``k_rope``), the
    VLM's self caches stacked (n_groups, cross_attn_every - 1, B, ...),
    the audio decoder's ``{"self": K/V, "ck", "cv"}`` stacked (L, B,
    ...) with the cross K/V over ``n_audio_frames``, or the SSM states
    ``h`` and ``conv``; ``shared`` the hybrid's shared-block K/V caches
    stacked (n_groups, B, ...), else None."""
    def stack(one, *lead):
        if isinstance(one, dict):
            return {k: stack(v, *lead) for k, v in one.items()}
        return one.expand(*lead, *one.shape).clone()
    if cfg.family == "vlm":
        g = cfg.cross_attn_every
        return stack(make_cache(cfg, batch, max_len, device),
                     cfg.n_layers // g, g - 1), None
    if cfg.family == "audio":
        cross = torch.zeros((batch, cfg.n_audio_frames, cfg.n_kv_heads,
                             cfg.resolved_head_dim), dtype=cdtype(cfg),
                            device=device)
        return stack({"self": make_cache(cfg, batch, max_len, device),
                      "ck": cross, "cv": cross}, cfg.n_layers), None
    if cfg.family in ("ssm", "hybrid"):
        states = stack(make_ssm_state(cfg, batch, device), cfg.n_layers)
        shared = None
        if cfg.family == "hybrid":
            shared = stack(make_cache(cfg, batch, max_len, device),
                           cfg.n_layers // cfg.attn_every)
        return states, shared
    make = make_mla_cache if cfg.use_mla else make_cache
    return stack(make(cfg, batch, max_len, device), cfg.n_layers), None


def input_specs(cfg: ModelConfig, shape: ShapeSpec,
                batch: Optional[int] = None, device="meta"
                ) -> Dict[str, Tensor]:
    """Every model input of one dry-run cell, as tensors on ``device``
    (``meta``: shapes and dtypes, nothing allocated): ``tokens`` (and
    ``labels`` for a training step) int32 (B, S), or (B,) for a decode
    step; the cross-attention families' stream (``vision`` or ``audio``,
    (B, tokens, d) in the config's activation dtype).  ``batch``
    overrides ``shape.global_batch`` (one data-parallel rank's share)."""
    b = shape.global_batch if batch is None else batch
    dims = (b, shape.seq_len) if shape.kind in ("train", "prefill") \
        else (b,)
    out = {"tokens": torch.zeros(dims, dtype=torch.int32, device=device)}
    if shape.kind == "train":
        out["labels"] = torch.zeros(dims, dtype=torch.int32, device=device)
    stream = {"vlm": ("vision", cfg.n_vision_tokens),
              "audio": ("audio", cfg.n_audio_frames)}.get(cfg.family)
    if stream is not None:
        out[stream[0]] = torch.zeros((b, stream[1], cfg.d_model),
                                     dtype=cdtype(cfg), device=device)
    return out


def cache_specs(cfg: ModelConfig, batch: int, max_len: int):
    """The cache :func:`init_cache` allocates, on the ``meta`` device."""
    return init_cache(cfg, batch, max_len, "meta")


def prefill(params: dict, batch: Dict[str, Tensor], cfg: ModelConfig,
            max_len: int):
    """Run the prompt (and the batch's stream, for the cross-attention
    families) through the model: last-token logits and a cache sized
    ``max_len``.  The head reads the last position alone (B rows, not B
    x S: the reference's forms every position's logits and keeps the
    last)."""
    b = batch["tokens"].shape[0]
    caches, shared = init_cache(cfg, b, max_len, batch["tokens"].device)
    logits, caches, shared, _ = _forward(params, batch, cfg, caches=caches,
                                         shared_caches=shared,
                                         last_only=True)
    return logits[:, -1], (caches, shared)


def decode_step(params: dict, cache, tokens: Tensor, cfg: ModelConfig,
                batch_extras: Optional[Dict[str, Tensor]] = None):
    """One decode step.  tokens: (B,).  Returns (logits, cache).  The
    positions are the cache's lengths (None for the SSM family).
    ``batch_extras`` carries the stream of a cross-attention family (the
    VLM re-reads it every step; the audio decoder reads its cached cross
    keys and values instead)."""
    caches, shared = cache
    lens = cache_lens(cache, cfg)
    positions = None if lens is None else lens[:, None]
    logits, caches, shared, _ = _forward(
        params, {"tokens": tokens[:, None], **(batch_extras or {})}, cfg,
        caches=caches, positions=positions, shared_caches=shared)
    return logits[:, -1], (caches, shared)


def prefill_chunk(params: dict, cache, tokens: Tensor, cfg: ModelConfig,
                  batch_extras: Optional[Dict[str, Tensor]] = None):
    """Append a chunk of prompt tokens (B, S) to an existing cache; each
    row's chunk is written at its current length and attends causally to
    the filled prefix.  Returns (chunk logits (B, S, V), cache); rows
    advance by S (``cache_with_lens`` fixes a padded final chunk).  The
    SSM family has no positional cache and raises, as the reference
    does."""
    caches, shared = cache
    lens = cache_lens(cache, cfg)
    if lens is None:
        raise ValueError(
            f"family {cfg.family!r} has no positional cache; "
            "chunked prefill is unsupported — use prefill()")
    positions = lens[:, None] + torch.arange(tokens.shape[1],
                                             device=tokens.device)[None, :]
    logits, caches, shared, _ = _forward(
        params, {"tokens": tokens, **(batch_extras or {})}, cfg,
        caches=caches, positions=positions, shared_caches=shared)
    return logits, (caches, shared)


def cache_lens(cache, cfg: ModelConfig) -> Optional[Tensor]:
    """Per-row filled lengths of a cache, (B,) (a copy: the cache's own
    length tensors advance in place while a model call runs); None for
    the positionless SSM family, the shared caches' for the hybrid, the
    first self layer's for the VLM and the audio decoder."""
    caches, shared = cache
    if cfg.family == "ssm":
        return None
    if cfg.family == "hybrid":
        return shared["len"][0].clone() if shared is not None else None
    if cfg.family == "vlm":
        return caches["len"][0, 0].clone()
    if cfg.family == "audio":
        return caches["self"]["len"][0].clone()
    return caches["len"][0].clone()


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    elif tree is not None:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def cache_with_lens(cache, lens: Tensor):
    """Set every per-row length leaf of ``cache`` to ``lens`` (B,), in
    place."""
    for path, leaf in _leaves(cache):
        if path[-1] == "len":
            leaf.copy_(torch.broadcast_to(lens.to(leaf.dtype), leaf.shape))
    return cache


def cache_batch_axes(cfg: ModelConfig, max_len: int) -> dict:
    """Batch-dim index of every cache leaf, by path, found by comparing
    shapes at two batch sizes (meta tensors: nothing is allocated)."""
    a = dict(_leaves(init_cache(cfg, 2, max_len, "meta")))
    b = dict(_leaves(init_cache(cfg, 3, max_len, "meta")))
    axes = {}
    for path, x in a.items():
        diff = [i for i, (p, q) in enumerate(zip(x.shape, b[path].shape))
                if p != q]
        if not diff:
            raise ValueError(f"no batch dim found in cache leaf {path}")
        axes[path] = diff[0]
    return axes


def cache_insert(dst, src, slot: int, axes: dict):
    """Copy the rows of ``src`` (a cache built with a smaller batch) into
    ``dst`` from batch row ``slot`` on, in place."""
    for path, d in _leaves(dst):
        s = _get(src, path)
        ax = axes[path]
        d.narrow(ax, slot, s.shape[ax]).copy_(s)
    return dst


def cache_reset_row(cache, slot: int, axes: dict):
    """Zero batch row ``slot`` of a cache, in place (a freed slot holds no
    stale K/V and its length is 0)."""
    for path, d in _leaves(cache):
        d.narrow(axes[path], slot, 1).zero_()
    return cache


def params_device(params) -> torch.device:
    """The device the parameter tree lives on."""
    return next(leaf for _, leaf in _leaves(params)).device


__all__ = ["init_params", "readout_digital", "program_digital", "forward",
           "loss_fn",
           "init_cache", "input_specs", "cache_specs", "prefill",
           "decode_step", "prefill_chunk",
           "cache_lens", "cache_with_lens", "cache_batch_axes",
           "cache_insert", "cache_reset_row", "params_device"]
