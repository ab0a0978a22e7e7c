"""Model API, dense and MoE decoder families (port of
``repro.models.model``).

    params         = init_params(cfg, generator, device="cuda")
    loss, metrics  = loss_fn(params, batch, cfg)
    logits, cache  = prefill(params, batch, cfg, max_len)
    logits, cache  = decode_step(params, cache, tokens, cfg)
    logits, cache  = prefill_chunk(params, cache, tokens, cfg)
    cache          = init_cache(cfg, batch, max_len, device)

A cache is the pair ``(caches, shared)`` of the reference, ``shared``
being None for this family; its tensors are updated in place by the
functions that take it, which return it for the caller's convenience.
Other families raise and are queued in ROADMAP.md.
"""
from __future__ import annotations

from typing import Dict, Union

import torch

from repro_torch.configs.base import PORTED_FAMILIES, ModelConfig
from repro_torch.core.analog_registry import (EXPERT_BATCHED, KINDS,
                                              classify, classify_param)
from repro_torch.core.tiled_analog import (crossbar_from_model,
                                           is_analog_container,
                                           program_stacked)

from . import transformer as tf
from .layers import make_cache, make_mla_cache, proj_readout

Tensor = torch.Tensor


def _ported_only(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; see ROADMAP.md")


# --------------------------------------------------------------------------
# init / forward
# --------------------------------------------------------------------------

def init_params(cfg: ModelConfig,
                generator: Union[torch.Generator, int] = 0,
                device="cuda") -> dict:
    """Random parameters from ``generator`` (a torch.Generator on
    ``device``, or an int seed for one).  MoE expert stacks are drawn
    (and in device mode programmed) one expert matrix at a time."""
    _ported_only(cfg)
    if isinstance(generator, int):
        seed, generator = generator, torch.Generator(device=device)
        generator.manual_seed(seed)
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
             caches=None, positions=None):
    """``(logits, caches, aux)``: :func:`forward` with the aux loss."""
    _ported_only(cfg)
    return tf.decoder_apply(params, batch["tokens"], cfg, caches=caches,
                            positions=positions)


def forward(params: dict, batch: Dict[str, Tensor], cfg: ModelConfig,
            caches=None, positions=None):
    """Returns ``(logits, caches)``; ``caches`` are updated in place."""
    logits, caches, _ = _forward(params, batch, cfg, caches, positions)
    return logits, caches


def loss_fn(params: dict, batch: Dict[str, Tensor], cfg: ModelConfig):
    """Mean next-token cross-entropy plus ``0.01 * aux``, the MoE layers'
    Switch load-balancing loss summed over the layers (0 for the dense
    family).  Returns ``(total, {"ce", "aux"})``; cross-entropy is
    logsumexp minus the true logit."""
    logits, _, aux = _forward(params, batch, cfg)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    true_logit = torch.gather(logits, -1,
                              batch["labels"].long()[..., None])[..., 0]
    loss = torch.mean(lse - true_logit)
    return loss + 0.01 * aux, {"ce": loss, "aux": aux}


# --------------------------------------------------------------------------
# caches / serving
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """``(caches, shared)`` with caches stacked (L, B, ...) per leaf: K/V,
    or with MLA the latent ``c_kv`` and the shared rope key ``k_rope``."""
    _ported_only(cfg)
    make = make_mla_cache if cfg.use_mla else make_cache
    one = make(cfg, batch, max_len, device)
    caches = {k: v[None].repeat(cfg.n_layers, *([1] * v.ndim))
              for k, v in one.items()}
    return caches, None


def prefill(params: dict, batch: Dict[str, Tensor], cfg: ModelConfig,
            max_len: int):
    """Run the prompt through the model: last-token logits and a cache
    sized ``max_len``."""
    b = batch["tokens"].shape[0]
    caches, shared = init_cache(cfg, b, max_len, batch["tokens"].device)
    logits, caches = forward(params, batch, cfg, caches=caches)
    return logits[:, -1], (caches, shared)


def decode_step(params: dict, cache, tokens: Tensor, cfg: ModelConfig):
    """One decode step.  tokens: (B,).  Returns (logits, cache)."""
    caches, shared = cache
    positions = cache_lens(cache, cfg)[:, None]
    logits, caches = forward(params, {"tokens": tokens[:, None]}, cfg,
                             caches=caches, positions=positions)
    return logits[:, -1], (caches, shared)


def prefill_chunk(params: dict, cache, tokens: Tensor, cfg: ModelConfig):
    """Append a chunk of prompt tokens (B, S) to an existing cache; each
    row's chunk is written at its current length and attends causally to
    the filled prefix.  Returns (chunk logits (B, S, V), cache); rows
    advance by S (``cache_with_lens`` fixes a padded final chunk)."""
    caches, shared = cache
    lens = cache_lens(cache, cfg)
    positions = lens[:, None] + torch.arange(tokens.shape[1],
                                             device=tokens.device)[None, :]
    logits, caches = forward(params, {"tokens": tokens}, cfg, caches=caches,
                             positions=positions)
    return logits, (caches, shared)


def cache_lens(cache, cfg: ModelConfig) -> Tensor:
    """Per-row filled lengths of a cache, (B,) (a copy: the cache's own
    length tensors advance in place while a model call runs)."""
    _ported_only(cfg)
    return cache[0]["len"][0].clone()


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
           "init_cache", "prefill", "decode_step", "prefill_chunk",
           "cache_lens", "cache_with_lens", "cache_batch_axes",
           "cache_insert", "cache_reset_row", "params_device"]
