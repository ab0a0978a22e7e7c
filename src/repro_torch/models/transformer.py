"""Decoder stack, dense and MoE families, MoE with MLA attention (port
of the decoder-only parts of ``repro.models.transformer``).

Per-layer parameters are stacked along a leading (L, ...) dim, as the
reference's scan expects; the stack runs as a Python loop over the
stacked tensors.  Caches use the same stacked layout and are updated in
place (see ``layers.attention``).  The MoE blocks' aux losses are summed
over the layers, as the reference's scan carries them.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tiled_analog import stack_trees

from . import moe as moe_mod
from .layers import (attention, attn_init, cdtype, dense_init, embed_init,
                     ffn, ffn_init, mla_attention, mla_init, rmsnorm,
                     rmsnorm_init)

Tensor = torch.Tensor


def tree_index(tree, i: int):
    """Leaf-wise ``tree[i]`` (views) of a stacked dict tree."""
    if isinstance(tree, dict):
        return {k: tree_index(v, i) for k, v in tree.items()}
    return tree[i]


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


def decoder_init(generator: torch.Generator, cfg: ModelConfig,
                 device=None) -> dict:
    block_init = moe_block_init if cfg.n_experts else dense_block_init
    p = {"embed": embed_init(generator, cfg.vocab, cfg.d_model, device),
         "layers": stack_trees((block_init(generator, cfg, device)
                                for _ in range(cfg.n_layers)), cfg.n_layers),
         "final_ln": rmsnorm_init(cfg.d_model, device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = {"w": dense_init(generator, cfg.d_model, cfg.vocab,
                                        device)}
    return p


def _logits(p: dict, x: Tensor, cfg: ModelConfig) -> Tensor:
    x = rmsnorm(p["final_ln"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        # the scale keeps init logits O(1) (embeddings are unit-variance)
        return x.float() @ p["embed"].T / (cfg.d_model ** 0.5)
    return (x @ p["lm_head"]["w"].to(x.dtype)).float()


def _embed_lookup(p: dict, tokens: Tensor, cfg: ModelConfig) -> Tensor:
    return p["embed"][tokens].to(cdtype(cfg))


def decoder_apply(p: dict, tokens: Tensor, cfg: ModelConfig, *,
                  caches=None, positions=None) -> Tuple[Tensor, Any, Tensor]:
    """Logits of ``tokens`` (B, S), the caches (updated in place) and the
    aux loss summed over the layers (0 for the dense family)."""
    x = _embed_lookup(p, tokens, cfg)
    block = moe_block if cfg.n_experts else dense_block
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        cache = tree_index(caches, i) if caches is not None else None
        x, new_cache, a = block(tree_index(p["layers"], i), x, cfg,
                                positions, cache)
        if a is not None:
            aux = aux + a
        if caches is not None:
            caches["len"][i] = new_cache["len"]
    return _logits(p, x, cfg), caches, aux
