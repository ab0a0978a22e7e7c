"""Sharding policy over shapes: parameters, batches, caches and
tiled-crossbar analog containers (port of ``repro.launch.sharding``).

A *spec* is a tuple with one entry per dim: ``None`` (replicated) or a
tuple of mesh axis names the dim splits over, major axis first (the
reference's ``PartitionSpec``).  The rules are the reference's:

  * TP over ``model``, FSDP over (pod, data), EP experts over ``model``,
    SP cache sequence over ``model``, DP batch over (pod, data);
  * analog containers shard at *whole-tile* granularity: row tiles over
    the FSDP axes, column tiles over ``model`` (flipped for row-parallel
    consumers), the layer dim never;
  * every rule degrades to replication when divisibility fails.

The functions read only ``mesh.shape`` (axis -> size) and
``mesh.axis_names``, so any object with those two serves (a test's fake
mesh, ``launch.mesh.emulated_mesh``).  :func:`shard_block` cuts this
rank's block out of a whole tensor and :func:`unshard` gathers the blocks
back in at-rest order.
"""
from __future__ import annotations

import math
import os
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import (AnalogMode, ModelConfig,
                                      resolve_analog_mode)
from repro_torch.core import analog_registry as registry
from repro_torch.core.analog_registry import ANALOG_LEAVES
from repro_torch.core.shardctx import (ShardMeta, combine_partials_exact,
                                       flat_index)

from .mesh import dp_axes

Tensor = torch.Tensor
Spec = Tuple[Optional[Tuple[str, ...]], ...]


def _names(names) -> Optional[Tuple[str, ...]]:
    if names is None:
        return None
    return (names,) if isinstance(names, str) else tuple(names)


def _axis_size(mesh, names) -> int:
    names = _names(names)
    if names is None:
        return 1
    return math.prod(mesh.shape[a] for a in names)


def _fit(mesh, dim: int, names):
    """``names`` if they divide ``dim``, else ``None`` (replicate)."""
    names = _names(names)
    if names is None:
        return None
    size = _axis_size(mesh, names)
    if size > 1 and dim % size == 0:
        return names
    return None


def _tile_fit(mesh, dim: int, names, tile: int):
    """``names`` if they divide ``dim`` at whole-*tile* granularity, else
    ``None``: a shard owns whole ``rows x cols`` arrays, so the write's
    per-(layer, tile) PRNG streams and the per-tile ADC stay with one
    owner."""
    names = _names(names)
    if names is None:
        return None
    size = _axis_size(mesh, names)
    if size > 1 and dim % (size * tile) == 0:
        return names
    return None


def _logical_axes(mesh, logical):
    """The registry's logical axes on a concrete mesh: ``"tp"`` and
    ``"ep"`` are the model axis, ``"fsdp"`` the data axes."""
    if logical is None:
        return None
    if logical in ("tp", "ep"):
        return ("model",)
    if logical == "fsdp":
        return dp_axes(mesh)
    raise KeyError(logical)


def analog_container_pspec(sp, shape, cfg: ModelConfig, mesh,
                           leaf: str) -> Spec:
    """Spec of one leaf of a tiled-crossbar container: the registry's
    ``leaf_layout`` (per-dim logical axis and tile granularity, from the
    container's consumer kind) on this mesh, each dim that does not
    divide at whole-tile granularity replicated."""
    rows, cols = cfg.analog_rows, cfg.analog_cols
    kind = registry.classify(sp)
    layout = registry.leaf_layout(kind, len(shape), leaf, rows, cols)
    return tuple(_tile_fit(mesh, dim, _logical_axes(mesh, logical), tile)
                 for dim, (logical, tile) in zip(shape, layout))


def analog_update_specs(path: Sequence[str], g_shape, cfg: ModelConfig,
                        mesh) -> Dict[str, Spec]:
    """Specs of one container's rank-k write: ``g`` (also ``ref`` and
    ``g_carry``), the two tapes (the token dim never sharded), the
    per-layer scale and ``w_scale``, all tile-aligned, so every shard owns
    whole tiles and the token contraction stays local."""
    sp = list(path)
    lead = tuple(g_shape[:-2])
    k, n = g_shape[-2:]
    tapes_lead = (*lead, 1)
    w_scale_spec = analog_container_pspec(sp, lead, cfg, mesh, "w_scale")
    g_spec = analog_container_pspec(sp, g_shape, cfg, mesh, "g")
    return {"g": g_spec, "g_carry": g_spec,
            "x_tape": analog_container_pspec(sp, (*tapes_lead, k), cfg, mesh,
                                             "x_tape"),
            "d_tape": analog_container_pspec(sp, (*tapes_lead, n), cfg, mesh,
                                             "d_tape"),
            "scale": w_scale_spec, "w_scale": w_scale_spec}


def _analog_training(cfg: ModelConfig) -> bool:
    return resolve_analog_mode(cfg) is AnalogMode.DEVICE


def param_pspec(path: Sequence, shape, cfg: ModelConfig, mesh) -> Spec:
    """Spec of one parameter leaf of shape ``shape`` at tree path
    ``path`` (the reference's digital rules; containers by tiles)."""
    sp = [str(k) for k in path]
    shape = tuple(shape)
    dp = dp_axes(mesh)

    def spec2d(d0_axes, d1_axes):
        lead = len(shape) - 2
        out = [None] * lead
        if "experts" in sp and lead >= 1:
            # EP: the expert dim takes the model axis; the inner dims only
            # FSDP-shard
            out[lead - 1] = _fit(mesh, shape[lead - 1], "model")
            out.append(_fit(mesh, shape[-2], dp))
            out.append(None)
            return tuple(out)
        out.append(_fit(mesh, shape[-2], d0_axes))
        out.append(_fit(mesh, shape[-1], d1_axes))
        return tuple(out)

    last_key = sp[-1] if sp else ""
    if _analog_training(cfg) and last_key in ANALOG_LEAVES:
        return analog_container_pspec(sp, shape, cfg, mesh, last_key)
    if os.environ.get("REPRO_FLAT_DP"):
        out = [None] * len(shape)
        for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
            ax = _fit(mesh, shape[i], dp)
            if ax is not None:
                out[i] = ax
                break
        return tuple(out)
    last = sp[-1]
    if last == "embed":
        return (_fit(mesh, shape[0], "model"), _fit(mesh, shape[1], dp))
    if "lm_head" in sp:
        return spec2d(dp, "model")
    if last == "enc_pos":
        return (None, None)
    if len(shape) < 2:
        return (None,) * len(shape)
    if os.environ.get("REPRO_SSM_FSDP") and \
            any(k in sp for k in ("in_proj", "out_proj")):
        return spec2d(dp, None)
    if any(k in sp for k in ("wq", "wk", "wv", "wqkv", "w_up", "w_gate",
                             "w_upgate", "wkv_b", "in_proj", "xattn")):
        if "wo" in sp:
            return spec2d("model", dp)
        return spec2d(dp, "model")
    if any(k in sp for k in ("wo", "w_down", "out_proj")):
        return spec2d("model", dp)
    if "shared_in" in sp:
        return spec2d(dp, None)
    return (None,) * len(shape)


def _map_leaves(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_map_leaves(fn, v, path + (str(i),))
                     for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def params_shardings(params, cfg: ModelConfig, mesh):
    """The tree of specs of a parameter tree (leaves: anything with a
    ``shape``)."""
    return _map_leaves(lambda path, leaf: param_pspec(path, leaf.shape, cfg,
                                                      mesh), params)


def analog_params_shardings(params, cfg: ModelConfig, mesh):
    """Specs of a parameter tree for the sharded analog step: containers
    split at tile granularity (:func:`analog_container_pspec`), every
    digital leaf (embeddings, norms, the head, routers) replicated, so
    the digital compute runs replicated and the step stays bit-identical
    to one device on any mesh."""
    def spec(path, leaf):
        last = path[-1] if path else ""
        if last in ANALOG_LEAVES:
            return analog_container_pspec(path, leaf.shape, cfg, mesh, last)
        return (None,) * len(leaf.shape)
    return _map_leaves(spec, params)


def batch_shardings(batch, mesh):
    """Specs of a batch: the leading dim over the data axes."""
    dp = dp_axes(mesh)

    def spec(path, leaf):
        if len(leaf.shape) == 0:
            return ()
        return (_fit(mesh, leaf.shape[0], dp),) + (None,) * (
            len(leaf.shape) - 1)
    return _map_leaves(spec, batch)


def cache_shardings(cache, cfg: ModelConfig, mesh):
    """Specs of KV caches and SSD states (stacked, leading layer dims)."""
    dp = dp_axes(mesh)

    def spec(path, leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        last = path[-1] if path else ""
        if last == "len":
            return (None,) * (nd - 1) + (_fit(mesh, shape[-1], dp),)
        if last in ("k", "v", "ck", "cv"):          # (..., B, S, KVH, hd)
            lead = nd - 4
            b, s, kvh = shape[lead], shape[lead + 1], shape[lead + 2]
            head_ax = _fit(mesh, kvh, "model")
            seq_ax = None if head_ax else _fit(mesh, s, "model")
            return (None,) * lead + (_fit(mesh, b, dp), seq_ax, head_ax,
                                     None)
        if last in ("c_kv", "k_rope"):              # (L, B, S, r)
            return (None, _fit(mesh, shape[1], dp), None,
                    _fit(mesh, shape[-1], "model"))
        if last == "h":                             # (L, B, H, N, P)
            return (None, _fit(mesh, shape[1], dp),
                    _fit(mesh, shape[2], "model"), None, None)
        if last == "conv":                          # (L, B, K-1, C)
            return (None, _fit(mesh, shape[1], dp), None,
                    _fit(mesh, shape[-1], "model"))
        return (None,) * nd
    return _map_leaves(spec, cache)


def replicated(mesh) -> Spec:
    """The spec of a fully replicated value (every dim unsplit)."""
    return ()


def block_slices(shape, spec: Spec, mesh) -> Tuple[slice, ...]:
    """The slices of a whole tensor of ``shape`` that the rank at
    ``mesh.coords`` holds under ``spec`` (row-major over each dim's axes,
    major first)."""
    out = []
    for d, size in enumerate(shape):
        names = spec[d] if d < len(spec) else None
        if not names:
            out.append(slice(None))
            continue
        n = _axis_size(mesh, names)
        loc = size // n
        i = flat_index(mesh.shape, mesh.coords, names)
        out.append(slice(i * loc, (i + 1) * loc))
    return tuple(out)


def shard_meta(shape, spec: Spec, mesh) -> Optional[ShardMeta]:
    """The ``core.shardctx.ShardMeta`` of a container of global ``shape``
    laid out by its ``g`` spec on ``mesh``, as the rank at
    ``mesh.coords`` holds it; ``None`` when the spec splits no dim."""
    lead = tuple(tuple(e or ()) for e in spec[:-2])
    row, col = tuple(spec[-2] or ()), tuple(spec[-1] or ())
    if not (row or col or any(lead)):
        return None
    return ShardMeta(shape=tuple(shape), row=row, col=col, lead=lead,
                     axis_sizes=tuple(mesh.shape.items()),
                     coords=tuple(mesh.coords.items()))


def shard_block(tensor: Tensor, spec: Spec, mesh) -> Tensor:
    """This rank's block of a whole ``tensor`` under ``spec`` (a copy)."""
    return tensor[block_slices(tensor.shape, spec, mesh)].clone()


def unshard(block: Tensor, spec: Spec, mesh) -> Tensor:
    """The whole tensor from every rank's block: the ordered gather of
    each sharded dim (``core.shardctx.combine_partials_exact``), which
    moves bits and adds nothing."""
    for d in range(block.ndim):
        names = spec[d] if d < len(spec) else None
        if names:
            block = combine_partials_exact(block, names, d, mesh)
    return block


def map_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a dict tree and its tree of specs."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, specs[k]) for k, v in tree.items()}
    return fn(tree, specs)
