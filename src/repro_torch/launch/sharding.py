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

The numeric step holds each rank's blocks of every numeric leaf
(:func:`state_specs`, :func:`shard_tree`, :func:`unshard_tree`) and
computes through :class:`NumericParallel`.  A fused leaf (``wqkv``,
``w_upgate``) whose output dim splits over ``model`` is cut per part
(:func:`fused_parts`): rank r holds its heads' q, k and v columns, its
slice of up and of gate, so a tensor-parallel rank reads its own heads
from its own block; k and v stay whole on every rank of ``model`` where
the kv heads do not divide over it (MQA).  Checkpoints hold whole
tensors in the reference's layout.
"""
from __future__ import annotations

import contextlib
import math
import os
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import (AnalogMode, ModelConfig,
                                      resolve_analog_mode)
from repro_torch.core import analog_registry as registry
from repro_torch.core import shardctx
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


# --------------------------------------------------------------------------
# The numeric step's rest layout: blocks of every leaf, fused leaves by part
# --------------------------------------------------------------------------

def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    """``(d_in, heads, groups x state)`` of an SSD layer."""
    d_in = cfg.ssm_expand * cfg.d_model
    return d_in, d_in // cfg.ssm_head_dim, cfg.ssm_groups * cfg.ssm_state


def fused_parts(path, width: int, cfg: ModelConfig, n: int):
    """The parts of a fused leaf's output dim, ``[(width, split), ...]``,
    over ``n`` ranks of ``model``; None for any other leaf.  ``wqkv``: q,
    k and v, q split when the heads divide, k and v when the kv heads
    do; ``w_upgate``: up and gate, each split when it divides; the SSD
    layer's ``in_proj``: z and x split when its heads divide (whole heads
    a rank), B and C when its groups do, dt whole on every rank (a rank
    slices its heads' dt after the read: split, its few columns would
    not fill a 64-column range block)."""
    sp = [str(k) for k in path]
    if "in_proj" in sp and cfg.ssm_state:
        d_in, h, gn = ssm_dims(cfg)
        if 2 * d_in + 2 * gn + h != width:
            return None
        heads, groups = h % n == 0, cfg.ssm_groups % n == 0
        return [(d_in, heads), (d_in, heads), (gn, groups), (gn, groups),
                (h, False)]
    if "wqkv" in sp:
        hd = cfg.resolved_head_dim
        nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
        if nq + 2 * nkv != width:
            return None
        kv = cfg.n_kv_heads % n == 0
        return [(nq, cfg.n_heads % n == 0), (nkv, kv), (nkv, kv)]
    if "w_upgate" in sp and width % 2 == 0:
        half = width // 2
        return [(half, half % n == 0)] * 2
    return None


def _model_parts(path, shape, spec, cfg, mesh):
    """The parts of ``shape``'s last dim when ``spec`` splits it over
    ``model`` alone and the leaf is fused, else None."""
    if not shape or len(spec) < len(shape) or spec[-1] != ("model",):
        return None
    return fused_parts(path, shape[-1], cfg, mesh.shape["model"])


def part_columns(parts, n: int, r: int) -> torch.Tensor:
    """The whole-leaf column indices rank ``r`` of ``n`` holds, in its
    block's order: each part's slice (split) or the whole part."""
    cols, off = [], 0
    for w, split in parts:
        if split:
            loc = w // n
            cols.append(torch.arange(off + r * loc, off + (r + 1) * loc))
        else:
            cols.append(torch.arange(off, off + w))
        off += w
    return torch.cat(cols)


def part_assembly(parts, n: int) -> torch.Tensor:
    """Where each whole-leaf column lies in the ``n`` blocks concatenated
    in rank order (a replicated part from rank 0's block)."""
    bw = len(part_columns(parts, n, 0))
    pos = {}
    for r in range(n):
        for j, c in enumerate(part_columns(parts, n, r).tolist()):
            pos.setdefault(c, r * bw + j)
    return torch.tensor([pos[c] for c in range(len(pos))])


def range_blocks(parts, n: int, cols: int = 64) -> Optional[Tensor]:
    """The order of a fused leaf's ``cols``-column blocks as its ``n``
    ranks' blocks come out of a gather in rank order: for each block of
    the whole leaf, its position among the gathered ones (a split read's
    range partials put back in the whole read's order); None where a
    part's slice does not fill whole blocks."""
    if any((w // n if split else w) % cols for w, split in parts):
        return None
    return part_assembly(parts, n)[::cols] // cols


def leaf_block(t: Tensor, path, spec, cfg, mesh) -> Tensor:
    """This rank's block of a whole leaf (a copy), fused parts cut per
    part."""
    parts = _model_parts(path, tuple(t.shape), spec, cfg, mesh)
    if parts is None:
        return shard_block(t, spec, mesh)
    cols = part_columns(parts, mesh.shape["model"], mesh.coords["model"])
    t = t.index_select(-1, cols.to(t.device))
    return shard_block(t, tuple(spec[:-1]) + (None,), mesh)


def leaf_unshard(block: Tensor, path, spec, cfg, mesh,
                 shape=None) -> Tensor:
    """The whole leaf from every rank's block (ordered gathers, no
    arithmetic); ``shape`` is the whole shape (needed for a fused
    leaf)."""
    parts = None if shape is None else _model_parts(path, tuple(shape),
                                                      spec, cfg, mesh)
    if parts is None:
        return unshard(block, spec, mesh)
    whole = unshard(block, tuple(spec[:-1]) + (None,), mesh)
    gathered = combine_partials_exact(whole, ("model",), whole.ndim - 1,
                                      mesh)
    pos = part_assembly(parts, mesh.shape["model"])
    return gathered.index_select(-1, pos.to(gathered.device))


def _walk(fn, tree, specs, path=()):
    if isinstance(tree, dict):
        return {k: _walk(fn, v, specs[k], path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_walk(fn, v, specs[i], path + (str(i),))
                     for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree, specs)


def state_specs(state: dict, cfg: ModelConfig, mesh, like=None) -> dict:
    """Specs of a numeric train state (``train_loop.init_state``): the
    parameters, adamw's ``m`` / ``v`` and the error-feedback residuals by
    :func:`params_shardings`; the step counter and ``t`` replicated.
    ``like``: the whole parameters (meta tensors will do) of a state that
    holds blocks, whose own shapes would give other specs."""
    p_sh = params_shardings(state["params"] if like is None else like, cfg,
                            mesh)
    opt = state["opt"]
    if isinstance(opt, dict) and "m" in opt:
        opt_sh = {"m": p_sh, "v": p_sh, "t": ()}
    elif isinstance(opt, dict):
        opt_sh = p_sh
    else:
        opt_sh = ()
    err = state.get("err_fb", ())
    return {"params": p_sh, "opt": opt_sh, "step": (),
            "err_fb": p_sh if isinstance(err, dict) else ()}


def _strip(path):
    """A state path without its leading ``params`` / ``opt/m`` / ...
    keys: the parameter path the parts rule reads."""
    return tuple(k for k in path if k not in ("params", "opt", "m", "v",
                                              "err_fb"))


def shard_tree(tree, specs, cfg: ModelConfig, mesh):
    """This rank's blocks of a whole tree (:func:`leaf_block`)."""
    return _walk(lambda path, t, sp: leaf_block(t, _strip(path), sp, cfg,
                                                mesh)
                 if sp and any(sp) else t, tree, specs)


def unshard_tree(tree, specs, like, cfg: ModelConfig, mesh):
    """The whole tree from every rank's blocks; ``like`` carries the
    whole shapes (meta tensors will do)."""
    flat = dict(_flat(like))
    return _walk(lambda path, t, sp: leaf_unshard(
        t, _strip(path), sp, cfg, mesh, flat["/".join(path)].shape)
        if sp and any(sp) else t, tree, specs)


def leaf_cutter(specs, cfg: ModelConfig, mesh):
    """``cut(path, whole)``: this rank's block of the whole leaf at
    ``path`` of a state laid out by ``specs`` (checkpoint restore)."""
    def cut(path, t):
        sp = _spec_at(specs, path)
        if not sp or not any(sp):
            return t
        return leaf_block(t, _strip(path), sp, cfg, mesh)
    return cut


def leaf_gatherer(specs, like, cfg: ModelConfig, mesh):
    """``gather(path, block)``: the whole leaf at ``path`` from every
    rank's block (checkpoint save); ``like`` the whole state's shapes."""
    flat = dict(_flat(like))

    def gather(path, t):
        sp = _spec_at(specs, path)
        if not sp or not any(sp):
            return t
        return leaf_unshard(t, _strip(path), sp, cfg, mesh,
                            flat["/".join(path)].shape)
    return gather


def _flat_paths(tree, path=()):
    """``(key tuple, leaf)`` of a dict tree, keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat_paths(tree[k], path + (k,))
    else:
        yield path, tree


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (str(k),))
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (str(i),))
    elif tree is not None:
        yield "/".join(path), tree


class _FusedGather(torch.autograd.Function):
    """A fused leaf's blocks over ``model`` reassembled whole; backward
    this rank's block of the whole gradient (the compute it feeds runs
    replicated over ``model``)."""

    @staticmethod
    def forward(ctx, t, mesh, parts):
        n = mesh.shape["model"]
        ctx.args = (part_columns(parts, n, mesh.coords["model"]),)
        gathered = mesh.all_gather(t.contiguous(), "model", t.ndim - 1)
        return gathered.index_select(
            -1, part_assembly(parts, n).to(t.device))

    @staticmethod
    def backward(ctx, g):
        cols, = ctx.args
        return g.index_select(-1, cols.to(g.device)), None, None


#: The leaves a tensor-parallel step keeps split, by their path in a
#: block (a leaf outside the layer stacks by its path in the tree, read
#: through :data:`TP_ALIAS`): the dim kept and the plan flag that allows
#: it.
TP_KEPT = {("embed",): (0, "vocab"),
           ("lm_head", "w"): (-1, "vocab"),
           ("attn", "wqkv", "w"): (-1, "attn"),
           ("attn", "wq", "w"): (-1, "mla"),
           ("attn", "wkv_b", "w"): (-1, "mla"),
           ("attn", "wo", "w"): (-2, "attn_row"),
           ("ffn", "w_upgate", "w"): (-1, "ffn"),
           ("ffn", "w_up", "w"): (-1, "ffn"),
           ("ffn", "w_down", "w"): (-2, "ffn_row"),
           ("moe", "shared", "w_upgate", "w"): (-1, "ffn"),
           ("moe", "shared", "w_up", "w"): (-1, "ffn"),
           ("moe", "shared", "w_down", "w"): (-2, "ffn_row"),
           ("moe", "experts", "w_up"): (-3, "ep"),
           ("moe", "experts", "w_gate"): (-3, "ep"),
           ("moe", "experts", "w_down"): (-3, "ep"),
           ("ssm", "in_proj", "w"): (-1, "ssm"),
           ("ssm", "out_proj", "w"): (-2, "ssm")}

#: Under sequence parallelism (the plan's ``seq``) every leaf that the plan
#: may leave unsplit over ``model``, by its path as :data:`TP_KEPT` reads
#: it: ``"chunk"`` where it acts on this rank's chunk of the sequence (its
#: gradient a partial sum over the chunk's tokens, summed over ``model``),
#: ``"whole"`` where it acts on the gathered whole sequence alike on every
#: ``model`` rank (its gradient whole already: the MoE router and shared
#: experts, the SSD layer's replicated leaves, which a ``copy_to`` sums,
#: and its gated norm, run whole on every rank; a block of such a leaf
#: gathered whole for its compute takes its slice of that gradient).
#: :meth:`NumericParallel.reduce_grads` raises for a leaf missing here.
SEQ_GRAD = {("ln", "scale"): "chunk",
            ("ln1", "scale"): "chunk",
            ("ln2", "scale"): "chunk",
            ("lnx", "scale"): "chunk",
            ("final_ln", "scale"): "chunk",
            ("enc_ln", "scale"): "chunk",
            ("shared_ln", "scale"): "chunk",
            ("shared_ln2", "scale"): "chunk",
            ("gate_attn",): "chunk",
            ("gate_ffn",): "chunk",
            ("enc_pos",): "chunk",
            ("shared_in", "w"): "chunk",
            ("attn", "wkv_a", "w"): "chunk",
            ("attn", "kv_norm", "scale"): "chunk",
            ("moe", "router", "w"): "whole",
            ("moe", "shared", "w_upgate", "w"): "whole",
            ("moe", "shared", "w_down", "w"): "whole",
            ("ssm", "conv_w"): "whole",
            ("ssm", "conv_b"): "whole",
            ("ssm", "a_log"): "whole",
            ("ssm", "dt_bias"): "whole",
            ("ssm", "d_skip"): "whole",
            ("ssm", "norm", "scale"): "whole"}

#: The layer stacks of every family's tree (a layer's path starts after
#: its stack's key).
STACKS = ("layers", "enc_layers", "dec_layers", "self_layers",
          "cross_layers")

#: Modules :data:`TP_KEPT` and the plan read as another: a cross-attention
#: as an attention, the hybrid's shared block (at the top of the tree) as
#: a block's attention and FFN.
TP_ALIAS = {"xattn": "attn", "shared_attn": "attn", "shared_ffn": "ffn"}


def block_path(path) -> Tuple[str, ...]:
    """A parameter path as :data:`TP_KEPT` reads it: a layer's leaf by its
    path in the block (the stack's key dropped), its first key through
    :data:`TP_ALIAS`."""
    path = tuple(str(k) for k in path)
    if path and path[0] in STACKS:
        path = path[1:]
    return (TP_ALIAS.get(path[0], path[0]),) + path[1:] if path else path


#: The plan flags of :class:`NumericParallel`, in the order they are
#: reported.
PLAN_FLAGS = ("attn", "mla", "attn_row", "ffn", "ffn_row", "ep", "ssm",
              "vocab", "seq")


def _spec_at(specs, path):
    for k in path:
        specs = specs[k]
    return specs


class NumericParallel:
    """The FSDP and tensor-parallel numeric step on ``mesh`` (installed
    with ``core.shardctx.numeric_parallel`` while the loss runs).

    Every numeric leaf lies in its policy block (:func:`state_specs`).
    Just before a layer runs, :meth:`layer` gathers its leaves over the
    axes its compute does not split: the FSDP axes always (backward: a
    ``reduce_scatter``, each data rank's gradient being partial), and
    ``model`` unless the plan keeps the dim split (backward: this rank's
    block of the gradient, the compute being replicated over ``model``).
    The plan (one flag each, ``model`` > 1, each flag off where its
    divisibility fails in any of the leaves it covers: a block's in every
    layer stack, :data:`STACKS`, and the hybrid's shared block at the top
    of the tree, :data:`TP_ALIAS`):

      * ``attn``: ``wqkv`` column-parallel and the heads split (whole
        heads a rank); in fakequant mode also the kv heads (GQA: the
        dense family, llama4-scout's MoE blocks, the hybrid's shared
        block, the audio encoder's and decoder's self-attention and the
        VLM's self blocks); a cross-attention's fused ``wqkv`` (``xattn``
        of whisper's decoder and the VLM's cross blocks) the same, its
        one read over both token streams;
      * ``mla``: MLA's ``wq`` and ``wkv_b`` column-parallel by whole
        heads, ``wkv_a``, ``kv_norm`` and the shared rope key replicated
        (every rank forms the whole latent); in fakequant mode each
        rank's columns whole 64-column range blocks;
      * ``attn_row``: ``wo`` row-parallel (fakequant: its block owns whole
        ``analog_rows`` tiles, and every rank's tiles are gathered for the
        ADC and the tile sum, so the read is one device's), a digital
        read's partial outputs summed over ``model``; otherwise the heads'
        outputs are gathered and ``wo`` read whole;
      * ``ffn`` / ``ffn_row``: the same for ``w_upgate`` (or ``w_up``)
        and ``w_down``, of the dense FFN (every family's, the shared
        block's too) or of the MoE's shared experts (``d_ff`` the width
        they split);
      * ``ep``: the expert stacks keep their expert dim split over
        ``model`` (gathered over the FSDP axes only); each rank runs its
        own experts' rows of the dispatch buffer and the experts' outputs
        are summed over ``model`` (``models.moe``);
      * ``ssm``: the SSD layers (the ssm and hybrid families) split by
        heads (``models.ssm``): ``in_proj`` column-parallel (z and x by
        whole heads, B and C whole on every rank unless the groups
        divide, dt whole), the conv and the scan on the rank's channels
        and heads, the gated norm whole on every rank over the gathered
        ``d_in`` (``counts["norm_gather_bytes"]``), ``out_proj``
        row-parallel; in fakequant mode each rank's ``in_proj`` columns
        whole 64-column range blocks and its ``out_proj`` rows whole
        tiles;
      * ``vocab``: the embedding vocab-split (a rank looks up its rows,
        the partial embeddings summed) and the head vocab-parallel, the
        loss a vocab-parallel cross-entropy (``models.model.loss_fn``);
      * ``seq``: ``REPRO_SEQ_SHARD`` with ``vocab`` and every flag of the
        family's blocks (:meth:`_seq_plan`), the activations split along
        the sequence at block boundaries (Megatron-SP), for a step whose
        sequences (the tokens, and whisper's frames) divide over
        ``model`` (``sp_on``, set by ``models.transformer`` as the step
        starts).  A column-parallel read gathers its input's sequence
        and a row-parallel read scatters its output's, so the SSD scan,
        the attention and the MoE dispatch see the data rank's whole
        sequences: the MoE layer gathers them before the router, runs
        the global dispatch unchanged and keeps its chunk of the output
        (:meth:`seq_gather`, :meth:`seq_split`); whisper's encoder takes
        its chunk of the frames and gathers its output once for the
        decoder's cross reads.  A read of a leaf that ``model`` does not
        split on a chunk (MLA's ``wkv_a``, the hybrid's ``shared_in``)
        shares its fakequant DAC scale over ``model`` too, so its rows
        are the whole read's (``models.layers.project``'s ``seq``).
        Each leaf that no flag splits is summed over ``model`` or not
        by :data:`SEQ_GRAD`.

    Over data ranks the MoE layer is the reference's one dispatch over
    the global batch (``models.moe``): the capacity of the global token
    count, each pair's place in its expert's buffer after the pairs of
    the data ranks before it (:meth:`data_gather` of the counts), the aux
    loss's means over the global tokens and each expert's DAC scale the
    max over the data ranks.

    ``counts["layer_gathers"]`` counts the layers gathered and
    ``counts["norm_gather_bytes"]`` the bytes of the SSD norm's gathered
    input (a rematted layer's backward gathers both again).
    """

    def __init__(self, cfg: ModelConfig, mesh):
        from repro_torch.models import model as M
        self.cfg, self.mesh = cfg, mesh
        self.like = M.init_params(cfg, None, device="meta")
        self.specs = params_shardings(self.like, cfg, mesh)
        self.fsdp = tuple(a for a in dp_axes(mesh) if mesh.shape[a] > 1)
        self.n_data = math.prod(mesh.shape[a] for a in self.fsdp)
        m = mesh.shape.get("model", 1)
        self.m = m = m if "model" not in dp_axes(mesh) else 1
        self.tp = ("model",) if m > 1 else ()
        self.counts = {"layer_gathers": 0, "norm_gather_bytes": 0}
        self.sp_on = False
        qat = resolve_analog_mode(cfg) is AnalogMode.FAKEQUANT
        on = m > 1
        moe = on and cfg.family == "moe"
        hd, rows = cfg.resolved_head_dim, cfg.analog_rows
        by_block: Dict[Tuple[str, ...], list] = {}
        for path, spec in _flat_paths(self.specs):
            by_block.setdefault(block_path(path), []).append(spec)

        def split(path, dim):
            """Every leaf at block path ``path`` (in any stack, or the
            shared block's) splits ``dim`` over ``model``."""
            found = by_block.get(tuple(path), [])
            return bool(found) and all(
                len(sp) >= -dim and sp[dim] == ("model",) for sp in found)
        self.kv_split = cfg.n_kv_heads % m == 0
        # the FFN the ffn flags split: the dense FFN or the shared experts
        ffn_path = ("moe", "shared") if moe else ("ffn",)
        self.d_ff = (cfg.n_shared_experts * (cfg.d_ff_expert or cfg.d_ff)
                     if moe else cfg.d_ff)
        # a fakequant read split by columns needs its range partials in
        # whole 64-column blocks (kernel 4's range pitch)
        w_qkv = (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
        w_q = cfg.n_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim)
        w_kv = cfg.n_heads * (cfg.qk_nope_dim + cfg.v_head_dim)
        d_in, h_ssm, gn = ssm_dims(cfg) if cfg.ssm_state else (0, 0, 0)
        w_in = 2 * d_in + 2 * gn + h_ssm

        def blocks(path, width):
            parts = fused_parts(path, width, cfg, m)
            return None if parts is None else range_blocks(parts, m)
        self.blocks = {
            "wqkv": blocks(("wqkv",), w_qkv),
            "wq": range_blocks([(w_q, True)], m),
            "wkv_b": range_blocks([(w_kv, True)], m),
            "w_upgate": blocks(("w_upgate",), 2 * self.d_ff),
            "w_up": range_blocks([(self.d_ff, True)], m),
            "in_proj": blocks(("in_proj",), w_in)}
        self.attn = on and cfg.n_heads > 0 and not cfg.use_mla \
            and cfg.n_heads % m == 0 and split(("attn", "wqkv", "w"), -1) \
            and fused_parts(("wqkv",), w_qkv, cfg, m)[0][1] \
            and (not qat or (self.kv_split
                             and self.blocks["wqkv"] is not None))
        self.mla = moe and cfg.use_mla and cfg.n_heads % m == 0 \
            and split(("attn", "wq", "w"), -1) \
            and split(("attn", "wkv_b", "w"), -1) \
            and (not qat or (self.blocks["wq"] is not None
                             and self.blocks["wkv_b"] is not None))
        v_dim = cfg.v_head_dim if cfg.use_mla else hd
        self.attn_row = (self.attn or self.mla) \
            and split(("attn", "wo", "w"), -2) \
            and (not qat or (cfg.n_heads * v_dim // m) % rows == 0)
        up = ffn_path + ("w_upgate" if cfg.gated else "w_up", "w")
        self.ffn = on and self.d_ff > 0 and self.d_ff % m == 0 \
            and split(up, -1) and (not qat or self.blocks[up[-2]] is not None)
        self.ffn_row = self.ffn and split(ffn_path + ("w_down", "w"), -2) \
            and (not qat or (self.d_ff // m) % rows == 0)
        self.ep = moe and cfg.n_experts % m == 0 and all(
            split(("moe", "experts", k), -3)
            for k in ("w_up", "w_gate", "w_down"))
        self.ssm = on and cfg.family in ("ssm", "hybrid") \
            and h_ssm % m == 0 \
            and (cfg.ssm_groups == 1 or cfg.ssm_groups % m == 0) \
            and split(("ssm", "in_proj", "w"), -1) \
            and split(("ssm", "out_proj", "w"), -2) \
            and (not qat or (self.blocks["in_proj"] is not None
                             and (d_in // m) % rows == 0))
        emb = self.specs.get("embed")
        head = self.specs.get("lm_head", {}).get("w")
        self.vocab = on and emb is not None and emb[0] == ("model",) \
            and (cfg.tie_embeddings or (head is not None
                                        and head[-1] == ("model",)))
        self.seq = bool(os.environ.get("REPRO_SEQ_SHARD")) and self.vocab \
            and self._seq_plan()

    def _seq_plan(self) -> bool:
        """Every flag of the family's blocks on (``seq``'s condition
        beside ``vocab``): the dense plan of the attention and FFN
        blocks; the MoE's attention (GQA or MLA), ``attn_row`` and
        ``ep`` (its shared experts run inside the MoE layer on the
        gathered whole sequence, so their flags do not bear on it:
        deepseek-v2-lite's 704 rows a rank on 1x4 are no whole 128-row
        tiles); the SSD layers' ``ssm`` (and the hybrid's shared block on
        the dense plan)."""
        dense = self.attn and self.attn_row and self.ffn and self.ffn_row
        fam = self.cfg.family
        if fam == "moe":
            return (self.attn or self.mla) and self.attn_row and self.ep
        if fam == "ssm":
            return self.ssm
        if fam == "hybrid":
            return self.ssm and dense
        return dense

    def plan(self) -> Dict[str, bool]:
        """The plan's flags (:data:`PLAN_FLAGS`), for reports."""
        return {k: bool(getattr(self, k)) for k in PLAN_FLAGS}

    # ------------------------------------------------------------ leaves

    def leaf(self, t: Tensor, spec, path=(), keep: Optional[int] = None,
             width: Optional[int] = None) -> Tensor:
        """``t``, this rank's block of a leaf under ``spec`` (``width``: the
        whole leaf's last dim), gathered over every split axis but the
        ``model`` split of dim ``keep``."""
        nd = t.ndim
        keep = None if keep is None else keep % nd
        for d in range(nd):
            names = tuple(spec[d] or ()) if d < len(spec) else ()
            if not names or (d == keep and names == ("model",)):
                continue
            parts = fused_parts(path, width, self.cfg, self.mesh.shape[
                "model"]) if d == nd - 1 and names == ("model",) \
                and width is not None else None
            if parts is not None:
                t = _FusedGather.apply(t, self.mesh, parts)
                continue
            for a in reversed(names):
                grad = "reduce_scatter" if a in dp_axes(self.mesh) \
                    else "slice"
                t = shardctx.gather(t, self.mesh, (a,), d, grad)
        return t

    def kept(self, path) -> Optional[int]:
        """The dim the leaf at ``path`` (its path in the tree) keeps split
        over ``model`` under the plan (:data:`TP_KEPT`), else None."""
        hit = TP_KEPT.get(block_path(path))
        return hit[0] if hit is not None and getattr(self, hit[1]) else None

    def tree(self, tree, specs, like, path=(), lead: int = 0):
        """Every leaf of ``tree`` (at ``path`` in the parameter tree)
        gathered by :meth:`leaf`, the split the plan keeps left in place
        (``like``: the whole tree on the meta device; a layer's specs and
        ``like`` carry ``lead`` stacking dims first)."""
        if isinstance(tree, dict):
            return {k: self.tree(v, specs[k], like[k], path + (k,), lead)
                    for k, v in tree.items()}
        if not isinstance(tree, torch.Tensor):
            return tree
        return self.leaf(tree, tuple(specs)[lead:], path, self.kept(path),
                         like.shape[-1])

    def layer(self, lp: dict, stack) -> dict:
        """A layer's leaves of the stack ``stack`` (a key of the parameter
        tree, a tuple for nested stacks), gathered for its block."""
        self.counts["layer_gathers"] += 1
        stack = (stack,) if isinstance(stack, str) else tuple(stack)
        return self.tree(lp, _spec_at(self.specs, stack),
                         _spec_at(self.like, stack), stack, 1)

    def top(self, t, path):
        """A leaf or subtree outside the layer stacks (the embedding, the
        head, the final norm, the audio encoder's positions, the hybrid's
        shared block), gathered but for the splits the plan keeps (the
        vocab split of the embedding and the head, the shared block's
        attention and FFN)."""
        path = (path,) if isinstance(path, str) else tuple(path)
        return self.tree(t, _spec_at(self.specs, path),
                         _spec_at(self.like, path), path, 0)

    # ------------------------------------------------------- activations

    def col_input(self, x: Tensor) -> Tensor:
        """The input of a column-parallel read: gathered along the
        sequence under sequence parallelism, else the identity whose
        gradient is summed over ``model``."""
        if self.sp_on:
            return shardctx.gather(x, self.mesh, self.tp, 1)
        return shardctx.copy_to(x, self.mesh, self.tp)

    def row_output(self, y: Tensor) -> Tensor:
        """The partial output of a row-parallel read summed over
        ``model`` (and split along the sequence under sequence
        parallelism)."""
        if self.sp_on:
            return shardctx.scatter_reduce(y, self.mesh, self.tp, 1)
        return shardctx.reduce_from(y, self.mesh, self.tp)

    def row_whole(self, y: Tensor) -> Tensor:
        """The whole output of a row-split fakequant read, the same on
        every ``model`` rank (it gathered every rank's tiles): as it is,
        or this rank's chunk of the sequence under sequence parallelism
        (backward: the chunks' gradients gathered)."""
        if self.sp_on:
            return shardctx.split_to(y, self.mesh, self.tp, 1)
        return y

    def seq_gather(self, x: Tensor) -> Tensor:
        """The data rank's whole sequences from this rank's chunk, for
        compute that then runs alike on every ``model`` rank (the MoE
        layer, the decoder's view of the encoder output): backward this
        rank's chunk of the gradient, which every rank forms whole."""
        return shardctx.gather(x, self.mesh, self.tp, 1, "slice")

    def seq_split(self, y: Tensor) -> Tensor:
        """This rank's chunk of a whole-sequence ``y`` that every
        ``model`` rank holds alike (backward the chunks' gradients
        gathered)."""
        return shardctx.split_to(y, self.mesh, self.tp, 1)

    def seq_offset(self, chunk: int) -> int:
        """The position of this rank's chunk of ``chunk`` tokens in its
        sequences."""
        return self.mesh.coords["model"] * chunk

    @contextlib.contextmanager
    def whole_sequence(self):
        """Compute on the whole sequences inside a sequence-parallel step
        (the MoE layer's shared experts): ``sp_on`` off for the block."""
        prev, self.sp_on = self.sp_on, False
        try:
            yield
        finally:
            self.sp_on = prev

    def gather_heads(self, o: Tensor) -> Tensor:
        """This rank's heads' (or ff slice's) outputs gathered along the
        last dim for a read made whole on every rank."""
        return shardctx.gather(o, self.mesh, self.tp, o.ndim - 1, "slice")

    def vocab_offset(self, local: int) -> int:
        return self.mesh.coords["model"] * local if self.tp else 0

    # ------------------------------------------------------ the MoE layer

    def data_index(self) -> int:
        """This rank's place among the data ranks (the order of the
        global batch's rows: ``batch_shardings``' row-major split)."""
        return flat_index(self.mesh.shape, self.mesh.coords, self.fsdp)

    def data_gather(self, t: Tensor) -> Tensor:
        """``t`` (no gradient) of every data rank stacked along a new
        leading dim, in data-rank order."""
        return shardctx._collective(t[None], self.mesh, self.fsdp, 0,
                                    "gather")

    def data_sum(self, t: Tensor) -> Tensor:
        """``t`` (no gradient) summed over the data ranks."""
        return shardctx._collective(t, self.mesh, self.fsdp, 0, "all_reduce")

    def expert_range(self, n_experts: int) -> Tuple[int, int]:
        """``(first, count)``: the experts this rank runs, all of them but
        under ``ep``."""
        if not self.ep:
            return 0, n_experts
        loc = n_experts // self.m
        return self.mesh.coords["model"] * loc, loc

    # --------------------------------------------------------- gradients

    def leaf_axes(self, spec) -> Tuple[str, ...]:
        """The mesh axes a leaf of ``spec`` is split over."""
        return tuple(a for e in spec if e for a in e
                     if self.mesh.shape[a] > 1)

    def reduce_grads(self, grads):
        """The data-parallel mean of the block gradients: a leaf split
        over the FSDP axes had its gradient summed over them by its
        gather's ``reduce_scatter``; the others are ``all_reduce``d over
        the FSDP axes they do not split; all are divided by the data
        ranks' count.  Under sequence parallelism a leaf that ``model``
        does not split is summed over ``model`` where it acted on this
        rank's chunk of the sequence (:meth:`seq_grad`)."""
        from repro_torch.core.adc import divisor
        n = math.prod(self.mesh.shape[a] for a in self.fsdp) or 1

        def one(path, g, spec):
            axes = self.leaf_axes(spec)
            for a in self.fsdp:
                if a not in axes:
                    g = self.mesh.all_reduce(g, a)
            if self.sp_on and self.seq_grad(path, axes) == "chunk":
                g = self.mesh.all_reduce(g, "model")
            return g / divisor(n, g) if n > 1 else g
        return _walk(one, grads, self.specs)

    def seq_grad(self, path, axes) -> str:
        """Under sequence parallelism, how the leaf at ``path`` (split
        over ``axes``) acted: ``"split"`` (its block kept split over
        ``model``), else :data:`SEQ_GRAD`'s ``"chunk"`` or ``"whole"``.
        A leaf missing from the table raises, and so does a block split
        over ``model`` at rest and gathered whole for a chunk's compute
        (its gather's backward slice of a partial gradient would be
        wrong): its gradient has no rule."""
        if "model" in axes and self.kept(path) is not None:
            return "split"
        key = block_path(path)
        if key not in SEQ_GRAD:
            raise KeyError(f"{'/'.join(path)} ({key}): no sequence-"
                           "parallel gradient rule in SEQ_GRAD")
        if "model" in axes and SEQ_GRAD[key] != "whole":
            raise ValueError(f"{'/'.join(path)}: split over 'model' at rest "
                             "and gathered whole for a sequence chunk")
        return SEQ_GRAD[key]

    def leaf_max(self, path, t: Tensor) -> Tensor:
        """``t`` (a max over a block) maxed over the axes the leaf at
        ``path`` is split along: the whole leaf's max (``train.compress``'s
        per-leaf scale)."""
        for a in self.leaf_axes(_spec_at(self.specs, path)):
            t = self.mesh.all_reduce(t, a, op="max")
        return t

    def sq_total(self, tree) -> Tensor:
        """The sum of squares of every whole leaf from the blocks of
        ``tree`` (``clip_by_global_norm``): the blocks' sums grouped by
        the axes their leaf is split along, each group summed over its
        axes in one ``all_reduce``; a replicated leaf counts once, and so
        does a fused leaf's part that every ``model`` rank holds whole
        (MQA's k and v): only ``model`` rank 0 counts it."""
        groups: Dict[Tuple[str, ...], Tensor] = {}
        for path, t in _flat_paths(tree):
            spec = _spec_at(self.specs, path)
            axes = self.leaf_axes(spec)
            sq = torch.square(t.float())
            parts = _model_parts(path, tuple(_spec_at(self.like, path).shape),
                                 spec, self.cfg, self.mesh)
            if parts is not None and self.mesh.coords["model"] \
                    and not all(split for _, split in parts):
                n = self.mesh.shape["model"]
                own = torch.cat([torch.full((w // n if split else w,), split)
                                 for w, split in parts]).to(t.device)
                sq = sq * own
            s = torch.sum(sq)
            groups[axes] = groups[axes] + s if axes in groups else s
        total = None
        for axes, s in groups.items():
            for a in axes:
                s = self.mesh.all_reduce(s, a)
            total = s if total is None else total + s
        return total
