"""Analog parameter registry of every family (port of
``repro.core.analog_registry``).

It owns the mapping from a parameter path to whether the matrix there
lives on crossbar tiles, which consumer kind it is, how its tapes are
shaped (:func:`tape_lead`, with the rows of one application from
:func:`operand_rows`: the audio encoder's containers see the frames, the
fused cross-attention ``wqkv`` both streams), how its leaves lay out on
a mesh (:func:`leaf_layout`) and how the rank-k write views it
(:func:`flatten_lead`, with the expert dim hoisted outermost by
:func:`hoist_axis`).  The hybrid shared block tapes once per
application (:func:`tape_reps`).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

#: Producer: activations drive the rows, output columns split under TP.
COLUMN_PARALLEL = "column_parallel"
#: Consumer: the projection reduces a TP-split feature dim (wo/w_down/...).
ROW_PARALLEL = "row_parallel"
#: A stack of per-expert matrices applied to expert-batched activations.
EXPERT_BATCHED = "expert_batched"

KINDS = (COLUMN_PARALLEL, ROW_PARALLEL, EXPERT_BATCHED)

#: Leaf names of a tiled-crossbar container (plus the training tape slots
#: and their scales).
ANALOG_LEAVES = ("g", "ref", "w_scale", "g_carry", "x_tape", "d_tape",
                 "x_tape_scale", "d_tape_scale")

#: Leaves with only the container's lead dims.
_LEAD_ONLY_LEAVES = ("w_scale", "x_tape_scale", "d_tape_scale")

ROW_PARALLEL_KEYS = frozenset({"wo", "w_down", "out_proj"})
COLUMN_PARALLEL_KEYS = frozenset({
    "wq", "wk", "wv", "wqkv", "w_up", "w_gate", "w_upgate",
    "wkv_a", "wkv_b", "in_proj", "shared_in",
})
PROJECTION_KEYS = ROW_PARALLEL_KEYS | COLUMN_PARALLEL_KEYS

#: The dict key under which MoE stacks its per-expert matrices.
EXPERT_STACK_KEY = "experts"

#: The hybrid family's shared block: one weight set applied at every group
#: boundary.
SHARED_BLOCK_KEYS = frozenset({"shared_in", "shared_attn", "shared_ffn"})

#: Matrix-shaped parameters the paper keeps on the digital core.
DIGITAL_CORE_KEYS = frozenset({
    "embed", "lm_head", "router", "enc_pos", "conv_w", "conv_b",
})

#: Non-matmul leaf names (norm gains, SSD scalars, block gates); 2-D once
#: scan-stacked, so the digital triage knows them by name.
DIGITAL_LEAF_NAMES = frozenset({
    "scale", "a_log", "d_skip", "dt_bias", "gate_attn", "gate_ffn",
})


def _keys(path: Sequence) -> Tuple[str, ...]:
    """A tree path as plain strings, without container-leaf names and the
    digital ``"w"`` wrapper."""
    return tuple(str(k) for k in path
                 if str(k) not in ANALOG_LEAVES and str(k) != "w")


def classify(path: Sequence) -> str:
    """Consumer kind of the container at ``path`` (or any leaf under it)."""
    keys = _keys(path)
    if EXPERT_STACK_KEY in keys:
        return EXPERT_BATCHED
    proj = next((k for k in reversed(keys) if k in PROJECTION_KEYS), None)
    if proj in ROW_PARALLEL_KEYS:
        return ROW_PARALLEL
    return COLUMN_PARALLEL


def classify_param(path: Sequence) -> Optional[str]:
    """Crossbar-vs-digital triage of one matrix-shaped parameter: a
    consumer kind, ``"digital"``, or ``None`` for a matrix the registry
    cannot place (an error in device mode, never silently digital)."""
    keys = _keys(path)
    if any(k in DIGITAL_CORE_KEYS for k in keys):
        return "digital"
    if keys and keys[-1] in DIGITAL_LEAF_NAMES:
        return "digital"
    if EXPERT_STACK_KEY in keys:
        return EXPERT_BATCHED
    proj = next((k for k in reversed(keys) if k in PROJECTION_KEYS), None)
    if proj is None:
        return None
    return ROW_PARALLEL if proj in ROW_PARALLEL_KEYS else COLUMN_PARALLEL


def expert_capacity(n_tokens: int, cfg) -> int:
    """Per-expert dispatch capacity (the MoE buffer's row count), which is
    also the tape length of an expert-batched container: the write
    drivers see one operand row per buffer slot, not per token.
    ``max(8, ceil(capacity_factor * T * top_k / n_experts))`` padded to a
    multiple of 8."""
    c = int(math.ceil(cfg.capacity_factor * n_tokens * cfg.top_k
                      / cfg.n_experts))
    return max(8, -(-c // 8) * 8)


def operand_rows(path: Sequence, cfg, n_tokens: int,
                 batch_shape: Optional[Tuple[int, ...]] = None) -> int:
    """Operand rows one application of the container at ``path`` sees.

    Most containers are driven by the decoder token batch (``n_tokens``).
    The audio encoder's (``enc_layers``) see the frame batch, B x
    ``n_audio_frames``; the fused cross-attention ``wqkv`` (under
    ``xattn``) both streams concatenated in its single application,
    ``n_tokens`` + B x (``n_vision_tokens`` or ``n_audio_frames``).
    ``batch_shape`` is the token batch's (B, S), which scales the
    per-sequence stream lengths to the batch (B = 1 without it).
    """
    keys = _keys(path)
    b = batch_shape[0] if batch_shape else 1
    stream = b * (getattr(cfg, "n_vision_tokens", 0)
                  or getattr(cfg, "n_audio_frames", 0))
    if "enc_layers" in keys:
        return b * cfg.n_audio_frames
    if "xattn" in keys and keys[-1] == "wqkv":
        return n_tokens + stream
    return n_tokens


def tape_lead(path: Sequence, cfg, n_tokens: int,
              batch_shape: Optional[Tuple[int, ...]] = None
              ) -> Tuple[int, ...]:
    """Shape of one container's tape slots between the container's own
    lead dims and the operand feature dim: ``(T,)`` for a container
    applied once per step (T from :func:`operand_rows`), ``(reps, T)``
    for the hybrid shared block (one slot per application,
    :func:`tape_reps`), ``(capacity,)`` per expert for an expert-batched
    container (:func:`expert_capacity`)."""
    if classify(path) == EXPERT_BATCHED:
        return (expert_capacity(n_tokens, cfg),)
    rows = operand_rows(path, cfg, n_tokens, batch_shape)
    reps = tape_reps(path, cfg)
    return (reps, rows) if reps > 1 else (rows,)


def tape_reps(path: Sequence, cfg) -> int:
    """How many times the container at ``path`` is applied per step: the
    hybrid shared block once per group boundary (``n_layers //
    attn_every``), every other container once.  The tapes
    (:func:`tape_lead`) and the cost roll-up (``hwmodel.arch_cost``) read
    it."""
    keys = _keys(path)
    if getattr(cfg, "attn_every", 0) and \
            any(k in SHARED_BLOCK_KEYS for k in keys):
        return cfg.n_layers // cfg.attn_every
    return 1


def leaf_layout(kind: str, ndim: int, leaf: str, rows: int, cols: int
                ) -> Tuple[Tuple[Optional[str], int], ...]:
    """Per-dim ``(logical_axis, granularity)`` of one container leaf.

    Logical axes: ``"fsdp"`` (the data axes) and ``"tp"`` (the model
    axis); granularity is the tile size the dim may only split at (1 for
    untiled dims); ``None`` is replicated.  ``"ep"`` (expert parallelism)
    is the model axis too, which the expert dim consumes, so an expert
    matrix's inner dims only FSDP-shard.  The layer dim of a stacked
    container is never sharded; ``w_scale`` and the tape scales follow
    their container's lead dims (per-expert scales follow their experts).
    """
    lead = ndim if leaf in _LEAD_ONLY_LEAVES else ndim - 2
    roles = [(None, 1)] * lead
    if kind == EXPERT_BATCHED and lead >= 1:
        roles[lead - 1] = ("ep", 1)
    if leaf in _LEAD_ONLY_LEAVES:
        return tuple(roles)
    if kind == EXPERT_BATCHED:
        r, c = ("fsdp", rows), (None, 1)
    elif kind == ROW_PARALLEL:
        r, c = ("tp", rows), ("fsdp", cols)
    else:
        r, c = ("fsdp", rows), ("tp", cols)
    if leaf in ("g", "ref", "g_carry"):
        return (*roles, r, c)
    if leaf == "x_tape":
        return (*roles, (None, 1), r)
    if leaf == "d_tape":
        return (*roles, (None, 1), c)
    raise KeyError(f"unknown container leaf {leaf!r}")


def hoist_axis(kind: str, g_ndim: int) -> Optional[int]:
    """Lead dim moved outermost before flattening onto the kernel's layer
    grid: the expert dim of a layer-stacked expert container (so an
    EP-sharded block is a contiguous range of flattened layer indices).
    ``None`` where the natural order already is that (everything else).
    The write's counter PRNG seeds each flattened layer index, so the
    hoist decides which noise field lands on which expert."""
    lead = g_ndim - 2
    if kind == EXPERT_BATCHED and lead >= 2:
        return lead - 1
    return None


def flatten_lead(kind: str, g, x_tape, d_tape, scale, *lead_scales):
    """Collapse a container's lead dims onto the kernel's single layer
    axis (and any tape-rep dims into the token axis), the expert dim
    outermost for expert-batched kinds (:func:`hoist_axis`).

    ``g``: (lead..., K, N); tapes: (lead..., reps?, T, K|N); ``scale``
    and any ``lead_scales`` (the tape code scales, per expert for an
    expert stack): (lead...,) or scalars.  Returns ``(g3, x3, d3, scale1,
    *lead_scales1, unflatten)`` with ``g3`` (Lflat, K, N), each scale
    flattened alike to (Lflat,), and ``unflatten`` mapping the updated
    conductances back to the container's layout (any field of ``g``'s
    shape, a noise field say, flattens as ``g`` does).  2-D containers
    pass through, their tape-rep dims (the hybrid shared block's
    applications) collapsed into the token axis: the summed outer product
    over the applications is the rank-k write a reused array receives.
    """
    lead = g.ndim - 2
    if lead == 0:
        x3 = x_tape.reshape(-1, x_tape.shape[-1])
        d3 = d_tape.reshape(-1, d_tape.shape[-1])
        return (g, x3, d3, scale, *lead_scales, lambda gg: gg)
    hoist = hoist_axis(kind, g.ndim)

    def move(a):
        return torch.movedim(a, hoist, 0) if hoist is not None else a

    g_shape = g.shape
    gm = move(g)
    lflat = math.prod(gm.shape[:lead])
    g3 = gm.reshape(lflat, *gm.shape[lead:])
    x3 = move(x_tape).reshape(lflat, -1, x_tape.shape[-1])
    d3 = move(d_tape).reshape(lflat, -1, d_tape.shape[-1])
    s1 = [move(torch.broadcast_to(torch.as_tensor(s, device=g.device),
                                  g_shape[:lead])).reshape(lflat)
          for s in (scale, *lead_scales)]

    def unflatten(gg):
        gg = gg.reshape(*gm.shape[:lead], *gg.shape[-2:])
        if hoist is not None:
            gg = torch.movedim(gg, 0, hoist)
        return gg.reshape(g_shape)

    return (g3, x3, d3, *s1, unflatten)


def validate_device_params(params, cfg) -> None:
    """Fail loudly if a device-mode parameter tree carries a projection
    matrix that is not a crossbar container: it would train digitally
    while claiming to be analog."""
    from .tiled_analog import is_analog_container
    bad = []

    def walk(p, path):
        if is_analog_container(p):
            return
        if isinstance(p, dict):
            for k, v in p.items():
                walk(v, path + (str(k),))
            return
        if getattr(p, "ndim", 0) < 2:
            return
        kind = classify_param(path)
        if kind in KINDS:
            bad.append("/".join(path))
        elif kind is None:
            bad.append("/".join(path) + " (unclassified)")

    walk(params, ())
    if bad:
        raise ValueError(
            "device-mode parameter tree has projection matrices that are "
            "not crossbar containers (they would train digitally while "
            f"claiming analog): {bad}")


def container_paths(params) -> Tuple[Tuple[str, ...], ...]:
    """Paths of every crossbar container in a parameter tree, sorted."""
    from .tiled_analog import is_analog_container
    out = []

    def walk(p, path):
        if is_analog_container(p):
            out.append(path)
            return
        if isinstance(p, dict):
            for k in p:
                walk(p[k], path + (str(k),))

    walk(params, ())
    return tuple(sorted(out))
