"""Analog parameter registry, dense family (port of the parts of
``repro.core.analog_registry`` the serving slice needs).

It owns the mapping from a parameter path to whether the matrix there
lives on crossbar tiles and which consumer kind it is.  Expert stacks,
tape routes, update views and sharding layouts follow with the families
and the training slice that need them (``ROADMAP.md``).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

#: Producer: activations drive the rows, output columns split under TP.
COLUMN_PARALLEL = "column_parallel"
#: Consumer: the projection reduces a TP-split feature dim (wo/w_down/...).
ROW_PARALLEL = "row_parallel"
#: A stack of per-expert matrices applied to expert-batched activations.
EXPERT_BATCHED = "expert_batched"

KINDS = (COLUMN_PARALLEL, ROW_PARALLEL, EXPERT_BATCHED)

#: Leaf names of a tiled-crossbar container (plus the training tape slots).
ANALOG_LEAVES = ("g", "ref", "w_scale", "g_carry", "x_tape", "d_tape")

ROW_PARALLEL_KEYS = frozenset({"wo", "w_down", "out_proj"})
COLUMN_PARALLEL_KEYS = frozenset({
    "wq", "wk", "wv", "wqkv", "w_up", "w_gate", "w_upgate",
    "wkv_a", "wkv_b", "in_proj", "shared_in",
})
PROJECTION_KEYS = ROW_PARALLEL_KEYS | COLUMN_PARALLEL_KEYS

#: The dict key under which MoE stacks its per-expert matrices.
EXPERT_STACK_KEY = "experts"

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
