"""Int8 gradient compression with error feedback (port of
``repro.train.compress``).

Models the wire format of a compressed data-parallel reduction (1 byte a
gradient element instead of 4).  Error feedback (Seide et al., 2014;
Karimireddy et al., 2019) carries the quantisation residual to the next
step, so SGD convergence is preserved.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.core.adc import divisor

from .optimizer import tree_leaves, tree_map, tree_map_path

Tensor = torch.Tensor
LEVELS = 127.0


def init_error_feedback(params) -> Any:
    """Zero residuals, one float32 leaf per parameter leaf."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def _q8(g: Tensor, amax=None) -> Tuple[Tensor, Tensor]:
    """int8 codes and the leaf's scale ``max|g| / 127``.  The divisors
    are tensors: on the card a division by a Python number is a product
    with its reciprocal, not the reference's division.  ``amax`` turns a
    block's max into the whole leaf's (a max over the ranks)."""
    m = g.abs().amax()
    if amax is not None:
        m = amax(m)
    scale = torch.clamp(m, min=1e-12) / divisor(LEVELS, g)
    q = torch.clamp(torch.round(g / scale), -LEVELS, LEVELS).to(torch.int8)
    return q, scale


def _dq8(q: Tensor, scale: Tensor) -> Tensor:
    return q.to(torch.float32) * scale


def compress_decompress(grads, err_fb, leaf_max=None) -> Tuple[Any, Any]:
    """Quantise each gradient leaf (plus its carried residual) to int8
    with one scale per leaf, dequantise, and carry the new residual:
    ``(new_grads, new_err_fb)``.  On blocks, ``leaf_max(path, m)`` turns a
    block's max into the whole leaf's (the reference's scale is the max
    over the whole leaf: ``launch.sharding.NumericParallel.leaf_max``)."""
    def leaf(path, g, e):
        g32 = g.to(torch.float32) + e
        amax = None if leaf_max is None else (
            lambda m: leaf_max(path, m))
        deq = _dq8(*_q8(g32, amax))
        return deq.to(g.dtype), g32 - deq

    pairs = tree_map_path(leaf, grads, err_fb)
    return (tree_map(lambda t: t[0], pairs),
            tree_map(lambda t: t[1], pairs))


def compression_ratio(grads) -> float:
    """Wire bytes against float32: an int8 payload plus one float32 scale
    a leaf."""
    leaves = tree_leaves(grads)
    total = sum(g.numel() * 4 for g in leaves)
    wire = sum(g.numel() + 4 for g in leaves)
    return wire / total
