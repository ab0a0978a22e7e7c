"""Carry a parameter tree of the JAX package across into the port.

The reference's parameter trees are nested dicts of arrays: digital
``{"w"}`` projections, the embedding and the norm scales, and crossbar
containers ``{"g", "ref", "w_scale"}`` (scan-stacked as (L, K, N) and
(L,)).  The port uses the same structure with torch tensors, so a tree
handed over as numpy arrays (``jax.tree.map(np.asarray, params)``) maps
leaf for leaf.  This module takes numpy only and imports nothing of the
JAX package.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device="cuda"):
    """Nested dicts of numpy arrays -> the same dicts of torch tensors on
    ``device`` (float32 leaves stay float32; copies, never views)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.kind not in "fiub" or arr.dtype.itemsize > 8:
        raise TypeError(f"unsupported parameter leaf of dtype {arr.dtype}")
    return torch.from_numpy(np.array(arr, copy=True)).to(device)
