"""Carry a parameter tree, or a train state, of the JAX package across
into the port.

The reference's parameter trees are nested dicts of arrays: digital
``{"w"}`` projections, the embedding and the norm scales, and crossbar
containers ``{"g", "ref", "w_scale"}`` (scan-stacked as (L, K, N) and
(L,)).  Its analog train state is ``{"params": tree, "step": int32}``.
The port uses the same structures with torch tensors, so a tree handed
over as numpy arrays (``jax.tree.map(np.asarray, state)``) maps leaf for
leaf.  This module takes numpy only and imports nothing of the JAX
package.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device="cuda"):
    """Nested dicts of numpy arrays (a parameter tree or a train state
    ``{"params", "step"}``) -> the same dicts of torch tensors on
    ``device`` (float32 leaves stay float32, the int32 step stays int32;
    copies, never views)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.kind not in "fiub" or arr.dtype.itemsize > 8:
        raise TypeError(f"unsupported parameter leaf of dtype {arr.dtype}")
    return torch.from_numpy(np.array(arr, copy=True)).to(device)
