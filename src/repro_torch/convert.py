"""Carry a parameter tree, or a train state, of the JAX package across
into the port.

The reference's parameter trees are nested dicts of arrays: digital
``{"w"}`` projections, the embedding and the norm scales, and crossbar
containers ``{"g", "ref", "w_scale"}`` (scan-stacked as (L, K, N) and
(L,)), with a ``g_carry`` leaf under periodic carry.  Its analog train
state is ``{"params": tree, "step": int32}``, and its numeric one
(``train_loop``) ``{"params", "opt", "step", "err_fb": ()}``, where
``opt`` is the optimizer's state: ``()`` for plain SGD, a parameter tree
of velocities with momentum, ``{"m", "v", "t"}`` for AdamW.  The port
uses the same structures with torch tensors, so a tree handed over as
numpy arrays (``jax.tree.map(np.asarray, state)``) maps leaf for leaf.
The paper's MLP carries a tuple of two layers: ``(w1, w2)`` (numeric),
two crossbar layers ``{"g", "ref", "w_scale"}`` (analog) or two
periodic-carry stacks, whose ``"base"`` is a Python float and stays one
(hand the stack over as it is, or with its arrays as numpy arrays).
This module takes numpy only and imports nothing of the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device="cuda"):
    """Nested dicts (and tuples) of numpy arrays — a parameter tree, an
    analog train state ``{"params", "step"}`` or a numeric one with its
    optimizer state — -> the same structure of torch tensors on
    ``device`` (float32 leaves stay float32, the int32 step stays int32;
    copies, never views; an empty tuple stays an empty tuple; a Python
    number, such as a periodic-carry stack's ``"base"``, stays a Python
    number)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(params_from_numpy(v, device) for v in tree)
    if isinstance(tree, (int, float)):
        return tree
    arr = np.asarray(tree)
    if arr.dtype.kind not in "fiub" or arr.dtype.itemsize > 8:
        raise TypeError(f"unsupported parameter leaf of dtype {arr.dtype}")
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def params_to_numpy(tree):
    """The inverse of :func:`params_from_numpy`: the same structure with
    every tensor as a numpy array (a copy on the host); Python numbers
    stay Python numbers."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(params_to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    return tree
