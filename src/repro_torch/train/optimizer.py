"""Optimizers: SGD (with momentum) and AdamW, over parameter trees.

Port of ``repro.train.optimizer`` without ``analog_sgd`` (it comes with
the paper's MLP, ``ROADMAP.md``).  Each optimizer is an ``(init,
update)`` pair over nested dicts of tensors: ``update(grads, state,
params)`` returns ``(new_params, new_state)`` and changes nothing in
place, as the reference's pure functions do.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

Tensor = torch.Tensor


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Tuple[Any, Any]]  # (grads, state, params, **kw)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts, with the leaves of ``rest``
    (trees of the same structure) as further arguments."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree):
    """The leaves of nested dicts, keys sorted as ``jax.tree.leaves``
    orders them."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(torch.zeros_like, params)

    def update(grads, state, params, **_):
        if momentum == 0.0:
            new = tree_map(lambda p, g: p - lr * g.to(p.dtype), params,
                           grads)
            return new, state
        vel = tree_map(lambda v, g: momentum * v + g, state, grads)
        new = tree_map(lambda p, v: p - lr * v.to(p.dtype), params, vel)
        return new, vel
    return Optimizer(init, update)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "t": torch.zeros((), dtype=torch.int32,
                                 device=tree_leaves(params)[0].device)}

    def update(grads, state, params, **_):
        t = state["t"] + 1
        bc1 = 1 - b1 ** t.to(torch.float32)
        bc2 = 1 - b2 ** t.to(torch.float32)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(
            g.float()), state["v"], grads)

        def step(p, m_, v_):
            upd = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay:
                upd = upd + weight_decay * p.float()
            return (p.float() - lr * upd).to(p.dtype)

        new = tree_map(step, params, m, v)
        return new, {"m": m, "v": v, "t": t}
    return Optimizer(init, update)


def global_norm(tree) -> Tensor:
    """The 2-norm of all leaves together, in float32."""
    sq = [torch.sum(torch.square(g.float())) for g in tree_leaves(tree)]
    return torch.sqrt(sum(sq))


def clip_by_global_norm(tree, max_norm: float):
    """Scale every leaf by ``min(1, max_norm / (norm + 1e-9))``; returns
    ``(clipped, norm)``."""
    norm = global_norm(tree)
    # a tensor numerator: torch's ``scalar / tensor`` multiplies by the
    # reciprocal, the reference divides
    scale = torch.clamp(torch.tensor(max_norm, dtype=norm.dtype,
                                     device=norm.device) / (norm + 1e-9),
                        max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), tree), norm
