"""Optimizers: SGD (with momentum) and AdamW, over parameter trees.

Port of ``repro.train.optimizer``.  Each optimizer is an ``(init,
update)`` pair over nested dicts of tensors: ``update(grads, state,
params)`` returns ``(new_params, new_state)`` and changes nothing in
place, as the reference's pure functions do.  ``analog_sgd`` pushes the
crossbar layers' gradients through the device model.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.crossbar import CrossbarConfig
from repro_torch.core.device import apply_update

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


def tree_map_path(fn, tree, *rest, path=()):
    """:func:`tree_map` with each leaf's key path as ``fn``'s first
    argument."""
    if isinstance(tree, dict):
        return {k: tree_map_path(fn, v, *(r[k] for r in rest),
                                 path=path + (k,))
                for k, v in tree.items()}
    return fn(path, tree, *rest)


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(torch.zeros_like, params)

    def update(grads, state, params, consume: bool = False, **_):
        """The new parameters and state.  ``consume``: ``grads`` is used
        up, so plain sgd forms each new leaf in its gradient's memory
        (``-(lr g) + p``, the bits of ``p - lr g``) and allocates
        nothing."""
        if momentum == 0.0:
            def leaf(p, g):
                if consume and g.dtype == p.dtype:
                    return g.mul_(-lr).add_(p)
                return p - lr * g.to(p.dtype)
            return tree_map(leaf, params, grads), state
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

    def update(grads, state, params, consume: bool = False, **_):
        """The new parameters and state.  ``consume``: ``grads`` (a dict
        tree) is emptied leaf by leaf as each leaf's update is made, so
        a gradient's memory is free before the next leaf's new moments
        are allocated (the same arithmetic)."""
        t = state["t"] + 1
        bc1 = 1 - b1 ** t.to(torch.float32)
        bc2 = 1 - b2 ** t.to(torch.float32)

        def leaf(p, m_, v_, g):
            # the reference's expressions, each product and sum rounded as
            # there; in place on fresh tensors, so a leaf's update holds
            # one temporary beside its new moments
            g = g.float()
            m = b1 * m_
            m += (1 - b1) * g
            v = b2 * v_
            v += (1 - b2) * torch.square(g)
            den = torch.sqrt_(v / bc2).add_(eps)
            upd = torch.div(m, bc1).div_(den)
            del den
            if weight_decay:
                upd += weight_decay * p.float()
            upd *= lr
            return (p.float() - upd).to(p.dtype), m, v

        def walk(p, m_, v_, g):
            if not isinstance(p, dict):
                return leaf(p, m_, v_, g)
            out = {}
            for k in list(p):
                out[k] = walk(p[k], m_[k], v_[k], g[k])
                if consume:
                    del g[k]
            return out
        triples = walk(params, state["m"], state["v"], grads)
        return (tree_map(lambda x: x[0], triples),
                {"m": tree_map(lambda x: x[1], triples),
                 "v": tree_map(lambda x: x[2], triples), "t": t})
    return Optimizer(init, update)


def global_norm(tree, sq_total=None) -> Tensor:
    """The 2-norm of all leaves together, in float32.  ``sq_total(tree)``
    gives the leaves' total sum of squares where they are blocks of
    leaves held over several ranks
    (``launch.sharding.NumericParallel.sq_total``)."""
    if sq_total is not None:
        return torch.sqrt(sq_total(tree))
    sq = [torch.sum(torch.square(g.float())) for g in tree_leaves(tree)]
    return torch.sqrt(sum(sq))


def clip_by_global_norm(tree, max_norm: float, sq_total=None):
    """Scale every leaf by ``min(1, max_norm / (norm + 1e-9))``; returns
    ``(clipped, norm)``; ``sq_total`` as in :func:`global_norm`."""
    norm = global_norm(tree, sq_total)
    # a tensor numerator: torch's ``scalar / tensor`` multiplies by the
    # reciprocal, the reference divides
    scale = torch.clamp(torch.tensor(max_norm, dtype=norm.dtype,
                                     device=norm.device) / (norm + 1e-9),
                        max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), tree), norm


# --------------------------------------------------------------------------
# Analog SGD: the paper's outer-product update through the device model.
# --------------------------------------------------------------------------

def _is_analog_leaf_container(d: Any) -> bool:
    return isinstance(d, dict) and set(d) >= {"g", "ref", "w_scale"}


def analog_sgd(lr: float, cfg: CrossbarConfig) -> Optimizer:
    """SGD where conductance leaves update through the device model.

    Expects analog layers shaped ``{"g", "ref", "w_scale"}`` whose
    gradients arrive in weight units (``core.analog_linear``); each gets
    ``apply_update(g, -lr * dg * w_scale)``.  Other leaves take plain
    SGD.  A noisy device needs its write-noise fields as input:
    ``noise=``, a dict from ``"/".join(path)`` to a standard-normal field
    of ``g``'s shape.  (The reference folds ``hash(path) % 2**31`` into
    its key, and a tuple of strings hashes differently in every Python
    process, so the port takes the fields instead of a key.)
    """

    def init(params):
        return ()

    def update(grads, state, params, noise: Optional[Dict] = None, **_):
        def field(path):
            if cfg.device.write_noise == 0.0:
                return None
            name = "/".join(path)
            if noise is None or name not in noise:
                raise ValueError("analog_sgd with a noisy device requires "
                                 f"noise[{name!r}]")
            return noise[name]

        def walk(p, g, path=()):
            if _is_analog_leaf_container(p):
                dg_req = -lr * g["g"] * p["w_scale"]
                return {**p, "g": apply_update(p["g"], dg_req, cfg.device,
                                               field(path))}
            if isinstance(p, dict):
                return {k: walk(p[k], g[k], path + (k,)) for k in p}
            return p - lr * g.to(p.dtype)

        return walk(params, grads), state
    return Optimizer(init, update)
