"""Train-step builders for the digital (numeric) model.

Port of ``repro.train.train_loop``: the float32 SGD baseline that the
analog runs are measured against.  ``TrainState`` is a plain dict
``{"params", "opt", "step", "err_fb"}``; the step returns a new state.
Gradients come from ``torch.autograd`` through ``models.model.loss_fn``.
With ``analog=True, analog_mode="fakequant"`` this is the reference's
QAT step (``launch/train.py --analog``, ``adamw``): every projection's
forward is the fakequant read, on the card its kernel inside
``kernels.ops.FakequantRead``, and its gradient the reference's (no
straight-through estimator).  ``grad_compress`` passes the gradients
through int8 compression with error feedback (``train.compress``; the
residuals ride in ``state["err_fb"]``), and ``grad_reduce`` (the
data-parallel mean of ``launch.train``) acts on them first.

With ``mesh`` the step is FSDP and tensor-parallel: the state holds this
rank's block of every numeric leaf (:func:`shard_state`,
``launch.sharding.state_specs``), the loss runs under
``launch.sharding.NumericParallel`` (each layer gathered at use, the
dense family's compute split over ``model``), the gathers' backward
``reduce_scatter``s the gradients over the FSDP axes, and clipping and
compression take their norms and scales over the whole leaves.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import shardctx
from repro_torch.models import model as M

from . import compress
from .optimizer import Optimizer, clip_by_global_norm, tree_map

Tensor = torch.Tensor


def init_state(generator: Union[torch.Generator, int], cfg: ModelConfig,
               optimizer: Optimizer, device="cuda",
               grad_compress: bool = False) -> dict:
    """A fresh train state: random parameters from ``generator`` (see
    ``models.model.init_params``), the optimizer's state, a step counter
    and, with ``grad_compress``, zero error-feedback residuals."""
    params = M.init_params(cfg, generator, device)
    return {"params": params, "opt": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=device),
            "err_fb": (compress.init_error_feedback(params)
                       if grad_compress else ())}


def abstract_state(cfg: ModelConfig, optimizer: Optimizer,
                   grad_compress: bool = False) -> dict:
    """:func:`init_state`'s tree on the ``meta`` device: every leaf's
    shape and dtype, nothing allocated and nothing drawn (the dry run)."""
    return init_state(0, cfg, optimizer, "meta", grad_compress)


def init_sharded_state(generator, cfg: ModelConfig, optimizer: Optimizer,
                       mesh, device="cuda",
                       grad_compress: bool = False) -> dict:
    """:func:`init_state`'s state as this rank of ``mesh`` holds it: the
    parameters drawn whole (the same values on every mesh), cut into
    this rank's blocks and the whole tree dropped; the optimizer state
    and the residuals made from the blocks."""
    from repro_torch.launch import sharding as S
    params = M.init_params(cfg, generator, device)
    specs = S.params_shardings(params, cfg, mesh)
    blocks = S.shard_tree(params, specs, cfg, mesh)
    del params
    return {"params": blocks, "opt": optimizer.init(blocks),
            "step": torch.zeros((), dtype=torch.int32, device=device),
            "err_fb": (compress.init_error_feedback(blocks)
                       if grad_compress else ())}


def shard_state(state: dict, cfg: ModelConfig, mesh) -> dict:
    """This rank's blocks of a whole train state on ``mesh``
    (``launch.sharding.state_specs``)."""
    from repro_torch.launch import sharding as S
    return S.shard_tree(state, S.state_specs(state, cfg, mesh), cfg, mesh)


def unshard_state(state: dict, cfg: ModelConfig, mesh) -> dict:
    """The whole train state from every rank's blocks (ordered gathers,
    no arithmetic)."""
    from repro_torch.launch import sharding as S
    params = M.init_params(cfg, None, "meta")
    like = {"params": params, "opt": {"m": params, "v": params, "t": None},
            "step": None, "err_fb": params}
    return S.unshard_tree(state, S.state_specs(state, cfg, mesh, params),
                          like, cfg, mesh)


def make_train_step(cfg: ModelConfig, optimizer: Optimizer,
                    clip_norm: float = 1.0,
                    grad_compress: bool = False,
                    grad_reduce: Optional[Callable] = None,
                    mesh=None) -> Callable:
    """``state, metrics = step(state, batch)``: the loss and its gradients,
    the gradients reduced by ``grad_reduce`` (a function of the gradient
    tree; none on one device), with ``grad_compress`` compressed to int8
    with error feedback (a state without residuals starts from zeros),
    clipped to ``clip_norm`` in global 2-norm, then the optimizer's
    update.  ``metrics`` holds ``loss``, ``grad_norm`` (before clipping),
    ``ce`` and ``aux``.  With ``mesh`` (a ``launch.mesh.Mesh`` over
    ``data`` / ``model``) the step is FSDP and tensor-parallel on a state
    from :func:`shard_state` (see the module docstring); ``grad_reduce``
    is then the numeric context's own, and ``step.numeric`` the
    context."""
    npar = None
    if mesh is not None:
        from repro_torch.launch.sharding import NumericParallel
        npar = NumericParallel(cfg, mesh)
        grad_reduce = npar.reduce_grads

    def train_step(state: dict, batch: Dict[str, Tensor]
                   ) -> Tuple[dict, Dict[str, Tensor]]:
        params = tree_map(lambda p: p.detach().requires_grad_(True),
                          state["params"])
        with shardctx.numeric_parallel(npar):
            loss, metrics = M.loss_fn(params, batch, cfg)
            loss.backward()
        grads = tree_map(lambda p: p.grad if p.grad is not None
                         else torch.zeros_like(p), params)
        with torch.no_grad():
            if grad_reduce is not None:
                grads = grad_reduce(grads)
            err_fb = state["err_fb"]
            if grad_compress:
                if isinstance(err_fb, tuple):
                    err_fb = compress.init_error_feedback(grads)
                grads, err_fb = compress.compress_decompress(
                    grads, err_fb, npar.leaf_max if npar else None)
            grads, gnorm = clip_by_global_norm(
                grads, clip_norm, npar.sq_total if npar else None)
            new_params, opt = optimizer.update(
                grads, state["opt"], tree_map(torch.Tensor.detach, params),
                consume=True)
        new_state = {"params": new_params, "opt": opt,
                     "step": state["step"] + 1, "err_fb": err_fb}
        out = {"loss": loss.detach(), "grad_norm": gnorm,
               **{k: v.detach() for k, v in metrics.items()}}
        return new_state, out
    train_step.numeric = npar
    return train_step


def make_eval_step(cfg: ModelConfig) -> Callable:
    """``metrics = eval_step(params, batch)``: the loss without
    gradients."""
    def eval_step(params, batch):
        with torch.no_grad():
            loss, metrics = M.loss_fn(params, batch, cfg)
        return {"loss": loss, **metrics}
    return eval_step
