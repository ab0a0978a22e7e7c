"""Pipeline parallelism: a GPipe schedule over the ``stage`` axis of a
mesh (port of ``repro.launch.pipeline``).

The layer stack splits into S stages, one per rank of the ``stage``
axis.  Microbatches flow through an (M + S - 1)-step software pipeline:
at every step each stage runs its computation on what it holds and hands
its output to the next stage with a point-to-point send/receive.

``dist.send`` and ``dist.recv`` carry no gradient, so each hand-over is a
``torch.autograd.Function`` (:class:`_Rotate`) whose backward sends the
cotangent the other way, and the closing broadcast of the last stage's
outputs (:class:`_FromLast`) returns the cotangent to the last stage
only: every rank computes the same loss from the replicated outputs, and
the gradients are those of one loss.

    mesh = make_mesh((S,), ("stage",), device)
    y = pipeline_apply(mesh, stage_fn, stage_params, x, microbatches=M)

``stage_params`` leaves carry a leading stage dim (S, ...); each rank
applies its own slice.  The bubble fraction is (S - 1) / (M + S - 1).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

Tensor = torch.Tensor


def _ring_exchange(send: Tensor, to: int, frm: int, group) -> Tensor:
    """Send ``send`` to group rank ``to`` while receiving a tensor of its
    shape from group rank ``frm``."""
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send.contiguous(),
                      dist.get_global_rank(group, to), group),
           dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, frm),
                      group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


class _Rotate(torch.autograd.Function):
    """Stage ``i`` hands its output to stage ``i + 1`` (mod S) and takes
    stage ``i - 1``'s; the backward hands the cotangent back."""

    @staticmethod
    def forward(ctx, out, idx, s, group):
        ctx.idx, ctx.s, ctx.group = idx, s, group
        return _ring_exchange(out, (idx + 1) % s, (idx - 1) % s, group)

    @staticmethod
    def backward(ctx, grad):
        idx, s = ctx.idx, ctx.s
        back = _ring_exchange(grad, (idx - 1) % s, (idx + 1) % s, ctx.group)
        return back, None, None, None


class _FromLast(torch.autograd.Function):
    """The last stage's tensor on every rank (a broadcast); the cotangent
    goes back to the last stage alone."""

    @staticmethod
    def forward(ctx, t, idx, s, group):
        ctx.last = idx == s - 1
        out = t.detach().clone()
        dist.broadcast(out, dist.get_global_rank(group, s - 1), group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.last else torch.zeros_like(grad)), None, None, \
            None


def pipeline_apply(mesh, stage_fn: Callable, stage_params, x: Tensor,
                   microbatches: int, axis: str = "stage") -> Tensor:
    """Run ``x`` through the S pipelined stages of ``mesh``'s ``axis``.

    ``x`` (batch, ...) is split into ``microbatches`` equal slices along
    dim 0, the same on every rank; ``stage_fn(params, h)`` is one stage on
    one microbatch, with activations of one shape throughout.  Returns
    the whole output batch, on every rank.
    """
    s = mesh.shape[axis]
    idx = mesh.coords[axis]
    group = mesh.group(axis)
    b = x.shape[0]
    if b % microbatches:
        raise ValueError("the batch must divide into microbatches")
    m = microbatches
    mb = x.reshape(m, b // m, *x.shape[1:])
    params = _stage_slice(stage_params, idx)
    first = torch.tensor(idx == 0, device=x.device)
    state = torch.zeros_like(mb[0])
    outputs = [torch.zeros_like(mb[0]) for _ in range(m)]
    for t in range(m + s - 1):
        # stage 0 takes microbatch t (while there is one), the others
        # what the previous stage handed over; both stay in the graph so
        # every rank's backward runs every hand-over
        inp = torch.where(first, mb[min(t, m - 1)], state)
        out = stage_fn(params, inp)
        retire = min(max(t - (s - 1), 0), m - 1)
        valid = torch.tensor(idx == s - 1 and t >= s - 1, device=x.device)
        outputs[retire] = torch.where(valid, out, outputs[retire])
        state = _Rotate.apply(out, idx, s, group)
    y = _FromLast.apply(torch.stack(outputs), idx, s, group)
    return y.reshape(b, *y.shape[2:])


def _stage_slice(tree, i: int):
    if isinstance(tree, dict):
        return {k: _stage_slice(v, i) for k, v in tree.items()}
    return tree[i]


def bubble_fraction(stages: int, microbatches: int) -> float:
    return (stages - 1) / (microbatches + stages - 1)
