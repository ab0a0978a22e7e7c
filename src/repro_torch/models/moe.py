"""Mixture-of-Experts FFN with sort-based token dispatch (port of
``repro.models.moe``, its flat dispatch).

Dispatch is the reference's argsort-to-expert-order, capacity-bounded
scatter: every routed (token, expert) pair is sorted stably by expert,
takes the next free row of its expert's (capacity, d) buffer, and is
dropped when the expert's buffer is full (capacity
``core.analog_registry.expert_capacity``).  The experts then run as one
expert-batched projection per weight (``layers.expert_project``: an
(E, cap, d) buffer through an (E, d, f) stack), so in device mode each
expert stack is one read of its crossbar container.

Top-k routing with renormalised gates, the Switch load-balancing aux
loss, shared (always-on) experts, and a capacity factor; an overflowing
token falls back to the shared path and the residual only.

The combine is deterministic: each token sums its k contributions in
one fixed order (ascending expert index, from zero), the order of the
reference's scatter-add over the expert-sorted pairs, with no atomics.

``REPRO_MOE_GROUPS=G`` dispatches within G batch groups, each with its
own capacity (the reference's one-device grouped dispatch), outside
device mode.  The sharded train step's expert parallelism needs no
dispatch of its own: its expert stacks hold whole experts per rank and
each rank's read takes only its own experts' rows of the replicated
capacity buffer (``kernels.xbar_vmm.manual_collective_read``).
"""
from __future__ import annotations

import contextlib
import os
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import (AnalogMode, ModelConfig,
                                      resolve_analog_mode)
from repro_torch.core.analog_registry import expert_capacity
from repro_torch.core.tiled_analog import (crossbar_from_model,
                                           is_analog_container,
                                           program_linear, readout,
                                           stack_trees)

from .layers import dense_init, expert_project, ffn, ffn_init, project

Tensor = torch.Tensor


def _expert_stack(generator: torch.Generator, cfg: ModelConfig, d_in: int,
                  d_out: int, device=None):
    """An (E, d_in, d_out) stack of expert weights, drawn one expert at a
    time; in device mode each matrix is programmed onto its own tile grid
    (its own calibration) as it is drawn, so the float32 weights of a
    whole stack are never held at once."""
    mats = (dense_init(generator, d_in, d_out, device)
            for _ in range(cfg.n_experts))
    if resolve_analog_mode(cfg) is AnalogMode.DEVICE:
        xc = crossbar_from_model(cfg)
        return stack_trees((program_linear(w, xc) for w in mats),
                           cfg.n_experts)
    out = torch.empty((cfg.n_experts, d_in, d_out), dtype=torch.float32,
                      device=device)
    for e, w in enumerate(mats):
        out[e] = w
    return out


def moe_init(generator: torch.Generator, cfg: ModelConfig,
             device=None) -> dict:
    """Router (digital: it gates, it carries no stationary matmul worth a
    tile grid) and the per-expert FFN stacks; in device mode the stacks
    are expert-batched crossbar containers, one tile grid and one
    calibration per expert.  Draws come from ``generator`` (not the
    reference's ``jax.random`` draws)."""
    ffe = cfg.d_ff_expert or cfg.d_ff
    p = {"router": {"w": dense_init(generator, cfg.d_model, cfg.n_experts,
                                    device)},
         "experts": {
             "w_up": _expert_stack(generator, cfg, cfg.d_model, ffe, device),
             "w_gate": _expert_stack(generator, cfg, cfg.d_model, ffe,
                                     device),
             "w_down": _expert_stack(generator, cfg, ffe, cfg.d_model,
                                     device)}}
    if cfg.n_shared_experts:
        p["shared"] = ffn_init(generator, cfg, device,
                               d_ff=cfg.n_shared_experts * ffe)
    return p


def _act(cfg: ModelConfig):
    if cfg.act == "gelu":
        return lambda t: F.gelu(t, approximate="tanh")
    return F.silu


@contextlib.contextmanager
def _float32_matmul():
    """The router's float32 product in full float32 on the card (no TF32),
    whatever the caller set: a routing decision must not hang on the
    matmul precision."""
    prev = torch.backends.cuda.matmul.allow_tf32
    # audit: allow RA301 -- scoped to the router's matmul and restored below: a routing decision must not hang on the caller's precision
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        # audit: allow RA301 -- restores the caller's own setting
        torch.backends.cuda.matmul.allow_tf32 = prev


def route(p: dict, xt: Tensor, cfg: ModelConfig):
    """Router probabilities and the top-k choice of the (T, d) tokens
    ``xt``: ``(probs, top_p, top_i)``, gates renormalised over the k."""
    with _float32_matmul():
        logits = project(p["router"], xt.float(), cfg.digital())
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, cfg.top_k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return probs, top_p, top_i


def moe_apply(p: dict, x: Tensor, cfg: ModelConfig) -> Tuple[Tensor, Tensor]:
    """``(output, aux_loss)`` of the MoE FFN on ``x`` (B, S, d); ``aux``
    is the Switch load-balancing loss.

    ``REPRO_MOE_GROUPS=G`` (outside device mode, when G divides the batch)
    dispatches within G independent batch groups, each its own routing,
    sort and capacity, and averages their aux losses (the reference's
    vmapped grouped dispatch; its ``REPRO_MOE_EXPLICIT`` variant differs
    only in the sharding constraints on its buffers, which eager torch
    does not have).  Device mode always dispatches globally: a grouped
    dispatch would apply each expert container once per group, against
    the one-application tape contract."""
    groups = int(os.environ.get("REPRO_MOE_GROUPS", "1"))
    if resolve_analog_mode(cfg) is not AnalogMode.DEVICE and groups > 1 \
            and x.shape[0] % groups == 0:
        return _moe_apply_grouped(p, x, cfg, groups)
    return _moe_apply_flat(p, x, cfg)


def _moe_apply_grouped(p: dict, x: Tensor, cfg: ModelConfig, groups: int
                       ) -> Tuple[Tensor, Tensor]:
    """The flat dispatch within each of ``groups`` equal batch groups."""
    outs = [_moe_apply_flat(p, xg, cfg)
            for xg in x.reshape(groups, -1, *x.shape[1:])]
    y = torch.stack([o[0] for o in outs]).reshape(x.shape)
    return y, torch.mean(torch.stack([o[1] for o in outs]))


def _moe_apply_flat(p: dict, x: Tensor, cfg: ModelConfig
                    ) -> Tuple[Tensor, Tensor]:
    b, s, d = x.shape
    t = b * s
    k, e = cfg.top_k, cfg.n_experts
    dev = x.device
    xt = x.reshape(t, d)
    probs, top_p, top_i = route(p, xt, cfg)

    # load-balance aux (Switch): e * <f_i * p_i>
    me = torch.mean(probs, dim=0)
    ce = torch.mean(F.one_hot(top_i[:, 0], e).float(), dim=0)
    aux = e * torch.sum(me * ce)

    # sort-based dispatch into (E, cap, d); a pair past its expert's
    # capacity writes the spare row e * cap, which is cut off
    flat_e = top_i.reshape(-1)
    flat_w = top_p.reshape(-1).to(x.dtype)
    flat_t = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], flat_w[order]
    counts = torch.bincount(flat_e, minlength=e)
    offsets = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t * k, device=dev) - offsets[se]
    cap = expert_capacity(t, cfg)
    keep = pos < cap
    slot = torch.where(keep, se * cap + pos, torch.full_like(pos, e * cap))
    buf = x.new_zeros((e * cap + 1, d)).index_put((slot,), xt[st])
    buf = buf[:e * cap].view(e, cap, d)

    # expert FFN, batched over the expert dim
    ew = p["experts"]
    up = expert_project(ew["w_up"], buf, cfg)
    gate = expert_project(ew["w_gate"], buf, cfg)
    out_buf = expert_project(ew["w_down"], _act(cfg)(gate) * up, cfg)

    # combine: each pair's weighted output back in (token, slot) order,
    # then each token's k contributions summed from zero in ascending
    # expert order
    out_flat = torch.cat([out_buf.reshape(e * cap, d),
                          out_buf.new_zeros((1, d))])
    gathered = out_flat[slot] * (sw * keep.to(x.dtype))[:, None]
    per_pair = gathered[torch.argsort(order)].view(t, k, d)
    by_expert = torch.argsort(top_i, dim=-1, stable=True)
    per_pair = torch.gather(per_pair, 1, by_expert[..., None].expand(t, k, d))
    y = x.new_zeros((t, d))
    for j in range(k):
        y = y + per_pair[:, j]

    if "shared" in p:
        y = y + ffn(p["shared"], xt, cfg)
    return y.reshape(b, s, d), aux


def moe_dense_reference(p: dict, x: Tensor, cfg: ModelConfig) -> Tensor:
    """Oracle: every expert computed densely over all tokens and masked by
    the top-k gates (tests)."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    _, top_p, top_i = route(p, xt, cfg)
    gates = torch.zeros((b * s, cfg.n_experts), dtype=torch.float32,
                        device=x.device).scatter(1, top_i, top_p)
    ew = p["experts"]
    if is_analog_container(ew["w_up"]):
        xc = crossbar_from_model(cfg)
        ew = {k: readout(ew[k], xc) for k in ("w_up", "w_gate", "w_down")}
    up = torch.einsum("td,edf->etf", xt, ew["w_up"].to(xt.dtype))
    gate = torch.einsum("td,edf->etf", xt, ew["w_gate"].to(xt.dtype))
    out = torch.einsum("etf,efd->etd", _act(cfg)(gate) * up,
                       ew["w_down"].to(xt.dtype))
    y = torch.einsum("etd,te->td", out, gates.to(xt.dtype))
    if "shared" in p:
        y = y + ffn(p["shared"], xt, cfg)
    return y.reshape(b, s, d)
