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
device mode.  The sharded analog train step's expert parallelism needs
no dispatch of its own: its expert stacks hold whole experts per rank
and each rank's read takes only its own experts' rows of the replicated
capacity buffer (``kernels.xbar_vmm.manual_collective_read``).  The
numeric step over data ranks dispatches once over the global batch, and
under its ``ep`` plan each ``model`` rank runs its own experts
(:func:`_moe_apply_flat`).
"""
from __future__ import annotations

import contextlib
import os
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import (AnalogMode, ModelConfig,
                                      resolve_analog_mode)
from repro_torch.core import shardctx
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


def route(p: dict, xt: Tensor, cfg: ModelConfig, seq: int = 0):
    """Router probabilities and the top-k choice of the (T, d) tokens
    ``xt``: ``(probs, top_p, top_i)``, gates renormalised over the k.
    ``seq``: the tokens are whole sequences of this length, and the
    product is taken one sequence at a time: on the card cuBLAS picks its
    split of the contraction by the row count, so a token's logits would
    otherwise hang on how many sequences share the product, and a data
    rank's routing on its share of the global batch."""
    x = xt.float()
    with _float32_matmul():
        if 1 < seq < x.shape[0] and x.shape[0] % seq == 0:
            w = p["router"]["w"]
            logits = torch.cat([x[i:i + seq] @ w
                                for i in range(0, x.shape[0], seq)])
        else:
            logits = project(p["router"], x, cfg.digital())
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
    the one-application tape contract.

    Under a numeric step's sequence parallelism ``x`` is this rank's
    chunk of the sequence: the data rank's whole sequences are gathered
    first, the dispatch runs on them as without it (alike on every
    ``model`` rank: the global capacity, drop order, aux loss and DAC
    scales), and this rank keeps its chunk of the output."""
    groups = int(os.environ.get("REPRO_MOE_GROUPS", "1"))
    npar = shardctx.numeric_context()
    if npar is not None and npar.sp_on:
        with npar.whole_sequence():
            y, aux = moe_apply(p, npar.seq_gather(x), cfg)
        return npar.seq_split(y), aux
    n = npar.n_data if npar is not None else 1
    if resolve_analog_mode(cfg) is not AnalogMode.DEVICE and groups > 1 \
            and groups % n == 0 and x.shape[0] % (groups // n) == 0:
        # over data ranks each holds groups / n whole groups of the
        # global batch: their dispatches are its own
        return _moe_apply_grouped(p, x, cfg, groups // n)
    return _moe_apply_flat(p, x, cfg)


def _moe_apply_grouped(p: dict, x: Tensor, cfg: ModelConfig, groups: int
                       ) -> Tuple[Tensor, Tensor]:
    """The flat dispatch within each of ``groups`` equal batch groups."""
    outs = [_moe_apply_flat(p, xg, cfg, local=True)
            for xg in x.reshape(groups, -1, *x.shape[1:])]
    y = torch.stack([o[0] for o in outs]).reshape(x.shape)
    return y, torch.mean(torch.stack([o[1] for o in outs]))


#: The routed pairs dropped at their expert's capacity, summed over the
#: MoE layers' forward calls since the caller last set it to 0 (a
#: tensor on the activations' device; no host sync).  A rematted
#: layer's backward replays its forward and adds again: count under
#: ``torch.no_grad``.
DROPPED = {"pairs": 0}


def _count_dropped(n: Tensor) -> None:
    prev = DROPPED["pairs"]
    same = isinstance(prev, torch.Tensor) and prev.device == n.device
    DROPPED["pairs"] = prev + n if same else n


def _moe_apply_flat(p: dict, x: Tensor, cfg: ModelConfig,
                    local: bool = False) -> Tuple[Tensor, Tensor]:
    """The flat dispatch.  In a numeric-parallel step
    (``core.shardctx.numeric_context``) it is the reference's one
    dispatch over the global batch: ``x`` holds this data rank's rows,
    the capacity is the global token count's, each routed pair takes its
    place in its expert's buffer after the pairs of the data ranks
    before this one (their per-expert counts gathered: integers, never
    tokens), and the aux loss's means run over the global tokens.  This
    rank's buffer holds its own kept pairs' rows of each expert's global
    buffer, as many rows an expert as its most kept pairs of one (a host
    sync; ``min(capacity, T)``, their bound, on meta tensors), and its
    expert reads take the whole buffer's kernel instance.  Under the plan's
    ``ep`` it runs only this ``model`` rank's experts: the tokens reach
    them through ``copy_to`` (their gradient summed over ``model``), and
    each pair's unweighted output is summed over ``model`` (one rank
    holds it, the others exact zeros) before the gates and the combine,
    which every rank applies alike.  ``local``: a batch group's
    dispatch of this rank's rows alone (``REPRO_MOE_GROUPS``)."""
    npar = shardctx.numeric_context()
    dp = npar.fsdp if npar is not None and not local else ()
    b, s, d = x.shape
    t = b * s
    k, e = cfg.top_k, cfg.n_experts
    dev = x.device
    xt = x.reshape(t, d)
    probs, top_p, top_i = route(p, xt, cfg, s)

    # load-balance aux (Switch): e * <f_i * p_i>, the means over the
    # global tokens
    one = F.one_hot(top_i[:, 0], e).float()
    if dp:
        t_all = t * npar.n_data
        me = shardctx.reduce_sum(torch.sum(probs, dim=0), npar.mesh,
                                 dp) / t_all
        ce = npar.data_sum(torch.sum(one, dim=0)) / t_all
    else:
        t_all = t
        me, ce = torch.mean(probs, dim=0), torch.mean(one, dim=0)
    aux = e * torch.sum(me * ce)

    # sort-based dispatch; a pair's place in its expert's global buffer
    # follows the pairs of the data ranks before this one
    flat_e = top_i.reshape(-1)
    flat_w = top_p.reshape(-1).to(x.dtype)
    flat_t = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], flat_w[order]
    counts = torch.bincount(flat_e, minlength=e)
    offsets = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t * k, device=dev) - offsets[se]
    cap = expert_capacity(t_all, cfg)
    rows = cap
    place = pos
    e0, n_e = npar.expert_range(e) if npar is not None else (0, e)
    if dp:
        before = npar.data_gather(counts)[:npar.data_index()].sum(dim=0)
        place = pos + before[se]
        rows = min(cap, t)      # the bound; meta tensors (the dry run) keep it
        if not x.is_meta:       # this rank's most kept pairs of an expert
            kept = torch.minimum(torch.clamp(cap - before, min=0), counts)
            rows = max(1, int(kept[e0:e0 + n_e].max()))
    keep = place < cap
    _count_dropped(t * k - keep.sum())

    # this rank's experts' rows, (E_mine, rows, d); a pair past its
    # expert's capacity or another rank's writes the spare row, cut off
    mine = keep & (se >= e0) & (se < e0 + n_e)
    slot = torch.where(mine, (se - e0) * rows + pos,
                       torch.full_like(pos, n_e * rows))
    xe = xt
    if n_e < e:
        xe = shardctx.copy_to(xt, npar.mesh, npar.tp)
    buf = x.new_zeros((n_e * rows + 1, d)).index_put((slot,), xe[st])
    buf = buf[:n_e * rows].view(n_e, rows, d)

    # expert FFN, batched over the expert dim
    ew = p["experts"]
    whole = cap if dp else None     # rows of each expert's global buffer
    up = expert_project(ew["w_up"], buf, cfg, whole)
    gate = expert_project(ew["w_gate"], buf, cfg, whole)
    out_buf = expert_project(ew["w_down"], _act(cfg)(gate) * up, cfg, whole)

    # combine: each pair's output back in (token, slot) order, the gate
    # applied, then each token's k contributions summed from zero in
    # ascending expert order
    out_flat = torch.cat([out_buf.reshape(n_e * rows, d),
                          out_buf.new_zeros((1, d))])
    pair = out_flat[slot]
    if n_e < e:
        pair = shardctx.reduce_from(pair, npar.mesh, npar.tp)
    gathered = pair * (sw * keep.to(x.dtype))[:, None]
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
