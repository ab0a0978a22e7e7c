"""Periodic carry (paper §VI.B, ref [35] — Agarwal et al., VLSI 2017).

Port of ``repro.core.periodic_carry``: the multi-cell stack of the
paper's MLP (``pc_*``) and the transfer the transformer containers use
(:func:`carry_fold`).  A weight is held by ``n_cells`` devices with place
values ``base^k``.  Training writes land on the least-significant cell,
which stays near the middle of its window where the device is most
linear, and periodically its accumulated value is *carried* into the next
cell by a serial closed-loop (read-verify-write) transfer, which is
accurate.

Effective weight (conductance units):

    v_k = g_k - g_mid                (signed cell value, |v_k| <= w_swing)
    w   = sum_k base^k * v_k

Updates:     v_0 += ΔW                 (through the device model)
Carry k->k+1: t = clamp_to_representable(v_k);  v_{k+1} += t / base;
             v_k -= t   (both via closed-loop serial writes ≈ ideal)

Random fields are inputs, as in ``core.device.apply_update``: the
initial weights' standard-normal draw, the write noise and the
closed-loop noise (a test feeds the reference's draws; the trainer draws
them from its ``torch.Generator``).
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch

from .crossbar import CrossbarConfig, make_reference
from .device import apply_update
from .xbar_ops import mvm, quantize_update_operands, vmm

Tensor = torch.Tensor


def pc_init(generator: Optional[torch.Generator], k: int, n: int,
            cfg: CrossbarConfig, n_cells: int = 3, base: float = 4.0,
            w_init_scale: float = 1.0, z: Optional[Tensor] = None,
            device=None) -> dict:
    """Initialise a periodic-carry weight stack.

    The initial weights (``w_init_scale / sqrt(k)`` times the
    standard-normal field ``z``, or a draw from ``generator``) are
    programmed into the MSB cell (closed loop); lower cells start at the
    midpoint.  ``base`` stays a Python float in the returned dict.
    """
    std = w_init_scale / math.sqrt(k)
    if device is None:
        device = z.device if z is not None else generator.device
    if z is None:
        z = torch.randn((k, n), generator=generator, device=device)
    w = std * z.to(device=device, dtype=torch.float32)
    w_max = 3.0 * std
    swing = cfg.w_swing
    # Total representable magnitude: swing * base^(n_cells-1) at the MSB
    # (lower cells add headroom).  Scale so w_max fills ~half the MSB range.
    w_scale = (0.5 * swing * base ** (n_cells - 1)) / w_max
    f32 = dict(dtype=torch.float32, device=device)
    top = torch.tensor(base ** (n_cells - 1), **f32)
    v_msb = torch.clamp(w * w_scale / top, -swing, swing)
    g = torch.full((n_cells, k, n), cfg.g_mid, **f32)
    g[n_cells - 1] += v_msb
    ref = make_reference((k, n), cfg, generator=generator
                         if cfg.ref_sigma > 0 else None, device=device)
    return {"g": g, "ref": ref, "w_scale": torch.tensor(w_scale, **f32),
            "base": float(base)}


def pc_effective_weights(params: dict, cfg: CrossbarConfig) -> Tensor:
    """``sum_k base^k (g_k - ref) / w_scale``, the stack's weight."""
    base = params["base"]
    n_cells = params["g"].shape[0]
    place = torch.tensor([base ** i for i in range(n_cells)],
                         dtype=torch.float32, device=params["g"].device)
    v = params["g"] - params["ref"][None]
    return torch.einsum("c,ckn->kn", place, v) / params["w_scale"]


def pc_forward(params: dict, x: Tensor, cfg: CrossbarConfig,
               read_eps: Optional[Sequence[Tensor]] = None) -> Tensor:
    """VMM against every cell array (one read per cell); digital
    place-value combine.  ``read_eps``: one read-noise field per cell,
    needed only when the device has read noise."""
    base = params["base"]
    y = 0.0
    for c in range(params["g"].shape[0]):
        # audit: allow RA303 -- n_cells <= 4 place-value cells with distinct significance weights, not a layer stack
        y = y + base ** c * vmm(x, params["g"][c], params["ref"],
                                params["w_scale"], cfg,
                                eps=read_eps[c] if read_eps else None)
    return y


def pc_backward(params: dict, d: Tensor, cfg: CrossbarConfig,
                read_eps: Optional[Sequence[Tensor]] = None) -> Tensor:
    """MVM (transpose read) of every cell array; place-value combine."""
    base = params["base"]
    dx = 0.0
    for c in range(params["g"].shape[0]):
        # audit: allow RA303 -- n_cells <= 4 place-value cells with distinct significance weights, not a layer stack
        dx = dx + base ** c * mvm(d, params["g"][c], params["ref"],
                                  params["w_scale"], cfg,
                                  eps=read_eps[c] if read_eps else None)
    return dx


def pc_update(params: dict, x: Tensor, d: Tensor, lr: float,
              cfg: CrossbarConfig, noise: Optional[Tensor] = None) -> dict:
    """Apply the outer-product update to the LSB cell through the device
    model; ``noise`` is its write-noise field (see ``apply_update``)."""
    x_q, d_q = quantize_update_operands(x.float(), d.float(), cfg)
    dw = -lr * torch.matmul(x_q.t(), d_q)  # requested ΔW
    dg_req = dw * params["w_scale"]  # LSB place value is base^0 = 1
    g0 = apply_update(params["g"][0], dg_req, cfg.device, noise)
    return {**params, "g": torch.cat([g0[None], params["g"][1:]])}


def carry_fold(g_src: Tensor, g_dst: Tensor, ref: Tensor, base: float,
               cfg: CrossbarConfig,
               quantize: Optional[Callable[[Tensor], Tensor]] = None
               ) -> Tuple[Tensor, Tensor]:
    """One closed-loop carry transfer between adjacent significance cells.

    Reads the source cell's signed value ``v = g_src - ref`` (through
    ``quantize``, the serial readout's ADC model, when given), clamps it
    to what the destination cell can absorb after the ``/base`` rescale,
    and returns the exact closed-loop write pair ``(t, inc)``: the source
    loses ``t``, the destination gains ``inc = t / base``, so the stack's
    effective value is conserved whatever the clamp does.  Elementwise.
    """
    v = g_src - ref
    if quantize is not None:
        v = quantize(v)
    # transferable amount: must fit in the next cell after the /base rescale
    head = cfg.w_swing - torch.abs(g_dst - ref)
    base_t = torch.tensor(base, dtype=v.dtype, device=v.device)
    t = torch.minimum(torch.maximum(v, -head * base_t), head * base_t)
    return t, t / base_t


def pc_carry(params: dict, cfg: CrossbarConfig,
             closed_loop_noise: float = 0.0,
             noise: Optional[Sequence[Tensor]] = None) -> dict:
    """Serial carry pass: fold each cell's value into the next (paper
    [35]).

    Closed-loop (read-verify-write) transfers are modelled as exact
    writes, perturbed by ``closed_loop_noise`` (fraction of the window)
    times ``noise[c]``, a standard-normal field per transfer, when both
    are given.
    """
    base = params["base"]
    swing = cfg.w_swing
    g = params["g"]
    for c in range(g.shape[0] - 1):
        t, inc = carry_fold(g[c], g[c + 1], params["ref"], base, cfg)
        if closed_loop_noise > 0.0 and noise is not None:
            inc = inc + closed_loop_noise * swing * noise[c]
        g = g.clone()
        g[c + 1] += inc
        g[c] -= t
        g = torch.clamp(g, cfg.device.gmin, cfg.device.gmax)
    return {**params, "g": g}


def pc_num_cells(params: dict) -> int:
    return int(params["g"].shape[0])
