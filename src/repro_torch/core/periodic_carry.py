"""Periodic carry (paper §VI.B, ref [35] — Agarwal et al., VLSI 2017).

Port of ``repro.core.periodic_carry`` (the transfer the transformer
containers use; the multi-cell MLP stack, ``pc_*``, comes with the MLP
slice, ``ROADMAP.md``).  A weight is held by cells of increasing place
value.  Training writes land on the least-significant cell, which stays
near the middle of its window where the device is most linear, and
periodically its accumulated value is *carried* into the next cell by a
serial closed-loop (read-verify-write) transfer, which is accurate.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .crossbar import CrossbarConfig

Tensor = torch.Tensor


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
