"""Plain torch oracles for the crossbar kernels (port of
``repro.kernels.ref``).

The reference semantics live in ``core.xbar_ops`` (the simulation the
paper's accuracy analysis depends on); this module names them at kernel
granularity, integer drive levels in and charge out, and adds the
*bit-plane temporal-coding* oracle, which drives the array one magnitude
bit at a time, as the hardware pulses its input lines (paper Fig. 5).
It is the executable proof of the integer-product shortcut every read
kernel takes:
``chip_smoke.py`` holds both read kernels, on both instances, bit-equal
to it where every charge is an exact float32 sum.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.crossbar import CrossbarConfig
from repro_torch.core.device import _deterministic_dg, write_noise_sigma
from repro_torch.core.xbar_ops import _tiled_read

Tensor = torch.Tensor


def vmm_ref(x_int: Tensor, diff: Tensor, cfg: CrossbarConfig) -> Tensor:
    """(B, Kp) integer drive levels x (Kp, Np) signed conductance, padded
    to whole tiles -> (B, Np) charge after the per-tile ADC."""
    return _tiled_read(x_int, diff, cfg, transpose=False)


def mvm_ref(d_int: Tensor, diff: Tensor, cfg: CrossbarConfig) -> Tensor:
    """(B, Np) integer drive levels x (Kp, Np) -> (B, Kp), the transpose
    read."""
    return _tiled_read(d_int, diff, cfg, transpose=True)


def outer_update_ref(g: Tensor, x_q: Tensor, d_q: Tensor, scale,
                     cfg: CrossbarConfig,
                     noise: Optional[Tensor] = None) -> Tensor:
    """The rank-k write through the device model, its write noise given
    as an N(0, 1) field ``noise`` of ``g``'s shape.  ``scale`` folds
    ``-lr * w_scale``: the request is ``scale * sum_b outer(x_q_b,
    d_q_b)``."""
    dev = cfg.device
    dg_req = scale * torch.einsum("bk,bn->kn", x_q.float(), d_q.float())
    dg = _deterministic_dg(g, dg_req, dev)
    if noise is not None and dev.write_noise > 0.0:
        dg = dg + write_noise_sigma(dg_req, dev) * noise
    return torch.clamp(g + dg, dev.gmin, dev.gmax)


def vmm_bitplanes(x_int: Tensor, diff: Tensor, cfg: CrossbarConfig) -> Tensor:
    """Temporal-coding oracle: drive the array one bit-plane at a time.

    Bit ``b`` of every input line's magnitude ``|x|`` drives a train of
    ``2^b`` unit pulses (paper Fig. 5), its sign the pulses' polarity;
    the column integrates the charge of every pulse.  The planes' charges
    are summed in plane order, from bit 0, in float32.  The total is the
    integer product ``x_int @ diff``; where every partial sum is exact in
    float32 (integer levels times conductances on a coarse grid) it is
    that product bit for bit, whatever order a kernel sums in.
    """
    sign = torch.sign(x_int).float()
    mag = torch.abs(x_int).to(torch.int32)
    d = diff.float()
    q = torch.zeros((*x_int.shape[:-1], diff.shape[-1]), dtype=torch.float32,
                    device=x_int.device)
    for b in range(cfg.adc.in_bits - 1):       # the magnitude bits
        plane = ((mag >> b) & 1).float() * sign
        q = q + float(2 ** b) * (plane @ d)
    return q
