"""Mixed-signal periphery: input temporal coding (DAC) and ramp ADC.

Port of ``repro.core.adc``.  Digital inputs are encoded into pulse trains
(one pulse per magnitude bit, the sign selects polarity), so the charge
on each column is the integer dot product ``q_j = sum_i x_int_i G_ij``.
The integrator saturates at a finite range and the ramp ADC digitises to
``out_bits`` levels.  All quantisers are symmetric mid-tread, so zero is
exactly representable.  Rounding is round-half-to-even (``torch.round``);
with ``stochastic_round`` and a uniform field ``u`` it is stochastic, as
the reference's with a key.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


def _clip(x: Tensor, lo, hi) -> Tensor:
    """``min(max(x, lo), hi)``, with float or tensor bounds (float bounds
    make no tensor, so nothing is copied to the device)."""
    if isinstance(lo, Tensor):
        return torch.minimum(torch.maximum(x, lo), hi)
    return torch.clamp(x, lo, hi)


@dataclasses.dataclass(frozen=True)
class AdcConfig:
    """Static configuration of the crossbar I/O path.

    ``in_bits``/``out_bits``: 8/8, 4/4 or 2/2 in the paper's variants (one
    input bit is the sign).  ``sat_frac``: integrator saturation as a
    fraction of the worst-case column charge ``in_levels * n_rows *
    g_max`` (``range_mode="fixed"``).  ``range_mode="dynamic"`` sets the
    range to ``sat_sigmas`` times the rms of the column charge per tile.
    ``stochastic_round`` rounds stochastically where a caller hands
    :func:`quantize_input` or :func:`adc_quantize` a uniform field ``u``
    (the reference's ``key``); no library read does, so every read rounds
    half to even with the flag set or not, as the reference's do.
    """

    in_bits: int = 8
    out_bits: int = 8
    sat_frac: float = 0.03
    range_mode: str = "dynamic"
    sat_sigmas: float = 4.0
    stochastic_round: bool = False

    @property
    def in_levels(self) -> int:
        return 2 ** (self.in_bits - 1) - 1  # magnitude levels (sign separate)

    @property
    def out_levels(self) -> int:
        return 2 ** (self.out_bits - 1) - 1


_DIVISORS = {}   # (value, dtype, device) -> 0-d tensor


def divisor(value: float, like: Tensor) -> Tensor:
    """``value`` as a 0-d tensor of ``like``'s dtype on its device, made
    once per device.  Quantiser scales divide by it, not by the Python
    number: on the card torch computes a division by a Python number as
    a product with its reciprocal, which can sit an ulp off the
    reference's division and move a code at a rounding boundary (on the
    CPU the two are the same division)."""
    key = (float(value), like.dtype, like.device)
    if key not in _DIVISORS:
        _DIVISORS[key] = torch.full((), float(value), dtype=like.dtype,
                                    device=like.device)
    return _DIVISORS[key]


def _round(x: Tensor, u: Optional[Tensor] = None) -> Tensor:
    """Round half to even, as ``lax.round(TO_NEAREST_EVEN)``; with a
    uniform [0, 1) field ``u`` of ``x``'s shape, stochastically:
    ``floor(x) + (u < x - floor(x))``, the reference's ``_round`` with a
    key (``u`` is its ``jax.random.uniform(key, x.shape)``)."""
    if u is None:
        return torch.round(x)
    f = torch.floor(x)
    return f + (u < x - f).to(x.dtype)


def fixed_saturation(cfg: AdcConfig, n_rows: int, g_max: float) -> float:
    """The ``fixed``-mode integrator bound, in Python doubles, rounded to
    float32 once (``repro.core.adc.integrator_saturation``)."""
    return float(np.float32(cfg.sat_frac * (cfg.in_levels * n_rows * g_max)))


def quantize_input(x: Tensor, cfg: AdcConfig,
                   scale: Optional[Tensor] = None,
                   lead: int = 0,
                   u: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Quantise activations to signed integers for temporal coding.

    Returns ``(x_int, scale)`` with ``x ≈ x_int * scale`` and ``x_int`` in
    ``[-L, L]``, ``L = 2^{in_bits-1} - 1``.  ``scale`` defaults to the
    per-call full scale ``max|x| / L``; with ``lead`` > 0 it is one full
    scale per matrix of the first ``lead`` dims (shape ``x.shape[:lead]``),
    as the reference's quantiser vmapped over them gives it.  ``u``, a
    uniform [0, 1) field of ``x``'s shape, rounds stochastically when
    ``cfg.stochastic_round`` is set (:func:`_round`).
    """
    levels = cfg.in_levels
    if scale is None:
        scale = torch.clamp(x.abs().amax(dim=tuple(range(lead, x.ndim))),
                            min=1e-12) / divisor(levels, x)
    per = scale.reshape(*scale.shape, *[1] * (x.ndim - lead)) if lead \
        else scale
    x_int = _round(x / per, u if cfg.stochastic_round else None)
    return _clip(x_int, float(-levels), float(levels)), scale


def integrator_saturation(q: Tensor, cfg: AdcConfig, n_rows: int,
                          g_max: float = 1.0,
                          reduce_axes: Optional[Tuple[int, ...]] = None
                          ) -> Tuple[Tensor, Tensor]:
    """Clip accumulated column charge to the integrator dynamic range.

    ``reduce_axes``: axes of ``q`` sharing one range in ``dynamic`` mode
    (batch and columns of a tile).  The rms is taken over the non-zero
    entries only, so zero padding at a matrix edge does not shrink it.
    Returns ``(q_clipped, sat)``; ``sat`` broadcasts against ``q``.
    """
    if cfg.range_mode == "fixed":
        sat = torch.tensor(fixed_saturation(cfg, n_rows, g_max),
                           dtype=q.dtype, device=q.device)
    else:
        if reduce_axes is None:
            reduce_axes = tuple(range(q.ndim))
        sumsq = torch.sum(q * q, dim=reduce_axes, keepdim=True)
        nz = torch.sum((q != 0).to(q.dtype), dim=reduce_axes, keepdim=True)
        rms = torch.sqrt(sumsq / torch.clamp(nz, min=1.0))
        sat = torch.clamp(cfg.sat_sigmas * rms, min=1e-6).to(q.dtype)
    return _clip(q, -sat, sat), sat


def adc_quantize(q: Tensor, sat: Tensor, cfg: AdcConfig,
                 u: Optional[Tensor] = None) -> Tensor:
    """Ramp ADC: uniform quantisation of ``[-sat, sat]`` to ``out_bits``
    levels, returned in charge units (``lsb * round(q / lsb)``); ``u`` as
    in :func:`quantize_input`."""
    lsb = sat / divisor(cfg.out_levels, sat)
    code = _clip(_round(q / lsb, u if cfg.stochastic_round else None),
                 float(-cfg.out_levels), float(cfg.out_levels))
    return code * lsb


def quantize_dequantize(x: Tensor, cfg: AdcConfig) -> Tensor:
    """Round-trip input quantisation."""
    x_int, scale = quantize_input(x, cfg)
    return x_int * scale
