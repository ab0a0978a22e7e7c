"""The fakequant projection (port of ``repro.kernels.ops``, the fakequant
part).

``fakequant_project`` is the matmul of ``analog_mode="fakequant"``: a DAC
round trip on the activations, the digital product tiled at the crossbar
row pitch, a per-token output-ADC fake quant per row tile and the digital
sum of the tiles.

Paths (``impl``):

* ``"eager"`` — the reference's jnp path in plain torch (the single-tile
  ``xq @ w`` or the padded multi-tile einsum summed over the tile axis),
  for tensors on the CPU; it is differentiable, as QAT needs;
* ``"cuda"`` — the fused read, :func:`repro_torch.kernels.xbar_vmm.
  fakequant_read`, whose CUDA kernels run on the card.  When autograd
  needs a gradient of ``x`` or ``w`` (QAT on the card), the read runs
  inside :class:`FakequantRead`: its forward is the kernel, its backward
  the VJP of the eager expression recomputed from the saved ``x`` and
  ``w`` (:func:`_fakequant_vjp`);
* ``"auto"``/``None`` — ``"cuda"`` for CUDA tensors, ``"eager"`` for CPU
  tensors.  A CUDA tensor never takes the plain path forward.

Tensors on the meta device (the dry run) take the card's autograd
structure: :class:`FakequantRead` over the plain read, so that a step
saves x and w as on the card and not the eager expression's
intermediates.

The gradient is the reference's: it has no straight-through estimator.
The rounding differentiates to zero, so the gradient flows only through
the DAC and ADC ranges (the scales' ``max``/``rms``), as ``jax.grad`` of
the reference's jnp path gives it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.adc import AdcConfig, divisor, quantize_dequantize

from .xbar_vmm import fakequant_read, resolve_impl

Tensor = torch.Tensor


def _adc_lsb(q: Tensor, adc: AdcConfig):
    """``(sat, lsb)`` of the per-token output ADC: one range per (token,
    row tile), ``sat_sigmas`` times the token's rms partial over the
    output width.  The lsb divides by ``core.adc.divisor``, the float32
    division the reference takes, on the card as on the CPU."""
    sat = adc.sat_sigmas * torch.sqrt(
        torch.mean(q * q, dim=-1, keepdim=True) + 1e-12)
    return sat, sat / divisor(adc.out_levels, sat)


def _adc_fake_quant(q: Tensor, adc: AdcConfig) -> Tensor:
    """Per-token output-ADC fake quantisation (QAT epilogue) at the range
    :func:`_adc_lsb` gives."""
    _, lsb = _adc_lsb(q, adc)
    return torch.clamp(torch.round(q / lsb), -adc.out_levels,
                       adc.out_levels) * lsb


def _fakequant_eager(x: Tensor, w: Tensor, adc: AdcConfig,
                     rows: int) -> Tensor:
    """The reference's jnp branch of ``fakequant_project``, step for step;
    for an expert stack (``w`` (E, K, N), ``x`` (E, T, K)) once per
    expert, as the reference's ``vmap`` over the experts computes it (one
    DAC scale per expert)."""
    if w.ndim == 3:
        return torch.stack([_fakequant_eager(x[e], w[e], adc, rows)
                            for e in range(w.shape[0])])
    xq = quantize_dequantize(x, adc)
    k = w.shape[0]
    n_tiles = max(1, -(-k // rows))
    if n_tiles == 1:
        return _adc_fake_quant(xq @ w, adc)
    pad = (-k) % rows
    xp = torch.nn.functional.pad(xq, (0, pad))
    wp = torch.nn.functional.pad(w, (0, 0, 0, pad))
    xt = xp.reshape(*x.shape[:-1], n_tiles, rows)
    wt = wp.reshape(n_tiles, rows, w.shape[1])
    q = torch.einsum("...tk,tkn->...tn", xt, wt)
    return _adc_fake_quant(q, adc).sum(dim=-2)


def _fakequant_vjp(x: Tensor, w: Tensor, dy: Tensor, adc: AdcConfig,
                   rows: int, need=(True, True)):
    """``(dx, dw)``: the VJP of :func:`_fakequant_eager` at ``(x, w)``,
    recomputed from the operands; ``need`` says which of the two to form
    (``None`` in place of the other)."""
    with torch.enable_grad():
        ops = [t.detach().requires_grad_(n) for t, n in zip((x, w), need)]
        y = _fakequant_eager(*ops, adc, rows)
        grads = iter(torch.autograd.grad(
            y, [t for t in ops if t.requires_grad], dy))
    return tuple(next(grads) if n else None for n in need)


class FakequantRead(torch.autograd.Function):
    """The fakequant read under autograd: forward the fused read's
    kernel on ``x`` (T, K) and ``w`` (K, N), or on an expert stack (``x``
    (E, T, K), ``w`` (E, K, N)), backward :func:`_fakequant_vjp` of the
    eager expression with the same lead dim."""

    @staticmethod
    def forward(ctx, x, w, adc, rows):
        ctx.save_for_backward(x, w)
        ctx.adc, ctx.rows = adc, rows
        return fakequant_read(x, w, adc, rows)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = _fakequant_vjp(x, w, dy, ctx.adc, ctx.rows,
                                ctx.needs_input_grad[:2])
        return dx, dw, None, None


def fakequant_project(x: Tensor, w: Tensor, adc: AdcConfig, rows: int,
                      impl: Optional[str] = None) -> Tensor:
    """Fakequant (QAT) projection of ``x`` (..., K) through ``w`` (K, N):
    (..., N) float32; or of an expert stack, ``x`` (E, T, K) through
    ``w`` (E, K, N): (E, T, N), each expert with its own DAC scale (one
    read of the stack on the card).  ``rows`` is the crossbar row pitch;
    ``impl`` as in the module docstring."""
    impl = resolve_impl(impl, x)
    if impl == "eager" and not x.is_meta:
        return _fakequant_eager(x, w, adc, rows)
    lead = x.shape[:-1]
    x2 = x if w.ndim == 3 else x.reshape(-1, x.shape[-1])
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        y = FakequantRead.apply(x2, w, adc, rows)
    else:
        y = fakequant_read(x2, w, adc, rows)
    return y.reshape(*lead, w.shape[-1])
