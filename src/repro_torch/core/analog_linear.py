"""AnalogLinear: a linear layer that executes on the simulated crossbar
(port of ``repro.core.analog_linear``).

Forward   = VMM through the analog array (quantised, saturated, ADC'd).
Backward  = MVM (transpose read) through the SAME array: the backward pass
            sees the identical conductances as the forward pass.
Gradient  = the outer product the write drivers would apply, in weight
            units, so that ``train.optimizer.analog_sgd`` (or the caller)
            can push ``-lr * dg * w_scale`` through the device model.

The layer is a plain function and a parameter dict:

    params = analog_linear_init(generator, k, n, cfg)
    y      = analog_linear_apply(params, x, cfg)

Both reads go through ``core.xbar_ops`` (on the card, the CUDA read
kernels; on the CPU, their plain version).  The weight gradient's outer
product is a plain ``torch.matmul``, as the reference's is a
``jnp.einsum`` outside any Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .crossbar import CrossbarConfig, make_reference, weights_to_conductance
from .xbar_ops import mvm, quantize_update_operands, vmm

Tensor = torch.Tensor


def analog_linear_init(generator: Optional[torch.Generator], k: int, n: int,
                       cfg: CrossbarConfig, w_init_scale: float = 1.0,
                       w_max: Optional[float] = None,
                       z: Optional[Tensor] = None, device=None) -> dict:
    """Initialise weights digitally, then program the array.

    The weights are ``w_init_scale / sqrt(k)`` times a standard-normal
    (k, n) field: ``z`` when given (a test feeds the reference's draw),
    else drawn from ``generator`` on ``device`` (default: the
    generator's).  ``w_max`` fixes the weight<->conductance scale and
    defaults to 8 sigma of the init distribution, so trained weights can
    grow several-fold without pinning at the rails.
    """
    std = w_init_scale / math.sqrt(k)
    if device is None:
        device = z.device if z is not None else generator.device
    if z is None:
        z = torch.randn((k, n), generator=generator, device=device)
    w = std * z.to(device=device, dtype=torch.float32)
    if w_max is None:
        w_max = 8.0 * std
    g, w_scale = weights_to_conductance(w, cfg, w_max=w_max)
    ref = make_reference((k, n), cfg, generator=generator
                         if cfg.ref_sigma > 0 else None, device=device)
    return {"g": g, "ref": ref, "w_scale": w_scale}


class AnalogMatmul(torch.autograd.Function):
    """``y = vmm(x, g)`` with the crossbar's backward: ``dx`` is the
    transpose read (``mvm``) of the same array, ``dg`` the write drivers'
    quantised outer product ``x_q^T d_q`` in weight units.  ``ref`` and
    ``w_scale`` get no gradient.  ``mvm`` is skipped when ``x`` needs no
    gradient (a first layer, whose input is data), the outer product when
    ``g`` needs none."""

    @staticmethod
    def forward(ctx, g, ref, w_scale, x, cfg, eps_fwd, eps_bwd):
        ctx.cfg = cfg
        ctx.save_for_backward(g, ref, w_scale, x, eps_bwd)
        return vmm(x, g, ref, w_scale, cfg, eps=eps_fwd)

    @staticmethod
    def backward(ctx, dy):
        g, ref, w_scale, x, eps_bwd = ctx.saved_tensors
        cfg = ctx.cfg
        dg = dx = None
        if ctx.needs_input_grad[3]:
            # Error backpropagation through the transpose read of the
            # same array.
            dx = mvm(dy, g, ref, w_scale, cfg, eps=eps_bwd).to(x.dtype)
        if ctx.needs_input_grad[0]:
            # The gradient the write drivers realise: quantised operands,
            # outer product, in weight units (dL/dW = x^T dy).
            x_q, d_q = quantize_update_operands(x.float(), dy.float(), cfg)
            dg = torch.matmul(x_q.t(), d_q).to(g.dtype)
        return dg, None, None, dx, None, None, None


def analog_linear_apply(params: dict, x: Tensor, cfg: CrossbarConfig,
                        read_eps: Optional[Tuple[Tensor, Tensor]] = None
                        ) -> Tensor:
    """Apply the analog layer to activations of shape (..., K).

    ``read_eps`` is the pair of read-noise fields ``(forward, backward)``
    of ``g``'s shape, needed only when the device has read noise (the
    reference splits its key into the two reads' keys).
    """
    eps_fwd, eps_bwd = read_eps if read_eps is not None else (None, None)
    lead = x.shape[:-1]
    xb = x.reshape(-1, x.shape[-1])
    y = AnalogMatmul.apply(params["g"], params["ref"], params["w_scale"], xb,
                           cfg, eps_fwd, eps_bwd)
    return y.reshape(*lead, -1)


def analog_linear_readout(params: dict, cfg: CrossbarConfig) -> Tensor:
    """Digital serial read of the programmed weights (paper §III.D)."""
    return (params["g"] - params["ref"]) / params["w_scale"]
