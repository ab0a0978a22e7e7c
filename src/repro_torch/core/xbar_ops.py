"""The paper's forward read as eager torch ops (port of
``repro.core.xbar_ops``).

``vmm`` is the parallel read ``y = x @ W`` (paper Fig. 3a):

  * inputs are DAC-quantised to ``in_bits`` (temporal coding),
  * every ``rows x cols`` tile integrates its own column charge,
    saturates at the integrator range and is ADC-quantised to
    ``out_bits``,
  * tile partial sums are accumulated digitally.

``vmm`` dispatches to the fused read in ``kernels.xbar_vmm`` (the CUDA
kernel for tensors on the card, its plain torch version for tensors on
the CPU).  ``impl="chain"`` pins the unfused quantise → pad → tiled
einsum → rescale chain below on CPU tensors: the port's own oracle for
the kernel's plain version.  The transpose read (MVM) and the rank-k
write belong to the training slice (``ROADMAP.md``).
"""
from __future__ import annotations

from typing import Optional

import torch

from .adc import adc_quantize, integrator_saturation, quantize_input
from .crossbar import CrossbarConfig, pad_to_tiles

Tensor = torch.Tensor


def _tiled_read(x_int: Tensor, diff: Tensor, cfg: CrossbarConfig) -> Tensor:
    """Per-tile integrate + saturate + ADC, summed over reduction tiles.

    ``x_int``: (..., B, K) integer drive levels; ``diff``: (..., Kp, Np)
    signed conductance ``G - G_ref`` padded to tile multiples, with the
    same lead dims as ``x_int``.  Returns (..., B, Np).
    """
    rows, cols = cfg.rows, cfg.cols
    kp, np_ = diff.shape[-2:]
    lead = diff.shape[:-2]
    b = x_int.shape[-2]
    if x_int.shape[-1] != kp:  # pad drive lines to the tile grid
        x_int = torch.nn.functional.pad(x_int, (0, kp - x_int.shape[-1]))
    tk, tn = kp // rows, np_ // cols
    xt = x_int.reshape(*lead, b, tk, rows).float()
    dt = diff.reshape(*lead, tk, rows, tn, cols).float()
    # Per-tile analog column charge: (..., B, tk, tn, cols)
    q = torch.einsum("...btr,...trnc->...btnc", xt, dt)
    nd = q.ndim
    # One integrator range per physical tile, shared over batch and columns.
    q, sat = integrator_saturation(q, cfg.adc, n_rows=rows,
                                   g_max=cfg.device.gmax,
                                   reduce_axes=(nd - 4, nd - 1))
    q = adc_quantize(q, sat, cfg.adc)
    # Digital accumulation across reduction tiles.
    return q.sum(dim=nd - 3).reshape(*lead, b, np_)


def _chain_read(x: Tensor, g: Tensor, g_ref: Tensor, w_scale,
                cfg: CrossbarConfig) -> Tensor:
    """The unfused read chain, one matrix at a time over lead dims:
    quantise → pad → per-tile einsum + integrator/ADC → crop → rescale."""
    if g.ndim > 2:
        ws = torch.broadcast_to(torch.as_tensor(w_scale, dtype=torch.float32,
                                                device=g.device),
                                g.shape[:-2])
        return torch.stack([_chain_read(x[i], g[i], g_ref[i], ws[i], cfg)
                            for i in range(g.shape[0])])
    in_dtype = x.dtype
    x_int, x_scale = quantize_input(x.float(), cfg.adc)
    diff = pad_to_tiles(g - g_ref, cfg.rows, cfg.cols)
    q = _tiled_read(x_int, diff, cfg)[:, :g.shape[1]]
    return (q * (x_scale / w_scale)).to(in_dtype)


def vmm(x: Tensor, g: Tensor, g_ref: Tensor, w_scale, cfg: CrossbarConfig,
        impl: Optional[str] = None) -> Tensor:
    """Analog vector-matrix multiply: ``y ≈ x @ W`` for
    ``W = (g - g_ref) / w_scale``.

    ``x``: (..., B, K) float activations; ``g``/``g_ref``: (..., K, N)
    conductances with matching lead dims.  ``impl`` picks the read path
    (``kernels.xbar_vmm.READ_IMPLS``, default by the tensors' device);
    ``"chain"``, the unfused oracle, takes CPU tensors only.
    """
    if cfg.device.read_noise > 0.0:
        raise NotImplementedError(
            "read noise draws per read; it waits for its own parity plan "
            "(ROADMAP.md)")
    if impl == "chain":
        if x.is_cuda:
            raise ValueError("impl='chain' on a CUDA tensor: tensors on the "
                             "card are read by the CUDA kernel")
        return _chain_read(x, g, g_ref, w_scale, cfg)
    from repro_torch.kernels.xbar_vmm import xbar_fused_read
    return xbar_fused_read(x, g, g_ref, w_scale, cfg, impl=impl)
