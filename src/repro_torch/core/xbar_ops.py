"""The paper's three crossbar operations as eager torch ops (port of
``repro.core.xbar_ops``).

  1. ``vmm``          — parallel read        y = x @ W      (paper Fig. 3a)
  2. ``mvm``          — transpose read       y = d @ W.T    (paper Fig. 3b)
  3. ``outer_update`` — rank-k parallel write W += sum outer (paper Fig. 3c)

Semantics per op (matching the circuit):

  * inputs are DAC-quantised to ``in_bits`` (temporal coding),
  * every ``rows x cols`` tile integrates its own column charge,
    saturates at the integrator range and is ADC-quantised to
    ``out_bits``,
  * tile partial sums are accumulated digitally,
  * the update quantises rows to ``in_bits`` (temporal) and columns to
    ``upd_col_bits`` (voltage coding) and pushes the outer product
    through the nonlinear, stochastic device.

``vmm``/``mvm`` dispatch to the fused read in ``kernels.xbar_vmm`` (the
CUDA kernel for tensors on the card, its plain torch version for tensors
on the CPU).  ``impl="chain"`` pins the unfused quantise → pad → tiled
einsum → rescale chain below on CPU tensors: the port's own oracle for
the kernel's plain version.  ``outer_update`` is the write's unfused
oracle; the train step writes through ``kernels.xbar_update``.
"""
from __future__ import annotations

from typing import Optional

import torch

from .adc import (AdcConfig, adc_quantize, integrator_saturation,
                  quantize_input)
from .crossbar import CrossbarConfig, pad_to_tiles
from .device import DeviceConfig, apply_update

Tensor = torch.Tensor


def _tile_partials(x_int: Tensor, diff: Tensor, cfg: CrossbarConfig,
                   transpose: bool = False) -> Tensor:
    """Per-tile integrate + saturate + ADC: the (..., tR, tO, B, C)
    quantised charges of every tile (tR reduction tiles, tO output tiles
    of C outputs), before the digital sum over the reduction tiles.
    Arguments as for :func:`_tiled_read`.

    Each tile's charges are one (B, rows) x (rows, C) product and its
    range one sum over its own contiguous (B, C) charges, so a tile's
    result does not depend on how many tiles share the call: a block of
    a container gives the bits of its tiles in the whole read (the
    sharded step's shard-local read relies on it)."""
    rows, cols = cfg.rows, cfg.cols
    if transpose:
        # Drive columns, integrate rows: the tile sizes swap roles.
        rows, cols = cols, rows
        diff = diff.transpose(-1, -2)
    kp, np_ = diff.shape[-2:]
    lead = diff.shape[:-2]
    b = x_int.shape[-2]
    if x_int.shape[-1] != kp:  # pad drive lines to the tile grid
        x_int = torch.nn.functional.pad(x_int, (0, kp - x_int.shape[-1]))
    tk, tn = kp // rows, np_ // cols
    xt = x_int.float().reshape(*lead, b, tk, rows).movedim(-2, -3)
    dt = diff.float().reshape(*lead, tk, rows, tn, cols).movedim(-2, -3)
    # Per-tile analog column charge: (..., tk, tn, B, cols)
    q = torch.matmul(xt.unsqueeze(-3), dt)
    nd = q.ndim
    # One integrator range per physical tile, shared over batch and columns.
    q, sat = integrator_saturation(q, cfg.adc, n_rows=rows,
                                   g_max=cfg.device.gmax,
                                   reduce_axes=(nd - 2, nd - 1))
    return adc_quantize(q, sat, cfg.adc)


def _sum_tiles(q: Tensor) -> Tensor:
    """Digital accumulation of :func:`_tile_partials` across the
    reduction tiles, float32 adds in tile order from tile 0 (the order of
    the kernels' tile sum): (..., tR, tO, B, C) -> (..., B, tO * C)."""
    acc = q[..., 0, :, :, :]
    for t in range(1, q.shape[-4]):
        acc = acc + q[..., t, :, :, :]
    tn, b, cols = acc.shape[-3:]
    return acc.movedim(-2, -3).reshape(*acc.shape[:-3], b, tn * cols)


def _tiled_read(x_int: Tensor, diff: Tensor, cfg: CrossbarConfig,
                transpose: bool = False) -> Tensor:
    """Per-tile integrate + saturate + ADC, summed over reduction tiles.

    ``x_int``: (..., B, K) integer drive levels; ``diff``: (..., Kp, Np)
    signed conductance ``G - G_ref`` padded to tile multiples, with the
    same lead dims as ``x_int``.  Returns (..., B, Np).  ``transpose``
    reads the array column-driven (the MVM of Fig. 3b): ``x_int`` is
    (..., B, Np), the reduction runs over the stored tile's columns and
    the result is (..., B, Kp).
    """
    return _sum_tiles(_tile_partials(x_int, diff, cfg, transpose))


def _chain_read(x: Tensor, g: Tensor, g_ref: Tensor, w_scale,
                cfg: CrossbarConfig, transpose: bool = False) -> Tensor:
    """The unfused read chain, one matrix at a time over lead dims:
    quantise → pad → per-tile einsum + integrator/ADC → crop → rescale."""
    if g.ndim > 2:
        ws = torch.broadcast_to(torch.as_tensor(w_scale, dtype=torch.float32,
                                                device=g.device),
                                g.shape[:-2])
        return torch.stack([_chain_read(x[i], g[i], g_ref[i], ws[i], cfg,
                                        transpose)
                            for i in range(g.shape[0])])
    in_dtype = x.dtype
    x_int, x_scale = quantize_input(x.float(), cfg.adc)
    diff = pad_to_tiles(g - g_ref, cfg.rows, cfg.cols)
    out_dim = g.shape[0] if transpose else g.shape[1]
    q = _tiled_read(x_int, diff, cfg, transpose)[:, :out_dim]
    return (q * (x_scale / w_scale)).to(in_dtype)


def _read_conductance(g: Tensor, cfg: CrossbarConfig,
                      eps: Optional[Tensor]) -> Tensor:
    """Multiplicative read noise (paper §V.A), if configured:
    ``g (1 + read_noise eps)``.  ``eps`` is the standard-normal field of
    ``g``'s shape: the reference draws it from its key, the port takes it
    as an input (on the card, drawn from an explicit ``torch.Generator``),
    so both can be fed the same field."""
    if cfg.device.read_noise > 0.0:
        if eps is None:
            raise ValueError("read_noise > 0 requires a noise field eps")
        g = g * (1.0 + cfg.device.read_noise * eps)
    return g


def _read(x: Tensor, g: Tensor, g_ref: Tensor, w_scale, cfg: CrossbarConfig,
          impl: Optional[str], transpose: bool,
          eps: Optional[Tensor] = None, meta=None) -> Tensor:
    g = _read_conductance(g, cfg, eps)
    if meta is not None and meta.sharded:
        # the sharded train step: ``g``/``g_ref`` are this rank's tile
        # blocks, ``x`` the whole replicated drive; the shard-local read
        # exchanges only the per-tile ADC partials, in pinned order
        from repro_torch.kernels.xbar_vmm import manual_collective_read
        return manual_collective_read(x, g, g_ref, w_scale, cfg, meta,
                                      transpose=transpose, impl=impl)
    if impl == "chain":
        if x.is_cuda:
            raise ValueError("impl='chain' on a CUDA tensor: tensors on the "
                             "card are read by the CUDA kernel")
        return _chain_read(x, g, g_ref, w_scale, cfg, transpose)
    from repro_torch.kernels.xbar_vmm import xbar_fused_read
    return xbar_fused_read(x, g, g_ref, w_scale, cfg, impl=impl,
                           transpose=transpose)


def vmm(x: Tensor, g: Tensor, g_ref: Tensor, w_scale, cfg: CrossbarConfig,
        impl: Optional[str] = None, eps: Optional[Tensor] = None,
        meta=None) -> Tensor:
    """Analog vector-matrix multiply: ``y ≈ x @ W`` for
    ``W = (g - g_ref) / w_scale``.

    ``x``: (..., B, K) float activations; ``g``/``g_ref``: (..., K, N)
    conductances with matching lead dims.  ``impl`` picks the read path
    (``kernels.xbar_vmm.READ_IMPLS``, default by the tensors' device);
    ``"chain"``, the unfused oracle, takes CPU tensors only.  ``eps`` is
    the read-noise field (:func:`_read_conductance`), needed only when the
    device has read noise; the noisy ``g`` goes through the same read.
    ``meta`` (a ``core.shardctx.ShardMeta``) marks ``g``/``g_ref`` as this
    rank's blocks of a tile-sharded container: the read goes shard-local
    (``kernels.xbar_vmm.manual_collective_read``).
    """
    return _read(x, g, g_ref, w_scale, cfg, impl, transpose=False, eps=eps,
                 meta=meta)


def mvm(d: Tensor, g: Tensor, g_ref: Tensor, w_scale, cfg: CrossbarConfig,
        impl: Optional[str] = None, eps: Optional[Tensor] = None,
        meta=None) -> Tensor:
    """Analog transpose read: ``y ≈ d @ W.T`` (same array, columns
    driven).  ``d``: (..., B, N); returns (..., B, K).  ``eps`` and
    ``meta`` as in :func:`vmm`."""
    return _read(d, g, g_ref, w_scale, cfg, impl, transpose=True, eps=eps,
                 meta=meta)


def quantize_update_codes(x: Tensor, d: Tensor, cfg: CrossbarConfig,
                          lead: int = 0):
    """The write drivers' codes and scales: ``(x_int, x_scale, d_int,
    d_scale)``, rows (x) by the temporal coder (``in_bits``), columns (d)
    by the voltage coder (``upd_col_bits``).  The scales are 0-d tensors,
    or with ``lead`` > 0 one per matrix of the first ``lead`` dims: the
    coders' full scale is calibrated per physical array, so each expert
    of a batched container quantises against its own operand range."""
    x_int, x_scale = quantize_input(x, cfg.adc, lead=lead)
    col_cfg = AdcConfig(in_bits=cfg.upd_col_bits, out_bits=cfg.adc.out_bits)
    d_int, d_scale = quantize_input(d, col_cfg, lead=lead)
    return x_int, x_scale, d_int, d_scale


def quantize_update_operands(x: Tensor, d: Tensor, cfg: CrossbarConfig):
    """Quantise the outer-product operands as the write drivers do.

    Rows (x) use the temporal coder (``in_bits``); columns (d) use the
    voltage coder (``upd_col_bits``).  Returns dequantised (x_q, d_q)
    (:func:`quantize_update_codes` gives the codes and scales).
    """
    x_int, x_scale, d_int, d_scale = quantize_update_codes(x, d, cfg)
    return x_int * x_scale, d_int * d_scale


def outer_update(g: Tensor, x: Tensor, d: Tensor, lr, w_scale,
                 cfg: CrossbarConfig, noise: Optional[Tensor] = None,
                 device: Optional[DeviceConfig] = None) -> Tensor:
    """Rank-k outer-product update: ``G <- device(G, -lr x^T d w_scale)``.

    ``x``: (B, K) forward activations, ``d``: (B, N) backprop errors;
    ``noise`` is the write-noise field of ``g``'s shape (see
    ``core.device.apply_update``).
    """
    device = device or cfg.device
    x_q, d_q = quantize_update_operands(x.float(), d.float(), cfg)
    dw = -lr * torch.einsum("bk,bn->kn", x_q, d_q)
    return apply_update(g, dw * w_scale, device, noise)
