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

Under tensor parallelism (:class:`FakequantSplitRead`, the numeric
step's ``tp`` reads) a rank holds some of a leaf's columns or some of
its row tiles.  Column split: each rank's read forms its range partials
(per token, row tile and 64-column block, the sum of q²), the ranks'
partials are gathered in the whole width's column order and every rank
quantises with the whole width's range
(``kernels.xbar_vmm.fakequant_split_read``; on the card the range is the
whole read's bit for bit).  Row split (whole row tiles a rank): the DAC
scale is the ``max`` over the ranks' drives, each rank's tiles' products
and range partials are gathered in tile order and every rank runs the
ADC over all of them (``kernels.xbar_vmm.fakequant_tiles_read``), so its
output is the whole read's.  The backward is the whole expression's
gradient (:func:`_fakequant_vjp` with the split's view of the whole):
the per-(token, tile) ``dL/dlsb`` partial of a column split is summed
over ``model`` before it flows into the rank's own q, and a shared DAC
scale's gradient is summed over its ranks and shared among their
elements at the max.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import shardctx
from repro_torch.core.adc import AdcConfig, divisor, quantize_dequantize

from .xbar_vmm import (fakequant_instance, fakequant_read, fakequant_scale,
                       fakequant_split_read, fakequant_tiles_read,
                       resolve_impl)

Tensor = torch.Tensor


class _Split(NamedTuple):
    """A split read's view of the whole read (:class:`FakequantSplitRead`):
    the mesh, the axes whose ranks hold the other columns
    (``range_axes``, ``n_range`` columns in all; ``tot`` (T, tiles) the
    whole width's per-(token, row tile) sum of q²) and those sharing the
    DAC scale (``scale_axes``; ``sc`` the shared scale, (1,), or (L,) one
    per lead matrix of an expert stack); ``own`` (N,), where a part of
    the leaf is whole on every rank of ``range_axes``, is 1 at the columns
    whose range term this rank counts (such a part's on the first rank
    alone, as the whole width counts it once) and 0 elsewhere."""
    mesh: object
    range_axes: tuple
    scale_axes: tuple
    n_range: int
    sc: Optional[Tensor]
    tot: Optional[Tensor]
    own: Optional[Tensor] = None


def _adc_lsb(q: Tensor, adc: AdcConfig, split: Optional[_Split] = None):
    """``(sat, lsb)`` of the per-token output ADC: one range per (token,
    row tile), ``sat_sigmas`` times the token's rms partial over the
    output width.  The lsb divides by ``core.adc.divisor``, the float32
    division the reference takes, on the card as on the CPU.  A column
    split's range is the whole width's: its value from ``split.tot``, its
    gradient through this rank's q only (the others' sums constants; a
    part every rank holds whole through the first rank's alone,
    ``split.own``), and ``dL/dlsb`` summed over ``split.range_axes`` (each
    rank's codes cover its own columns, and a whole part's codes carry
    this rank's share of their cotangent)."""
    if split is None or split.tot is None:
        sat = adc.sat_sigmas * torch.sqrt(
            torch.mean(q * q, dim=-1, keepdim=True) + 1e-12)
        return sat, sat / divisor(adc.out_levels, sat)
    n = torch.full((), float(split.n_range), device=q.device)
    tot = split.tot.reshape(*q.shape[:-1], 1)
    sq = q * q if split.own is None else q * q * split.own
    own = torch.sum(sq, dim=-1, keepdim=True)
    grad = adc.sat_sigmas * torch.sqrt((own + (tot - own.detach())) / n
                                       + 1e-12)
    sat = adc.sat_sigmas * torch.sqrt(tot / n + 1e-12) \
        + (grad - grad.detach())
    lsb = sat / divisor(adc.out_levels, sat)
    return sat, shardctx.copy_to(lsb, split.mesh, split.range_axes)


def _adc_fake_quant(q: Tensor, adc: AdcConfig,
                    split: Optional[_Split] = None) -> Tensor:
    """Per-token output-ADC fake quantisation (QAT epilogue) at the range
    :func:`_adc_lsb` gives."""
    _, lsb = _adc_lsb(q, adc, split)
    return torch.clamp(torch.round(q / lsb), -adc.out_levels,
                       adc.out_levels) * lsb


def _fakequant_eager(x: Tensor, w: Tensor, adc: AdcConfig,
                     rows: int, split: Optional[_Split] = None) -> Tensor:
    """The reference's jnp branch of ``fakequant_project``, step for step;
    for an expert stack (``w`` (E, K, N), ``x`` (E, T, K)) once per
    expert, as the reference's ``vmap`` over the experts computes it (one
    DAC scale per expert).  ``split`` makes it a split read's part of the
    whole expression: the DAC round trip at the shared scale, the ADC at
    the whole width's range (:func:`_adc_lsb`)."""
    if w.ndim == 3:
        if split is None or split.sc is None:   # each its own scale
            return torch.stack([_fakequant_eager(x[e], w[e], adc, rows)
                                for e in range(w.shape[0])])
        return torch.stack([     # each lead matrix's shared scale
            _fakequant_eager(x[e], w[e], adc, rows,
                             split._replace(sc=split.sc[e:e + 1]))
            for e in range(w.shape[0])])
    if split is None or split.sc is None:
        xq = quantize_dequantize(x, adc)
    else:
        xq = quantize_dequantize_at(x, split.sc, adc)
    k = w.shape[0]
    n_tiles = max(1, -(-k // rows))
    if n_tiles == 1:
        return _adc_fake_quant(xq @ w, adc, split)
    pad = (-k) % rows
    xp = torch.nn.functional.pad(xq, (0, pad))
    wp = torch.nn.functional.pad(w, (0, 0, 0, pad))
    xt = xp.reshape(*x.shape[:-1], n_tiles, rows)
    wt = wp.reshape(n_tiles, rows, w.shape[1])
    q = torch.einsum("...tk,tkn->...tn", xt, wt)
    return _adc_fake_quant(q, adc, split).sum(dim=-2)


def _fakequant_vjp(x: Tensor, w: Tensor, dy: Tensor, adc: AdcConfig,
                   rows: int, need=(True, True),
                   split: Optional[_Split] = None):
    """``(dx, dw)``: the VJP of :func:`_fakequant_eager` at ``(x, w)``,
    recomputed from the operands; ``need`` says which of the two to form
    (``None`` in place of the other).  For a split read (``split``) the
    whole expression's: the range's gradient as :func:`_adc_lsb` gives
    it, and a shared DAC scale's gradient summed over
    ``split.scale_axes`` and shared among every rank's elements at the
    drive's max (:func:`_shared_scale_dx`)."""
    shared = split is not None and split.sc is not None and need[0]
    with torch.enable_grad():
        ops = [t.detach().requires_grad_(n) for t, n in zip((x, w), need)]
        sc = None
        if split is not None and split.sc is not None:
            sc = split.sc.detach().requires_grad_(shared)
            split = split._replace(sc=sc)
        y = _fakequant_eager(*ops, adc, rows, split)
        wrt = [t for t in (*ops, sc) if t is not None and t.requires_grad]
        grads = dict(zip(map(id, wrt), torch.autograd.grad(y, wrt, dy)))
    dx, dw = (grads.get(id(t)) for t in ops)
    if shared:
        dx = dx + _shared_scale_dx(ops[0], grads[id(sc)], split, adc)
    return dx if need[0] else None, dw if need[1] else None


def _shared_scale_dx(x: Tensor, g_sc: Tensor, split: _Split,
                     adc: AdcConfig) -> Tensor:
    """``dx`` from a DAC scale shared over ``split.scale_axes``: the
    scale's gradient summed over them, shared equally among the elements
    of every rank where ``|x|`` reaches the shared max (the gradient of
    the reference's ``max`` over its one global drive); for an expert
    stack ``x`` (L, T, K) each lead matrix's scale on its own, its ties
    counted over the ranks' rows of that matrix."""
    g = _all_reduce(g_sc.reshape(-1), split.mesh, split.scale_axes)
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        x3 = xg if x.ndim == 3 else xg[None]
        top = x3.abs().amax(dim=(1, 2))
        own = torch.clamp(top, min=1e-12) / divisor(adc.in_levels, xg)
    hit = own.detach() == split.sc.reshape(-1)
    ties = (x3.detach().abs() == top.detach()[:, None, None]).sum(dim=(1, 2))
    ties = ties.float() * hit
    total = _all_reduce(ties, split.mesh, split.scale_axes)
    share = torch.where(hit, g * ties / torch.clamp(total, min=1.0),
                        torch.zeros_like(g))
    return torch.autograd.grad(own, xg, share)[0]


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


def _all_reduce(t: Tensor, mesh, axes, op: str = "sum") -> Tensor:
    for a in axes:
        t = mesh.all_reduce(t, a, op)
    return t


class FakequantSplitRead(torch.autograd.Function):
    """A fakequant read of this rank's part of a read spread over the
    ranks of ``mesh``: the drive's DAC scale is the max over the ranks of
    ``scale_axes`` (the data ranks' tokens of one global batch, and the
    ranks holding the other row tiles of a row-split leaf).  A column
    split's per-(token, row tile) ADC range sums q² over the ranks of
    ``range_axes`` (the ranks holding the other columns, ``n_range``
    columns wide in all; ``blocks`` puts the gathered 64-column range
    partials in the whole width's order; where it takes a part from the
    first rank alone, the part every rank holds whole, the other ranks'
    columns of that part carry no range gradient).  A row split gathers the
    ranks of ``tile_axes``' row tiles and returns the whole read (one
    device's output on every rank).  An expert stack (``x`` (L, T, K),
    ``w`` (L, K, N)) shares each lead matrix's scale over ``scale_axes``
    (one per expert: the max over the data ranks' rows of its buffer)
    and reads on ``instance`` (the whole buffer's, so that a rank's rows
    are the whole read's bit for bit); it splits no range or tiles.
    See the module docstring."""

    @staticmethod
    def forward(ctx, x, w, adc, rows, mesh, range_axes, scale_axes,
                n_range, blocks=None, tile_axes=(), instance=None):
        sc = None
        if scale_axes:
            sc = _all_reduce(fakequant_scale(x, adc.in_levels), mesh,
                             scale_axes, "max")
        tot = own = None
        if range_axes:
            own = _range_owned(w.shape[-1], mesh, range_axes, blocks,
                               w.device)
            def combine(s):     # ordered gather, then the whole width's order
                for a in reversed(range_axes):
                    s = mesh.all_gather(s, a, s.ndim - 1)
                return s if blocks is None else s.index_select(
                    -1, blocks.to(s.device))
            y, full = fakequant_split_read(x, w, adc, rows, combine,
                                           n_range, sc)
            tot = full.sum(dim=-1)
        elif tile_axes:
            def combine(t):     # every rank's tiles, in tile order
                for a in reversed(tile_axes):
                    t = mesh.all_gather(t, a, 1)
                return t
            y = fakequant_tiles_read(x, w, adc, rows, combine, sc)
        else:
            y = fakequant_read(x, w, adc, rows, sc=sc, instance=instance)
        ctx.save_for_backward(x, w, sc, tot, own)
        ctx.args = (adc, rows, mesh, range_axes, scale_axes, n_range)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, sc, tot, own = ctx.saved_tensors
        adc, rows, mesh, range_axes, scale_axes, n_range = ctx.args
        dx, dw = _fakequant_vjp(
            x, w, dy, adc, rows, ctx.needs_input_grad[:2],
            _Split(mesh, range_axes, scale_axes, n_range, sc, tot, own))
        return (dx, dw) + (None,) * 9


def _range_owned(n: int, mesh, range_axes, blocks, device,
                 cols: int = 64) -> Optional[Tensor]:
    """``_Split.own`` of a rank's ``n`` columns of a column split whose
    gathered 64-column range blocks ``blocks`` puts in the whole width's
    order: 1 where the whole width takes the block from this rank's, 0
    at a whole part's blocks it takes from another rank; None when it
    takes every block of every rank (no part is whole)."""
    if blocks is None:
        return None
    per = n // cols
    r = shardctx.flat_index(mesh.shape, mesh.coords, range_axes)
    mine = torch.isin(r * per + torch.arange(per), blocks.cpu())
    if bool(mine.all()):
        return None
    return mine.float().repeat_interleave(cols).to(device)


def quantize_dequantize_at(x: Tensor, sc: Tensor, adc: AdcConfig) -> Tensor:
    """The DAC round trip at the full scale ``sc`` (differentiable in
    ``sc``; the rounding differentiates to zero)."""
    lv = float(adc.in_levels)
    return torch.clamp(torch.round(x / sc), -lv, lv) * sc


def fakequant_split_project(x: Tensor, w: Tensor, adc: AdcConfig, rows: int,
                            mesh, range_axes, scale_axes, n_range: int,
                            blocks=None, tile_axes=(),
                            tokens: Optional[int] = None) -> Tensor:
    """:class:`FakequantSplitRead` of ``x`` (..., K) (the reads' tokens
    flattened), in float32; ``tokens``: the rows of the whole read this
    rank's rows belong to, whose kernel instance the read takes (a read
    of a sequence chunk)."""
    lead = x.shape[:-1]
    instance = None if tokens is None \
        else fakequant_instance(tokens, adc.in_levels)
    y = FakequantSplitRead.apply(x.reshape(-1, x.shape[-1]).float(),
                                 w.float(), adc, rows, mesh,
                                 tuple(range_axes), tuple(scale_axes),
                                 n_range, blocks, tuple(tile_axes), instance)
    return y.reshape(*lead, w.shape[-1])


def fakequant_expert_project(x: Tensor, w: Tensor, adc: AdcConfig,
                             rows: int, mesh, scale_axes,
                             tokens: int) -> Tensor:
    """:class:`FakequantSplitRead` of a rank's rows ``x`` (E, T, K) of an
    expert-stack read through ``w`` (E, K, N) whose whole buffer is
    ``tokens`` rows over the ranks of ``scale_axes``: each expert's DAC
    scale the max over them, the kernel instance the whole buffer's; in
    float32."""
    return FakequantSplitRead.apply(
        x.float(), w.float(), adc, rows, mesh, (), tuple(scale_axes),
        w.shape[-1], None, (), fakequant_instance(tokens, adc.in_levels))


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
