"""Fused analog crossbar reads: the CUDA kernels, their plain torch
version and the dispatch between them.

Port of ``repro.kernels.xbar_vmm`` (the device-mode reads).  The kernels in
``csrc/xbar_vmm.cu`` replace the TPU kernels ``_fused_vmm_kernel`` (the
forward read) and ``_fused_mvm_kernel`` (the transpose read): per lead
matrix they quantise the drives against the per-matrix DAC scale,
subtract the reference array on the tile, form each ``rows x cols``
tile's charge (the transpose read contracts the stored tile's column
dim), apply integrator saturation and the ramp ADC per tile (one range
per tile over the whole batch in ``dynamic`` mode), accumulate the tiles
digitally and rescale by ``x_scale / w_scale``.  ``max|x|`` and the
``(L, 2)`` scale operand ``[x_scale, x_scale / w_scale]`` are computed
outside the kernels, as in the reference.

Paths (``impl``):

* ``"cuda"`` — the hand-written kernels, for tensors on the card;
* ``"eager"`` — :func:`_read_plain`, the kernels' plain torch version,
  for tensors on the CPU;
* ``"auto"``/``None`` — ``"cuda"`` for CUDA tensors, ``"eager"`` for CPU
  tensors.  There is no fallback: a CUDA tensor launches the kernel or
  the call raises, and an explicit ``"eager"`` on a CUDA tensor raises.

``"chain"`` names the unfused oracle in ``core.xbar_ops``; it is resolved
there and never dispatches into this module.

The fakequant read (:func:`fakequant_read`, the read of
``analog_mode="fakequant"``: digital weights behind the crossbar's DAC and
per-token ADC) dispatches by the device of its input, with the same
rules.  Its kernels in ``csrc/xbar_fakequant.cu`` replace the TPU kernel
``_fakequant_kernel``; each read launches three, in one of two
instances :func:`fakequant_instance` picks from the operands: below
:data:`FQ_TC_MIN_TOKENS` tokens (decode, prefill chunks, short prompts)
the FP32 instance (``fakequant_scale``, the DAC scale; ``fakequant_fp32``,
the product), from there the tensor-core one (``fakequant_prepare``, the
scale, the DAC codes and W's three bf16 planes; ``fakequant_tc``); then
the shared per-token ADC ``fakequant_epilogue``.  An expert stack (x
(L, T, K) through w (L, K, N), MoE's fakequant experts) is one read: the
lead dim rides every kernel's grid, each lead matrix with its own DAC
scale, so a stack costs three launches, not three per expert.
``LAUNCHES["fakequant"]``
counts reads, ``LAUNCHES["fakequant_lead"]`` the expert-stack reads
among them, ``LAUNCHES["fakequant_split"]`` the split reads among
them (tensor parallelism: :func:`fakequant_split_read` for a column
split, :func:`fakequant_tiles_read` for a row split, whose epilogues
over every rank's tiles ``LAUNCHES["fakequant_tiles"]`` counts) and
``LAUNCHES[name]`` each kernel's launches, from the launch record the
launcher fills.

The kernels are built at first use from ``csrc/xbar_vmm.cu`` (see
``kernels._nvcc``).  :func:`read_instance` picks one of its two instances
from the operands.  Every read adds one to ``LAUNCHES["fused_vmm"]``
(forward) or ``LAUNCHES["fused_mvm"]`` (transpose) when its read pass
launches.  Each kernel also has a count per direction,
``LAUNCHES[f"{kernel}_{direction}"]`` with ``direction`` ``vmm`` or
``mvm``, taken from the launch record the launcher fills as it launches:
``tc_read`` (the tensor-core instance's read pass), ``read_prepare`` (its
pre-pass, which quantises the drives and splits the conductance pair once
per read), ``read_range`` (its range pass, dynamic range only),
``read_tile`` (the FP32 instance's tile kernel) and ``reduce_tiles`` (the
FP32 instance's tile-order sum, when the reduction spans more than one
tile).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.core import shardctx
from repro_torch.core.adc import (AdcConfig, _clip, _round, divisor,
                                  fixed_saturation)
from repro_torch.core.crossbar import CrossbarConfig
from repro_torch.core.xbar_ops import _tile_partials, _tiled_read

from . import _nvcc, outputs

Tensor = torch.Tensor

READ_IMPLS = ("auto", "chain", "cuda", "eager")

#: The read's kernels, in the order of the launcher's launch record.
READ_KERNEL_COUNTS = ("read_tile", "reduce_tiles", "read_prepare",
                      "read_range", "tc_read")
#: The fakequant read's kernels, in the order of its launch record.
FQ_KERNEL_COUNTS = ("fakequant_scale", "fakequant_prepare", "fakequant_fp32",
                    "fakequant_tc", "fakequant_epilogue")
#: Launches of each kernel of this module; only the wrappers add to it.
LAUNCHES = {"fused_vmm": 0, "fused_mvm": 0,
            **{f"{name}_{d}": 0 for d in ("vmm", "mvm")
               for name in READ_KERNEL_COUNTS},
            "fakequant": 0, "fakequant_lead": 0, "fakequant_split": 0,
            "fakequant_tiles": 0,
            **{name: 0 for name in FQ_KERNEL_COUNTS}}

SOURCE = _nvcc.CSRC / "xbar_vmm.cu"
FAKEQUANT_SOURCE = _nvcc.CSRC / "xbar_fakequant.cu"
TC_MIN_BATCH = 17              # the tensor-core instance from this batch
# The fakequant read's tensor-core instance from this many tokens: the
# measured crossover of one lm100m layer's reads on an H100 (the two tie
# from 96 to 128 tokens, the tensor cores lead from 144;
# tools/fakequant_crossover.py).
FQ_TC_MIN_TOKENS = 144
TC_MAX_LEVELS = 256            # kTcMaxLevels: DAC codes exact in bf16
RANGE_COLS = 64                # kQCols: the columns of one range partial
KERNEL_IMPLS = ("auto", "cuda", "eager")


def resolve_read_impl(impl: Optional[str], x: Tensor) -> str:
    """Resolve the read path for activations ``x`` (see module docstring)."""
    if impl not in (None, *READ_IMPLS):
        raise ValueError(f"impl must be one of {READ_IMPLS}, got {impl!r}")
    if impl == "chain":
        raise ValueError("impl='chain' is the unfused reference path; call "
                         "core.xbar_ops.vmm, which owns it")
    return resolve_impl(impl, x)


def resolve_impl(impl: Optional[str], x: Tensor) -> str:
    """``"cuda"`` or ``"eager"`` for a kernel's input ``x``: ``None`` /
    ``"auto"`` follow the tensor's device; an explicit choice that does
    not fit it raises."""
    if impl not in (None, *KERNEL_IMPLS):
        raise ValueError(f"impl must be one of {KERNEL_IMPLS}, got "
                         f"{impl!r}")
    on_card = x.is_cuda
    if impl in (None, "auto"):
        return "cuda" if on_card else "eager"
    if impl == "eager" and on_card:
        raise ValueError("impl='eager' on a CUDA tensor: tensors on the card "
                         "are read by the CUDA kernel")
    if impl == "cuda" and not on_card:
        raise ValueError("impl='cuda' needs CUDA tensors; a CPU tensor is "
                         "read by the plain version (impl='eager')")
    return impl


# --------------------------------------------------------------------------
# The plain version
# --------------------------------------------------------------------------

def _read_plain(x: Tensor, g: Tensor, ref: Tensor, sc: Tensor,
                cfg: CrossbarConfig, transpose: bool = False,
                partials: bool = False) -> Tensor:
    """The kernels' function in plain torch, on the kernels' operands.

    ``x`` (L, B, K), ``g``/``ref`` (L, K, N), ``sc`` (L, 2) float32 →
    (L, B, N): quantise by ``sc[:, 0]`` → pad → per-tile einsum →
    saturation → ADC → sum over K tiles → ``× sc[:, 1]`` (the steps of
    the reference's ``_read_one_jnp`` / ``_tiled_read_twin``).  With
    ``transpose``, ``x`` is (L, B, N) and the result (L, B, K).  With
    ``partials``, the read stops before the tile sum, as the kernels'
    partials form does: (L, tR, B, O), each reduction tile's quantised
    charges, unscaled (:func:`_reduce_tiles_plain` finishes it).
    """
    levels = float(cfg.adc.in_levels)
    xi = _clip(_round(x / sc[:, 0, None, None]), -levels, levels)
    k, n = g.shape[-2:]
    diff = torch.nn.functional.pad(g - ref, (0, (-n) % cfg.cols,
                                             0, (-k) % cfg.rows))
    out = k if transpose else n
    if partials:
        q = _tile_partials(xi, diff, cfg, transpose)   # (L, tR, tO, B, C)
        lyr, t_r, _, b = q.shape[:4]
        return q.movedim(3, 2).reshape(lyr, t_r, b, -1)[..., :out]
    q = _tiled_read(xi, diff, cfg, transpose)[..., :out]
    return q * sc[:, 1, None, None]


def _reduce_tiles_plain(partials: Tensor, sc: Tensor) -> Tensor:
    """The tile sum of a read in partials form, (L, tR, B, O) → (L, B, O):
    float32 adds in tile order from tile 0, then ``× sc[:, 1]``, the
    kernel ``reduce_tiles_kernel``'s arithmetic."""
    acc = partials[:, 0]
    for t in range(1, partials.shape[1]):
        acc = acc + partials[:, t]
    return acc * sc[:, 1, None, None]


# --------------------------------------------------------------------------
# The CUDA kernels
# --------------------------------------------------------------------------

def read_instance(batch: int, in_levels: int) -> str:
    """The kernel instance a read of ``batch`` rows takes.

    ``"tensor_core"`` for training batches and prefill (``batch`` > 16)
    when the DAC codes are exact in bf16 (``in_levels`` <= 256: DACs of up
    to 9 bits); ``"fp32"`` otherwise: decode and small prefill chunks,
    where the bytes of the conductances bound the read, and wider DACs.
    """
    if batch >= TC_MIN_BATCH and in_levels <= TC_MAX_LEVELS:
        return "tensor_core"
    return "fp32"


_lib = None
_sms = {}   # device index -> SM count, after the device's one-time setup


def _library():
    global _lib
    if _lib is None:
        lib = _nvcc.load(SOURCE)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.xbar_read.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                                  i, i, f, f, f, f, i, p, p]
        lib.xbar_read.restype = ctypes.c_int
        lib.xbar_reduce_tiles.argtypes = [p, p, p, i, i, i, i, p,
                                          ctypes.POINTER(i)]
        lib.xbar_reduce_tiles.restype = ctypes.c_int
        lib.xbar_read_setup.argtypes = [ctypes.POINTER(i)]
        lib.xbar_read_setup.restype = ctypes.c_int
        lib.xbar_read_scratch_floats.argtypes = [i, i, i, i, i, i, i, i]
        lib.xbar_read_scratch_floats.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def _check_operands(x: Tensor, g: Tensor, ref: Tensor, sc: Tensor,
                    transpose: bool) -> None:
    tensors = {"x": x, "g": g, "ref": ref, "sc": sc}
    for name, t in tensors.items():
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 CUDA "
                             f"tensor, got {t.dtype} on {t.device}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    lyr, b, d = x.shape
    drive = g.shape[2] if transpose else g.shape[1]
    if g.ndim != 3 or g.shape[0] != lyr or d != drive \
            or ref.shape != g.shape or sc.shape != (lyr, 2):
        raise ValueError(f"operand shapes x {tuple(x.shape)} g "
                         f"{tuple(g.shape)} ref {tuple(ref.shape)} sc "
                         f"{tuple(sc.shape)} do not match")


def _read_cuda(x: Tensor, g: Tensor, ref: Tensor, sc: Tensor,
               cfg: CrossbarConfig, transpose: bool = False,
               partials: bool = False) -> Tensor:
    """Launch a fused read on (L, B, K|N) / (L, K, N) / (L, 2): the
    forward read, or with ``transpose`` the transpose read.  With
    ``partials`` the read stops before its tile sum and returns (L, tR,
    B, O), each reduction tile's quantised charges, unscaled (the
    kernels' partials form; :func:`_reduce_tiles_cuda` sums them)."""
    _check_operands(x, g, ref, sc, transpose)
    lib = _library()
    lyr, b, _ = x.shape
    k, n = g.shape[1:]
    adc = cfg.adc
    out = k if transpose else n
    t_r = -(-(n if transpose else k) // (cfg.cols if transpose
                                         else cfg.rows))
    y = outputs.empty((lyr, t_r, b, out) if partials else (lyr, b, out),
                      torch.float32, x.device)
    tc = read_instance(b, adc.in_levels) == "tensor_core"
    n_scratch = lib.xbar_read_scratch_floats(lyr, b, k, n, cfg.rows,
                                             cfg.cols, int(transpose),
                                             int(tc))
    if partials and not tc:
        n_scratch = 0   # the FP32 instance writes its partials into y
    scratch = torch.empty((n_scratch,), dtype=torch.float32,
                          device=x.device) if n_scratch else None
    dev = x.device.index
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if dev not in _sms:
            sms = ctypes.c_int(0)
            err = lib.xbar_read_setup(ctypes.byref(sms))
            if err != 0:
                raise RuntimeError(f"xbar_read_setup failed: CUDA error "
                                   f"{err} on {x.device}")
            _sms[dev] = sms.value
    n_rows = cfg.cols if transpose else cfg.rows
    launched = (ctypes.c_int * len(READ_KERNEL_COUNTS))()
    err = lib.xbar_read(
        x.data_ptr(), g.data_ptr(), ref.data_ptr(), sc.data_ptr(),
        y.data_ptr(), scratch.data_ptr() if scratch is not None else None,
        lyr, b, k, n, cfg.rows, cfg.cols, int(transpose), int(tc),
        int(partials), int(adc.range_mode != "fixed"), float(adc.in_levels),
        float(adc.out_levels), fixed_saturation(adc, n_rows, cfg.device.gmax),
        float(adc.sat_sigmas), _sms[dev], stream, launched)
    direction = "mvm" if transpose else "vmm"
    for name, count in zip(READ_KERNEL_COUNTS, launched):
        LAUNCHES[f"{name}_{direction}"] += count
    LAUNCHES[f"fused_{direction}"] += launched[0] + launched[-1]
    if err != 0:
        raise RuntimeError(f"xbar_read launch failed: CUDA error {err} "
                           f"(x {tuple(x.shape)}, g {tuple(g.shape)}, tile "
                           f"{cfg.rows}x{cfg.cols}, transpose={transpose})")
    return y


def _reduce_tiles_cuda(partials: Tensor, sc: Tensor,
                       transpose: bool = False) -> Tensor:
    """Launch ``reduce_tiles_kernel`` on a read's (L, tR, B, O) partials:
    the (L, B, O) tile sum in tile order, rescaled by ``sc[:, 1]``.
    Counted as ``reduce_tiles_vmm`` / ``reduce_tiles_mvm``."""
    for name, t in {"partials": partials, "sc": sc}.items():
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 CUDA "
                             f"tensor, got {t.dtype} on {t.device}")
    lyr, t_r, b, out = partials.shape
    if sc.shape != (lyr, 2) or sc.device != partials.device:
        raise ValueError(f"sc {tuple(sc.shape)} on {sc.device} does not "
                         f"match partials {tuple(partials.shape)}")
    y = outputs.empty((lyr, b, out), torch.float32, partials.device)
    launched = ctypes.c_int(0)
    with torch.cuda.device(partials.device):
        stream = torch.cuda.current_stream().cuda_stream
    err = _library().xbar_reduce_tiles(
        partials.data_ptr(), sc.data_ptr(), y.data_ptr(), lyr, t_r, b, out,
        stream, ctypes.byref(launched))
    LAUNCHES[f"reduce_tiles_{'mvm' if transpose else 'vmm'}"] += \
        launched.value
    if err != 0:
        raise RuntimeError(f"xbar_reduce_tiles launch failed: CUDA error "
                           f"{err} (partials {tuple(partials.shape)})")
    return y


# --------------------------------------------------------------------------
# Dispatch
# --------------------------------------------------------------------------

def read_scales(x: Tensor, w_scale: Tensor, in_levels: int) -> Tensor:
    """The (L, 2) operand ``[x_scale, x_scale / w_scale]`` per matrix:
    the DAC full scale ``max|x| / in_levels`` and the folded rescale.
    The divisor is a tensor (``core.adc.divisor``): on the card, torch
    turns a division by a Python number into a product with its
    reciprocal, which can sit an ulp off the reference's division."""
    x_scale = torch.clamp(x.abs().amax(dim=(1, 2)), min=1e-12) \
        / divisor(in_levels, x)
    return torch.stack([x_scale, x_scale / w_scale], dim=1).contiguous()


def xbar_fused_read(x: Tensor, g: Tensor, ref: Tensor, w_scale,
                    cfg: CrossbarConfig, *, impl: Optional[str] = None,
                    transpose: bool = False) -> Tensor:
    """``y ≈ x @ (g - ref) / w_scale`` with the full DAC / per-tile
    integrator + ADC / digital-accumulate semantics of ``core.xbar_ops``;
    with ``transpose``, ``y ≈ x @ ((g - ref) / w_scale).T``.

    ``x``: (..., B, K), or (..., B, N) transposed; ``g``/``ref``:
    (..., K, N) with matching lead dims (none for a plain matrix, (L,) for
    a scan-stacked container); ``w_scale`` broadcasts over the lead dims.
    Each lead matrix has its own DAC full scale.  Returns (..., B, N), or
    (..., B, K) transposed, in ``x.dtype``.
    """
    impl = resolve_read_impl(impl, x)
    lead = g.shape[:-2]
    if ref.shape != g.shape:
        raise ValueError(f"ref {tuple(ref.shape)} does not match g "
                         f"{tuple(g.shape)}")
    drive = g.shape[-1] if transpose else g.shape[-2]
    if x.ndim != len(lead) + 2 or x.shape[:len(lead)] != lead \
            or x.shape[-1] != drive:
        raise ValueError(f"x {tuple(x.shape)} does not match container "
                         f"g {tuple(g.shape)}")
    in_dtype = x.dtype
    lyr = 1
    for d in lead:
        lyr *= d
    xf = x.float().reshape(lyr, *x.shape[len(lead):]).contiguous()
    gf = g.float().reshape(lyr, *g.shape[len(lead):]).contiguous()
    rf = ref.float().reshape(lyr, *ref.shape[len(lead):]).contiguous()
    ws = torch.broadcast_to(torch.as_tensor(w_scale, dtype=torch.float32,
                                            device=x.device), lead)
    sc = read_scales(xf, ws.reshape(lyr), cfg.adc.in_levels)
    if impl == "cuda":
        y = _read_cuda(xf, gf, rf, sc, cfg, transpose)
    else:
        y = _read_plain(xf, gf, rf, sc, cfg, transpose)
    return y.reshape(*lead, *y.shape[1:]).to(in_dtype)


# --------------------------------------------------------------------------
# The shard-local read of the sharded train step
# --------------------------------------------------------------------------

def manual_collective_read(x: Tensor, g: Tensor, ref: Tensor, w_scale,
                           cfg: CrossbarConfig, meta, *,
                           transpose: bool = False,
                           impl: Optional[str] = None,
                           mesh=None) -> Tensor:
    """Shard-local read with the ordered exchange of per-tile partials
    (port of the reference's ``manual_collective_read``).

    ``g``/``ref``/``w_scale`` are this rank's whole-tile blocks of a
    container tiled over the mesh (``meta``, a ``core.shardctx.ShardMeta``,
    carries the global geometry, the axes and this rank's coordinates);
    ``x`` is the whole replicated drive, (lead..., B, K) (or (lead..., B,
    N) transposed) with the container's *global* lead dims.  Returns the
    whole replicated read, bit-equal to :func:`xbar_fused_read` of the
    whole container.  Stage by stage, the same on the card (the kernels)
    and on the CPU (their plain version):

      * DAC: the drives are cut to this rank's lead (expert) block, whose
        matrices' full scales (:func:`read_scales`) come from their whole
        drive rows; the codes are then cut to this rank's reduction rows,
        so each code is the whole read's;
      * tiles: each rank reads only its own tiles.  A reduction dim split
        over shards is read in partials form (each reduction tile's
        quantised charges, unscaled), the partials gathered in tile order
        over the reduction shards and summed over the full tile axis in
        the whole read's order (``reduce_tiles_kernel``, or
        :func:`_reduce_tiles_plain`), then rescaled by ``x_scale /
        w_scale``; a rank that holds its reduction dim whole reads its
        block as it is;
      * output columns, then the lead blocks, are gathered.

    The gathers are ``core.shardctx.combine_partials_exact`` on ``mesh``
    (default: the installed one).

    With ``meta.exact`` False (the port's counterpart of the reference's
    GSPMD read, ``AnalogTrainStep(exact=False)``) a split reduction dim
    trades the ordered combine for a mesh-dependent association: each
    rank sums its *own* reduction tiles' partials in tile order
    (``reduce_tiles_kernel``, unscaled), the ranks' sums are
    ``all_reduce``d over the reduction axes, and the result is rescaled
    once.  The payload falls from (L, tiles, B, O) partials to (L, B, O);
    each element moves within ``ranks * 2^-23 * sum |partial|`` of the
    exact read.  Output and lead blocks are still gathered.
    """
    impl = resolve_read_impl(impl, x)
    nlead = g.ndim - 2
    lead_loc = tuple(g.shape[:-2])
    gview = meta.view(g.ndim)
    lead_glob = tuple(gview[:-2])
    lead_names = meta.lead_names(nlead)
    red_names = meta.col if transpose else meta.row
    out_names = meta.row if transpose else meta.col
    if x.ndim != nlead + 2 or tuple(x.shape[:nlead]) != lead_glob \
            or x.shape[-1] != gview[-1 if transpose else -2]:
        raise ValueError(f"x {tuple(x.shape)} does not match container "
                         f"{tuple(gview)} (local block {tuple(g.shape)})")
    in_dtype = x.dtype
    n_loc = math.prod(lead_loc)
    b, d_glob = x.shape[-2:]
    xl = x.float()
    for d, names in enumerate(lead_names):
        if names:
            xl = xl.narrow(d, shardctx.shard_index(meta, names) * lead_loc[d],
                           lead_loc[d])
    xl = xl.reshape(n_loc, b, d_glob)
    ws = torch.broadcast_to(torch.as_tensor(
        w_scale, dtype=torch.float32, device=x.device), lead_loc)
    sc = read_scales(xl, ws.reshape(n_loc), cfg.adc.in_levels)
    k_loc, n_cols = g.shape[-2:]
    red_loc = n_cols if transpose else k_loc
    red_off = shardctx.shard_index(meta, red_names) * red_loc \
        if red_names else 0
    xr = xl.narrow(2, red_off, red_loc).contiguous()
    gf = g.float().reshape(n_loc, k_loc, n_cols).contiguous()
    rf = ref.float().reshape(n_loc, k_loc, n_cols).contiguous()
    if impl == "cuda":
        read = _read_cuda
        reduce = functools.partial(_reduce_tiles_cuda, transpose=transpose)
    else:
        read, reduce = _read_plain, _reduce_tiles_plain

    def combine(t, names, axis):
        return shardctx.combine_partials_exact(t, names, axis, mesh)

    if red_names and not getattr(meta, "exact", True):
        part = read(xr, gf, rf, sc, cfg, transpose, partials=True)
        unscaled = torch.stack([sc[:, 0], torch.ones_like(sc[:, 0])], 1)
        y = reduce(part, unscaled)
        m = mesh if mesh is not None else shardctx.current_mesh()
        for a in red_names:
            y = m.all_reduce(y, a)
        y = y * sc[:, 1, None, None]
    elif red_names:
        part = read(xr, gf, rf, sc, cfg, transpose, partials=True)
        # audit: allow RA103 -- ordered gather of the per-tile ADC partial sums of the shard-local read (activation-sized, arithmetic-free), reduced after in single-device tile order; conductances never move and RA107 bounds the payload
        y = reduce(combine(part, red_names, 1).contiguous(), sc)
    else:
        y = read(xr, gf, rf, sc, cfg, transpose)
    y = y.reshape(*lead_loc, b, y.shape[-1])
    # audit: allow RA103 -- ordered gather of the read's output-column blocks (activation-sized ADC results, concatenated, no arithmetic); RA107 bounds the payload
    y = combine(y, out_names, y.ndim - 1)
    for d in range(nlead - 1, -1, -1):
        # audit: allow RA103 -- ordered gather of the read's lead-dimension (layer / expert) output blocks, concatenated with no arithmetic; RA107 bounds the payload
        y = combine(y, lead_names[d], d)
    return y.to(in_dtype)


# --------------------------------------------------------------------------
# The fakequant read (digital weights, crossbar I/O quantisation)
# --------------------------------------------------------------------------

def _fakequant_plain(x: Tensor, w: Tensor, sc: Tensor, adc: AdcConfig,
                     rows: int) -> Tensor:
    """The fakequant kernel's function in plain torch, on its operands.

    ``x`` (T, K), ``w`` (K, N), ``sc`` (1,) float32 → (T, N): pad K to
    whole row tiles; the DAC round trip ``clip(round(x / sc)) * sc``; per
    row tile ``q = xq @ w_tile`` and the per-token ADC fake quant over all
    N columns (``sat = sat_sigmas * sqrt(sum q² / N + 1e-12)``); the tiles
    summed in tile order from 0 (the steps of ``_fakequant_kernel``).
    Divisors are tensors on ``x``'s device, so that on the card, too, each
    division is a division and not a product with a reciprocal.
    """
    t, k = x.shape
    n = w.shape[1]
    in_lv, out_lv = float(adc.in_levels), float(adc.out_levels)
    pad = (-k) % rows
    xq = _clip(_round(torch.nn.functional.pad(x, (0, pad)) / sc),
               -in_lv, in_lv) * sc
    wp = torch.nn.functional.pad(w, (0, 0, 0, pad))
    n_cols = torch.full((), float(n), device=x.device)
    levels = torch.full((), out_lv, device=x.device)
    y = torch.zeros((t, n), dtype=torch.float32, device=x.device)
    for i in range(0, k + pad, rows):
        q = xq[:, i:i + rows] @ wp[i:i + rows]
        ms = torch.sum(q * q, dim=-1, keepdim=True) / n_cols
        lsb = adc.sat_sigmas * torch.sqrt(ms + 1e-12) / levels
        y = y + _clip(_round(q / lsb), -out_lv, out_lv) * lsb
    return y


def _fakequant_plain_lead(x: Tensor, w: Tensor, sc: Tensor, adc: AdcConfig,
                          rows: int) -> Tensor:
    """The lead-dim (expert-stack) fakequant read in plain torch: ``x``
    (L, T, K), ``w`` (L, K, N), ``sc`` (L,) → (L, T, N), one
    :func:`_fakequant_plain` per lead matrix with its own DAC scale (the
    reference vmaps its read over the experts)."""
    return torch.stack([_fakequant_plain(x[i], w[i], sc[i:i + 1], adc, rows)
                        for i in range(x.shape[0])])


def split_bf16x3(w: Tensor) -> tuple:
    """``(hi, mid, lo)``: float32 tensors holding bf16 values (round to
    nearest even), ``hi = bf16(w)``, ``mid = bf16(w - hi)``, ``lo =
    bf16(w - hi - mid)``; their sum is ``w`` exactly for ``|w| >= 2^-110``
    and 0 (below that the tail lost is under 2^-133, bf16's least
    subnormal).  The split the tensor-core instance's pre-pass writes."""
    hi = w.to(torch.bfloat16).float()
    r1 = w - hi
    mid = r1.to(torch.bfloat16).float()
    return hi, mid, (r1 - mid).to(torch.bfloat16).float()


def fakequant_codes(x: Tensor, sc: Tensor, in_levels: int) -> Tensor:
    """The DAC codes ``clip(round(x / sc), +-in_levels)`` (float32
    integers), as the tensor-core instance's pre-pass writes them."""
    lv = float(in_levels)
    return _clip(_round(x / sc), -lv, lv)


def _fakequant_tc_plain(x: Tensor, w: Tensor, sc: Tensor, adc: AdcConfig,
                        rows: int) -> Tensor:
    """The plain twin of the tensor-core instance's arithmetic, on the
    kernel's operands: the DAC codes (:func:`fakequant_codes`), W split
    into three bf16 parts (:func:`split_bf16x3`), per row tile ``q = sc *
    (codes @ hi + codes @ mid + codes @ lo)`` (every product exact in
    float32; the sums' order is the kernel's own business), then the
    per-token ADC and tile sum of :func:`_fakequant_plain`.  Used by the
    tests and ``chip_smoke.py``, never by the main path on a card."""
    t, k = x.shape
    n = w.shape[1]
    out_lv = float(adc.out_levels)
    pad = (-k) % rows
    codes = fakequant_codes(torch.nn.functional.pad(x, (0, pad)), sc,
                            adc.in_levels)
    hi, mid, lo = split_bf16x3(torch.nn.functional.pad(w, (0, 0, 0, pad)))
    n_cols = torch.full((), float(n), device=x.device)
    levels = torch.full((), out_lv, device=x.device)
    y = torch.zeros((t, n), dtype=torch.float32, device=x.device)
    for i in range(0, k + pad, rows):
        c = codes[:, i:i + rows]
        s = c @ hi[i:i + rows] + c @ mid[i:i + rows] + c @ lo[i:i + rows]
        q = sc * s
        ms = torch.sum(q * q, dim=-1, keepdim=True) / n_cols
        lsb = adc.sat_sigmas * torch.sqrt(ms + 1e-12) / levels
        y = y + _clip(_round(q / lsb), -out_lv, out_lv) * lsb
    return y


def fakequant_instance(tokens: int, in_levels: int) -> str:
    """The kernel instance a fakequant read of ``tokens`` rows (per lead
    matrix: an expert stack's read picks on its capacity) takes.

    ``"tensor_core"`` for long prefills (``tokens`` >=
    :data:`FQ_TC_MIN_TOKENS`) when the DAC codes are exact in bf16
    (``in_levels`` <= 256: DACs of up to 9 bits); ``"fp32"`` otherwise:
    decode, prefill chunks and short prompts, where streaming W once per
    16 tokens costs less than the tensor cores' pre-pass over all of W
    and their 128-token padding, and wider DACs.
    """
    if tokens >= FQ_TC_MIN_TOKENS and in_levels <= TC_MAX_LEVELS:
        return "tensor_core"
    return "fp32"


_fq_lib = None
# device index -> (SM count, pre-pass CTAs that fit at once)
_fq_dev = {}


def _fakequant_library():
    global _fq_lib
    if _fq_lib is None:
        lib = _nvcc.load(FAKEQUANT_SOURCE)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.xbar_fakequant.argtypes = [p, p, p, p, i, i, i, i, i, i, f, f,
                                       f, i, i, p, p, p]
        lib.xbar_fakequant.restype = ctypes.c_int
        lib.xbar_fakequant_split.argtypes = [p, p, p, p, i, i, i, i, i, i,
                                             f, i, i, p, p, p, p]
        lib.xbar_fakequant_split.restype = ctypes.c_int
        lib.xbar_fakequant_finish.argtypes = [p, p, i, p, i, i, i, i, i, i,
                                              f, f, f, i, i, p, p]
        lib.xbar_fakequant_finish.restype = ctypes.c_int
        lib.xbar_fakequant_tiles.argtypes = [p, p, p, i, i, i, f, f, i, p, p]
        lib.xbar_fakequant_tiles.restype = ctypes.c_int
        lib.xbar_fakequant_setup.argtypes = [ctypes.POINTER(i)]
        lib.xbar_fakequant_setup.restype = ctypes.c_int
        lib.xbar_fakequant_scratch_floats.argtypes = [i] * 8
        lib.xbar_fakequant_scratch_floats.restype = ctypes.c_longlong
        _fq_lib = lib
    return _fq_lib


def _fakequant_cuda(x: Tensor, w: Tensor, adc: AdcConfig, rows: int,
                    instance: Optional[str] = None,
                    sc: Optional[Tensor] = None):
    """Launch a fakequant read of x (T, K) through w (K, N), or of an
    expert stack, x (L, T, K) through w (L, K, N), with the lead dim in
    the grid of every kernel: the pre-pass and the product of
    ``instance`` (default :func:`fakequant_instance` on the T rows of one
    lead matrix), then the epilogue, three launches for the whole stack.
    Returns ``(y, sc)``: the (T, N) or (L, T, N) result and the DAC
    scales the pre-pass computed, one per lead matrix ((1,) or (L,)), or
    copied from ``sc`` when it is given (a row-split read: the whole
    drive's scale).
    Everything a read counts or keeps on the card lies in its own scratch
    (a pre-pass that counts its CTAs has the counts zeroed on the current
    stream first), so reads may run together on several streams."""
    squeeze = x.ndim == 2
    if squeeze:
        x, w = x[None], w[None]
    lib, plan = _fakequant_plan(x, w, adc, rows, instance, sc)
    y = outputs.empty(tuple(x.shape[:2]) + (w.shape[2],), torch.float32,
                      x.device)
    launched = (ctypes.c_int * len(FQ_KERNEL_COUNTS))()
    err = lib.xbar_fakequant(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), plan["scratch"].data_ptr(),
        *plan["dims"], float(adc.in_levels), float(adc.out_levels),
        float(adc.sat_sigmas), *plan["dev"], plan["stream"], launched,
        sc.data_ptr() if sc is not None else None)
    _fq_count(launched)
    if not squeeze:
        LAUNCHES["fakequant_lead"] += launched[0] + launched[1]
    if err != 0:
        raise RuntimeError(f"xbar_fakequant launch failed: CUDA error {err} "
                           f"(x {tuple(x.shape)}, w {tuple(w.shape)}, rows "
                           f"{rows}, {plan['instance']} instance)")
    scratch = plan["scratch"]
    if squeeze:
        return y[0], scratch[:1]
    return y, scratch[:x.shape[0]]


def _fq_count(launched) -> None:
    for name, count in zip(FQ_KERNEL_COUNTS, launched):
        LAUNCHES[name] += count
    LAUNCHES["fakequant"] += launched[0] + launched[1]


def _fakequant_plan(x: Tensor, w: Tensor, adc: AdcConfig, rows: int,
                    instance: Optional[str], sc: Optional[Tensor]) -> dict:
    """Check a read's (L, T, K) / (L, K, N) operands and plan it: the
    library, the instance, the dims, the device's setup, the stream and
    the read's own scratch."""
    if x.ndim != 3 or w.ndim != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"operand shapes x {tuple(x.shape)} w "
                         f"{tuple(w.shape)} do not match")
    instance = instance or fakequant_instance(x.shape[1], adc.in_levels)
    if instance not in ("fp32", "tensor_core"):
        raise ValueError(f"unknown fakequant instance {instance!r}")
    tc = instance == "tensor_core"
    if tc and adc.in_levels > TC_MAX_LEVELS:
        raise ValueError(f"the tensor-core instance takes DAC codes of at "
                         f"most {TC_MAX_LEVELS} levels, got {adc.in_levels}")
    ops = {"x": x, "w": w, **({"sc": sc} if sc is not None else {})}
    for name, t in ops.items():
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 CUDA "
                             f"tensor, got {t.dtype} on {t.device}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if sc is not None and sc.shape != (x.shape[0],):
        raise ValueError(f"sc {tuple(sc.shape)} is not one scale a lead "
                         f"matrix ({x.shape[0]},)")
    lib = _fakequant_library()
    lead, t, k = x.shape
    n = w.shape[2]
    dev = x.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if dev.index not in _fq_dev:
            info = (ctypes.c_int * 2)()
            err = lib.xbar_fakequant_setup(info)
            if err != 0:
                raise RuntimeError(f"xbar_fakequant_setup failed: CUDA "
                                   f"error {err} on {dev}")
            _fq_dev[dev.index] = (info[0], info[1])
    sms, cap = _fq_dev[dev.index]
    n_scratch = lib.xbar_fakequant_scratch_floats(lead, t, k, n, rows,
                                                  int(tc), sms, cap)
    if n_scratch <= 0:
        raise ValueError(f"no fakequant plan for x {tuple(x.shape)} w "
                         f"{tuple(w.shape)}, rows {rows}")
    return lib, {"instance": instance,
                 "dims": (lead, t, k, n, rows, int(tc)), "dev": (sms, cap),
                 "stream": stream,
                 "scratch": torch.empty((n_scratch,), dtype=torch.float32,
                                        device=dev)}


def _fakequant_split_cuda(x: Tensor, w: Tensor, adc: AdcConfig, rows: int,
                          sc: Optional[Tensor] = None, q_out: bool = False):
    """The first half of a split-range read on the card (x (T, K), w (K,
    N): this rank's columns or row tiles): the pre-pass and the product,
    two launches.  Returns ``(head, ssq)``: what
    :func:`_fakequant_finish_cuda` takes, and the read's range partials,
    (T, tiles, ceil(N / 64)): each token and row tile's sum of q² over
    each 64-column block; with ``q_out`` ``(head, ssq, q)``, q (T, tiles,
    N) each row tile's product (for :func:`_fakequant_tiles_cuda`)."""
    x3, w3 = x[None], w[None]
    lib, plan = _fakequant_plan(x3, w3, adc, rows, None, sc)
    tiles = -(-x.shape[1] // rows)
    ssq = torch.empty((x.shape[0], tiles, -(-w.shape[1] // RANGE_COLS)),
                      dtype=torch.float32, device=x.device)
    q = torch.empty((x.shape[0], tiles, w.shape[1]), dtype=torch.float32,
                    device=x.device) if q_out else None
    launched = (ctypes.c_int * len(FQ_KERNEL_COUNTS))()
    err = lib.xbar_fakequant_split(
        x3.data_ptr(), w3.data_ptr(), ssq.data_ptr(),
        plan["scratch"].data_ptr(), *plan["dims"], float(adc.in_levels),
        *plan["dev"], plan["stream"], launched,
        sc.data_ptr() if sc is not None else None,
        q.data_ptr() if q_out else None)
    _fq_count(launched)
    LAUNCHES["fakequant_split"] += launched[0] + launched[1]
    if err != 0:
        raise RuntimeError(f"xbar_fakequant_split launch failed: CUDA error "
                           f"{err} (x {tuple(x.shape)}, w {tuple(w.shape)})")
    return ((lib, plan), ssq, q) if q_out else ((lib, plan), ssq)


def _fakequant_tiles_cuda(q_all: Tensor, ssq_all: Tensor,
                          adc: AdcConfig) -> Tensor:
    """The epilogue over every rank's row tiles gathered in tile order:
    ``q_all`` (T, tiles, N) and ``ssq_all`` (T, tiles, ceil(N / 64)) as
    :func:`_fakequant_split_cuda` gives them with ``q_out``; (T, N), the
    tiles summed in tile order (the whole read's bits).  One launch."""
    lib = _fakequant_library()
    q_all, ssq_all = q_all.float().contiguous(), ssq_all.float().contiguous()
    t, tiles, n = q_all.shape
    dev = q_all.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
    y = outputs.empty((t, n), torch.float32, dev)
    launched = (ctypes.c_int * len(FQ_KERNEL_COUNTS))()
    err = lib.xbar_fakequant_tiles(
        q_all.data_ptr(), ssq_all.data_ptr(), y.data_ptr(), t, tiles, n,
        float(adc.out_levels), float(adc.sat_sigmas), _fq_dev[dev.index][0],
        stream, launched)
    _fq_count(launched)
    LAUNCHES["fakequant_tiles"] += launched[FQ_KERNEL_COUNTS.index(
        "fakequant_epilogue")]
    if err != 0:
        raise RuntimeError(f"xbar_fakequant_tiles launch failed: CUDA error "
                           f"{err} (q {tuple(q_all.shape)})")
    return y


def _fakequant_finish_cuda(head, ssq_all: Tensor, n_range: int,
                           adc: AdcConfig) -> Tensor:
    """The second half: the epilogue on the head's scratch with
    ``ssq_all`` (T, tiles, blocks), the range partials of every 64-column
    block of the whole width in its column order, ``n_range`` columns
    wide; (T, N) for this rank's columns.  One launch."""
    lib, plan = head
    _, t, _, n, _, _ = plan["dims"]
    ssq_all = ssq_all.float().contiguous()
    y = outputs.empty((t, n), torch.float32, ssq_all.device)
    launched = (ctypes.c_int * len(FQ_KERNEL_COUNTS))()
    err = lib.xbar_fakequant_finish(
        plan["scratch"].data_ptr(), ssq_all.data_ptr(), ssq_all.shape[-1],
        y.data_ptr(), *plan["dims"], float(n_range), float(adc.out_levels),
        float(adc.sat_sigmas), *plan["dev"], plan["stream"], launched)
    _fq_count(launched)
    if err != 0:
        raise RuntimeError(f"xbar_fakequant_finish launch failed: CUDA error "
                           f"{err} (y {tuple(y.shape)})")
    return y


def _fakequant_plain_head(x: Tensor, w: Tensor, sc: Tensor, adc: AdcConfig,
                          rows: int):
    """The first half of the split-range read in plain torch: ``(q,
    ssq)``, each row tile's product (T, tiles, N) and its range partials
    (T, tiles, ceil(N / 64)), each 64-column block's per-token sum of q²
    (:func:`_fakequant_plain`'s steps)."""
    t, k = x.shape
    in_lv = float(adc.in_levels)
    pad = (-k) % rows
    xq = _clip(_round(torch.nn.functional.pad(x, (0, pad)) / sc),
               -in_lv, in_lv) * sc
    wp = torch.nn.functional.pad(w, (0, 0, 0, pad))
    q = torch.stack([xq[:, i:i + rows] @ wp[i:i + rows]
                     for i in range(0, k + pad, rows)], dim=1)
    qp = torch.nn.functional.pad(q, (0, (-q.shape[-1]) % RANGE_COLS))
    ssq = torch.sum((qp * qp).reshape(*q.shape[:2], -1, RANGE_COLS), dim=-1)
    return q, ssq


def _fakequant_plain_finish(q: Tensor, ssq_all: Tensor, n_range: int,
                            adc: AdcConfig) -> Tensor:
    """The second half in plain torch: each tile's per-token ADC at the
    range of the blocks' partials ``ssq_all`` over ``n_range`` columns,
    the tiles summed in tile order from 0."""
    out_lv = float(adc.out_levels)
    n_cols = torch.full((), float(n_range), device=q.device)
    levels = torch.full((), out_lv, device=q.device)
    tot = ssq_all.sum(dim=-1)
    y = torch.zeros((q.shape[0], q.shape[2]), dtype=torch.float32,
                    device=q.device)
    for i in range(q.shape[1]):
        ms = tot[:, i:i + 1] / n_cols
        lsb = adc.sat_sigmas * torch.sqrt(ms + 1e-12) / levels
        y = y + _clip(_round(q[:, i] / lsb), -out_lv, out_lv) * lsb
    return y


def fakequant_split_read(x: Tensor, w: Tensor, adc: AdcConfig, rows: int,
                         combine, n_range: int,
                         sc: Optional[Tensor] = None) -> Tensor:
    """A fakequant read of this rank's columns ``w`` (K, N) of a leaf
    ``n_range`` columns wide, x (T, K) → (T, N), whose per-(token, row
    tile) ADC range is the whole width's: the read's range partials, one
    per 64-column block, (T, tiles, blocks), go through ``combine`` (the
    ordered gather of every rank's blocks into the whole width's column
    order) before the ADC.  ``sc`` (1,) is a given DAC scale.  On the
    card the kernels' split form (:func:`_fakequant_split_cuda`, three
    launches with the finish), whose range is then the whole read's bit
    for bit; on the CPU the plain halves.  Returns ``(y, ssq_all)``, the
    read and the whole width's partials."""
    xf, wf = x.float().contiguous(), w.float().contiguous()
    if x.is_cuda:
        head, ssq = _fakequant_split_cuda(xf, wf, adc, rows, sc)
        full = combine(ssq)
        return _fakequant_finish_cuda(head, full, n_range, adc), full
    if sc is None:
        sc = fakequant_scale(xf, adc.in_levels)
    q, ssq = _fakequant_plain_head(xf, wf, sc, adc, rows)
    full = combine(ssq)
    return _fakequant_plain_finish(q, full, n_range, adc), full


def fakequant_tiles_read(x: Tensor, w: Tensor, adc: AdcConfig, rows: int,
                         combine, sc: Optional[Tensor] = None) -> Tensor:
    """A fakequant read of this rank's whole row tiles ``w`` (K, N) of a
    leaf split by rows, x (T, K) its part of the drive → (T, N), the
    whole read's output: each tile's product q (T, tiles, N) and its range
    partials (T, tiles, blocks) go through ``combine`` (the ordered gather
    of every rank's tiles along dim 1, in tile order) and the ADC runs
    over every tile, summing them in tile order as the whole read does.
    ``sc`` (1,) is the whole drive's DAC scale.  On the card the kernels'
    split form with its q copied out and ``xbar_fakequant_tiles`` (three
    launches: the read on every rank is the whole read's bit for bit); on
    the CPU the plain halves."""
    xf, wf = x.float().contiguous(), w.float().contiguous()
    if x.is_cuda:
        _, ssq, q = _fakequant_split_cuda(xf, wf, adc, rows, sc, q_out=True)
        return _fakequant_tiles_cuda(combine(q), combine(ssq), adc)
    if sc is None:
        sc = fakequant_scale(xf, adc.in_levels)
    q, ssq = _fakequant_plain_head(xf, wf, sc, adc, rows)
    return _fakequant_plain_finish(combine(q), combine(ssq), w.shape[1], adc)


def fakequant_scale(x: Tensor, in_levels: int) -> Tensor:
    """The DAC full scale ``max(max|x|, 1e-12) / in_levels``: shape (1,)
    for x (T, K), (L,) for an expert stack x (L, T, K), one per lead
    matrix.  The divisor is a tensor: on the card, torch turns a division
    by a Python number into a product with its reciprocal, which is not
    the reference's (nor the kernels') division."""
    levels = torch.full((), float(in_levels), device=x.device)
    amax = x.abs().amax(dim=(1, 2)) if x.ndim == 3 else x.abs().amax()
    return (torch.clamp(amax, min=1e-12) / levels).reshape(-1)


def fakequant_read(x: Tensor, w: Tensor, adc: AdcConfig,
                   rows: int, sc: Optional[Tensor] = None,
                   instance: Optional[str] = None) -> Tensor:
    """Fused fakequant projection (port of ``fakequant_read_pallas``):
    x (T, K), w (K, N) → (T, N) float32, or an expert stack, x (L, T, K),
    w (L, K, N) → (L, T, N), forward only (``kernels.ops.FakequantRead``
    gives it the eager expression's VJP).

    One DAC scale for all of ``x``, as in the reference's wrapper, per
    lead matrix for a stack (the reference vmaps its read over the
    experts); ``rows`` is the crossbar row pitch (the ADC's tile).  A
    CUDA tensor launches the kernels, three for the whole stack (the
    scales are computed by the first of them); a CPU tensor takes
    :func:`fakequant_scale` and :func:`_fakequant_plain` (per lead matrix,
    :func:`_fakequant_plain_lead`).  ``sc``, one scale a lead matrix,
    replaces the scale of ``x`` (a row-split read takes the whole
    drive's, a rank's expert-stack read each expert's over the data
    ranks); ``instance`` replaces :func:`fakequant_instance`'s choice on
    the card (a rank's rows of a buffer read whole elsewhere take the
    whole buffer's instance).
    """
    if x.ndim not in (2, 3) or w.ndim != x.ndim \
            or x.shape[-1] != w.shape[-2] or x.shape[:-2] != w.shape[:-2]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} are not "
                         "(T, K) and (K, N), or (L, T, K) and (L, K, N)")
    xf, wf = x.float().contiguous(), w.float().contiguous()
    if x.is_cuda:
        if sc is None:
            return _fakequant_cuda(xf, wf, adc, rows, instance)[0]
        return _fakequant_cuda(xf, wf, adc, rows, instance, sc=sc)[0]
    if sc is None:
        sc = fakequant_scale(xf, adc.in_levels)
    if x.ndim == 3:
        return _fakequant_plain_lead(xf, wf, sc, adc, rows)
    return _fakequant_plain(xf, wf, sc, adc, rows)
