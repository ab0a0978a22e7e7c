"""Rank-k crossbar write: the CUDA kernel, its plain torch version and the
dispatch between them.

Port of ``repro.kernels.xbar_update``.  The kernel in
``csrc/xbar_update.cu`` replaces the TPU kernel ``_update_kernel`` in
both update modes (``cfg.update_mode``):

* ``"outer"`` — per lead matrix it accumulates the outer product
  ``acc = sum_t x_q[t] (outer) d_q[t]`` over the token batch, scales it
  by the folded ``-lr * w_scale`` and pushes ``dg_req = scale * acc``
  through the device epilogue (:func:`_device_epilogue`: the TaOx
  SET/RESET factors, the random-walk write noise and the clip to the
  conductance window);
* ``"pulse_train"`` — it also accumulates ``a_abs = sum_t |x_q[t]|
  (outer) |d_q[t]|`` and fires the request as integer SET and RESET
  event counts, each event answered by the device's slope at the cell's
  state, with write noise over the total event count
  (:func:`_pulse_epilogue`).

Write noise (``noise_mode``):

* ``"none"`` — noiseless devices;
* ``"host"`` — a standard-normal field of ``g``'s shape rides in;
* ``"kernel"`` — the counter PRNG: murmur fmix32 of (seed, layer, k-tile,
  n-tile) per tile and one 16-bit Box–Muller draw per pair of adjacent
  columns (:func:`field_normals`).  Its hash words are bit-identical to
  the reference's.  torch has no full uint32 arithmetic, so the plain
  version computes them in int64 masked to 32 bits after every operation,
  each 32 x 32-bit multiply split into 16-bit halves so that no product
  leaves int64's range.

Paths (``impl``) as for the read (``kernels.xbar_vmm``): ``"cuda"`` for
tensors on the card, ``"eager"`` (:func:`_update_plain`) for tensors on
the CPU, ``"auto"``/``None`` by the tensors' device; an explicit path on
the wrong device raises, and there is no fallback.

On the card the write takes one of two instances of the kernel, chosen by
:func:`update_instance` from the operands, as the read's
``read_instance`` chooses: the tensor-core instance when the caller
states the write drivers' scales (``x_q = codes * x_scale``, ``d_q =
codes * d_scale``, as the training step's tapes are), the codes fit bf16
exactly and every sum of code products stays below 2^24; the FP32
instance otherwise (float operands).  The tensor-core instance launches
a pre-pass (the bf16 code planes, scratch of ``update_code_dims``) and
the write.  ``LAUNCHES["outer_update"]`` and ``LAUNCHES["pulse_update"]``
count every write by mode; ``LAUNCHES["update_tc"]``,
``LAUNCHES["update_prepare"]`` and ``LAUNCHES["update_fp32"]`` count the
launches of each kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.core.adc import AdcConfig
from repro_torch.core.crossbar import CrossbarConfig
from repro_torch.core.device import DeviceConfig
from repro_torch.core.shardctx import flat_index

from . import _nvcc, outputs

Tensor = torch.Tensor

NOISE_MODES = ("none", "host", "kernel")
UPDATE_MODES = ("outer", "pulse_train")
UPDATE_IMPLS = ("auto", "cuda", "eager")

#: Writes on the card by update mode, and launches of each of the write's
#: kernels; only the wrappers add to them.
LAUNCHES = {"outer_update": 0, "pulse_update": 0, "update_tc": 0,
            "update_prepare": 0, "update_fp32": 0}

SOURCE = _nvcc.CSRC / "xbar_update.cu"
TC_BLOCK = 128         # kTcBlock of the source: the code planes' feature pad
TC_TOKENS = 32         # kTcTok: the code planes' token pad
TC_MAX_LEVELS = 256    # kTcMaxLevels: codes exact in bf16
TC_MAX_SUM = 2 ** 24   # sums of code products exact in float32 below this

_M32 = 0xFFFFFFFF


# --------------------------------------------------------------------------
# Counter-based PRNG (uint32 arithmetic in int64)
# --------------------------------------------------------------------------

def _u32(x, device=None) -> Tensor:
    """A uint32 value (int or tensor) as an int64 tensor in [0, 2^32)."""
    return torch.as_tensor(x, dtype=torch.int64, device=device) & _M32


def _mul32(a, b):
    """``a * b mod 2^32`` for operands in [0, 2^32): ``a`` split into
    16-bit halves keeps every product below 2^48."""
    lo = (a & 0xFFFF) * b
    hi = (((a >> 16) * b) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x: Tensor) -> Tensor:
    """murmur3 fmix32: a bijective 32-bit finaliser with full avalanche."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _tile_seed(seed, layer, tile_k, tile_n) -> Tensor:
    """Decorrelated per-(layer, tile) seed from one scalar base seed."""
    h = _mix32(_u32(seed) ^ 0x9E3779B9)
    h = _mix32((h + _mul32(_u32(layer), 0x9E3779B1)) & _M32)
    h = _mix32((h + _mul32(_u32(tile_k), 0x85EBCA77)) & _M32)
    return _mix32((h + _mul32(_u32(tile_n), 0xC2B2AE3D)) & _M32)


def _pair_normals(h: Tensor):
    """Both Box–Muller outputs of one hashed word (16 bits per uniform;
    u1 in (0, 1] keeps the log finite)."""
    u1 = ((h >> 16).to(torch.float32) + 1.0) * (1.0 / (1 << 16))
    u2 = (h & 0xFFFF).to(torch.float32) * (1.0 / (1 << 16))
    r = torch.sqrt(-2.0 * torch.log(u1))
    a = (2.0 * np.pi) * u2
    return r * torch.cos(a), r * torch.sin(a)


def _tile_normals(seed: Tensor, rows: int, cols: int) -> Tensor:
    """(..., rows, cols) standard normals for tiles of seeds (..., 1, 1).

    Pairs interleave along the column axis — (r, 2j) and (r, 2j + 1)
    share one Box–Muller draw; an odd ``cols`` spends a full draw per cell
    and keeps only the cosine leg.
    """
    dev = seed.device
    r = torch.arange(rows, dtype=torch.int64, device=dev)[:, None]
    if cols % 2 == 0:
        half = cols // 2
        pid = (r * half + torch.arange(half, dtype=torch.int64,
                                       device=dev)) & _M32
        z0, z1 = _pair_normals(_mix32(pid ^ seed))
        z = torch.stack([z0, z1], dim=-1)
        return z.reshape(*z.shape[:-2], cols)
    idx = (r * cols + torch.arange(cols, dtype=torch.int64,
                                   device=dev)) & _M32
    return _pair_normals(_mix32(idx ^ seed))[0]


def field_normals(seed, shape, cfg: CrossbarConfig, tile_offsets=(0, 0, 0),
                  device=None) -> Tensor:
    """(L, K, N) standard-normal field, bit-identical in its hash words to
    what the kernel generates per (layer, tile).

    ``tile_offsets`` = (layer, row-tile, col-tile) base coordinates of
    this block in a larger container: the block of layers ``l0:`` and
    tiles ``k0:``, ``n0:`` gets exactly that slice of the larger
    container's field."""
    lyr, k, n = shape
    rows, cols = cfg.rows, cfg.cols
    tk, tn = -(-k // rows), -(-n // cols)

    def axis(size, dim):
        a = torch.arange(size, dtype=torch.int64, device=device) \
            + tile_offsets[dim]
        return a.reshape([size if i == dim else 1 for i in range(3)])
    seeds = _tile_seed(_u32(seed, device), axis(lyr, 0), axis(tk, 1),
                       axis(tn, 2))
    z = _tile_normals(seeds[..., None, None], rows, cols)
    z = z.permute(0, 1, 3, 2, 4).reshape(lyr, tk * rows, tn * cols)
    return z[:, :k, :n]


# --------------------------------------------------------------------------
# Device epilogue (elementwise; mirrors core.device.apply_update)
# --------------------------------------------------------------------------

def _factor_consts(nu: float):
    """``exp(-nu)`` and the centre normaliser, in Python doubles."""
    e = np.exp(-nu)
    return e, (np.exp(-0.5 * nu) - e) / (1.0 - e)


def _updown_factors(g: Tensor, dev: DeviceConfig):
    """State-dependent SET/RESET step factors (see core.device)."""
    x = (g - dev.gmin) / (dev.gmax - dev.gmin)

    def factor(xx, nu):
        if nu < 1e-6:
            return 2.0 * (1.0 - xx)
        e, mid = _factor_consts(nu)
        return (torch.exp(-nu * xx) - e) / (1.0 - e) / mid

    if dev.nu_set == dev.nu_reset and dev.nu_set >= 1e-6:
        # exp(-nu (1-x)) = e^{-nu} / exp(-nu x): one exp serves both
        nu = dev.nu_set
        e, mid = _factor_consts(nu)
        s = torch.exp(-nu * x)
        e32 = torch.tensor(e, dtype=torch.float32, device=g.device)
        up = dev.gain_set * ((s - e) / ((1.0 - e) * mid))
        # a tensor numerator: torch's ``scalar / tensor`` multiplies by the
        # reciprocal, the reference divides
        dn = dev.gain_reset * ((e32 / s - e) / ((1.0 - e) * mid))
    else:
        up = dev.gain_set * factor(x, dev.nu_set)
        dn = dev.gain_reset * factor(1.0 - x, dev.nu_reset)
    return up, dn


def _device_epilogue(g: Tensor, dg_req: Tensor, noise: Optional[Tensor],
                     dev: DeviceConfig) -> Tensor:
    """Elementwise device model (mirrors core.device.apply_update)."""
    if dev.kind in ("ideal", "linearized"):
        dg = dg_req
    else:
        up, dn = _updown_factors(g, dev)
        dg = torch.where(dg_req >= 0, dg_req * up, dg_req * dn)
    if dev.write_noise > 0.0 and noise is not None:
        n_pulses = torch.abs(dg_req) / dev.pulse_dg
        sigma = dev.write_noise * dev.pulse_dg * torch.sqrt(n_pulses)
        dg = dg + sigma * noise
    return torch.clamp(g + dg, dev.gmin, dev.gmax)


def _pulse_epilogue(g: Tensor, acc: Tensor, a_abs: Tensor, m: Tensor,
                    noise: Optional[Tensor], dev: DeviceConfig) -> Tensor:
    """Pulse-train write (mirrors core.device.apply_pulse_train).

    ``acc = sum_b x_b d_b`` is the signed outer-product accumulator and
    ``a_abs = sum_b |x_b| |d_b|`` its magnitude twin.  The four drive
    phases of the sign-decomposed update (++/-- on the SET rail, +-/-+ on
    the RESET rail) partition the event mass so that

        S = (a_abs |m| + acc m) / 2      R = (a_abs |m| - acc m) / 2

    with ``S - R = m acc`` (the requested update) and ``S + R = |m| a_abs``
    (the total fired charge).  Each rail fires an integer number of
    events ``n = round(mag / pulse_dg)`` (half to even); the device answers
    every SET event with ``pulse_dg * up`` and every RESET event with
    ``pulse_dg * dn``, and the write noise scales with
    ``sqrt(n_set + n_reset)``.
    """
    s_mag = 0.5 * (a_abs * torch.abs(m) + acc * m)
    r_mag = 0.5 * (a_abs * torch.abs(m) - acc * m)
    n_set = torch.round(torch.clamp(s_mag, min=0.0) / dev.pulse_dg)
    n_reset = torch.round(torch.clamp(r_mag, min=0.0) / dev.pulse_dg)
    if dev.kind in ("ideal", "linearized"):
        up = torch.ones_like(g)
        dn = torch.ones_like(g)
    else:
        up, dn = _updown_factors(g, dev)
    dg = dev.pulse_dg * (n_set * up - n_reset * dn)
    if dev.write_noise > 0.0 and noise is not None:
        sigma = dev.write_noise * dev.pulse_dg * torch.sqrt(n_set + n_reset)
        dg = dg + sigma * noise
    return torch.clamp(g + dg, dev.gmin, dev.gmax)


# --------------------------------------------------------------------------
# The plain version
# --------------------------------------------------------------------------

def _update_plain(g: Tensor, x_q: Tensor, d_q: Tensor, scale: Tensor,
                  noise: Optional[Tensor], seed: Optional[int],
                  cfg: CrossbarConfig, noise_mode: str,
                  offs=(0, 0, 0)) -> Tensor:
    """The kernel's function in plain torch (the reference's
    ``_fused_update``): one layer-batched einsum (two in pulse-train mode)
    and the epilogue, with the counter PRNG's field in kernel-noise mode,
    its tiles at the (layer, row-tile, col-tile) base ``offs``."""
    acc = torch.einsum("lbk,lbn->lkn", x_q, d_q)
    if noise_mode == "kernel":
        noise = field_normals(seed, g.shape, cfg, offs, device=g.device)
    elif noise_mode == "none":
        noise = None
    if cfg.update_mode == "pulse_train":
        a_abs = torch.einsum("lbk,lbn->lkn", torch.abs(x_q), torch.abs(d_q))
        return _pulse_epilogue(g, acc, a_abs, scale[:, None, None], noise,
                               cfg.device)
    return _device_epilogue(g, scale[:, None, None] * acc, noise,
                            cfg.device)


def update_levels(cfg: CrossbarConfig):
    """Magnitude levels of the write drivers' codes: rows (the temporal
    coder, ``in_bits``) and columns (the voltage coder,
    ``upd_col_bits``)."""
    col = AdcConfig(in_bits=cfg.upd_col_bits, out_bits=cfg.adc.out_bits)
    return cfg.adc.in_levels, col.in_levels


def update_code_dims(t_tok: int, k: int, n: int):
    """(Tp, Kp, Np): the code planes' padded token and feature dims."""
    def up(v, m):
        return -(-v // m) * m
    return up(t_tok, TC_TOKENS), up(k, TC_BLOCK), up(n, TC_BLOCK)


def _update_codes_plain(x_q: Tensor, d_q: Tensor, x_scale: Tensor,
                        d_scale: Tensor, cfg: CrossbarConfig):
    """The pre-pass in plain torch: bf16 code planes (L, Tp, Kp) and
    (L, Tp, Np), ``clip(round(x_q / x_scale))`` per lead matrix (round
    half to even, as ``rintf``), zero in the padding."""
    lx, ld = update_levels(cfg)
    tp, kp, np_ = update_code_dims(*x_q.shape[1:], d_q.shape[2])

    def plane(v, s, lv, width):
        c = torch.clamp(torch.round(v / s[:, None, None]), -lv, lv)
        return torch.nn.functional.pad(
            c, (0, width - v.shape[2], 0, tp - v.shape[1])).to(torch.bfloat16)
    return plane(x_q, x_scale, lx, kp), plane(d_q, d_scale, ld, np_)


def _update_tc_plain(g: Tensor, x_q: Tensor, d_q: Tensor, scale: Tensor,
                     noise: Optional[Tensor], seed: Optional[int],
                     cfg: CrossbarConfig, noise_mode: str, x_scale: Tensor,
                     d_scale: Tensor, offs=(0, 0, 0)) -> Tensor:
    """The tensor-core instance's arithmetic in plain torch: the codes of
    the pre-pass, their sums taken exactly (in float64, exact below
    2^53), then ``acc = fl(sum) * fl(x_scale d_scale)`` and the same
    epilogue as :func:`_update_plain`.  Where the plain version's float32
    sum of ``x_q d_q`` is exact the two agree bit for bit; elsewhere they
    differ by that sum's rounding."""
    t_tok, k = x_q.shape[1:]
    cx, cd = (c[:, :t_tok, :f].double() for c, f in zip(
        _update_codes_plain(x_q, d_q, x_scale, d_scale, cfg),
        (k, d_q.shape[2])))
    sxd = (x_scale * d_scale)[:, None, None]
    acc = torch.einsum("lbk,lbn->lkn", cx, cd).float() * sxd
    if noise_mode == "kernel":
        noise = field_normals(seed, g.shape, cfg, offs, device=g.device)
    elif noise_mode == "none":
        noise = None
    if cfg.update_mode == "pulse_train":
        a_abs = torch.einsum("lbk,lbn->lkn", cx.abs(), cd.abs()).float() * sxd
        return _pulse_epilogue(g, acc, a_abs, scale[:, None, None], noise,
                               cfg.device)
    return _device_epilogue(g, scale[:, None, None] * acc, noise,
                            cfg.device)


# --------------------------------------------------------------------------
# The CUDA kernels
# --------------------------------------------------------------------------

def update_instance(t_tok: int, cfg: CrossbarConfig, scaled: bool) -> str:
    """The kernel instance a write over ``t_tok`` tokens takes on the card.

    ``"tensor_core"`` when the operands come with their scales
    (``scaled``), both coders' codes are exact in bf16 (at most 256
    levels) and every sum of code products is exact in float32
    (``t_tok * levels_x * levels_d < 2^24``); ``"fp32"`` otherwise.
    """
    lx, ld = update_levels(cfg)
    if scaled and max(lx, ld) <= TC_MAX_LEVELS \
            and t_tok * lx * ld < TC_MAX_SUM:
        return "tensor_core"
    return "fp32"


_INT_FIELDS = ("kind", "noise_mode", "lin_set", "lin_reset")
_PARAM_FIELDS = ("kind", "noise_mode", "gmin", "gmax", "span", "neg_nu",
                 "e", "emid", "gain_set", "gain_reset", "lin_set",
                 "lin_reset", "neg_nu_set", "e_set", "ome_set", "mid_set",
                 "neg_nu_reset", "e_reset", "ome_reset", "mid_reset",
                 "pulse_dg", "sigma_scale", "two_pi")


class _DeviceParams(ctypes.Structure):
    """``DeviceParams`` of ``csrc/xbar_update.cu``, field for field."""
    _fields_ = [(n, ctypes.c_int if n in _INT_FIELDS else ctypes.c_float)
                for n in _PARAM_FIELDS]


def device_params(dev: DeviceConfig, noise_mode: str) -> _DeviceParams:
    """The kernel's constants, formed in Python doubles as the reference
    forms them and rounded to float32 once (by ctypes).  ``ideal`` and
    ``linearized`` are linear (kind 0); every other kind (``taox``,
    ``lut``) takes the TaOx slope, as in the reference's kernel: kind 1
    with one ``exp`` for equal nonlinearities, else kind 2."""
    p = _DeviceParams()
    if dev.kind in ("ideal", "linearized"):
        p.kind = 0
    elif dev.nu_set == dev.nu_reset and dev.nu_set >= 1e-6:
        p.kind = 1
        e, mid = _factor_consts(dev.nu_set)
        p.neg_nu, p.e, p.emid = -dev.nu_set, e, (1.0 - e) * mid
    else:
        p.kind = 2
        for side, nu in (("set", dev.nu_set), ("reset", dev.nu_reset)):
            lin = nu < 1e-6
            e, mid = _factor_consts(nu) if not lin else (0.0, 1.0)
            setattr(p, f"lin_{side}", int(lin))
            setattr(p, f"neg_nu_{side}", -nu)
            setattr(p, f"e_{side}", e)
            setattr(p, f"ome_{side}", 1.0 - e)
            setattr(p, f"mid_{side}", mid)
    p.gmin, p.gmax, p.span = dev.gmin, dev.gmax, dev.gmax - dev.gmin
    p.gain_set, p.gain_reset = dev.gain_set, dev.gain_reset
    p.noise_mode = (NOISE_MODES.index(noise_mode)
                    if dev.write_noise > 0.0 else 0)
    p.pulse_dg = dev.pulse_dg
    p.sigma_scale = dev.write_noise * dev.pulse_dg
    p.two_pi = 2.0 * np.pi
    return p


_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _nvcc.load(SOURCE)
        p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, \
            ctypes.c_float
        for fn in (lib.xbar_outer_update, lib.xbar_pulse_update):
            fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, u, u, u, u,
                           _DeviceParams, p]
            fn.restype = ctypes.c_int
        lib.xbar_update_prepare.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                            i, f, f, p]
        lib.xbar_update_prepare.restype = ctypes.c_int
        lib.xbar_tc_update.argtypes = [i, p, p, p, p, p, p, p, i, i, i, i,
                                       i, i, i, i, i, u, u, u, u,
                                       _DeviceParams, p]
        lib.xbar_tc_update.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_cuda(tensors: dict, device) -> None:
    for name, t in tensors.items():
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 CUDA "
                             f"tensor, got {t.dtype} on {t.device}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, not on {device}")


def _stream(device) -> int:
    with torch.cuda.device(device):
        return torch.cuda.current_stream().cuda_stream


def _update_prepare_cuda(x_q: Tensor, d_q: Tensor, x_scale: Tensor,
                         d_scale: Tensor, cfg: CrossbarConfig) -> Tensor:
    """Launch the pre-pass: one bf16 buffer holding the code planes (L,
    Tp, Kp) and then (L, Tp, Np) (see :func:`_update_codes_plain`)."""
    _check_cuda({"x_q": x_q, "d_q": d_q, "x_scale": x_scale,
                 "d_scale": d_scale}, x_q.device)
    lyr, t_tok, k = x_q.shape
    n = d_q.shape[2]
    if d_q.shape[:2] != (lyr, t_tok) or x_scale.shape != (lyr,) \
            or d_scale.shape != (lyr,):
        raise ValueError(f"operand shapes x_q {tuple(x_q.shape)} d_q "
                         f"{tuple(d_q.shape)} x_scale {tuple(x_scale.shape)} "
                         f"d_scale {tuple(d_scale.shape)} do not match")
    tp, kp, np_ = update_code_dims(t_tok, k, n)
    codes = torch.empty((lyr * tp * (kp + np_),), dtype=torch.bfloat16,
                        device=x_q.device)
    lx, ld = update_levels(cfg)
    err = _library().xbar_update_prepare(
        x_q.data_ptr(), d_q.data_ptr(), x_scale.data_ptr(),
        d_scale.data_ptr(), codes.data_ptr(), lyr, t_tok, k, n, tp, kp, np_,
        float(lx), float(ld), _stream(x_q.device))
    if err != 0:
        raise RuntimeError(f"xbar_update_prepare launch failed: CUDA error "
                           f"{err} (L {lyr}, T {t_tok}, K {k}, N {n})")
    LAUNCHES["update_prepare"] += 1
    return codes


def code_planes(codes: Tensor, lyr: int, t_tok: int, k: int, n: int):
    """The two planes of a pre-pass buffer, as (L, Tp, Kp) / (L, Tp, Np)
    views."""
    tp, kp, np_ = update_code_dims(t_tok, k, n)
    return (codes[:lyr * tp * kp].view(lyr, tp, kp),
            codes[lyr * tp * kp:].view(lyr, tp, np_))


def _update_tc_cuda(g: Tensor, codes: Tensor, t_tok: int, scale: Tensor,
                    x_scale: Tensor, d_scale: Tensor, noise: Optional[Tensor],
                    seed: Optional[int], cfg: CrossbarConfig,
                    noise_mode: str, offs=(0, 0, 0)) -> Tensor:
    """Launch the tensor-core write from the pre-pass's code planes, its
    tiles' noise at the (layer, row-tile, col-tile) base ``offs``."""
    lyr, k, n = g.shape
    tp, kp, np_ = update_code_dims(t_tok, k, n)
    if codes.dtype != torch.bfloat16 or codes.device != g.device \
            or codes.numel() != lyr * tp * (kp + np_):
        raise ValueError(f"codes must be the pre-pass's bf16 buffer of "
                         f"{lyr * tp * (kp + np_)} on {g.device}")
    out = outputs.empty_like(g)
    err = _library().xbar_tc_update(
        int(cfg.update_mode == "pulse_train"), g.data_ptr(),
        codes.data_ptr(), scale.data_ptr(), x_scale.data_ptr(),
        d_scale.data_ptr(), noise.data_ptr() if noise is not None else None,
        out.data_ptr(), lyr, t_tok, k, n, tp, kp, np_, cfg.rows, cfg.cols,
        int(seed or 0) & _M32, *(int(o) & _M32 for o in offs),
        device_params(cfg.device, noise_mode), _stream(g.device))
    if err != 0:
        raise RuntimeError(f"xbar_tc_update launch failed: CUDA error {err} "
                           f"(g {tuple(g.shape)}, T {t_tok}, tile "
                           f"{cfg.rows}x{cfg.cols})")
    LAUNCHES["update_tc"] += 1
    return out


def _update_fp32_cuda(g: Tensor, x_q: Tensor, d_q: Tensor, scale: Tensor,
                      noise: Optional[Tensor], seed: Optional[int],
                      cfg: CrossbarConfig, noise_mode: str,
                      offs=(0, 0, 0)) -> Tensor:
    """Launch the FP32 instance on the float operands, its tiles' noise at
    the (layer, row-tile, col-tile) base ``offs``."""
    lyr, k, n = g.shape
    t_tok = x_q.shape[1]
    lib = _library()
    fn = lib.xbar_pulse_update if cfg.update_mode == "pulse_train" \
        else lib.xbar_outer_update
    out = outputs.empty_like(g)
    err = fn(g.data_ptr(), x_q.data_ptr(), d_q.data_ptr(), scale.data_ptr(),
             noise.data_ptr() if noise is not None else None, out.data_ptr(),
             lyr, t_tok, k, n, cfg.rows, cfg.cols,
             int(seed or 0) & _M32, *(int(o) & _M32 for o in offs),
             device_params(cfg.device, noise_mode), _stream(g.device))
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error "
                           f"{err} (g {tuple(g.shape)}, T {t_tok}, tile "
                           f"{cfg.rows}x{cfg.cols})")
    LAUNCHES["update_fp32"] += 1
    return out


def _update_cuda(g: Tensor, x_q: Tensor, d_q: Tensor, scale: Tensor,
                 noise: Optional[Tensor], seed: Optional[int],
                 cfg: CrossbarConfig, noise_mode: str,
                 x_scale: Optional[Tensor] = None,
                 d_scale: Optional[Tensor] = None,
                 offs=(0, 0, 0)) -> Tensor:
    """The rank-k write (in ``cfg.update_mode``) on the card, on (L, K, N)
    / (L, T, K) / (L, T, N) / (L,) operands and, when stated, the (L,)
    scales of the codes: the instance :func:`update_instance` picks, its
    tiles' noise at the tile base ``offs``.  Returns the new conductances
    (a new tensor)."""
    tensors = {"g": g, "x_q": x_q, "d_q": d_q, "scale": scale}
    if noise is not None:
        tensors["noise"] = noise
    scaled = x_scale is not None
    if scaled:
        tensors.update(x_scale=x_scale, d_scale=d_scale)
    _check_cuda(tensors, g.device)
    lyr, k, n = g.shape
    t_tok = x_q.shape[1]
    if x_q.shape != (lyr, t_tok, k) or d_q.shape != (lyr, t_tok, n) \
            or scale.shape != (lyr,) \
            or (noise is not None and noise.shape != g.shape) \
            or (scaled and (x_scale.shape != (lyr,)
                            or d_scale.shape != (lyr,))):
        raise ValueError(f"operand shapes g {tuple(g.shape)} x_q "
                         f"{tuple(x_q.shape)} d_q {tuple(d_q.shape)} scale "
                         f"{tuple(scale.shape)} do not match")
    if update_instance(t_tok, cfg, scaled) == "tensor_core":
        codes = _update_prepare_cuda(x_q, d_q, x_scale, d_scale, cfg)
        out = _update_tc_cuda(g, codes, t_tok, scale, x_scale, d_scale,
                              noise, seed, cfg, noise_mode, offs)
    else:
        out = _update_fp32_cuda(g, x_q, d_q, scale, noise, seed, cfg,
                                noise_mode, offs)
    LAUNCHES["pulse_update" if cfg.update_mode == "pulse_train"
             else "outer_update"] += 1
    return out


# --------------------------------------------------------------------------
# Dispatch
# --------------------------------------------------------------------------

def _resolve_impl(impl: Optional[str], g: Tensor) -> str:
    if impl not in (None, *UPDATE_IMPLS):
        raise ValueError(f"impl must be one of {UPDATE_IMPLS}, got {impl!r}")
    if impl in (None, "auto"):
        return "cuda" if g.is_cuda else "eager"
    if impl == "eager" and g.is_cuda:
        raise ValueError("impl='eager' on a CUDA tensor: tensors on the card "
                         "are written by the CUDA kernel")
    if impl == "cuda" and not g.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors; a CPU tensor is "
                         "written by the plain version (impl='eager')")
    return impl


def xbar_outer_update(g: Tensor, x_q: Tensor, d_q: Tensor, scale,
                      cfg: CrossbarConfig, *, noise: Optional[Tensor] = None,
                      seed=None, noise_mode: Optional[str] = None,
                      impl: Optional[str] = None, x_scale=None,
                      d_scale=None, tile_offsets=None) -> Tensor:
    """``G <- device(G, scale * sum_t outer(x_q_t, d_q_t))``, layer-batched.

    ``g``: (K, N) or scan-stacked (L, K, N) conductances; ``x_q``: (T, K)
    or (L, T, K) row drives; ``d_q``: (T, N) or (L, T, N) column drives
    (already quantised by the write drivers); ``scale`` folds
    ``-lr * w_scale``, a scalar or (L,).

    ``x_scale``/``d_scale`` (both or neither; each a scalar or (L,))
    state that ``x_q = codes * x_scale`` and ``d_q = codes * d_scale``
    per lead matrix, with the codes inside the coders' levels
    (:func:`update_levels`).  On the card they let the write take the
    tensor-core instance (:func:`update_instance`); the plain version
    ignores them.  A block of a larger container keeps the container's
    scales: a scale recomputed from the block's slice of the tapes would
    give other codes.

    ``tile_offsets``: (layer, row-tile, col-tile) base coordinates of this
    block when it is a shard of a larger container, uint32 words.  They
    shift the counter PRNG's tile streams (:func:`field_normals`), so a
    block written at its offsets gets exactly its slice of the whole
    container's write.  Default (0, 0, 0).

    Write noise: ``seed`` (a uint32) for the counter PRNG
    (``noise_mode="kernel"``), or an N(0, 1) ``noise`` field of ``g``'s
    shape (``noise_mode="host"``); ``noise_mode`` defaults as in the
    reference (``"none"`` for a noiseless device).  The write mode is
    ``cfg.update_mode``: ``"outer"`` or ``"pulse_train"``.  Returns new
    conductances in ``g.dtype``.
    """
    if cfg.update_mode not in UPDATE_MODES:
        raise ValueError(f"update_mode must be one of {UPDATE_MODES}, got "
                         f"{cfg.update_mode!r}")
    dev = cfg.device
    impl = _resolve_impl(impl, g)
    if noise_mode is None:
        if dev.write_noise <= 0.0:
            noise_mode = "none"
        elif noise is not None:
            noise_mode = "host"
        elif seed is not None:
            noise_mode = "kernel"
        else:
            raise ValueError(
                "stochastic device model requires a noise field "
                "(noise_mode='host') or a scalar seed (noise_mode='kernel')")
    if noise_mode not in NOISE_MODES:
        raise ValueError(f"noise_mode must be one of {NOISE_MODES}")
    if noise_mode == "host" and noise is None:
        raise ValueError("noise_mode='host' requires a noise field")
    if noise_mode == "kernel" and seed is None:
        raise ValueError("noise_mode='kernel' requires a scalar seed")
    if noise_mode != "host":
        noise = None
    seed = int(seed) & _M32 if noise_mode == "kernel" else None

    if (x_scale is None) != (d_scale is None):
        raise ValueError("x_scale and d_scale come together")

    squeeze = g.ndim == 2
    in_dtype = g.dtype
    if squeeze:
        g, x_q, d_q = g[None], x_q[None], d_q[None]
        noise = noise[None] if noise is not None else None
    lyr = g.shape[0]
    g = g.float().contiguous()
    x_q = x_q.float().contiguous()
    d_q = d_q.float().contiguous()
    noise = noise.float().contiguous() if noise is not None else None

    scale = torch.broadcast_to(torch.as_tensor(
        scale, dtype=torch.float32, device=g.device).reshape(-1),
        (lyr,)).contiguous()

    def code_scale(v, name):
        v = torch.as_tensor(v, dtype=torch.float32, device=g.device)
        if v.ndim > 1 or v.numel() not in (1, lyr):
            raise ValueError(f"{name} must be a scalar or ({lyr},), got "
                             f"shape {tuple(v.shape)}")
        return torch.broadcast_to(v.reshape(-1), (lyr,)).contiguous()
    if x_scale is not None:
        x_scale = code_scale(x_scale, "x_scale")
        d_scale = code_scale(d_scale, "d_scale")
    offs = tuple(int(o) & _M32 for o in (tile_offsets or (0, 0, 0)))
    if len(offs) != 3:
        raise ValueError(f"tile_offsets must be (layer, row-tile, col-tile), "
                         f"got {tile_offsets!r}")
    if impl == "cuda":
        out = _update_cuda(g, x_q, d_q, scale, noise, seed, cfg, noise_mode,
                           x_scale, d_scale, offs)
    else:
        out = _update_plain(g, x_q, d_q, scale, noise, seed, cfg, noise_mode,
                            offs)
    return (out[0] if squeeze else out).to(in_dtype)


# --------------------------------------------------------------------------
# The write of one rank's block of a sharded container
# --------------------------------------------------------------------------

def xbar_sharded_update(g: Tensor, x_q: Tensor, d_q: Tensor, scale,
                        cfg: CrossbarConfig, mesh, spec, *, seed=None,
                        noise_mode: Optional[str] = None, x_scale=None,
                        d_scale=None) -> Tensor:
    """The layer-batched write of this rank's block of a container tiled
    over ``mesh`` (port of the reference's ``xbar_sharded_update``; one
    process per rank, so the block is this process's own).

    ``g``: this rank's (L_loc, K_loc, N_loc) block (or (K_loc, N_loc)) of
    an (L, K, N) container laid out by ``spec`` (per dim ``None`` or the
    mesh axes it splits over: ``launch.sharding``); ``scale``: the
    block's (L_loc,) scales.  ``x_q`` (L, T, K), ``d_q`` (L, T, N) and the
    code scales (L,) are the whole container's, replicated.  They are cut
    to the block, whose write runs over the full token batch with the
    container's code scales, its tiles' noise drawn at their global
    (layer, row-tile, col-tile) coordinates: the block is bit-equal to its
    slice of the whole write on any mesh.  The block's coordinates come
    from ``mesh.coords`` (row-major over each dim's axes)."""
    squeeze = g.ndim == 2
    if squeeze:
        g, x_q, d_q = g[None], x_q[None], d_q[None]
        spec = (None, *spec)
    l_loc, k_loc, n_loc = g.shape

    def start(d, size):
        names = spec[d] if d < len(spec) else None
        return flat_index(mesh.shape, mesh.coords, names) * size \
            if names else 0
    l0, k0, n0 = start(0, l_loc), start(1, k_loc), start(2, n_loc)
    lyr = slice(l0, l0 + l_loc)
    x_q = x_q[lyr, :, k0:k0 + k_loc]
    d_q = d_q[lyr, :, n0:n0 + n_loc]
    if x_scale is not None:
        x_scale = torch.as_tensor(x_scale).reshape(-1)
        d_scale = torch.as_tensor(d_scale).reshape(-1)
        x_scale = x_scale[lyr] if x_scale.numel() > 1 else x_scale
        d_scale = d_scale[lyr] if d_scale.numel() > 1 else d_scale
    out = xbar_outer_update(g, x_q, d_q, scale, cfg, seed=seed,
                            noise_mode=noise_mode, x_scale=x_scale,
                            d_scale=d_scale,
                            tile_offsets=(l0, k0 // cfg.rows,
                                          n0 // cfg.cols))
    return out[0] if squeeze else out
