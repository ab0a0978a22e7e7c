"""Layer 2: kernel launch safety (RA2xx; the port's counterpart of
``repro.analysis.pallas_lint``).

The reference evaluates every Pallas ``BlockSpec`` index map over its
whole grid.  A CUDA kernel's grid bookkeeping lives in its host code and
in the kernel's own index arithmetic, where Python cannot read it, so the
checks split in two halves.

On the CPU (:func:`audit_kernels`):

RA203  for every shipped tile geometry, ragged ones included (the
       reference's 40 = 2.5 and 24 = 1.5 tiles of 16), the wrappers'
       padding gives the divisibility their launches assume: the
       write's bf16 code planes (``xbar_update.update_code_dims``) pad to
       whole tensor-core blocks, the plain read's padded conductance
       difference and its partials form to whole tiles (the tile count
       the card's tile sum takes), the fakequant read (at its row pitches
       of 64 and up) and flash attention to the output shapes; each
       evaluated on ``meta`` tensors.
RA204  a numpy twin of ``kernels.xbar_update._tile_seed`` is checked bit
       for bit against it over a grid of inputs; then, per config of
       ``configs.registry.ARCHS`` at the smoke geometry (64x64 tiles),
       every container's (L, tile_k, tile_n) seed blocks are pairwise
       unique and no two containers derive the same base seed
       ``_mix32(seed_base ^ crc32(path))`` (``train.analog_lm.
       container_seed``).

On the card (:func:`audit_launches`, called by ``chip_smoke.py`` phase
25(b)): every kernel's output buffer is allocated through the wrappers'
one hook (``kernels.outputs``) as a NaN sentinel between two guard
regions, and the wrapper launches on ragged shapes (partial tiles in every
tiled dimension) and a full-width one:

RA201  every output element is written (no sentinel left), and two
       launches on the same inputs are bit-equal (no race decides a
       value);
RA202  no guard element changes (no write outside the output).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .findings import Finding

#: Tile geometries the port ships (rows, cols) and the shapes each is
#: audited at: (L, K, N) containers, ragged against the tile.
TILES = (16, 48, 64, 128, 1024)
RAGGED = ((3, 40, 24), (2, 200, 150), (1, 1000, 300))
LM100M = ((12, 768, 2304), (12, 768, 768), (12, 768, 3072), (12, 3072, 768))

#: Elements of each guard region around a kernel's output (1 MiB of
#: float32: a whole row of the widest output past either end).
GUARD = 1 << 18


# --------------------------------------------------------------------------
# RA203: padding
# --------------------------------------------------------------------------

def check_divisible(entry: str, role: str, shape: Sequence[int],
                    block: Sequence[int],
                    cover: Optional[Sequence[int]] = None) -> List[Finding]:
    """RA203 for one padded operand: ``shape`` divides ``block`` dim by
    dim and, with ``cover`` (the unpadded dims), covers them with less
    than one block of padding."""
    for i, (size, blk) in enumerate(zip(shape, block)):
        if blk <= 0 or size % blk:
            return [Finding(
                "RA203", f"{role} shape {tuple(shape)} not divisible by "
                f"block {tuple(block)} (wrapper padding is wrong for this "
                "geometry)", entry=entry)]
        if cover is not None and not (cover[i] <= size < cover[i] + blk):
            return [Finding(
                "RA203", f"{role} shape {tuple(shape)} does not cover "
                f"{tuple(cover)} with less than one block {tuple(block)}",
                entry=entry)]
    return []


def _padding_findings() -> List[Finding]:
    import torch

    from repro_torch.core.adc import AdcConfig
    from repro_torch.core.crossbar import CrossbarConfig, pad_to_tiles
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import xbar_update as U
    from repro_torch.kernels import xbar_vmm as K

    meta = dict(device="meta", dtype=torch.float32)
    out: List[Finding] = []
    for tile in TILES:
        cfg = CrossbarConfig(rows=tile, cols=tile, adc=AdcConfig())
        for lyr, k, n in RAGGED + LM100M:
            entry = f"{tile}x{tile} tiles, (L, K, N) = ({lyr}, {k}, {n})"
            out += check_divisible(
                entry, "padded G - G_ref",
                pad_to_tiles(torch.empty((k, n), **meta), tile, tile).shape,
                (tile, tile), (k, n))
            g = torch.empty((lyr, k, n), **meta)
            sc = torch.empty((lyr, 2), **meta)
            for transpose in (False, True):
                red, res = (n, k) if transpose else (k, n)
                x = torch.empty((lyr, 5, red), **meta)
                part = K._read_plain(x, g, g, sc, cfg, transpose,
                                     partials=True)
                t_r = -(-red // tile)
                if tuple(part.shape) != (lyr, t_r, 5, res):
                    out.append(Finding(
                        "RA203", f"partials form {tuple(part.shape)} is "
                        f"not (L, ceil(reduction / tile), B, out) = "
                        f"{(lyr, t_r, 5, res)} (transpose={transpose})",
                        entry=entry))
            for t in (5, 37, 2048):
                dims = U.update_code_dims(t, k, n)
                out += check_divisible(
                    f"{entry}, T={t}", "write code planes (Tp, Kp, Np)",
                    dims, (U.TC_TOKENS, U.TC_BLOCK, U.TC_BLOCK), (t, k, n))
            for t in ((5, 150) if tile >= 64 else ()):
                y = K._fakequant_plain(torch.empty((t, k), **meta),
                                       torch.empty((k, n), **meta),
                                       torch.empty((1,), **meta),
                                       AdcConfig(), tile)
                if tuple(y.shape) != (t, n):
                    out.append(Finding(
                        "RA203", f"fakequant read gives {tuple(y.shape)}, "
                        f"not (T, N) = {(t, n)}", entry=entry))
    for sq, skv in ((100, 100), (100, 130), (2048, 2048)):
        q = torch.empty((1, sq, 4, 64), **meta)
        kv = torch.empty((1, skv, 2, 64), **meta)
        o = FA.flash_attention(q, kv, kv, causal=sq == skv)
        if tuple(o.shape) != tuple(q.shape):
            out.append(Finding(
                "RA203", f"flash attention gives {tuple(o.shape)} for q "
                f"{tuple(q.shape)}", entry=f"flash_attention[{sq}x{skv}]"))
    return out


# --------------------------------------------------------------------------
# RA204: seed-block uniqueness
# --------------------------------------------------------------------------

def _mix32_np(x: np.ndarray) -> np.ndarray:
    """numpy twin of ``kernels.xbar_update._mix32`` (uint32 wrap-around)."""
    with np.errstate(over="ignore"):
        x = x ^ (x >> np.uint32(16))
        x = (x * np.uint32(0x85EBCA6B)).astype(np.uint32)
        x = x ^ (x >> np.uint32(13))
        x = (x * np.uint32(0xC2B2AE35)).astype(np.uint32)
        return x ^ (x >> np.uint32(16))


def _tile_seed_np(seed, layer, tile_k, tile_n) -> np.ndarray:
    """numpy twin of ``kernels.xbar_update._tile_seed``."""
    with np.errstate(over="ignore"):
        h = _mix32_np(np.uint32(seed) ^ np.uint32(0x9E3779B9))
        h = _mix32_np((h + np.uint32(0x9E3779B1) * layer).astype(np.uint32))
        h = _mix32_np((h + np.uint32(0x85EBCA77) * tile_k).astype(np.uint32))
        h = _mix32_np((h + np.uint32(0xC2B2AE3D) * tile_n).astype(np.uint32))
    return h


#: (seed, layer, tile_k, tile_n) points the twin is held to.
TWIN_POINTS = [(0, 0, 0, 0), (1, 2, 3, 4), (0xDEADBEEF, 7, 31, 255),
               (0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF),
               *[(s, lyr, k, n) for s in (0x12345678, 0x9E3779B9)
                 for lyr in (0, 1, 47, 767) for k in (0, 5, 47)
                 for n in (0, 1, 511)]]


def numpy_twin_matches(tile_seed: Optional[Callable] = None
                       ) -> Optional[Finding]:
    """The numpy twin against the port's ``_tile_seed`` (or
    ``tile_seed``) over :data:`TWIN_POINTS`, bit for bit: else RA204's
    uniqueness proof would be about the wrong hash."""
    if tile_seed is None:
        from repro_torch.kernels.xbar_update import _tile_seed
        tile_seed = _tile_seed
    for s, lyr, k, n in TWIN_POINTS:
        ours = int(_tile_seed_np(np.uint32(s), np.uint32(lyr),
                                 np.uint32(k), np.uint32(n)))
        theirs = int(tile_seed(s, lyr, k, n))
        if ours != theirs:
            return Finding(
                "RA204", f"numpy seed twin diverges from the kernel's "
                f"_tile_seed at {(s, lyr, k, n)}: {ours:#x} != "
                f"{theirs:#x}", entry="seed-twin")
    return None


def check_seed_uniqueness(
        containers: Sequence[Tuple[str, Tuple[int, int, int], int]],
        entry: str = "seed-grid") -> List[Finding]:
    """``containers``: (path, (L_flat, tile_k, tile_n), base_seed) per
    container of one program.  Within each container the per-(layer,
    tile) seeds must be pairwise unique over the whole grid, and no two
    containers may share a base seed."""
    findings: List[Finding] = []
    seen: Dict[int, str] = {}
    for path, (lyr, tk, tn), base in containers:
        prev = seen.get(base)
        if prev is not None:
            findings.append(Finding(
                "RA204", f"containers '{prev}' and '{path}' derive the "
                f"same base seed {base:#010x}: identical noise streams",
                entry=entry))
            continue
        seen[base] = path
        li, ki, ni = np.meshgrid(np.arange(lyr, dtype=np.uint32),
                                 np.arange(tk, dtype=np.uint32),
                                 np.arange(tn, dtype=np.uint32),
                                 indexing="ij")
        seeds = _tile_seed_np(np.uint32(base), li, ki, ni).ravel()
        dup = seeds.size - np.unique(seeds).size
        if dup:
            findings.append(Finding(
                "RA204", f"container '{path}' grid ({lyr},{tk},{tn}) has "
                f"{dup} colliding (layer, tile) seed blocks", entry=entry))
    return findings


def config_seed_entries(tile: int = 64) -> Dict[
        str, List[Tuple[str, Tuple[int, int, int], int]]]:
    """Per shipped config: (path, (L_flat, tile_k, tile_n), base_seed) of
    every container at the smoke geometry, the base seed derived as the
    train step derives it (``container_seed`` with a ``seed_base`` of 0:
    two containers collide here iff their streams collide in the step).
    Grouped by config: only the containers of one program share a seed
    space."""
    from repro_torch.configs.registry import ARCHS, get_config
    from repro_torch.core.analog_registry import container_paths
    from repro_torch.models.model import init_params
    from repro_torch.train.analog_lm import container_seed

    out: Dict[str, List[Tuple[str, Tuple[int, int, int], int]]] = {}
    for arch in ARCHS:
        cfg = get_config(arch, smoke=True).replace(
            dtype="float32", analog=True, analog_mode="device",
            analog_rows=tile, analog_cols=tile)
        params = init_params(cfg, None, device="meta")
        for path in container_paths(params):
            p = params
            for k in path:
                p = p[k]
            shape = p["g"].shape
            out.setdefault(arch, []).append((
                "/".join(path), (math.prod(shape[:-2]), -(-shape[-2] // tile),
                                 -(-shape[-1] // tile)),
                container_seed(0, path)))
    return out


def audit_kernels(root=None) -> List[Finding]:
    """The CPU half of Layer 2: RA203 and RA204."""
    findings = _padding_findings()
    twin = numpy_twin_matches()
    if twin is not None:
        findings.append(twin)
    else:
        for arch, entries in config_seed_entries().items():
            findings += check_seed_uniqueness(entries,
                                              entry=f"seed-grid[{arch}]")
    return findings


# --------------------------------------------------------------------------
# RA201 / RA202: launch coverage on the card
# --------------------------------------------------------------------------

def _guarded(allocs: list, guard: int):
    """An allocation hook (``kernels.outputs``): each output inside one
    buffer, NaN in the output and a fixed value in ``guard`` elements
    before and after it."""
    import torch

    def alloc(shape, dtype, device):
        n = math.prod(shape)
        buf = torch.full((n + 2 * guard,), GUARD_VALUE, dtype=dtype,
                         device=device)
        buf[guard:guard + n] = float("nan")
        allocs.append((buf, n, guard))
        return buf[guard:guard + n].view(shape)
    return alloc


#: What the guard regions hold (exact in float32, float16 and bfloat16).
GUARD_VALUE = -1232.0


def coverage_check(name: str, launch: Callable, guard: int = GUARD
                   ) -> Tuple[List[Finding], dict]:
    """Launch ``launch()`` (a wrapper call returning its output) twice
    with every output it allocates guarded; RA201 if an output element
    keeps the sentinel or the two launches differ in a bit, RA202 if a
    guard element changed.  Returns (findings, row)."""
    import torch

    from repro_torch.kernels import outputs

    runs = []
    for _ in range(2):
        allocs: list = []
        with outputs.allocating_with(_guarded(allocs, guard)):
            launch()
        if any(buf.is_cuda for buf, _, _ in allocs):
            torch.cuda.synchronize()
        runs.append(allocs)
    row = {"case": name, "outputs": len(runs[0]), "unwritten": 0,
           "guard_touched": 0, "bit_equal": True}
    findings: List[Finding] = []
    if not runs[0] or len(runs[0]) != len(runs[1]):
        findings.append(Finding(
            "RA201", f"{len(runs[0])} and {len(runs[1])} outputs allocated "
            "through the hook (the wrapper did not reach its kernel)",
            entry=name))
        row["bit_equal"] = False
        return findings, row
    for (buf, n, g), (buf2, _, _) in zip(*runs):
        body = buf[g:g + n]
        row["unwritten"] += int(torch.isnan(body.float()).sum())
        guards = torch.cat([buf[:g], buf[g + n:]])
        row["guard_touched"] += int((guards != GUARD_VALUE).sum())
        row["bit_equal"] &= torch.equal(body.float(), buf2[g:g + n].float())
    if row["unwritten"]:
        findings.append(Finding(
            "RA201", f"{row['unwritten']} output elements never written "
            "(the NaN sentinel is left)", entry=name))
    if not row["bit_equal"]:
        findings.append(Finding(
            "RA201", "two launches on the same inputs are not bit-equal "
            "(a race decides a value)", entry=name))
    if row["guard_touched"]:
        findings.append(Finding(
            "RA202", f"{row['guard_touched']} guard elements written "
            "(the kernel writes outside its output)", entry=name))
    return findings, row


def coverage_cases(device: str = "cuda", seed: int = 0
                   ) -> List[Tuple[str, str, Callable]]:
    """(kernel, case, launch) for phase 25(b): kernels 1, 2 (both read
    instances, the partials form and the tile sum), 3 and 3p (both write
    instances), 4 (both instances, an expert stack) and 5 (float32 and
    bfloat16), each on ragged shapes (partial tiles in every tiled dim)
    and at lm100m's full width."""
    import torch

    from repro_torch.core import TAOX, AdcConfig, CrossbarConfig
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import xbar_update as U
    from repro_torch.kernels import xbar_vmm as K

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    cases: List[Tuple[str, str, Callable]] = []
    cfg = CrossbarConfig(rows=64, cols=64, adc=AdcConfig(), device=TAOX)
    reads = (("ragged", (3, 200, 150), (5, 37)),
             ("lm100m-wqkv", (12, 768, 2304), (4, 2048)))
    for label, (lyr, k, n), batches in reads:
        g, ref = 0.2 + 0.6 * rand(lyr, k, n), 0.2 + 0.6 * rand(lyr, k, n)
        ws = torch.full((lyr,), 2.0, device=device)
        for transpose, kname in ((False, "xbar_fused_vmm"),
                                 (True, "xbar_fused_mvm")):
            for b in batches:
                x = randn(lyr, b, k if not transpose else n)
                inst = K.read_instance(b, cfg.adc.in_levels)
                cases.append((kname, f"{inst}/{label}/B={b}",
                              lambda x=x, g=g, ref=ref, ws=ws, t=transpose:
                              K.xbar_fused_read(x, g, ref, ws, cfg,
                                                transpose=t, impl="cuda")))
            if label == "ragged":      # the sharded read's partials form
                x = randn(lyr, 5, k if not transpose else n)
                sc = K.read_scales(x, ws, cfg.adc.in_levels)
                cases.append((kname, f"partials+reduce_tiles/{label}/B=5",
                              lambda x=x, sc=sc, g=g, ref=ref, t=transpose:
                              K._reduce_tiles_cuda(K._read_cuda(
                                  x, g, ref, sc, cfg, t, partials=True),
                                  sc, t)))
    lx, ld = U.update_levels(cfg)
    for label, (lyr, k, n), t in (("ragged", (3, 200, 150), 37),
                                  ("lm100m-wqkv", (12, 768, 2304), 2048)):
        g = cfg.device.gmin + (cfg.device.gmax - cfg.device.gmin) \
            * rand(lyr, k, n)
        xs = torch.full((lyr,), 0.01, device=device)
        ds = torch.full((lyr,), 0.02, device=device)
        xq = torch.round((2 * rand(lyr, t, k) - 1) * lx) * xs[:, None, None]
        dq = torch.round((2 * rand(lyr, t, n) - 1) * ld) * ds[:, None, None]
        scale = torch.full((lyr,), -0.05, device=device)
        for mode, kname in (("outer", "xbar_outer_update"),
                            ("pulse_train", "xbar_pulse_update")):
            wcfg = cfg.replace(update_mode=mode)
            for inst, kw in (("tensor_core", dict(x_scale=xs, d_scale=ds)),
                             ("fp32", {})):
                cases.append((kname, f"{inst}/{label}/T={t}",
                              lambda g=g, xq=xq, dq=dq, s=scale, wcfg=wcfg,
                              kw=kw: U.xbar_outer_update(
                                  g, xq, dq, s, wcfg, seed=7, impl="cuda",
                                  **kw)))
    adc = AdcConfig()
    for label, (k, n, rows), ts in (("ragged", (1000, 300, 256), (5, 150)),
                                    ("lm100m-wqkv", (768, 2304, 1024),
                                     (4, 2048))):
        w = 0.05 * randn(k, n)
        for t in ts:
            x = randn(t, k)
            inst = K.fakequant_instance(t, adc.in_levels)
            cases.append(("xbar_fakequant_read", f"{inst}/{label}/T={t}",
                          lambda x=x, w=w, rows=rows:
                          K._fakequant_cuda(x, w, adc, rows)[0]))
    xs3, ws3 = randn(3, 5, 1000), 0.05 * randn(3, 1000, 300)
    cases.append(("xbar_fakequant_read", "fp32/ragged-lead/L=3,T=5",
                  lambda: K._fakequant_cuda(xs3, ws3, adc, 256)[0]))
    for label, (b, sq, skv, h, kvh, hd, causal) in (
            ("ragged-causal", (1, 100, 100, 4, 2, 64, True)),
            ("ragged-full", (1, 100, 130, 4, 2, 64, False)),
            ("lm100m", (1, 2048, 2048, 12, 12, 64, True))):
        for dt in (torch.float32, torch.bfloat16):
            q = randn(b, sq, h, hd, dtype=dt)
            kk, vv = randn(b, skv, kvh, hd, dtype=dt), \
                randn(b, skv, kvh, hd, dtype=dt)
            cases.append(("flash_attention",
                          f"{str(dt).split('.')[-1]}/{label}",
                          lambda q=q, kk=kk, vv=vv, c=causal:
                          FA.flash_attention(q, kk, vv, causal=c)))
    return cases


def audit_launches(cases: Optional[Sequence] = None, guard: int = GUARD
                   ) -> Tuple[List[Finding], List[dict]]:
    """The card half of Layer 2: :func:`coverage_check` over
    :func:`coverage_cases` (or ``cases``).  Returns (findings, one row a
    case)."""
    findings: List[Finding] = []
    rows: List[dict] = []
    for kernel, case, launch in (cases if cases is not None
                                 else coverage_cases()):
        got, row = coverage_check(f"{kernel}[{case}]", launch, guard)
        findings += got
        rows.append({"kernel": kernel, **row})
    return findings, rows
