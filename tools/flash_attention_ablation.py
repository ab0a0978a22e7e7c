"""Where flash attention's device time goes: the kernel of
``src/repro_torch/kernels/csrc/flash_attention.cu`` timed whole and with
parts of its key-block loop cut out, beside scaled_dot_product_attention,
on one CUDA card.

Variants, each built from a copy of the source with one span of the loop
body removed (the spans are found by the source's own comments, and the
script stops if one is missing):

* ``full``        the kernel as shipped;
* ``no_softmax``  scale, mask and online softmax removed: P is the raw
                  score fragment;
* ``no_pv``       the ``O += P V`` products removed;
* ``loads_only``  the whole block body removed: the cp.async copies of K
                  and V, the barriers and the epilogue remain.

The cut kernels compute nothing useful; only their times are read.  Each
case reports the device time per call by torch.profiler (CUDA events if
the profiler records no kernel) with the calls back to back, and with
each call isolated (the card idle between calls, as when the host's
launch cost separates them), the mma.sync instructions the full
kernel issues and the rate that makes, the bytes of K and V its CTAs
copy (every CTA copies each key block it walks) and the rate the
``loads_only`` variant copies them at, and sdpa's time and kernel names.
Before each case the card runs half a second of matrix products, so
that its clocks are up when the timing starts.

Run from the repository root on a machine with the CUDA toolkit:

    python3 tools/flash_attention_ablation.py

It prints one line per case and variant and writes
``chiprun_out/flash_attention_ablation.json``.
"""
from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _nvcc  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402

BF16_FLOPS = 989e12    # H100 SXM data sheet, dense bf16 tensor cores
TF32_FLOPS = 495e12    # H100 SXM data sheet, dense TF32 tensor cores

MARK_QK = "    // S = Q K^T\n"
MARK_SOFTMAX = ("    // scale, mask, online softmax (rows gq and gq + 8 of "
                "the warp)\n")
MARK_PV = "    // O += P V\n"
MARK_END = ("    __syncthreads();  // this stage is refilled by the next "
            "prefetch\n")
CUTS = {"full": None, "no_softmax": (MARK_SOFTMAX, MARK_PV),
        "no_pv": (MARK_PV, MARK_END), "loads_only": (MARK_QK, MARK_END)}

# name, B, S, H, KVH, hd: the registry's causal attention shapes at S = 2048
CASES = [("lm100m", 1, 2048, 12, 12, 64),
         ("starcoder2-3b", 1, 2048, 24, 2, 128)]
BQ = 64   # kBQ of the source


def cut_source(text, span):
    """``text`` without the lines from ``span[0]`` up to ``span[1]``."""
    if span is None:
        return text
    start, end = span
    if text.count(start) != 1 or text.count(end) != 1:
        raise SystemExit(f"marker {start.strip()!r} or {end.strip()!r} is "
                         "not in the source once: update CUTS")
    i, j = text.index(start), text.index(end)
    return text[:i] + text[j:]


def build_variants():
    out_dir = _nvcc.BUILD_DIR / "flash_ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = FA.SOURCE.read_text()
    sources = {}
    for name, span in CUTS.items():
        src = out_dir / f"flash_attention_{name}.cu"
        src.write_text(cut_source(text, span))
        sources[name] = src
    libs = _nvcc.build(sources.values())
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    loaded = {}
    for name, src in sources.items():
        lib = ctypes.CDLL(str(libs[src]))
        lib.flash_attention_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                                            i, f, p]
        lib.flash_attention_fwd.restype = ctypes.c_int
        loaded[name] = lib
    return loaded


def launcher(lib, q, k, v, causal):
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s,
            k.shape[1], h, kvh, hd, int(causal),
            int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(hd), stream)

    def run():
        err = lib.flash_attention_fwd(*args)
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")
    return run


def events_ms(fn, n_iter):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_iter):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n_iter


def profiled(fn, n_iter, isolated=False):
    """Device time per call of every kernel ``fn`` launches (ms), by
    torch.profiler, the kernels' names and the kernel events recorded;
    (None, names, 0) if it recorded no device time.  Each kernel's time is
    its mean event time times its launches per call, ceil(count / n_iter):
    the profiler drops a kernel event now and then.  The calls run back to
    back, or with ``isolated`` each after the card has finished the one
    before."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n_iter):
            fn()
            if isolated:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
    total, names, recorded = 0.0, [], 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU or not e.count:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            total += us / e.count * math.ceil(e.count / n_iter)
            names.append(e.key[:120])
            recorded += e.count
    return (total / 1e3 if total > 0 else None), names, recorded


def warm_up(seconds=0.5):
    """Keep the card busy for ``seconds`` so its clocks are up."""
    a = torch.randn((4096, 4096), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(10):
            a = torch.tanh(a @ a)
        torch.cuda.synchronize()


def mma_work(b, s, h, hd, dtype):
    """mma.sync instructions the full kernel issues in a causal call at
    sequence length ``s``, their flops (diagonal blocks' masked products
    included) and the bytes of K and V its CTAs copy."""
    kb = 32 if hd == 256 else 64
    pairs = 0   # (query block, key block) pairs the CTAs walk
    for qb in range(s // BQ):
        pairs += (min(s, (qb + 1) * BQ) + kb - 1) // kb
    per_pair_flops = 2 * (2 * BQ * kb * hd)     # Q K^T and P V
    if dtype == torch.bfloat16:
        per_mma, factor = 2 * 16 * 8 * 16, 1    # m16n8k16
    else:
        per_mma, factor = 2 * 16 * 8 * 8, 3     # m16n8k8, three products
    flops = b * h * pairs * per_pair_flops
    kv_bytes = b * h * pairs * 2 * kb * hd * (2 if dtype == torch.bfloat16
                                              else 4)
    return {"block_pairs": b * h * pairs, "mma": factor * flops // per_mma,
            "mma_flops": factor * flops, "kv_copy_bytes": kv_bytes}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    libs = build_variants()
    F = torch.nn.functional
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    rows = []
    for name, b, s, h, kvh, hd in CASES:
        base = [torch.randn(shape, generator=gen, device="cuda")
                for shape in ((b, s, h, hd), (b, s, kvh, hd),
                              (b, s, kvh, hd))]
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (t.to(dtype) for t in base)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            row = {"case": name, "dtype": str(dtype).replace("torch.", ""),
                   "B": b, "S": s, "H": h, "KVH": kvh, "hd": hd,
                   **mma_work(b, s, h, hd, dtype)}
            warm_up()
            for variant, lib in libs.items():
                fn = launcher(lib, q, k, v, True)
                ms, _, row[f"{variant}_recorded_of_50"] = profiled(fn, 50)
                row[f"{variant}_events_ms"] = events_ms(fn, 50)
                row[f"{variant}_ms"] = ms if ms is not None \
                    else row[f"{variant}_events_ms"]
                row[f"{variant}_isolated_ms"] = profiled(fn, 50, True)[0]
                # ten calls, as chip_smoke.py's phase 11 times them
                _, _, row[f"{variant}_recorded_of_10"] = profiled(fn, 10)
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=True, enable_gqa=True)
            ms, names, _ = profiled(sdpa, 50)
            row["sdpa_events_ms"] = events_ms(sdpa, 50)
            row["sdpa_ms"] = ms if ms is not None else row["sdpa_events_ms"]
            row["sdpa_kernels"] = names
            row["sdpa_isolated_ms"] = profiled(sdpa, 50, True)[0]
            rate = BF16_FLOPS if dtype == torch.bfloat16 else TF32_FLOPS
            row["mma_tflops"] = row["mma_flops"] / row["full_ms"] / 1e9
            row["mma_peak_share"] = row["mma_tflops"] * 1e12 / rate
            row["softmax_ms"] = row["full_ms"] - row["no_softmax_ms"]
            row["pv_ms"] = row["full_ms"] - row["no_pv_ms"]
            row["loads_only_tb_per_s"] = (row["kv_copy_bytes"]
                                          / row["loads_only_ms"] / 1e9)
            rows.append(row)
            print(f"{name} {row['dtype']}: full {row['full_ms']:.4f} ms, "
                  f"no softmax {row['no_softmax_ms']:.4f}, no P.V "
                  f"{row['no_pv_ms']:.4f}, loads only "
                  f"{row['loads_only_ms']:.4f} ({row['kv_copy_bytes']} B of "
                  f"K/V at {row['loads_only_tb_per_s']:.2f} TB/s), sdpa "
                  f"{row['sdpa_ms']:.4f} "
                  f"({', '.join(names)}); {row['mma']} mma.sync at "
                  f"{row['mma_tflops']:.1f} TFLOP/s "
                  f"({100 * row['mma_peak_share']:.1f}% of peak); "
                  f"isolated calls: " + ", ".join(
                      f"{v} {row[f'{v}_isolated_ms']}"
                      for v in (*CUTS, "sdpa"))
                  + "; kernel events recorded of 50 and of 10 calls: "
                  + ", ".join(f"{v} {row[f'{v}_recorded_of_50']}/"
                              f"{row[f'{v}_recorded_of_10']}" for v in CUTS))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "flash_attention_ablation.json").write_text(json.dumps(
        {"card": smi, "rows": rows}, indent=1))


if __name__ == "__main__":
    main()
