#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Builds the fused analog read kernel (``src/repro_torch/kernels/csrc/
xbar_vmm.cu``) with nvcc, then runs four phases and exits non-zero if
any of the first three fails:

1. kernel vs plain version on the card, at the shapes of lm100m's four
   crossbar containers (64x64 tiles) at decode (B=4) and prefill-chunk
   (B=16) batch sizes, plus a ragged case, a 128x128-tile case and a
   large-batch case that takes the kernel's scratch path.  Two parity
   classes:
     * fixed ADC range with a power-of-two lsb on conductances on the
       device's 1/256 pulse grid: every tile charge is an exact float32
       sum, so the kernel must be bit-equal to the plain version;
     * dynamic ADC range on arbitrary conductances (the serving path's
       class): the tile charges are float32 sums taken in another order,
       so an ADC code may flip by one level where a charge sits within
       rounding of a code boundary.  Every element must lie within one
       lsb per K tile (times the output scale) of the plain version, and
       fewer than 1% of the elements may differ by more than 1e-5
       relative.
   Full-width cases are timed (kernel device time from torch.profiler,
   or back-to-back CUDA-event time where the profiler records no kernel;
   conductances cycled through copies so each read misses L2) against
   their byte bound.
2. lm100m at full width served from programmed TaOx crossbars (random
   weights from torch.Generator seed 0) by the continuous scheduler: 4
   slots, prefill chunk 16, 4 prompts of 8-16 tokens, 32 greedy tokens.
   The read count must be 48 (4 containers x 12 layers) per model call;
   each read launches the tile kernel and the kernel that sums the tile
   partials in K order.  One digital-backend request follows.
3. the same weights and tokens on the card and on the CPU (the plain
   version): prefill logits and 4 decode steps fed the card's greedy
   tokens.  Gates: every read of the card's run against the plain version
   on the CPU fed the card's own read operands, with phase 1's bound (a
   read that skipped the ADC would be off by up to half an lsb per tile
   on nearly every element, far above the 1% share); the card's logits
   against the CPU's with the card's read results replayed into the CPU
   run, within 1e-3 (only float32 rounding of attention, norms, embedding
   and logits remains); and, as a gross check only, the free-running CPU
   within twice the analog read's own error (analog vs float32 digital
   logits): there, 8-bit ADC codes that flip at a rounding boundary
   cascade through the layers.
4. a torch.profiler trace of 4 decode steps, reported only.

The second-to-last line is a JSON object with each kernel's launches,
error and times; the last is ``{"ok": true, "device": {...}}``.  Details
go to ``chiprun_out/chip_smoke.json``.
"""
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_FLOPS = 67e12            # H100 SXM data sheet, FP32 outside tensor cores
L2_BYTES = 50e6


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def kernel_us(prof):
    """Device time, in µs, of the kernels a torch.profiler run recorded
    (kernel events only: an operator's own device time repeats its
    kernels')."""
    from torch.autograd import DeviceType
    return sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
               for e in prof.key_averages()
               if e.device_type != DeviceType.CPU)


def device_ms(fn, n_iter):
    """Kernel time per call of ``fn`` on the card, from torch.profiler
    (the launches' host overhead is left out); None if the profiler
    recorded no kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n_iter):
            fn(i)
        torch.cuda.synchronize()
    us = kernel_us(prof)
    return us / n_iter / 1e3 if us > 0 else None


def profiler_warmup():
    """A first, discarded profiler session: a short first session can come
    back without device events while the tracer starts up."""
    from torch.profiler import ProfilerActivity, profile
    a = torch.randn((1024, 1024), device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(100):
            a = torch.tanh(a @ a)
        torch.cuda.synchronize()


def cuda_ms(fn, n_iter, sync):
    fn(0)
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n_iter):
        fn(i)
    end.record()
    sync()
    return start.elapsed_time(end) / n_iter


def make_operands(k, n, b, gen, grid, device):
    """Conductances programmed from normal weights (window [0, 1], reference
    at the midpoint), on the 1/256 pulse grid when ``grid``."""
    w = torch.randn((k, n), generator=gen, device=device) / math.sqrt(k)
    w_max = w.abs().amax()
    g = 0.5 + w * (0.5 / w_max)
    if grid:
        g = torch.round(g * 256.0) / 256.0
    ref = torch.full_like(g, 0.5)
    x = torch.randn((1, b, k), generator=gen, device=device)
    return x, g[None].contiguous(), ref[None].contiguous(), (0.5 / w_max)[None]


def tile_lsb(x, g, ref, sc, cfg):
    """Per-(K tile, N tile) ADC lsb of the read, from the plain pieces."""
    from repro_torch.core.adc import _clip, _round, integrator_saturation
    lv = float(cfg.adc.in_levels)
    xi = _clip(_round(x / sc[:, 0, None, None]), -lv, lv)[0]
    k, n = g.shape[-2:]
    diff = torch.nn.functional.pad(g[0] - ref[0], (0, (-n) % cfg.cols,
                                                   0, (-k) % cfg.rows))
    xi = torch.nn.functional.pad(xi, (0, diff.shape[0] - k))
    tk, tn = diff.shape[0] // cfg.rows, diff.shape[1] // cfg.cols
    q = torch.einsum("btr,trnc->btnc", xi.reshape(-1, tk, cfg.rows),
                     diff.reshape(tk, cfg.rows, tn, cfg.cols))
    _, sat = integrator_saturation(q, cfg.adc, cfg.rows, cfg.device.gmax,
                                   reduce_axes=(0, 3))
    return sat[0, :, :, 0] / cfg.adc.out_levels          # (tk, tn)


def phase_kernel(K, cfg_of, report):
    """Kernel vs plain version at the slice's shapes; returns the rows."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    full = [(768, 2304), (768, 768), (768, 6144), (3072, 768)]
    cases = [(k, n, b, 64, True) for b in (4, 16) for k, n in full]
    cases += [(200, 72, 37, 64, False), (768, 2304, 16, 128, False),
              (768, 768, 384, 128, False)]
    rows = []
    for k, n, b, tile, timed in cases:
        for cls in ("pow2", "dynamic"):
            cfg = cfg_of(tile, cls)
            x, g, ref, ws = make_operands(k, n, b, gen, cls == "pow2", dev)
            sc = K.read_scales(x, ws, cfg.adc.in_levels)
            y_k = K._read_cuda(x, g, ref, sc, cfg)
            torch.cuda.synchronize()
            y_p = K._read_plain(x, g, ref, sc, cfg)
            err = (y_k - y_p).abs()
            row = {"K": k, "N": n, "B": b, "tile": tile, "class": cls,
                   "max_abs_err": err.max().item()}
            if cls == "pow2":
                ok = torch.equal(y_k, y_p)
            else:
                lsb = tile_lsb(x, g, ref, sc, cfg)            # (tk, tn)
                per_col = lsb.sum(0).repeat_interleave(tile)[:n]
                bound = per_col * sc[0, 1].abs() + 1e-5 * y_p.abs()
                share = (err > 1e-5 * y_p.abs().amax()).float().mean().item()
                row["flip_share"] = share
                ok = bool((err <= bound).all()) and share < 0.01
            row["ok"] = ok
            if timed and cls == "dynamic":
                row.update(time_read(K, x, g, ref, sc, cfg))
            rows.append(row)
            report(row)
            if not ok:
                fail(f"kernel disagrees with its plain version: {row}")
    return rows


def time_read(K, x, g, ref, sc, cfg):
    """CUDA-event times of the kernel and the plain version, cycling over
    copies of the conductances so each launch finds them out of L2."""
    b, k = x.shape[1:]
    n = g.shape[2]
    pair = 2 * g.numel() * 4
    copies = max(2, min(64, math.ceil(3 * L2_BYTES / pair)))
    gs = [g.clone() for _ in range(copies)]
    rs = [ref.clone() for _ in range(copies)]
    sync = torch.cuda.synchronize
    iters = max(50, copies)
    def kern(i):
        return K._read_cuda(x, gs[i % copies], rs[i % copies], sc, cfg)

    def plain(i):
        return K._read_plain(x, gs[i % copies], rs[i % copies], sc, cfg)
    launch_ms = cuda_ms(kern, iters, sync)
    ms, plain_ms = device_ms(kern, iters), device_ms(plain, iters)
    timing = "profiler"
    if ms is None or plain_ms is None:  # host-bound event times instead
        ms, plain_ms = launch_ms, cuda_ms(plain, iters, sync)
        timing = "events"
    n_bytes = 4 * (b * k + 2 * k * n + 2 + b * n)
    flops = 2 * b * k * n
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    bound_ms = 1e3 * max(t_bytes, t_ops)
    return {"ms": ms, "plain_ms": plain_ms, "launch_ms": launch_ms,
            "timing": timing,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_share": bound_ms / ms}


def phase_serve(M, K, make_engine, SamplingParams, acfg, dcfg,
                report):
    """lm100m at full width from programmed crossbars, continuous batching."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = M.init_params(dcfg.replace(dtype="float32"), gen, device="cuda")
    aparams = M.program_digital(params, acfg)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, acfg.vocab,
                                             rng.integers(8, 17))]
               for _ in range(4)]
    engine = make_engine(acfg, aparams, backend="analog", n_slots=4,
                         prefill_chunk=16, max_len=64)
    engine.generate(prompts[:1], SamplingParams(max_new_tokens=2))  # warm-up
    torch.cuda.synchronize()
    sp = SamplingParams(max_new_tokens=32)
    stream = engine.stream
    for name in K.LAUNCHES:
        K.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    outs = engine.generate(prompts, sp)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = K.LAUNCHES["fused_vmm"]
    reduces = K.LAUNCHES["reduce_tiles"]
    m = stream.metrics
    calls = m["prefill_chunks"] + m["decode_steps"]
    n_tok = sum(len(o) for o in outs)
    res = {"tokens": n_tok, "seconds": dt, "tokens_per_s": n_tok / dt,
           "model_calls": calls, "prefill_chunks": m["prefill_chunks"],
           "decode_steps": m["decode_steps"], "launches": launches,
           "reduce_launches": reduces,
           "prompt_lens": [len(p) for p in prompts]}
    report(res)
    print(f"analog serving: {n_tok} tokens in {dt:.3f} s = "
          f"{n_tok / dt:.1f} tokens/s ({calls} model calls, {launches} "
          f"fused reads = {launches} tile-kernel + {reduces} K-order-sum "
          f"launches)")
    per_call = 4 * acfg.n_layers      # wqkv, wo, w_upgate, w_down per layer
    # every lm100m read spans several 64-row K tiles, so each read also
    # launches the K-order sum
    if launches != per_call * calls or reduces != launches or calls == 0:
        fail(f"fused read launched {launches} tile and {reduces} sum "
             f"kernels for {calls} model calls; expected "
             f"{per_call * calls} of each")
    if [len(o) for o in outs] != [32] * 4 or \
            not all(0 <= t < acfg.vocab for o in outs for t in o):
        fail(f"bad analog outputs {outs}")
    dengine = make_engine(dcfg, params, backend="digital", n_slots=1,
                          prefill_chunk=16, max_len=64)
    before = dict(K.LAUNCHES)
    dout = dengine.generate(prompts[:1], SamplingParams(max_new_tokens=8))
    if len(dout[0]) != 8 or K.LAUNCHES != before:
        fail(f"digital request: {dout}, launches moved from {before} to "
             f"{K.LAUNCHES}")
    print(f"digital request: {dout[0]}")
    return params, aparams, prompts, res


def run_steps(M, params, cfg, toks, next_toks):
    """Prefill logits of ``toks`` and the logits of one decode step per
    entry of ``next_toks``; greedy tokens from the card when
    ``next_toks`` is None."""
    dev = M.params_device(params)
    with torch.no_grad():
        logits, cache = M.prefill(params, {"tokens": toks.to(dev)}, cfg, 32)
        out, fed = [logits.cpu()], []
        for i in range(4):
            tok = logits.argmax(-1) if next_toks is None \
                else next_toks[i].to(dev)
            fed.append(tok.cpu())
            logits, cache = M.decode_step(params, cache, tok, cfg)
            out.append(logits.cpu())
    return out, fed


def max_diff(a, b):
    return max((x - y).abs().max().item() for x, y in zip(a, b))


def check_reads(K, reads):
    """Every read the card ran, held against the plain version on the CPU
    fed the same operands: within one ADC lsb per K tile per element, and
    under 1% of the elements more than 1e-5 relative off (phase 1's
    bound).  A read that skipped the ADC or returned a float product would
    be off by up to half an lsb per tile on nearly every element."""
    host = {}

    def on_cpu(t):
        key = (t.data_ptr(), tuple(t.shape))
        if key not in host:
            host[key] = t.cpu()
        return host[key]

    worst = {"max_abs_err": 0.0, "max_err_over_bound": 0.0,
             "max_flip_share": 0.0}
    for x, g, ref, sc, cfg, y in reads:
        x, g, ref, sc = x.cpu(), on_cpu(g), on_cpu(ref), sc.cpu()
        y_p = K._read_plain(x, g, ref, sc, cfg)
        err = (y.cpu() - y_p).abs()
        lsb = tile_lsb(x, g, ref, sc, cfg)
        per_col = lsb.sum(0).repeat_interleave(cfg.cols)[:g.shape[2]]
        bound = per_col * sc[0, 1].abs() + 1e-5 * y_p.abs()
        share = (err > 1e-5 * y_p.abs().amax()).float().mean().item()
        worst["max_abs_err"] = max(worst["max_abs_err"], err.max().item())
        worst["max_err_over_bound"] = max(worst["max_err_over_bound"],
                                          (err / bound).max().item())
        worst["max_flip_share"] = max(worst["max_flip_share"], share)
        if not (bool((err <= bound).all()) and share < 0.01):
            fail(f"a read of the full-width run disagrees with the plain "
                 f"version on its operands: x {tuple(x.shape)} g "
                 f"{tuple(g.shape)}, max err {err.max().item()}, flip "
                 f"share {share}")
    return worst


def phase_card_vs_cpu(M, K, acfg, params, aparams, report):
    """The same weights and tokens on the card (kernel) and the CPU (plain
    version): prefill of a (4, 12) batch and 4 greedy decode steps.

    Gates: (a) every read of the card's run against the plain version on
    the card's own read operands (``check_reads``); (b) the card's logits
    against the CPU's when the CPU's reads return the card's read results:
    then only the digital ops (attention, norms, embedding, logits) differ,
    by float32 rounding, so the bound is 1e-3; (c) the free-running CPU,
    whose 8-bit ADC codes flip at rounding boundaries and cascade through
    the layers: a gross check only, bound twice the analog read's own
    error (analog vs float32 digital logits), which (a) and (b) make
    tight."""
    def to_cpu(t):
        return {k: to_cpu(v) for k, v in t.items()} if isinstance(t, dict) \
            else t.cpu()
    cpu_params = to_cpu(aparams)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, acfg.vocab, (4, 12)))

    reads, read_cuda, read_plain = [], K._read_cuda, K._read_plain

    def recorded(x, g, ref, sc, cfg):
        y = read_cuda(x, g, ref, sc, cfg)
        reads.append((x.clone(), g, ref, sc.clone(), cfg, y.clone()))
        return y

    K._read_cuda = recorded
    try:
        card, fed = run_steps(M, aparams, acfg, toks, None)
    finally:
        K._read_cuda = read_cuda
    dig, _ = run_steps(M, params, acfg.digital(), toks, fed)
    cpu, _ = run_steps(M, cpu_params, acfg, toks, fed)
    replay = iter(reads)

    def replayed(x, g, ref, sc, cfg):
        y = next(replay)[-1]
        if y.shape != (x.shape[0], x.shape[1], g.shape[2]):
            fail(f"replayed read of shape {tuple(y.shape)} for x "
                 f"{tuple(x.shape)} g {tuple(g.shape)}")
        return y.cpu()

    K._read_plain = replayed
    try:
        forced, _ = run_steps(M, cpu_params, acfg, toks, fed)
    finally:
        K._read_plain = read_plain
    if next(replay, None) is not None:
        fail("the CPU run made fewer reads than the card's")
    worst = check_reads(K, reads)
    gap = max_diff(card, dig)
    res = {"reads_checked": len(reads), **worst,
           "forced_max_abs_logit_diff": max_diff(card, forced),
           "forced_bound": 1e-3,
           "max_abs_logit": max(t.abs().max().item() for t in card),
           "max_abs_logit_diff": max_diff(card, cpu),
           "per_step": [(a - b).abs().max().item()
                        for a, b in zip(card, cpu)],
           "analog_vs_digital": gap, "bound": 2 * gap,
           "greedy_agree": [torch.equal(a.argmax(-1), b.argmax(-1))
                            for a, b in zip(card, cpu)]}
    report(res)
    print(f"card vs CPU: {len(reads)} reads of the run agree with the plain "
          f"version on their operands (max abs err {worst['max_abs_err']:.3g}"
          f", {worst['max_err_over_bound']:.3f} of the one-lsb-per-tile "
          f"bound, flip share at most {worst['max_flip_share']:.2g}); logits "
          f"with the card's reads replayed on the CPU differ by "
          f"{res['forced_max_abs_logit_diff']:.3g} (bound 1e-3, logits up to "
          f"{res['max_abs_logit']:.3g}); free-running CPU max abs logit "
          f"difference {res['max_abs_logit_diff']:.6f} (gross bound "
          f"{2 * gap:.6f} = 2 x analog-vs-digital error); greedy tokens "
          f"agree per step {res['greedy_agree']}")
    if not res["forced_max_abs_logit_diff"] <= 1e-3:
        fail(f"card and CPU logits differ with the reads replayed: {res}")
    if not res["max_abs_logit_diff"] <= 2 * gap:
        fail(f"card and CPU logits differ beyond the bound: {res}")
    return res


def phase_profile(M, acfg, aparams, report):
    """Device time of 4 decode steps (B=4) by kernel, from torch.profiler,
    against the wall time of 4 unprofiled steps just before; reported
    only, it gates nothing."""
    from torch.profiler import ProfilerActivity, profile
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, acfg.vocab, (4, 12))).cuda()
    with torch.no_grad():
        logits, cache = M.prefill(aparams, {"tokens": toks}, acfg, 32)
        tok = logits.argmax(-1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(4):
            logits, cache = M.decode_step(aparams, cache, tok, acfg)
            tok = logits.argmax(-1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(4):
                logits, cache = M.decode_step(aparams, cache, tok, acfg)
                tok = logits.argmax(-1)
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0

    from torch.autograd import DeviceType

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    events = [e for e in prof.key_averages()
              if e.device_type != DeviceType.CPU]
    total = kernel_us(prof)
    read = sum(dev_us(e) for e in events
               if "fused_vmm_tile" in e.key or "reduce_tiles" in e.key)
    top = sorted(events, key=dev_us, reverse=True)[:8]
    res = {"wall_ms_per_step": 1e3 * wall / 4,
           "profiled_wall_ms_per_step": 1e3 * prof_wall / 4,
           "device_ms_per_step": total / 4e3,
           "read_ms_per_step": read / 4e3,
           "idle_share": (1 - total / 1e6 / wall) if total else None,
           "top": [(e.key[:60], dev_us(e) / 4e3, e.count // 4) for e in top]}
    report(res)
    if total:
        prof_ms = res["profiled_wall_ms_per_step"]
        print(f"profile (4 decode steps, B=4): {res['wall_ms_per_step']:.3f} "
              f"ms/step wall unprofiled ({prof_ms:.3f} under the "
              f"profiler), {res['device_ms_per_step']:.3f} "
              f"ms/step device ({res['read_ms_per_step']:.3f} in the fused "
              f"read), device idle {100 * res['idle_share']:.1f}% of the "
              f"unprofiled wall")
    else:
        print("profile: the profiler recorded no device time (not measured)")


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device: torch.cuda.is_available() is false")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"the port's package is missing under {ROOT / 'src'}")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.core import AdcConfig, CrossbarConfig, TAOX_NONOISE
    from repro_torch.kernels import xbar_vmm as K
    from repro_torch.models import model as M
    from repro_torch.serve import SamplingParams, make_engine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr}")
    gpu_line = smi.stdout.strip().splitlines()[0]
    print(gpu_line)
    details = {"gpu": gpu_line, "torch": torch.__version__,
               "cuda": torch.version.cuda, "phases": {}}

    def reporter(name):
        details["phases"].setdefault(name, [])
        return details["phases"][name].append

    t0 = time.perf_counter()
    K.build()
    K._library()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in K.BUILD_LOG.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"built {K.SOURCE.name} in {build_s:.1f} s; " + " | ".join(ptxas))
    details["build"] = {"seconds": build_s, "ptxas": ptxas}

    def cfg_of(tile, cls):
        adc = (AdcConfig(range_mode="fixed", sat_frac=0.03125)
               if cls == "pow2" else AdcConfig(range_mode="dynamic"))
        return CrossbarConfig(rows=tile, cols=tile, adc=adc,
                              device=TAOX_NONOISE)

    profiler_warmup()
    rows = phase_kernel(K, cfg_of, reporter("kernel"))
    for r in rows:
        if "ms" in r:
            print(f"  K={r['K']} N={r['N']} B={r['B']}: kernel {r['ms']:.4f} "
                  f"ms, plain {r['plain_ms']:.4f} ms ({r['timing']}; "
                  f"{r['launch_ms']:.4f} ms per back-to-back launch), byte "
                  f"bound "
                  f"{r['bound_ms']:.4f} ms ({100 * r['bound_share']:.1f}% "
                  f"of bound), max abs err {r['max_abs_err']:.3g}")
    print(f"phase 1: {len(rows)} kernel-vs-plain cases agree")

    acfg = get_config("lm100m").replace(
        dtype="float32", analog=True, analog_mode="device",
        analog_device="taox-nonoise", analog_rows=64, analog_cols=64)
    dcfg = get_config("lm100m")
    params, aparams, prompts, serve = phase_serve(
        M, K, make_engine, SamplingParams, acfg, dcfg,
        reporter("serve"))
    phase_card_vs_cpu(M, K, acfg, params, aparams, reporter("card_cpu"))
    phase_profile(M, acfg, aparams, reporter("profile"))

    decode = [r for r in rows if r.get("B") == 4 and "ms" in r]
    kernel = {
        "name": "xbar_fused_vmm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/xbar_vmm.cu",
        "replaces": "src/repro/kernels/xbar_vmm.py:148",
        "launches": serve["launches"],
        "launches_by_kernel": {"fused_vmm_tile_kernel": serve["launches"],
                               "reduce_tiles_kernel":
                                   serve["reduce_launches"]},
        "max_abs_err": max(r["max_abs_err"] for r in decode),
        "ms": sum(r["ms"] for r in decode),
        "plain_ms": sum(r["plain_ms"] for r in decode),
        "bound_ms": sum(r["bound_ms"] for r in decode),
        "bound_by": "bytes", "library_ms": None}
    details["kernels_line_note"] = (
        "launches counts reads: each read launches the tile kernel and the "
        "K-order sum (launches_by_kernel); "
        "ms, plain_ms and bound_ms sum one lm100m layer's four reads at "
        "decode (B=4, 64x64 tiles); max_abs_err is the largest at those "
        "shapes in the dynamic-range class; no single PyTorch call "
        "computes the fused read, so library_ms is null")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(details, indent=1))
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
