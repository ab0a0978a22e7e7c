"""Where the fakequant read's tensor-core instance overtakes its FP32 one.

    python3 tools/fakequant_crossover.py [--tree DIR --label NAME]

On one CUDA card, times one lm100m layer's four fakequant reads (1024-row
tiles, 8-bit DAC/ADC, W cycled through copies so each read finds it out
of L2) at T = 4 to 256 tokens: the device time per read from
torch.profiler (every kernel and memset the read issues), and the
back-to-back CUDA-event time (host launch cost included) beside it.

With no ``--tree`` it times this tree's two instances, each forced
through ``_fakequant_cuda``, and reports the crossover: the least timed T
from which the tensor-core layer is faster than the FP32 one at every
timed T, which ``FQ_TC_MIN_TOKENS`` should follow.  With ``--tree DIR``
(another checkout, for example a parent commit unpacked with ``git
archive``) it times that tree's public ``fakequant_read`` instead, with
this tree's timing helpers.  The operands come from a seed and are the
same for every tree.

Writes ``chiprun_out/fakequant_crossover_<label>.json``.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
TOKENS = (4, 16, 17, 32, 48, 64, 96, 128, 144, 160, 176, 192, 224, 256)


def layer_times(CS, fns):
    """``{variant: {T: row}}``: each variant's device and event ms for one
    layer's four reads at each T (and per projection)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    out = {name: {} for name in fns}
    for t in TOKENS:
        for name in fns:
            out[name][t] = {"ms": 0.0, "events_ms": 0.0, "projections": {}}
        for proj, k, n in CS.TRAIN_SHAPES:
            x = torch.randn((t, k), generator=gen, device="cuda")
            w = torch.randn((k, n), generator=gen, device="cuda") \
                / math.sqrt(k)
            copies = max(2, min(64, math.ceil(3 * CS.L2_BYTES
                                              / (4 * w.numel()))))
            ws = [w.clone() for _ in range(copies)]
            iters = max(copies, 30)
            for name, fn in fns.items():
                def run(i, fn=fn):
                    return fn(x, ws[i % copies])
                ms = CS.device_ms(run, iters)
                ev = CS.cuda_ms(run, iters, torch.cuda.synchronize)
                row = out[name][t]
                row["projections"][proj] = {"ms": ms, "events_ms": ev}
                row["ms"] = None if ms is None or row["ms"] is None \
                    else row["ms"] + ms
                row["events_ms"] += ev
    return out


def crossover(fp32, tc):
    """The least timed T from which the tensor-core layer beats the FP32
    one at every timed T (device time, events where the profiler saw
    nothing); None if it never does."""
    def ms(row):
        return row["ms"] if row["ms"] is not None else row["events_ms"]
    best = None
    for t in sorted(fp32, reverse=True):
        if ms(tc[t]) >= ms(fp32[t]):
            break
        best = t
    return best


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=None,
                    help="another checkout whose public fakequant_read to "
                         "time (default: this tree's two instances)")
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as CS
    tree = (args.tree or ROOT).resolve()
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.core.adc import AdcConfig
    from repro_torch.kernels import xbar_vmm as K
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{gpu}; {args.label}: {K.__file__}", flush=True)
    adc = AdcConfig(in_bits=8, out_bits=8)
    if args.tree is None:
        fns = {inst: (lambda x, w, inst=inst:
                      K._fakequant_cuda(x, w, adc, 1024, inst))
               for inst in ("fp32", "tensor_core")}
    else:
        fns = {"read": lambda x, w: K.fakequant_read(x, w, adc, 1024)}
    CS.profiler_warmup()
    times = layer_times(CS, fns)
    res = {"gpu": gpu, "label": args.label, "tree": str(tree),
           "tokens": list(TOKENS), "layer": times}
    for t in TOKENS:
        print(f"T={t}: one layer's four reads, " + ", ".join(
            f"{name} {times[name][t]['ms'] or float('nan'):.4f} ms "
            f"(events {times[name][t]['events_ms']:.4f})" for name in fns),
            flush=True)
    if args.tree is None:
        res["crossover_tokens"] = crossover(times["fp32"],
                                            times["tensor_core"])
        res["FQ_TC_MIN_TOKENS"] = K.FQ_TC_MIN_TOKENS
        print(f"crossover: the tensor-core instance is faster from T = "
              f"{res['crossover_tokens']} (FQ_TC_MIN_TOKENS = "
              f"{K.FQ_TC_MIN_TOKENS})")
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / f"fakequant_crossover_{args.label}.json") \
        .write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
