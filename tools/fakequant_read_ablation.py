"""Where the fakequant read's device time goes, on one CUDA card.

The read of ``src/repro_torch/kernels/csrc/xbar_fakequant.cu`` is timed
whole and with parts cut out, each variant built from a copy of the source
with one substitution (the script stops if a substitution's text is not in
the source once):

* ``full``              the source as shipped;
* ``fp32_no_slice_sum`` the FP32 product without the cluster's slice sum
                        (its cluster barriers remain);
* ``tc_no_products``    the tensor-core product's mma.sync removed: its
                        cp.async ring, barriers and stores remain;
* ``tc_no_ring``        its ring refills removed (products on the first
                        two chunks' data): products, barriers, stores;
* ``prepare_no_barrier`` the tensor-core pre-pass's grid barrier replaced
                        by a CTA barrier.

Each variant reads lm100m's four projections (1024-row tiles, 8-bit
DAC/ADC) at T = 4 on the FP32 instance and at T = 2048 on the tensor-core
instance, each kernel's device time from torch.profiler.  The cut variants
compute nothing useful; only their times are read.

Run from the repository root on a machine with the CUDA toolkit:

    python3 tools/fakequant_read_ablation.py

It prints one line per variant and case and writes
``chiprun_out/fakequant_read_ablation.json``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402
from repro_torch.core.adc import AdcConfig  # noqa: E402
from repro_torch.kernels import _nvcc  # noqa: E402
from repro_torch.kernels import xbar_vmm as K  # noqa: E402

VARIANTS = {
    "full": (),
    "fp32_no_slice_sum": (("  if (sl == 0) {", "  if (false) {"),),
    "tc_no_products": (("    mma_chunk<BM>(ring + (s % kStages) * "
                        "Cta<BM>::kStage, acc);", ""),),
    "tc_no_ring": (("      load_stage<BM>(a, i, ahead * kTcKC, b0, c0,\n"
                    "                     ring + (ahead % kStages) * "
                    "Cta<BM>::kStage);", ""),),
    "prepare_no_barrier": (("  grid_barrier(a.bar);",
                            "  __syncthreads();"),),
}
KERNELS = ("fakequant_scale", "fakequant_prepare", "fakequant_fp32",
           "fakequant_tc", "fakequant_epilogue")


def variant_sources():
    """One source file per variant, built together (one nvcc each)."""
    text = K.FAKEQUANT_SOURCE.read_text()
    out = ROOT / "build" / "fakequant_read_ablation"
    paths = {}
    for name, subs in VARIANTS.items():
        src = text
        for old, new in subs:
            if src.count(old) != 1:
                raise SystemExit(f"{name}: {old.strip()[:50]!r} is not in "
                                 "the source once: update VARIANTS")
            src = src.replace(old, new)
        (out / name).mkdir(parents=True, exist_ok=True)
        paths[name] = out / name / "xbar_fakequant.cu"
        paths[name].write_text(src)
    _nvcc.build(paths.values())
    return paths


def time_variant(source, gen, adc):
    """Per-kernel device ms of each case on the variant's library."""
    K.FAKEQUANT_SOURCE, K._fq_lib = source, None
    K._fq_dev.clear()
    rows = []
    for t, instance in ((4, "fp32"), (2048, "tensor_core")):
        for name, k, n in CS.TRAIN_SHAPES:
            x = torch.randn((t, k), generator=gen, device="cuda")
            w = torch.randn((k, n), generator=gen, device="cuda") \
                / math.sqrt(k)
            copies = max(2, min(64, math.ceil(3 * CS.L2_BYTES
                                              / (4 * w.numel()))))
            ws = [w.clone() for _ in range(copies)]

            def run(i):
                return K._fakequant_cuda(x, ws[i % copies], adc, 1024,
                                         instance)
            ms, parts = CS.device_ms(run, max(copies, 50 if t == 4 else 5),
                                     KERNELS)
            rows.append({"projection": name, "T": t, "instance": instance,
                         "ms": ms, **{f"{k2[10:]}_ms": v
                                      for k2, v in parts.items() if v}})
    return rows


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(gpu)
    paths = variant_sources()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    adc = AdcConfig(in_bits=8, out_bits=8)
    CS.profiler_warmup()
    out = {"gpu": gpu, "variants": {}}
    for name, path in paths.items():
        rows = time_variant(path, gen, adc)
        out["variants"][name] = rows
        for t in (4, 2048):
            sel = [r for r in rows if r["T"] == t]
            parts = {key: sum(r.get(key, 0.0) for r in sel)
                     for key in sel[0] if key.endswith("_ms")}
            print(f"{name} T={t} ({sel[0]['instance']}), one layer: " +
                  ", ".join(f"{key[:-3]} {v * 1e3:.1f} us"
                            for key, v in parts.items()), flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "fakequant_read_ablation.json").write_text(
        json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
