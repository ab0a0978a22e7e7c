"""Where the tensor-core rank-k write's device time goes, and which cells
its float class lets differ from the plain version, on one CUDA card.

Part 1, the time.  The write kernel of
``src/repro_torch/kernels/csrc/xbar_update.cu`` (``tc_update_kernel``) is
timed whole and with parts cut out, each variant built from a copy of the
source with one substitution (the script stops if a substitution's text
is not in the source once):

* ``full``         the kernel as shipped;
* ``no_noise``     the counter-PRNG draw removed (z = 0);
* ``no_epilogue``  the device epilogue replaced by a store of the scaled
                   sums: the staging loads, the products and the sums'
                   trip through shared memory remain;
* ``loads_only``   also the products removed: the cp.async ring, its
                   barriers and the stores remain.

Each variant runs the write from the same pre-pass planes, at lm100m's
w_upgate and wqkv containers (12 layers, T = 2048, 64x64 tiles, TaOx,
counter-PRNG noise), in both update modes, timed by CUDA events over 10
back-to-back calls.  The cut kernels compute nothing useful; only their
times are read.

Part 2, the sum-rounding ties.  One outer write of wqkv in lm100m's
regime (codes times scales 3/127 and 2e-4/7, as chip_smoke's phase 6(b))
on the tensor-core instance against the plain version: the cells where
they differ by more than ``chip_smoke.update_bound``, the exact integer
code sums at those cells, and how far each accumulate is from the
float64 sum of x_q d_q, as a share of the float32 summation error bound
T u sum|x_q d_q|.

Run from the repository root on a machine with the CUDA toolkit:

    python3 tools/update_write_ablation.py

It prints one line per case and writes
``chiprun_out/update_write_ablation.json``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402
from repro_torch.core import TAOX, CrossbarConfig  # noqa: E402
from repro_torch.kernels import _nvcc  # noqa: E402
from repro_torch.kernels import xbar_update as U  # noqa: E402

EPILOGUE = ("""      if constexpr (kPulse)
        a.out[off] = pulse_epilogue(a.g[off], av[q], mv[q], sc, z[q], p);
      else
        a.out[off] = epilogue(a.g[off], __fmul_rn(sc, av[q]), z[q], p);""",
            "      a.out[off] = av[q] + mv[q];")
NOISE = ("    if (p.noise_mode == 2) {\n      if (pairs) {",
         "    if (false) {\n      if (pairs) {")
PRODUCTS = ("    tc_mma_stage<kPulse>(ring + (s % kTcStages) * kTcStage, "
            "wm, wn, acc,\n                         mag);", "")
VARIANTS = {"full": (), "no_noise": (NOISE,), "no_epilogue": (EPILOGUE,),
            "loads_only": (EPILOGUE, PRODUCTS)}
CASES = [("w_upgate", 768, 6144), ("wqkv", 768, 2304)]
LAYERS, TOKENS = 12, 2048


def build_variants():
    """One shared library per variant, all nvcc processes at once."""
    text = U.SOURCE.read_text()
    out = ROOT / "build" / "update_write_ablation"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        src = text
        for old, new in subs:
            if src.count(old) != 1:
                raise SystemExit(f"{name}: {old.strip()[:50]!r} is not in "
                                 "the source once: update VARIANTS")
            src = src.replace(old, new)
        cu = out / f"{name}.cu"
        cu.write_text(src)
        procs[name] = subprocess.Popen(
            [_nvcc._nvcc(), *_nvcc.NVCC_FLAGS, "-o", str(out / f"{name}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        lib.xbar_tc_update.argtypes = [i, p, p, p, p, p, p, p, i, i, i, i,
                                       i, i, i, i, i, u, U._DeviceParams, p]
        lib.xbar_tc_update.restype = ctypes.c_int
        libs[name] = lib
    return libs


def time_variants(libs, gen):
    rows = []
    for name, k, n in CASES:
        g, x_q, d_q, scale, xs, ds = CS.update_operands(
            LAYERS, k, n, TOKENS, gen, False)
        tp, kp, np_ = U.update_code_dims(TOKENS, k, n)
        for mode in ("outer", "pulse_train"):
            cfg = CrossbarConfig(rows=64, cols=64, device=TAOX,
                                 update_mode=mode)
            codes = U._update_prepare_cuda(x_q, d_q, xs, ds, cfg)
            out = torch.empty_like(g)
            params = U.device_params(cfg.device, "kernel")
            stream = torch.cuda.current_stream().cuda_stream
            row = {"container": name, "K": k, "N": n, "mode": mode}
            for variant, lib in libs.items():
                def run(i):
                    err = lib.xbar_tc_update(
                        int(mode == "pulse_train"), g.data_ptr(),
                        codes.data_ptr(), scale.data_ptr(), xs.data_ptr(),
                        ds.data_ptr(), None, out.data_ptr(), LAYERS, TOKENS,
                        k, n, tp, kp, np_, 64, 64, 0x9E3779B9, params, stream)
                    if err != 0:
                        raise SystemExit(f"{variant}: CUDA error {err}")
                row[f"{variant}_ms"] = CS.cuda_ms(run, 10,
                                                  torch.cuda.synchronize)
            rows.append(row)
            print(f"{name} (12, {k}, {n}) {mode}: " + ", ".join(
                f"{v} {row[f'{v}_ms']:.3f} ms" for v in VARIANTS),
                flush=True)
    return rows


def sum_rounding_ties(gen):
    """Part 2 at wqkv's shape (see the module docstring)."""
    g, x_q, d_q, scale, xs, ds = CS.update_operands(LAYERS, 768, 2304,
                                                    TOKENS, gen, False)
    cfg = CrossbarConfig(rows=64, cols=64, device=TAOX)
    g_k = U.xbar_outer_update(g, x_q, d_q, scale, cfg, seed=7,
                              noise_mode="kernel", x_scale=xs, d_scale=ds)
    g_p = U._update_plain(g, x_q, d_q, scale, None, 7, cfg, "kernel")
    off = (g_k - g_p).abs() > CS.update_bound(g_p, g)
    codes = torch.einsum("ltk,ltn->lkn",
                         torch.round(x_q / xs[:, None, None]).double(),
                         torch.round(d_q / ds[:, None, None]).double())
    exact = torch.einsum("ltk,ltn->lkn", x_q.double(), d_q.double())
    bound = TOKENS * 2.0 ** -24 * torch.einsum(
        "ltk,ltn->lkn", x_q.abs().double(), d_q.abs().double())
    acc_p = torch.einsum("ltk,ltn->lkn", x_q, d_q).double()
    acc_k = codes.float().double() * (xs * ds).double()[:, None, None]
    sums = codes[off].abs()
    res = {"cells": off.numel(), "cells_off_update_bound": int(off.sum()),
           "share": off.float().mean().item(),
           "code_sums_at_those_cells": {
               "zero": int((sums == 0).sum()),
               "at_most_2": int((sums <= 2).sum()),
               "largest": sums.max().item() if sums.numel() else None},
           "zero_code_sum_cells": int((codes == 0).sum()),
           "plain_acc_err_over_f32_bound_max":
               ((acc_p - exact).abs() / bound).max().item(),
           "tensor_core_acc_err_over_f32_bound_max":
               ((acc_k - exact).abs() / bound).max().item()}
    print(f"sum-rounding ties (wqkv, outer): {res}")
    return res


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(gpu)
    _nvcc.build([U.SOURCE])
    libs = build_variants()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    out = {"gpu": gpu, "variants": time_variants(libs, gen),
           "sum_rounding_ties": sum_rounding_ties(gen)}
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "update_write_ablation.json").write_text(
        json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
