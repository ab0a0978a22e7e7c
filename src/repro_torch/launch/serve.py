"""Serving CLI: batched prefill + decode of any registry model (dense,
MoE with MLA among them, VLM, audio encoder-decoder, SSM, hybrid) on
synthetic prompts, on the card unless ``--device cpu``.

    python -m repro_torch.launch.serve --arch lm100m --backend analog
    python -m repro_torch.launch.serve --arch gemma-2b --backend analog \\
        --sim-days 3          # in-array decode after 3 days of drift
    python -m repro_torch.launch.serve --arch lm100m --smoke \\
        --backend digital --scheduler static --device cpu
    python -m repro_torch.launch.serve --arch llama4-scout-17b-a16e \\
        --smoke --backend analog --analog-tile 16 --device cpu
    python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b \\
        --smoke --backend analog --analog-tile 16 --device cpu
    python -m repro_torch.launch.serve --arch mamba2-1.3b --backend analog
    python -m repro_torch.launch.serve --arch zamba2-1.2b --backend analog
    python -m repro_torch.launch.serve --arch whisper-medium --backend analog
    python -m repro_torch.launch.serve --arch llama-3.2-vision-90b \\
        --smoke --backend analog --analog-tile 16 --device cpu

``--arch`` is one of the registry's 11 (lm100m, gemma-2b, stablelm-3b,
starcoder2-3b, granite-20b, llama4-scout-17b-a16e, deepseek-v2-lite-16b,
llama-3.2-vision-90b, whisper-medium, mamba2-1.3b, zamba2-1.2b).  The
SSM and hybrid families have no positional cache per slot, and the VLM
and the audio model take a second token stream (stub frontend inputs of
zeros, ``(batch, n_vision_tokens | n_audio_frames, d_model)``, as the
reference's CLI gives them): all four are served by the static scheduler
whatever ``--scheduler`` says, as in the reference.  mamba2-1.3b (9.9
GB of ``g`` + ``ref``), zamba2-1.2b (8.4 GB) and whisper-medium (5.6 GB)
fit one card at full size from crossbars, each about twice that with
the programming targets; llama-3.2-vision-90b needs 6.8 GB of ``g`` +
``ref`` a layer, 684 GB at 100 layers.
A model serves at full size only where the card's memory holds it:
llama4-scout (MoE, 16 experts) needs 845 GB of conductances at 48
layers, and deepseek-v2-lite (MLA, 64 experts of 2048 x 1408) 191 GB at
27 (4.68 GB of ``g`` + ``ref`` a layer, 2.34 GB of programming targets,
1.68 GB of embedding and head), more than one H100 has, so on one card
they serve from crossbars as ``--smoke`` only (llama-3.2-vision-90b
too).  ``chip_smoke.py`` runs them at full width cut in depth:
llama4-scout at 2 layers (phase 18), deepseek-v2-lite at 4 of 27 (phase
19, about 30 GB resident), llama-3.2-vision at 5 of 100 (phase 23, one
cross layer and its four self layers), the depth that fits one card
beside the script's other phases.  ``--backend analog`` programs the weights
onto tiled crossbars (``--analog-device``, ``--analog-tile``) and serves
the conductances in-array: every projection read goes through the fused
read, and the run prints how many times its CUDA kernels were launched,
the maintenance metrics and the projected energy per token.
``--sim-days`` advances the simulated deployment clock first, so
retention drift (and, past the retention spec's interval, the scheduled
recalibration sweep) is exercised.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.xbar_vmm import LAUNCHES
from repro_torch.models import model as M
from repro_torch.serve import SamplingParams, make_engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="lm100m",
                    help="a config of the port's registry; it serves at "
                         "full size only where memory allows: "
                         "llama4-scout-17b-a16e, deepseek-v2-lite-16b and "
                         "llama-3.2-vision-90b do not fit one H100 from "
                         "crossbars (use --smoke)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", choices=["digital", "analog"],
                    default="digital")
    ap.add_argument("--scheduler", "--engine", dest="scheduler",
                    choices=["continuous", "static"], default="continuous")
    ap.add_argument("--slots", type=int, default=None,
                    help="decode slots for the continuous scheduler "
                         "(default: batch size)")
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--analog-device", default="taox-nonoise",
                    help="device model for --backend analog")
    ap.add_argument("--analog-tile", type=int, default=64,
                    help="sim tile size for --backend analog")
    ap.add_argument("--sim-days", type=float, default=0.0,
                    help="advance the analog backend's simulated clock "
                         "this many days before serving")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    params = M.init_params(cfg, args.seed, device=args.device)
    if args.backend == "analog":
        cfg = cfg.replace(dtype="float32", analog=True,
                          analog_mode="device",
                          analog_device=args.analog_device,
                          analog_rows=args.analog_tile,
                          analog_cols=args.analog_tile)
        params = M.program_digital(params, cfg)
    rng = np.random.default_rng(args.seed)
    prompts = [[int(t) for t in rng.integers(
        0, cfg.vocab, size=rng.integers(4, args.prompt_len))]
               for _ in range(args.batch)]
    extras = {}
    if cfg.family == "vlm":
        extras["vision"] = torch.zeros(
            (args.batch, cfg.n_vision_tokens, cfg.d_model),
            device=args.device)
    if cfg.family == "audio":
        extras["audio"] = torch.zeros(
            (args.batch, cfg.n_audio_frames, cfg.d_model),
            device=args.device)
    engine = make_engine(cfg, params, backend=args.backend,
                         scheduler=args.scheduler,
                         max_len=args.prompt_len + args.max_new + 8,
                         n_slots=args.slots or args.batch,
                         prefill_chunk=args.prefill_chunk, extras=extras)
    sp = SamplingParams(temperature=args.temperature,
                        max_new_tokens=args.max_new)
    if args.sim_days:
        engine.advance_clock(args.sim_days * 86400.0)
    launches0 = dict(LAUNCHES)
    t0 = time.perf_counter()
    outs = engine.generate(prompts, sp, seed=args.seed)
    if args.device != "cpu":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n_tok = sum(len(o) for o in outs)
    for i, o in enumerate(outs):
        print(f"[{i}] prompt={prompts[i][:8]}... -> {o[:16]}...")
    sched = engine.scheduler if engine.supports_continuous else "static"
    mode = f"{engine.backend}/{sched}"
    print(f"[{mode}] {n_tok} tokens in {dt:.2f}s = {n_tok / dt:.1f} tok/s "
          f"on {args.device}")
    if sched == "continuous":
        print(f"metrics={dict(engine.metrics)}")
    if engine.backend == "analog":
        counts = {name: LAUNCHES[name] - launches0[name] for name in LAUNCHES}
        print(f"fused read kernel launches {counts}")
        epj = engine.energy_per_token()
        print(f"maintenance={dict(engine.maintenance.metrics)}")
        print(f"energy/token: analog={epj['analog_pj']:.1f}pJ "
              f"digital_reram={epj['digital_reram_pj']:.1f}pJ "
              f"sram={epj['sram_pj']:.1f}pJ")
    return outs


if __name__ == "__main__":
    main()
