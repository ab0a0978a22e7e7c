#!/usr/bin/env python
"""Serving demo on the PyTorch/CUDA port: continuous-batching prefill +
KV-cache decode (``repro_torch.launch.serve``), on the CUDA card unless
``--device cpu`` is given.

    PYTHONPATH=src python examples/serve_demo_torch.py --arch gemma-2b
    PYTHONPATH=src python examples/serve_demo_torch.py --arch lm100m \\
        --scheduler static
    PYTHONPATH=src python examples/serve_demo_torch.py --arch lm100m \\
        --backend analog          # decode straight from the crossbars
    PYTHONPATH=src python examples/serve_demo_torch.py --device cpu

(uses the reduced smoke config of the chosen arch; the full configs are
served by ``python -m repro_torch.launch.serve`` without ``--smoke``)
"""
import argparse
import sys

sys.path.insert(0, "src")

from repro_torch.launch.serve import main as serve_main  # noqa: E402

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--scheduler", default="continuous",
                    choices=["continuous", "static"])
    ap.add_argument("--backend", default="digital",
                    choices=["digital", "analog"])
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args, _ = ap.parse_known_args()
    serve_main(["--arch", args.arch, "--smoke", "--batch", "4",
                "--max-new", "24", "--temperature", "0.7",
                "--scheduler", args.scheduler,
                "--backend", args.backend, "--device", args.device])
