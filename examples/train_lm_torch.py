#!/usr/bin/env python
"""End-to-end driver on the PyTorch/CUDA port: train a ~100M-parameter
dense LM for a few hundred steps on the synthetic Markov token stream,
with checkpointing and (optionally) analog-crossbar projection semantics
(``repro_torch.launch.train``), on the CUDA card unless ``--device cpu``
is given.

    PYTHONPATH=src python examples/train_lm_torch.py               # ~15M
    PYTHONPATH=src python examples/train_lm_torch.py --full-100m   # lm100m
    PYTHONPATH=src python examples/train_lm_torch.py --analog      # QAT
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu

Kill and rerun with --ckpt-dir to exercise restart; several ranks (and
``--mesh``) run through ``torchrun -m repro_torch.launch.train``.
"""
import argparse
import sys

sys.path.insert(0, "src")

from repro_torch.launch.train import main as train_main  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--analog", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    argv = ["--arch", "lm100m", "--device", args.device]
    if args.full_100m:
        argv += ["--steps", str(args.steps or 200), "--seq-len", "128",
                 "--global-batch", "4"]
    else:
        # ~15M-param reduction
        argv += ["--smoke", "--steps", str(args.steps or 300),
                 "--seq-len", "128", "--global-batch", "8"]
    if args.analog:
        argv += ["--analog"]
    if args.ckpt_dir:
        argv += ["--ckpt-dir", args.ckpt_dir]
    train_main(argv)


if __name__ == "__main__":
    main()
