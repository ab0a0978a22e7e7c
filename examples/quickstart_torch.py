#!/usr/bin/env python
"""Quickstart on the PyTorch/CUDA port: the paper's experiment in minutes.

Trains the 784-300-10 MLP (paper §VI) three ways on the synthetic digit
set: numeric fp32, analog TaOx crossbar (nonlinear+asymmetric+stochastic
writes), and analog TaOx with periodic carry — the Fig. 14/15 result that
write nonlinearity destroys training and periodic carry restores it.
Runs on the CUDA card (the hand-written read kernels) unless ``--device
cpu`` is given.

    PYTHONPATH=src python examples/quickstart_torch.py [--full] [--device cpu]
"""
import argparse
import sys

sys.path.insert(0, "src")

from repro_torch.train.mlp_analog import MLPRun, train_mlp  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="full 4-epoch protocol (the paper's)")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args()
    kw = {} if args.full else dict(epochs=1, n_train=4000, n_test=1000)
    dev = args.device

    print("=== numeric (fp32 SGD) ===")
    numeric = train_mlp(MLPRun(mode="numeric", **kw), device=dev)["final"]
    print("=== analog TaOx (nonlinear + asymmetric + stochastic) ===")
    taox = train_mlp(MLPRun(mode="analog", device="taox", **kw),
                     device=dev)["final"]
    print("=== analog TaOx + periodic carry ===")
    pc = train_mlp(MLPRun(mode="pc", device="taox", **kw),
                   device=dev)["final"]

    print(f"\nnumeric {numeric:.3f} | analog TaOx {taox:.3f} "
          f"| + periodic carry {pc:.3f}")
    print("paper claim: TaOx nonlinearity degrades training badly; "
          "periodic carry recovers to ~numeric.  "
          f"{'REPRODUCED' if pc > taox + 0.1 and numeric > taox + 0.1 else 'inconclusive at this budget — rerun with --full'}")


if __name__ == "__main__":
    main()
