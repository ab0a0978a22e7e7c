"""Fig. 14 / Fig. 15 reproduction on the port: MLP training accuracy
across device models, and periodic-carry recovery (port of
``benchmarks/accuracy.py``, same rows and claim lines).

    python -m repro_torch.launch.accuracy [--fast] [--carry] [--device cpu]

--fast trims the protocol (1 epoch, 4k examples); the full protocol
(4 epochs, 8k) is the paper's.  The reference documents these figures
for it:
    numeric 0.990 > linearized 0.969 ~ ideal-quant 0.971
                  >> taox-full 0.575 ~ no-noise 0.582   (Fig. 14)
    periodic-carry on full TaOx: 0.985 (within 1 % of numeric, Fig. 15)
The run is on the card unless ``--device cpu`` (the kernels' plain
versions).
"""
from __future__ import annotations

import argparse
import time

from repro_torch.train.mlp_analog import MLPRun, train_mlp

FIG14_MODES = [
    ("numeric", MLPRun(mode="numeric")),
    ("analog-ideal", MLPRun(mode="analog", device="ideal")),
    ("analog-taox", MLPRun(mode="analog", device="taox")),
    ("analog-taox-nonoise", MLPRun(mode="analog", device="taox-nonoise")),
    ("analog-linearized", MLPRun(mode="analog", device="linearized")),
]
FIG15 = ("periodic-carry-taox", MLPRun(mode="pc", device="taox"))


def fast(run: MLPRun) -> MLPRun:
    """The ``--fast`` protocol: 1 epoch, 4000 training and 1000 test
    digits."""
    return MLPRun(**{**run.__dict__, "epochs": 1, "n_train": 4000,
                     "n_test": 1000})


def claims(results, carry: bool, fast_run: bool):
    """The paper's qualitative claims, as ``(name, holds)`` pairs."""
    checks = []
    if "numeric" in results and "analog-taox" in results:
        checks.append(("numeric >> taox (>0.15 gap)",
                       results["numeric"] - results["analog-taox"] > 0.15))
    if "analog-linearized" in results and "analog-taox" in results:
        checks.append(("linearized recovers (nonlinearity dominates)",
                       results["analog-linearized"]
                       > results["analog-taox"] + 0.1))
    if carry and not fast_run:
        checks.append(("periodic carry within 2% of numeric",
                       results["numeric"]
                       - results["periodic-carry-taox"] < 0.02))
    return checks


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--carry", action="store_true",
                    help="also run Fig. 15 periodic carry")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    print("name,us_per_call,derived")
    results = {}
    runs = list(FIG14_MODES) + ([FIG15] if args.carry else [])
    for name, run in runs:
        if args.fast:
            run = fast(run)
        t0 = time.time()
        out = train_mlp(run, log=None, device=args.device)
        dt = (time.time() - t0) * 1e6
        results[name] = out["final"]
        print(f"accuracy/{name},{dt:.0f},final_acc={out['final']:.4f}"
              f"|curve={'/'.join(f'{a:.3f}' for a in out['acc'])}")

    for name, ok in claims(results, args.carry, args.fast):
        print(f"claim/{name},0,{'PASS' if ok else 'FAIL'}")
    return results


if __name__ == "__main__":
    main()
