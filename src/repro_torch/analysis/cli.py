"""The static auditor's command line (``python -m repro_torch.analysis``)."""
from __future__ import annotations

import argparse
import sys
import time
from typing import List

from .findings import NO_COUNTERPART, RULES, Allowlist, Finding, report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static auditor: contracts of the traced step (RA1xx), "
                    "kernel launch safety (RA2xx), AST and CUDA-source "
                    "rules (RA3xx)")
    ap.add_argument("--all", action="store_true",
                    help="run every layer (default if none selected)")
    ap.add_argument("--trace", action="store_true",
                    help="Layer 1 only (the reference's --jaxpr)")
    ap.add_argument("--kernels", action="store_true",
                    help="Layer 2's CPU half only (the reference's "
                         "--pallas)")
    ap.add_argument("--ast", action="store_true", help="Layer 3 only")
    ap.add_argument("--arch", default="lm100m",
                    help="config traced by the trace layer")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rid, desc in sorted(RULES.items()):
            print(f"{rid}  {desc}")
        for rid, why in sorted(NO_COUNTERPART.items()):
            print(f"{rid}  no counterpart: {why}")
        return 0

    run_all = args.all or not (args.trace or args.kernels or args.ast)
    findings: List[Finding] = []
    # AST first: it imports no torch and fails fastest.
    if run_all or args.ast:
        from .ast_rules import audit_ast
        t0 = time.time()
        got = audit_ast()
        print(f"[ast]     {len(got)} raw finding(s) in {time.time() - t0:.1f}s")
        findings += got
    if run_all or args.kernels:
        from .kernel_lint import audit_kernels
        t0 = time.time()
        got = audit_kernels()
        print(f"[kernels] {len(got)} raw finding(s) in "
              f"{time.time() - t0:.1f}s (RA203, RA204; RA201 and RA202 "
              "need the card: chip_smoke.py phase 25(b) runs "
              "kernel_lint.audit_launches there, not this CLI)")
        findings += got
    if run_all or args.trace:
        from .trace_lint import audit_trace
        t0 = time.time()
        got = audit_trace(arch=args.arch)
        print(f"[trace]   {len(got)} raw finding(s) in "
              f"{time.time() - t0:.1f}s")
        findings += got

    # identical findings (same rule/site/message) collapse to one line
    findings = list(dict.fromkeys(findings))
    active, suppressed = Allowlist().split(findings)
    print(report(active, suppressed))
    return 1 if active else 0


if __name__ == "__main__":
    sys.exit(main())
