"""``python -m repro_torch.analysis``: the static auditor's entry point.

The trace layer spawns gloo ranks, which import this module again as
``__mp_main__``: the audit runs only under ``__main__``.
"""
import os
import sys

from repro_torch.analysis.cli import main

if __name__ == "__main__":
    try:
        code = main()
    except BrokenPipeError:  # `... | head` closed stdout mid-report
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        code = 0
    sys.exit(code)
