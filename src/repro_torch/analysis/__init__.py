"""``repro_torch.analysis``: the port's three-layer static program auditor
(port of ``repro.analysis``).

Layer 1 (``trace_lint``) runs the shipped entry points under a dispatch
mode and enforces the step's contracts (RA1xx); Layer 2 (``kernel_lint``)
checks the kernels' padding and seed grids on the CPU and their launch
coverage on the card (RA2xx); Layer 3 (``ast_rules``) applies the
repo-specific AST and CUDA-source rules (RA3xx).  One CLI:

    python -m repro_torch.analysis --all

Rule catalog and allowlist syntax: ``findings``.  Importing this package
imports no torch; the trace and kernel layers import it when they run.
"""
from .findings import NO_COUNTERPART, RULES, Allowlist, Finding, report  # noqa: F401
