"""Findings, rule catalog, and the inline-comment allowlist (port of
``repro.analysis.findings``).

Every auditor layer reports :class:`Finding` records carrying a stable
rule ID (``RA1xx`` contracts of the traced step, ``RA2xx`` kernel launch
safety, ``RA3xx`` AST and source lint).  A finding anchored to a repo
source line can be suppressed *only* by an inline allowlist comment with
a non-empty justification on that line or the line directly above it:

    y = combine(y, out_names, y.ndim - 1)  # audit: allow RA103 -- ordered
                                           # gather of ADC outputs

Silent suppressions are rejected: ``# audit: allow RA103`` without a
justification does not match, and an allowlist comment never suppresses a
*different* rule ID.  Findings that cannot be resolved to a repo source
line (a dtype leak whose frames are all inside torch) are never
suppressible: they must be fixed.

The catalog keeps the reference's IDs wherever the contract carries
over, and an ID is never reused.  Three of the reference's rules guard a
compiler's buffers and rewrites that eager torch does not have
(:data:`NO_COUNTERPART`); they stay in the catalog, and the AST layer
raises each where the port would start to need it (a compiled entry
point, a captured CUDA graph, traceable collectives).
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, Iterable, List, Optional, Tuple

#: Stable rule catalog: id -> one-line description.
RULES: Dict[str, str] = {
    # Layer 1 - contracts of the traced step (trace_lint)
    "RA101": "no float64/complex128 tensor in any op the analog train "
             "step or the serve decode step dispatches (a dtype promotion "
             "leak doubles memory and breaks bit-exactness)",
    "RA102": "split_tapes containment: the differentiated tree holds tape "
             "slots only, every frozen container has g/ref/w_scale, and no "
             "conductance tensor requires grad or gets a .grad",
    "RA103": "every torch.distributed call of the exact-mode sharded step "
             "carries an inline justification at its source line (a bare "
             "gather of a conductance tensor is a finding)",
    "RA104": "no counterpart in the port: jitted steps donate their state "
             "buffers; eager torch updates its state without a compiled "
             "copy to alias (raised where a CUDA graph is captured)",
    "RA105": "the analog step's count of dispatched aten ops stays under "
             "its budget (per-layer unrolling, a de-fused read chain); the "
             "reference's pjit-wrapped clip/round half has no counterpart",
    "RA106": "no counterpart in the port: compiled sharded modules hold no "
             "order-sensitive collective; eager torch has no compiler free "
             "to rewrite a collective (raised where traceable collectives "
             "are imported)",
    "RA107": "the exact-mode sharded step moves no parameter-sized "
             "collective: every recorded payload stays below the smallest "
             "sharded conductance block",
    # Layer 2 - kernel launch safety (kernel_lint)
    "RA201": "every output element of each CUDA kernel is written (no NaN "
             "sentinel left) and two launches on the same inputs are "
             "bit-equal (card half)",
    "RA202": "no CUDA kernel writes outside its output buffer (the guard "
             "regions before and after it are untouched; card half)",
    "RA203": "the wrappers' padding gives the divisibility their launches "
             "assume for every shipped tile geometry, ragged ones included",
    "RA204": "per-(layer, tile) PRNG seed blocks are pairwise unique "
             "across the container grid and across container paths",
    # Layer 3 - AST and source rules (ast_rules)
    "RA301": "library code does not change global numerics (allow_tf32, "
             "set_float32_matmul_precision, set_default_dtype, "
             "use_deterministic_algorithms)",
    "RA302": "no host or library RNG (curand*, rand()) in a CUDA kernel "
             "or device function: every noise draw is the counter PRNG",
    "RA303": "no Python per-layer loop around container ops (the pattern "
             "the layer-batched kernels exist to kill)",
    "RA304": "no counterpart in the port: jax.jit entry points declare "
             "buffer donation; the port's steps are eager (raised where a "
             "step is compiled)",
}

#: The reference's rules that guard a compiler's work, with why eager
#: torch has no counterpart.
NO_COUNTERPART: Dict[str, str] = {
    "RA104": "eager torch updates its state in place or returns a new "
             "one; no compiled executable holds a second copy to alias",
    "RA106": "eager torch has no compiler free to rewrite a collective: "
             "every call runs as written and RA103 sees each one",
    "RA304": "the port has no jit: there is no compiled entry point whose "
             "arguments could be donated",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One auditor finding.  ``file`` is repo-relative when the finding
    anchors to a source line (allowlistable); ``entry`` names the traced
    entry point / kernel / config that produced it."""
    rule: str
    message: str
    file: Optional[str] = None
    line: Optional[int] = None
    entry: Optional[str] = None

    def where(self) -> str:
        if self.file:
            loc = f"{self.file}:{self.line}" if self.line else self.file
        else:
            loc = self.entry or "<untraceable>"
        return loc

    def __str__(self) -> str:
        tail = f" [{self.entry}]" if self.entry and self.file else ""
        return f"{self.rule} {self.where()}: {self.message}{tail}"


# --------------------------------------------------------------------------
# Allowlist
# --------------------------------------------------------------------------

#: ``# audit: allow RA103 -- justification`` (separator: -, --, —, or :).
_ALLOW_RE = re.compile(
    r"#\s*audit:\s*allow\s+(RA\d{3})\s*(?:[-—:]+\s*(\S.*))?$")


def repo_root(start: Optional[str] = None) -> str:
    """The repository root (directory holding ``src/``), from this file."""
    here = start or os.path.dirname(os.path.abspath(__file__))
    d = here
    for _ in range(8):
        if os.path.isdir(os.path.join(d, "src")) \
                and os.path.isfile(os.path.join(d, "pyproject.toml")):
            return d
        d = os.path.dirname(d)
    return here


class Allowlist:
    """Inline-comment allowlist over the repo's source files.

    ``entries[path][lineno] = (rule, justification)``.  A finding at
    (path, line) is suppressed by a matching-rule entry at ``line`` or
    ``line - 1`` (comment directly above), and only when the
    justification is non-empty.
    """

    def __init__(self, root: Optional[str] = None):
        self.root = root or repo_root()
        self._cache: Dict[str, Dict[int, Tuple[str, str]]] = {}

    def _entries(self, rel_path: str) -> Dict[int, Tuple[str, str]]:
        cached = self._cache.get(rel_path)
        if cached is not None:
            return cached
        out: Dict[int, Tuple[str, str]] = {}
        full = os.path.join(self.root, rel_path)
        try:
            with open(full, encoding="utf-8") as f:
                for i, text in enumerate(f, start=1):
                    m = _ALLOW_RE.search(text.rstrip())
                    if m and m.group(2):  # justification required
                        out[i] = (m.group(1), m.group(2).strip())
        except OSError:
            pass
        self._cache[rel_path] = out
        return out

    def justification(self, finding: Finding) -> Optional[str]:
        """The justification suppressing ``finding``, or None."""
        if not finding.file or not finding.line:
            return None
        entries = self._entries(finding.file)
        for ln in (finding.line, finding.line - 1):
            hit = entries.get(ln)
            if hit and hit[0] == finding.rule:
                return hit[1]
        return None

    def split(self, findings: Iterable[Finding]
              ) -> Tuple[List[Finding], List[Tuple[Finding, str]]]:
        """(active, suppressed-with-justification)."""
        active: List[Finding] = []
        suppressed: List[Tuple[Finding, str]] = []
        for f in findings:
            j = self.justification(f)
            if j is None:
                active.append(f)
            else:
                suppressed.append((f, j))
        return active, suppressed


def relativize(path: Optional[str], root: Optional[str] = None
               ) -> Optional[str]:
    """Repo-relative form of ``path``; None for paths outside the repo
    (torch internals: those findings are not allowlistable)."""
    if not path:
        return None
    root = root or repo_root()
    ap = os.path.abspath(path)
    if ap.startswith(root + os.sep):
        return os.path.relpath(ap, root)
    return None


def report(active: List[Finding],
           suppressed: List[Tuple[Finding, str]],
           title: str = "static audit") -> str:
    lines = []
    for f, why in suppressed:
        lines.append(f"  allowlisted {f.rule} {f.where()}: {why}")
    for f in active:
        lines.append(f"  FINDING {f}")
    verdict = "clean" if not active else f"{len(active)} finding(s)"
    lines.append(f"{title}: {verdict}, {len(suppressed)} allowlisted")
    return "\n".join(lines)
