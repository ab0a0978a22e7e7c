"""Layer 3: AST and source rules over ``src/repro_torch`` (RA3xx; port of
``repro.analysis.ast_rules``).

Repo-specific rules a generic linter cannot express.  Pure ``ast`` and a
regex pass over the CUDA sources: importing this module never imports
torch, so the layer runs first and fastest.

RA301  library code does not change global numerics: no assignment to
       ``torch.backends.*.allow_tf32`` (or the reduced-precision
       reduction flags), no ``torch.set_float32_matmul_precision``,
       ``torch.set_default_dtype`` / ``set_default_tensor_type`` or
       ``torch.use_deterministic_algorithms``.  Such a switch changes
       every caller's numerics; it belongs to entry points (tests,
       ``chip_smoke.py``, CLIs).  A scoped switch that restores the
       caller's setting carries an allow comment.
RA302  no host or library RNG inside a CUDA kernel or device function
       (``curand*``, ``rand()``, ``<random>``'s engines) in
       ``kernels/csrc/*.cu``: every noise draw is the counter PRNG, so a
       shard at its tile offsets draws exactly its slice of the field.
RA303  no Python ``for``/``while`` loop whose body calls a container op
       (the reads, the writes, the analog projections): the
       layer-batched kernels exist so that the layer dimension stays in
       one launch.
RA104, RA106, RA304 (no counterpart in the port, ``findings.
       NO_COUNTERPART``): raised where the port would start to need
       them: a compiled entry point (``torch.compile``, ``torch.jit``,
       ``torch.export``: RA304, its buffer donation unchecked), a
       captured CUDA graph (RA104, its static buffers alias the state)
       and traceable collectives a compiler may rewrite
       (``torch.distributed._functional_collectives``: RA106).
"""
from __future__ import annotations

import ast
import os
import re
from typing import Iterator, List, Optional, Sequence

from .findings import Finding, repo_root

#: Calls whose presence inside a Python loop body indicates a per-layer
#: loop around container ops (RA303).
_CONTAINER_OPS = {
    "vmm", "mvm", "outer_update", "xbar_fused_read", "xbar_outer_update",
    "xbar_sharded_update", "manual_collective_read", "fakequant_read",
    "analog_project", "analog_project_batched", "expert_project",
    "_read_cuda", "_update_cuda", "_fakequant_cuda",
}

#: RA301: global numerics switches (calls) and flags (assignments).
_NUMERICS_CALLS = {"torch.set_float32_matmul_precision",
                   "torch.set_default_dtype", "torch.set_default_tensor_type",
                   "torch.use_deterministic_algorithms"}
_NUMERICS_FLAGS = ("allow_tf32", "allow_bf16_reduced_precision_reduction",
                   "allow_fp16_reduced_precision_reduction")

#: Compiler entry points and what each would need (the no-counterpart
#: rules' premise).
_COMPILERS = {"torch.compile": "RA304", "torch.jit.script": "RA304",
              "torch.jit.trace": "RA304", "torch.export.export": "RA304",
              "torch.cuda.graph": "RA104", "torch.cuda.CUDAGraph": "RA104",
              "torch.cuda.make_graphed_callables": "RA104"}
_FUNCOL = "torch.distributed._functional_collectives"

#: RA302: RNG in device code.
_DEVICE_RNG = re.compile(r"\b(curand\w*|rand|random|std::mt19937\w*|"
                         r"std::random_device|std::\w+_distribution)\s*[(<{]")
_DEVICE_FN = re.compile(r"__(global|device)__")


def _dotted(node: ast.AST) -> str:
    """Dotted name of an attribute chain, e.g. 'torch.backends.cuda'."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


class _FileAuditor(ast.NodeVisitor):
    def __init__(self, rel_path: str):
        self.rel_path = rel_path
        self.findings: List[Finding] = []
        self._loop_depth = 0

    def _emit(self, rule: str, line: int, msg: str) -> None:
        self.findings.append(
            Finding(rule, msg, file=self.rel_path, line=line))

    def _visit_loop(self, node) -> None:
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    visit_For = visit_While = visit_AsyncFor = _visit_loop

    def visit_Call(self, node: ast.Call) -> None:
        name = _dotted(node.func)
        leaf = name.rsplit(".", 1)[-1]
        if name in _NUMERICS_CALLS:
            self._emit("RA301", node.lineno,
                       f"global numerics switch in library code: {name}()")
        if name in _COMPILERS:
            self._emit(_COMPILERS[name], node.lineno,
                       f"{name}() in library code: the port's auditor has "
                       "no check for what it needs (findings."
                       "NO_COUNTERPART)")
        if self._loop_depth and leaf in _CONTAINER_OPS:
            self._emit("RA303", node.lineno,
                       f"container op '{leaf}' called inside a Python loop "
                       "(layer batching must stay in-kernel)")
        self.generic_visit(node)

    def _assigned(self, targets, line: int) -> None:
        for t in targets:
            dotted = _dotted(t) if isinstance(t, ast.Attribute) else ""
            if dotted.startswith("torch.backends.") \
                    and dotted.endswith(_NUMERICS_FLAGS):
                self._emit("RA301", line, f"global numerics flag set in "
                           f"library code: {dotted}")

    def visit_Assign(self, node: ast.Assign) -> None:
        self._assigned(node.targets, node.lineno)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._assigned([node.target], node.lineno)
        self.generic_visit(node)

    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            if a.name.startswith(_FUNCOL):
                self._emit("RA106", node.lineno, f"import of {_FUNCOL}: "
                           "traceable collectives a compiler may rewrite")

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        mod = node.module or ""
        names = {f"{mod}.{a.name}" for a in node.names}
        if mod.startswith(_FUNCOL) or _FUNCOL in names:
            self._emit("RA106", node.lineno, f"import of {_FUNCOL}: "
                       "traceable collectives a compiler may rewrite")


def _iter_py_files(src_root: str) -> Iterator[str]:
    for dirpath, dirnames, filenames in os.walk(src_root):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", "analysis"))
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


def _device_bodies(text: str):
    """(start offset, body text) of every ``__global__`` / ``__device__``
    function definition in a CUDA source (brace matching; declarations
    without a body are skipped)."""
    for m in _DEVICE_FN.finditer(text):
        i = m.end()
        while i < len(text) and text[i] not in "{;":
            i += 1
        if i >= len(text) or text[i] == ";":
            continue
        depth, j = 0, i
        while j < len(text):
            if text[j] == "{":
                depth += 1
            elif text[j] == "}":
                depth -= 1
                if depth == 0:
                    break
            j += 1
        yield i, text[i:j + 1]


def audit_cuda(root: Optional[str] = None,
               files: Optional[Sequence[str]] = None) -> List[Finding]:
    """RA302 over ``kernels/csrc/*.cu`` (or ``files``)."""
    root = root or repo_root()
    if files is None:
        csrc = os.path.join(root, "src", "repro_torch", "kernels", "csrc")
        files = sorted(os.path.join(csrc, f) for f in os.listdir(csrc)
                       if f.endswith((".cu", ".cuh")))
    findings: List[Finding] = []
    for path in files:
        rel = os.path.relpath(os.path.abspath(path), root)
        with open(path, encoding="utf-8") as f:
            text = f.read()
        # comments and string literals never draw anything
        code = re.sub(r"//[^\n]*|/\*.*?\*/|\"(?:\\.|[^\"\\])*\"",
                      lambda m: re.sub(r"[^\n]", " ", m.group(0)), text,
                      flags=re.S)
        hits = set()
        for start, body in _device_bodies(code):
            for m in _DEVICE_RNG.finditer(body):
                line = code.count("\n", 0, start + m.start()) + 1
                if line not in hits:
                    hits.add(line)
                    findings.append(Finding(
                        "RA302", f"'{m.group(1)}' in device code (use the "
                        "counter PRNG)", file=rel, line=line))
    return findings


def audit_ast(root: Optional[str] = None,
              files: Optional[Sequence[str]] = None) -> List[Finding]:
    """All RA3xx rules (and the no-counterpart guards).  ``files``
    (absolute paths, ``.py`` or ``.cu``) overrides the default walk of
    ``src/repro_torch`` and its CUDA sources: the fixture tests use it."""
    root = root or repo_root()
    if files is None:
        py = list(_iter_py_files(os.path.join(root, "src", "repro_torch")))
        cu = None
    else:
        py = [f for f in files if f.endswith(".py")]
        cu = [f for f in files if f.endswith((".cu", ".cuh"))]
    findings: List[Finding] = []
    for path in py:
        rel = os.path.relpath(os.path.abspath(path), root)
        try:
            with open(path, encoding="utf-8") as f:
                tree = ast.parse(f.read(), filename=path)
        except (OSError, SyntaxError) as e:
            findings.append(Finding("RA301", f"unparseable file: {e}",
                                    file=rel))
            continue
        auditor = _FileAuditor(rel)
        auditor.visit(tree)
        findings.extend(auditor.findings)
    if cu is None or cu:
        findings.extend(audit_cuda(root, cu))
    return findings
