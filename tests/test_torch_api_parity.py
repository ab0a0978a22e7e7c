"""No public name of the reference goes missing from the port.

Every module of ``src/repro/`` is parsed (the AST only, nothing is
imported), and so is its counterpart under ``src/repro_torch/``: the
module of the same path, or of its new name for the three modules the
port renamed (``RENAMED``).  Each public top-level function and class,
each public method of a public class and each UPPER_CASE constant must
have a counterpart of the same name in the port's module (defined or
imported at its top level; a method or class attribute of the class of
the same name), or sit in ``NO_COUNTERPART``: the JAX- and TPU-only
names, each with the reason it has none.
"""
import ast
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"

#: Reference modules whose counterpart has another name.
RENAMED = {"analysis/jaxpr_lint.py": "analysis/trace_lint.py",
           "analysis/pallas_lint.py": "analysis/kernel_lint.py",
           "launch/hlo_analysis.py": "launch/trace_analysis.py"}

_JAXPR = ("a rule over the step's jaxpr or its compiled XLA module; "
          "trace_lint audits the port's dispatch trace")
_PALLAS = ("captures pallas_call grids and BlockSpecs; kernel_lint audits "
           "the CUDA launches (their outputs and guard regions)")
_HLO = ("parses XLA's HLO text; trace_analysis.Trace counts the port's "
        "FLOPs, bytes and collectives from the dispatch trace")

#: (reference module, name): why the port has no counterpart.
NO_COUNTERPART = {
    ("analysis/jaxpr_lint.py", "COLLECTIVE_PRIMS"): _JAXPR,
    ("analysis/jaxpr_lint.py", "EXACT_MODE_WHITELIST"): _JAXPR,
    ("analysis/jaxpr_lint.py", "MAX_PJIT_CLIP_ROUND"):
        "bounds pjit-wrapped clip/round calls in a jaxpr; eager torch "
        "wraps none",
    ("analysis/jaxpr_lint.py", "MAX_STEP_EQNS"): _JAXPR,
    ("analysis/jaxpr_lint.py", "audit_jaxpr"): _JAXPR,
    ("analysis/jaxpr_lint.py", "check_clip_round_budget"):
        "bounds pjit-wrapped clip/round calls in a jaxpr; eager torch "
        "wraps none",
    ("analysis/jaxpr_lint.py", "check_compiled_collectives"): _JAXPR,
    ("analysis/jaxpr_lint.py", "check_donation"):
        "checks jit buffer donation; eager torch donates no buffers",
    ("analysis/jaxpr_lint.py", "compiled_step_collectives"): _JAXPR,
    ("analysis/pallas_lint.py", "MAX_GRID_POINTS"): _PALLAS,
    ("analysis/pallas_lint.py", "PallasCapture"): _PALLAS,
    ("analysis/pallas_lint.py", "SpecInfo"): _PALLAS,
    ("analysis/pallas_lint.py", "audit_pallas"): _PALLAS,
    ("analysis/pallas_lint.py", "capture_pallas_calls"): _PALLAS,
    ("analysis/pallas_lint.py", "check_capture"): _PALLAS,
    ("core/shardctx.py", "replicate_for_exact_reduce"):
        "a GSPMD sharding constraint; the port's ranks are processes that "
        "exchange explicitly (combine_partials_exact)",
    ("kernels/ops.py", "default_interpret"):
        "picks Pallas interpret mode off the TPU; the port dispatches by "
        "the tensor's device",
    ("kernels/xbar_update.py", "IMPLS"):
        "the Pallas paths (pallas, interpret, fused); the port's are "
        "UPDATE_IMPLS (cuda, eager)",
    ("kernels/xbar_update.py", "xbar_outer_update_inline"):
        "the jit-inlined twin of xbar_outer_update; eager torch has no "
        "jit boundary to inline across",
    ("kernels/xbar_vmm.py", "fakequant_read_pallas"):
        "named for Pallas; its counterpart is fakequant_read, which "
        "kernels.__init__ exports in its place",
    ("kernels/xbar_vmm.py", "xbar_fused_read_inline"):
        "the jit-inlined twin of xbar_fused_read; eager torch has no jit "
        "boundary to inline across",
    ("launch/hlo_analysis.py", "Computation"): _HLO,
    ("launch/hlo_analysis.py", "Instr"): _HLO,
    ("launch/hlo_analysis.py", "analyze"): _HLO,
    ("launch/hlo_analysis.py", "collective_byte_volume"):
        _HLO + " (Trace.collective_byte_volume)",
    ("launch/hlo_analysis.py", "collective_payloads"):
        _HLO + " (Trace.collective_payloads)",
    ("launch/hlo_analysis.py", "count_collectives"):
        _HLO + " (Trace.collectives)",
    ("launch/hlo_analysis.py", "parse_hlo"): _HLO,
    ("models/layers.py", "shard_batch_dim"):
        "a GSPMD sharding constraint on the batch dim; the port's data "
        "ranks hold their own rows",
    ("serve/engine.py", "ContinuousEngine.decode_compiles"):
        "counts jit traces of the decode step; eager torch traces none",
    ("serve/engine.py", "Engine.decode_compiles"):
        "counts jit traces of the decode step; eager torch traces none",
    ("train/analog_lm.py", "AnalogTrainStep.compiles"):
        "counts jit compiles of the step; eager torch compiles none",
}

_CONST = re.compile(r"[A-Z][A-Z0-9_]*")


def _public(path: Path) -> set:
    """The names the guard holds the port to."""
    out = set()
    for n in ast.parse(path.read_text()).body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)) and not n.name.startswith("_"):
            out.add(n.name)
            if isinstance(n, ast.ClassDef):
                out |= {f"{n.name}.{m.name}" for m in n.body
                        if isinstance(m, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))
                        and not m.name.startswith("_")}
        elif isinstance(n, (ast.Assign, ast.AnnAssign)):
            targets = n.targets if isinstance(n, ast.Assign) else [n.target]
            out |= {t.id for t in targets if isinstance(t, ast.Name)
                    and _CONST.fullmatch(t.id)}
    return out


def _defined(path: Path) -> set:
    """Every name a module defines or imports at its top level, and every
    method and class attribute of its classes."""
    out = set()
    for n in ast.parse(path.read_text()).body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            out.add(n.name)
            if isinstance(n, ast.ClassDef):
                for m in n.body:
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        out.add(f"{n.name}.{m.name}")
                    targets = m.targets if isinstance(m, ast.Assign) else \
                        [m.target] if isinstance(m, ast.AnnAssign) else []
                    out |= {f"{n.name}.{t.id}" for t in targets
                            if isinstance(t, ast.Name)}
        elif isinstance(n, (ast.Assign, ast.AnnAssign)):
            targets = n.targets if isinstance(n, ast.Assign) else [n.target]
            out |= {t.id for t in targets if isinstance(t, ast.Name)}
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            out |= {a.asname or a.name.split(".")[0] for a in n.names}
    return out


def _modules():
    for path in sorted(REF.rglob("*.py")):
        rel = path.relative_to(REF).as_posix()
        yield rel, path, PORT / RENAMED.get(rel, rel)


def _missing():
    return {(rel, name) for rel, ref, port in _modules()
            for name in _public(ref) - _defined(port)}


def test_every_reference_module_has_a_counterpart():
    absent = [rel for rel, _, port in _modules() if not port.is_file()]
    assert absent == []


def test_every_public_name_has_a_counterpart():
    unexplained = sorted(_missing() - set(NO_COUNTERPART))
    assert unexplained == [], (
        "public names of the reference with no counterpart in the port "
        "(port them, or add them to NO_COUNTERPART with the reason)")


def test_no_counterpart_list_is_current():
    """Each entry names a public name of the reference that the port
    still lacks, with a reason; a name the port gains leaves the list."""
    assert sorted(set(NO_COUNTERPART) - _missing()) == []
    assert all(reason.strip() for reason in NO_COUNTERPART.values())


def _all(path: Path) -> list:
    for n in ast.parse(path.read_text()).body:
        if isinstance(n, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in n.targets):
            return ast.literal_eval(n.value)
    return []


def test_core_all_covers_the_reference():
    ref = _all(REF / "core" / "__init__.py")
    port = _all(PORT / "core" / "__init__.py")
    assert len(ref) == 53 and sorted(set(ref) - set(port)) == []
    assert set(port) <= _defined(PORT / "core" / "__init__.py")
