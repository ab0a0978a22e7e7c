"""The PyTorch/CUDA port's examples (``examples/*_torch.py``) on the CPU at
their smoke sizes: ``hw_report_torch.py``'s table equal to the reference
example's, line for line; ``serve_demo_torch.py`` serving every request
of its batch; ``train_lm_torch.py`` training 2 steps with a checkpoint;
and none of them importing ``jax`` or the reference package."""
import ast
import contextlib
import io
import runpy
import sys
from pathlib import Path

import pytest

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
TORCH_EXAMPLES = ("hw_report_torch.py", "serve_demo_torch.py",
                  "train_lm_torch.py", "quickstart_torch.py")


def _run(name, *argv):
    """The example's standard output, run as ``__main__`` in this
    process with ``argv``."""
    out = io.StringIO()
    saved = sys.argv
    sys.argv = [str(EXAMPLES / name), *argv]
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(str(EXAMPLES / name), run_name="__main__")
    finally:
        sys.argv = saved
    return out.getvalue()


@pytest.mark.parametrize("name", TORCH_EXAMPLES)
def test_example_imports_no_jax(name):
    tree = ast.parse((EXAMPLES / name).read_text())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names]
    mods += [n.module or "" for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom)]
    assert mods and not [m for m in mods
                         if m.split(".")[0] in ("jax", "jaxlib", "repro")]


def test_hw_report_equals_reference():
    got = _run("hw_report_torch.py")
    want = _run("hw_report.py")
    table = [ln for ln in got.splitlines() if ln.strip()]
    assert len(table) > 4
    assert got == want


def test_serve_demo_on_cpu():
    out = _run("serve_demo_torch.py", "--arch", "lm100m", "--device", "cpu")
    assert sum(ln.startswith("[") and "-> [" in ln
               for ln in out.splitlines()) == 4, out
    assert "tok/s on cpu" in out, out


def test_train_lm_on_cpu(tmp_path):
    from repro_torch.core.shardctx import clear_shard_context
    try:
        out = _run("train_lm_torch.py", "--device", "cpu", "--steps", "2",
                   "--ckpt-dir", str(tmp_path / "ckpt"))
    finally:
        clear_shard_context()
    assert "done: 2 steps" in out, out
    assert any((tmp_path / "ckpt").iterdir())
