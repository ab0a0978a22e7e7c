"""The port stands alone: importing every ``repro_torch`` module loads
neither ``jax`` nor anything of the JAX package ``repro``, and
``chip_smoke.py`` imports neither."""
import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
"""


def test_port_modules_import_without_jax_or_repro():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.split(" ", 1)
    assert int(n) >= 77 and bad.strip() == "[]", out.stdout


def _imported_roots(path: Path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_sources_and_chip_smoke_import_no_jax_or_repro():
    files = [ROOT / "chip_smoke.py",
             *sorted((ROOT / "src" / "repro_torch").rglob("*.py"))]
    for f in files:
        roots = _imported_roots(f)
        assert not roots & {"jax", "jaxlib", "repro"}, (f, roots)


def test_probe_walks_the_kernel_modules():
    """The probe above imports every kernel module of the port, the
    fakequant projection and flash attention among them, the carry and
    numeric-training modules, the registry's dense and SSM configs, the
    SSD layer, the retention model, the serving maintenance runtime, the
    checkpoints, the multi-device modules (the shard context, the
    mesh, the sharding policy, the pipeline schedule, the training CLI,
    gradient compression and the data pipeline), and the auditor, the
    kernel oracles, the output-allocation hook, the trace analysis and
    the dry run."""
    import pkgutil

    import repro_torch
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    assert {"repro_torch.kernels.ops", "repro_torch.kernels.flash_attention",
            "repro_torch.kernels.xbar_vmm", "repro_torch.kernels.xbar_update",
            "repro_torch.models.layers", "repro_torch.core.periodic_carry",
            "repro_torch.train.optimizer",
            "repro_torch.train.train_loop", "repro_torch.configs.gemma_2b",
            "repro_torch.configs.stablelm_3b",
            "repro_torch.configs.starcoder2_3b",
            "repro_torch.configs.granite_20b", "repro_torch.core.endurance",
            "repro_torch.serve.state", "repro_torch.serve.engine",
            "repro_torch.train.checkpoint",
            "repro_torch.launch.serve", "repro_torch.models.ssm",
            "repro_torch.configs.mamba2_1_3b",
            "repro_torch.configs.zamba2_1_2b",
            "repro_torch.core.shardctx", "repro_torch.launch.mesh",
            "repro_torch.launch.sharding", "repro_torch.launch.pipeline",
            "repro_torch.launch.train", "repro_torch.train.compress",
            "repro_torch.data.pipeline",
            "repro_torch.analysis", "repro_torch.analysis.__main__",
            "repro_torch.analysis.cli", "repro_torch.analysis.findings",
            "repro_torch.analysis.ast_rules",
            "repro_torch.analysis.kernel_lint",
            "repro_torch.analysis.trace_lint", "repro_torch.kernels.ref",
            "repro_torch.kernels.outputs", "repro_torch.launch.dryrun",
            "repro_torch.launch.trace_analysis"} <= names
