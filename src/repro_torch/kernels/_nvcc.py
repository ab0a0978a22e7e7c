"""Build of the port's CUDA sources: ``nvcc`` into one shared library per
source, with a plain C interface loaded by ``ctypes``.

Each ``csrc/*.cu`` is compiled at first use into ``build/repro_torch/`` at
the repository root (gitignored), once per source content and flags.
:func:`build` starts one ``nvcc`` per source that is not built yet, all
together, and waits for them, so building every kernel costs one
compile's time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Compiler output of each build (``-Xptxas -v``: registers, spills), by
#: source file name.
BUILD_LOGS: Dict[str, str] = {}
_libs: Dict[Path, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           f"{CSRC} on a machine with the CUDA toolkit")
    return nvcc


def library_path(source: Path) -> Path:
    digest = hashlib.sha1(source.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{source.stem}_{digest}.so"


def build(sources: Iterable[Path]) -> Dict[Path, Path]:
    """Compile every source that is not built yet, in parallel; return
    each source's shared-library path."""
    out = {Path(s): library_path(Path(s)) for s in sources}
    todo = {s: p for s, p in out.items() if not p.exists()}
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for src, lib in todo.items():
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs[src] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for src, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[src.name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src}:\n{log}")
        else:
            os.replace(tmp, todo[src])
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(source: Path) -> ctypes.CDLL:
    """The built library of ``source`` (built first if need be)."""
    path = build([source])[source]
    if path not in _libs:
        _libs[path] = ctypes.CDLL(str(path))
    return _libs[path]
