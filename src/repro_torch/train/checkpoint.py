"""Checkpoint manager: atomic save/restore, keep-N, train -> serve handoff
(port of ``repro.train.checkpoint``).

Layout (one directory per step), the reference's:

    <dir>/step_00000100/
        meta.json        — step, tree structure, leaf shapes/dtypes
        arrays.npz       — leaves keyed by their "/"-joined tree path
    <dir>/step_00000100.COMMITTED   — commit marker

Writes go to ``step_xxx.tmp`` and are renamed into place, then the commit
marker is written: a crash leaves either a committed checkpoint or junk
that ``latest_step`` ignores and ``save`` sweeps.  The leaf keys are the
reference's (dict keys and tuple indices joined by "/"), so a checkpoint
written by either package restores into the other.  ``meta.json``'s
``treedef`` is this package's own description of the structure; restore
goes by the ``like`` tree, as the reference's does.

A state held in blocks over a mesh (the FSDP / tensor-parallel numeric
step) is saved whole: ``save(..., gather=)`` makes each leaf whole in
turn (every rank takes part in its gathers, rank 0 writes), and
``restore(..., cut=)`` cuts each whole leaf into this rank's block, on
any mesh.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import AnalogMode, resolve_analog_mode
from repro_torch.core.tiled_analog import pop_tapes


def _leaves(tree, path=()):
    """(key, leaf) pairs of a tree of dicts and tuples, dict keys sorted
    as the reference's flattening orders them."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    elif tree is not None:
        yield "/".join(path), tree


def _treedef(tree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, tuple):
        return "(" + ", ".join(_treedef(v) for v in tree) + ")"
    return "None" if tree is None else "*"


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str | Path, state: Any, step: int,
         keep_n: int = 3, gather=None, write: bool = True
         ) -> Optional[Path]:
    """Write ``state`` (a tree of dicts and tuples of tensors and numbers)
    as step ``step``; keep the newest ``keep_n`` committed steps.
    ``gather(path, leaf)`` makes a block-held leaf whole (``path`` its
    key tuple), one leaf at a time; with ``write`` False (every rank but
    the one that writes) the gathers run and nothing is written."""
    if gather is not None:
        flat = {}
        for key, leaf in _leaves(state):
            whole = gather(tuple(key.split("/")), leaf)
            if write:
                flat[key] = _to_numpy(whole)
            del whole
        if not write:
            return None
        return _write(ckpt_dir, state, step, keep_n, flat)
    return _write(ckpt_dir, state, step, keep_n,
                  {k: _to_numpy(v) for k, v in _leaves(state)})


def _write(ckpt_dir, state, step: int, keep_n: int, flat: dict) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    name = f"step_{step:08d}"
    tmp = ckpt_dir / (name + ".tmp")
    final = ckpt_dir / name
    marker = ckpt_dir / (name + ".COMMITTED")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    np.savez(tmp / "arrays.npz", **flat)
    meta = {
        "step": step,
        "treedef": _treedef(state),
        "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                   for k, v in flat.items()},
    }
    (tmp / "meta.json").write_text(json.dumps(meta))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    marker.write_text("ok")

    steps = sorted(committed_steps(ckpt_dir))
    for old in steps[:-keep_n]:
        old_name = f"step_{old:08d}"
        shutil.rmtree(ckpt_dir / old_name, ignore_errors=True)
        (ckpt_dir / (old_name + ".COMMITTED")).unlink(missing_ok=True)
    for junk in ckpt_dir.glob("*.tmp"):
        shutil.rmtree(junk, ignore_errors=True)
    return final


def committed_steps(ckpt_dir: str | Path):
    ckpt_dir = Path(ckpt_dir)
    out = []
    for marker in ckpt_dir.glob("step_*.COMMITTED"):
        name = marker.name[: -len(".COMMITTED")]
        if (ckpt_dir / name / "arrays.npz").exists():
            out.append(int(name.split("_")[1]))
    return sorted(out)


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    steps = committed_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str | Path, like: Any, step: Optional[int] = None,
            device=None, cut=None) -> Any:
    """Restore into the structure of ``like`` (a tree of tensors, meta
    tensors included, and numbers): each tensor leaf takes ``like``'s
    dtype and lands on ``device`` (default: the leaf's own device; a meta
    leaf needs ``device``); a number leaf stays a number of its type.
    ``cut(path, whole)`` gives this rank's block of a whole leaf (a
    block-held ``like``)."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    data = np.load(ckpt_dir / f"step_{step:08d}" / "arrays.npz")

    def build(leaf, path):
        if isinstance(leaf, dict):
            return {k: build(v, path + (str(k),)) for k, v in leaf.items()}
        if isinstance(leaf, tuple):
            return tuple(build(v, path + (str(i),))
                         for i, v in enumerate(leaf))
        if leaf is None:
            return None
        arr = data["/".join(path)]
        if not isinstance(leaf, torch.Tensor):
            return type(leaf)(arr)
        where = device if device is not None else leaf.device
        if torch.device(where).type == "meta":
            raise ValueError("restoring into meta tensors needs device=")
        whole = torch.from_numpy(np.array(arr)).to(dtype=leaf.dtype,
                                                   device=where)
        return whole if cut is None else cut(path, whole)
    return build(like, ())


# ---------------------------------------------------------------------------
# Train -> serve handoff
# ---------------------------------------------------------------------------

def to_serve_state(state: Any, cfg, *, backend: Optional[str] = None,
                   retention=None):
    """A training state (``{"params", "step", ...}``) or a bare parameter
    tree as a :class:`~repro_torch.serve.state.ServeState`: per-step tape
    leaves are stripped (serving runs no backward), and the factory takes
    the containers' programming targets and zeroed drift counters."""
    from repro_torch.serve.state import make_serve_state
    params = state["params"] if isinstance(state, dict) \
        and "params" in state else state
    params, _, _ = pop_tapes(params)
    return make_serve_state(cfg, params, backend=backend,
                            retention=retention)


def from_checkpoint(ckpt_dir: str | Path, cfg, *,
                    step: Optional[int] = None,
                    backend: Optional[str] = None, retention=None,
                    device="cuda"):
    """Restore the latest (or ``step``'s) committed training checkpoint
    straight into a ServeState on ``device``, ready for
    ``serve.make_engine``.  Device-mode configs restore the analog
    training state ``{"params", "step"}``, the others a parameter tree;
    the template is built on the meta device (shapes only)."""
    from repro_torch.models import model as M
    if resolve_analog_mode(cfg) is AnalogMode.DEVICE:
        from repro_torch.train.analog_lm import init_state
        like = init_state(torch.Generator(), cfg, device="meta")
    else:
        like = M.init_params(cfg, torch.Generator(), device="meta")
    state = restore(ckpt_dir, like, step=step, device=device)
    return to_serve_state(state, cfg, backend=backend, retention=retention)
