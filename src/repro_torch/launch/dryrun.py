"""Dry run: reckon every (arch x shape x mesh) cell without a card and
without processes (the port's counterpart of ``repro.launch.dryrun``).

For each cell the dry run builds the cell's state, batch and cache on the
``meta`` device (``train_loop.abstract_state``, ``models.model.
input_specs`` / ``cache_specs``: shapes and dtypes, nothing allocated),
takes one rank's view of the mesh (``launch.mesh.Mesh(shape, axes,
coords)``: the production meshes need 256 or 512 ranks, which
``make_production_mesh`` rightly refuses here) and records

  * ``mem``: the bytes one rank holds, as the port holds them: in a
    training cell on a mesh of several ranks its block of every numeric
    leaf and of adamw's ``m`` and ``v`` (``launch.sharding.state_specs``;
    a fused ``wqkv``'s k and v cut by columns where the kv heads do not
    divide over ``model``; the SSD layers' ``in_proj`` B, C and dt whole
    on every ``model`` rank), whole on one rank; in the serving cells of
    the dense, SSM and hybrid families on a mesh of several ranks its
    serving blocks (``launch.sharding.ServeParallel``: the parameters'
    blocks as in training; the cache's block, split by kv heads or along
    the sequence, the SSD state by heads and the conv state by the
    channels the rank's conv reads), and the whole model on every rank in
    the MoE and cross-attention families' serving cells; the batch and
    the cache at this rank's share of the batch (over the data axes where
    they divide it).  Beside it, ``policy_argument_gb`` is what the
    sharding policy (``launch.sharding.params_shardings`` /
    ``cache_shardings``, each leaf's block by ``block_slices``) gives the
    rank, ``replicated_by_port_gb`` the difference, what the port holds
    beyond the policy, and ``replicated_by_port_leaves`` the leaves that
    make it up, by path (the SSM family's ``in_proj`` B, C and dt and its
    conv state's B and C channels, whole on every ``model`` rank where
    the groups do not divide).
    ``temp_gb`` is the step's peak of live bytes it allocates and
    ``fits_h100`` compares arguments plus temporaries with the H100's 80
    GB;
  * ``remat``: the per-layer remat policy the step ran under
    (``models.transformer.remat_policy``, ``REPRO_REMAT``: ``full`` by
    default, as in the reference; ``--remat none,full`` runs each cell
    under each);
  * ``trace``: the local step's FLOPs, bytes moved and peak, counted by
    ``launch.trace_analysis`` over the step as it runs on ``meta``
    tensors (the train step of ``train_loop.make_train_step`` with
    ``adamw``, ``prefill`` or one ``decode_step`` against a ``seq_len``
    cache, under the policy where the cell holds its blocks;
    ``REPRO_ANALOG=1`` puts every projection through the
    fakequant read, as the reference's flag does), and the collective
    link-bytes the port's own step sends (the ``torch.distributed``
    calls of :class:`DryMesh`, whose groups are their sizes, recorded
    and not made by ``launch.trace_analysis.tracing(dry=True)``): a
    training step on several
    ranks is the FSDP / tensor-parallel step of ``train_loop.
    make_train_step(mesh=)``, its layers' gathers, their backward
    ``reduce_scatter``s and the tensor-parallel sums (among them the SSD
    layers' gathers of the gated norm's input; ``numeric`` holds the
    step's ``NumericParallel.counts``: its layer gathers and
    ``norm_gather_bytes``, that gather's bytes a step, and ``seq``, whether
    the step ran sequence parallel under ``REPRO_SEQ_SHARD``: its
    activations between blocks then are this rank's chunk of the sequence
    in the trace too, the dry mesh's gathers and reduce-scatters giving
    their outputs the collectives' shapes); a MoE layer's
    temporaries are this rank's: its rows of the global dispatch's
    buffer and, under expert parallelism, its own experts' alone.  On
    the card a data rank's buffer holds as many rows an expert as its
    most kept pairs of one, which meta tensors cannot know: the dry run
    takes their bound, ``min(capacity, local tokens)``, and over-reckons
    the buffers (the balanced load is ``capacity / data ranks``).  The exact-mode
    combines of the sharded analog step apply only to device-mode
    training, which no cell of this grid runs.

On ``meta`` tensors the kernels' plain versions run in their place (the
fakequant read under ``REPRO_ANALOG``): the FLOPs are the function's,
the temporaries the plain version's, not the kernel's scratch.  Autograd
saves what it saves on the card: the fakequant read keeps the card's
``kernels.ops.FakequantRead`` on meta tensors.  The
model's attention is the plain softmax attention of ``models.layers`` on
the card too, so its score matrices are the program's own.  A cell that
fails records its error and the sweep goes on.

    python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--mesh 1x1,4x1] \\
        [--remat none,full] [--out results/dryrun] [--table]

Nothing is written unless ``--out`` is given.
"""
from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import math
import os
import time
import traceback
from pathlib import Path
from typing import Dict, Optional

import torch

from repro_torch.configs import (ASSIGNED, SHAPE_BY_NAME, ShapeSpec,
                                 applicable_shapes, get_config)
from repro_torch.launch import sharding
from repro_torch.launch.mesh import PRODUCTION_SHAPES, Mesh, dp_axes
from repro_torch.launch.trace_analysis import tracing
from repro_torch.models import model as M
from repro_torch.models.transformer import remat_policy
from repro_torch.train import train_loop
from repro_torch.train.optimizer import adamw

#: The meshes of the sweep: the reference's two production meshes and
#: the layouts of this port's machines (one card; four cards, data
#: parallel, data x model, or model parallel: tensor and expert
#: parallelism).
MESHES = {"16x16": PRODUCTION_SHAPES[False],
          "2x16x16": PRODUCTION_SHAPES[True],
          "1x1": ((1, 1), ("data", "model")),
          "4x1": ((4, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model"))}
H100_GB = 80.0


class DryMesh(Mesh):
    """One rank's view of a mesh without processes: an axis's group is
    its size, which ``tracing(dry=True)`` records as the collective's
    group (the call is not made)."""

    def group(self, axis: str) -> int:
        return self.shape[axis]


def make_mesh(name: str) -> Mesh:
    """Rank 0's view of mesh ``name`` (no processes; its collectives are
    recorded, not made)."""
    shape, axes = MESHES[name]
    return DryMesh(shape, axes, coords=(0,) * len(shape))


def dp_size(mesh: Mesh) -> int:
    return math.prod(mesh.shape[a] for a in dp_axes(mesh))


def local_batch(global_batch: int, mesh: Mesh) -> int:
    """This rank's share of the batch: split over the data axes where
    they divide it, else whole (``sharding.batch_shardings``' rule)."""
    dp = dp_size(mesh)
    return global_batch // dp if global_batch % dp == 0 else global_batch


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for _, t in M._leaves(tree))


def block_bytes(tree, specs, mesh: Mesh) -> int:
    """Bytes of this rank's blocks of ``tree`` under ``specs``."""
    total = 0
    for path, t in M._leaves(tree):
        spec = specs
        for k in path:
            spec = spec[k if isinstance(spec, dict) else int(k)]
        n = 1
        for size, sl in zip(t.shape, sharding.block_slices(t.shape, spec,
                                                            mesh)):
            n *= len(range(*sl.indices(size)))
        total += n * t.element_size()
    return total


def leaf_excess(held_tree, whole_tree, specs, mesh: Mesh, prefix: str
                ) -> Dict[str, int]:
    """The bytes each leaf of ``held_tree`` (this rank's) holds beyond its
    policy block of the same leaf of ``whole_tree`` under ``specs``, by
    ``prefix/path``, for the leaves where they differ."""
    held = dict(M._leaves(held_tree))
    out = {}
    for path, t in M._leaves(whole_tree):
        spec = specs
        for k in path:
            spec = spec[k if isinstance(spec, dict) else int(k)]
        pol = block_bytes(t, spec, mesh)
        mine = held[path].numel() * held[path].element_size()
        if mine != pol:
            out["/".join([prefix, *map(str, path)])] = mine - pol
    return out


def serving_state(cfg, shape: ShapeSpec, mesh: Mesh):
    """A serving cell's parameters and (a decode cell) cache as this rank
    of ``mesh`` holds them, on the ``meta`` device: ``(params, cache,
    kw, bytes)``, ``kw`` the serving functions' ``mesh`` keyword (empty
    where the cell holds the whole model) and ``bytes`` this rank's
    ``held`` and ``policy`` bytes by key (``params``, ``cache``) and the
    ``excess`` by leaf (:func:`leaf_excess`)."""
    whole = M.init_params(cfg, None, device="meta")
    specs = sharding.params_shardings(whole, cfg, mesh)
    sharded = mesh.size > 1 and cfg.family in sharding.ServeParallel.FAMILIES
    kw = {"mesh": mesh} if sharded else {}
    params = sharding.serve_parallel(cfg, mesh).shard_params(whole) \
        if kw else whole
    out = {"held": {"params": tree_bytes(params)},
           "policy": {"params": block_bytes(whole, specs, mesh)},
           "excess": leaf_excess(params, whole, specs, mesh, "params")}
    cache = None
    if shape.kind == "decode":
        cache = M.cache_specs(cfg, local_batch(shape.global_batch, mesh),
                              shape.seq_len, **kw)
        whole = M.cache_specs(cfg, shape.global_batch, shape.seq_len)
        cspecs = sharding.cache_shardings(whole, cfg, mesh)
        out["held"]["cache"] = tree_bytes(cache)
        out["policy"]["cache"] = block_bytes(whole, cspecs, mesh)
        out["excess"].update(leaf_excess(cache, whole, cspecs, mesh,
                                         "cache"))
    return params, cache, kw, out


def reckon(cfg, shape: ShapeSpec, mesh: Mesh) -> dict:
    """The memory and trace record of one cell on one rank of ``mesh``
    (see the module docstring)."""
    b = local_batch(shape.global_batch, mesh)
    dp = dp_size(mesh)
    batch = M.input_specs(cfg, shape, batch=b)
    held: Dict[str, int] = {"batch": tree_bytes(batch)}
    policy: Dict[str, int] = {"batch": held["batch"]}
    excess: Dict[str, int] = {}
    if shape.kind == "train":
        opt = adamw(3e-4)
        whole = train_loop.abstract_state(cfg, opt)
        params = whole["params"]
        sharded = mesh.size > 1
        state = train_loop.shard_state(whole, cfg, mesh) if sharded \
            else whole
        step = train_loop.make_train_step(cfg, opt,
                                          mesh=mesh if sharded else None)
        with tracing(dry=True, group_size=dp) as trace:
            step(state, batch)
        held["params"] = tree_bytes(state["params"])
        held["opt"] = tree_bytes(state["opt"]) + tree_bytes(state["step"])
        specs = sharding.params_shardings(params, cfg, mesh)
        policy["params"] = block_bytes(params, specs, mesh)
        excess.update(leaf_excess(state["params"], params, specs, mesh,
                                  "params"))
        policy["opt"] = 2 * block_bytes(whole["opt"]["m"],
                                        sharding.params_shardings(
                                            whole["opt"]["m"], cfg, mesh),
                                        mesh) \
            + tree_bytes(whole["opt"]["t"]) + tree_bytes(whole["step"])
    else:
        params, cache, kw, served = serving_state(cfg, shape, mesh)
        held.update(served["held"])
        policy.update(served["policy"])
        excess.update(served["excess"])
        with torch.no_grad(), tracing(dry=True, group_size=dp) as trace:
            if shape.kind == "prefill":     # its cache is an output
                M.prefill(params, batch, cfg, max_len=shape.seq_len, **kw)
            else:
                extras = {k: v for k, v in batch.items() if k != "tokens"}
                M.decode_step(params, cache, batch["tokens"], cfg,
                              batch_extras=extras or None, **kw)
    gb = 1e9
    arg = sum(held.values())
    temp = trace.peak_bytes
    numeric = {}
    if shape.kind == "train" and step.numeric is not None:
        numeric = dict(step.numeric.counts, seq=step.numeric.sp_on)
    return {
        "devices": mesh.size,
        "local_batch": b,
        "mem": {
            "argument_gb": arg / gb,
            **{f"{k}_gb": v / gb for k, v in held.items()},
            "temp_gb": temp / gb,
            "total_gb": (arg + temp) / gb,
            "fits_h100": (arg + temp) / gb < H100_GB,
            "hbm_gb": H100_GB,
            "policy_argument_gb": sum(policy.values()) / gb,
            "replicated_by_port_gb": (arg - sum(policy.values())) / gb,
            "replicated_by_port": {k: (held[k] - policy[k]) / gb
                                   for k in held},
            "replicated_by_port_leaves": {k: v / gb
                                          for k, v in excess.items()},
        },
        "trace": trace.summary(),
        "numeric": numeric,
        "argument_bytes": arg,
    }


def run_cell(arch: str, shape_name: str, mesh_name: str,
             smoke: bool = False) -> dict:
    t0 = time.time()
    cfg = get_config(arch, smoke=smoke)
    if os.environ.get("REPRO_SSM_CHUNK"):  # the SSD chunk length
        cfg = cfg.replace(ssm_chunk=int(os.environ["REPRO_SSM_CHUNK"]))
    if os.environ.get("REPRO_ANALOG"):     # the fakequant projections
        cfg = cfg.replace(analog=True)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "remat": remat_policy(), "ok": False}
    try:
        shape = SHAPE_BY_NAME[shape_name]
        rec["kind"] = shape.kind
        rec.update(reckon(cfg, shape, make_mesh(mesh_name)))
        rec["model"] = {"params": cfg.param_count(),
                        "params_active": cfg.param_count(active_only=True),
                        "seq_len": shape.seq_len,
                        "global_batch": shape.global_batch}
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 - the sweep survives a bad cell
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["total_s"] = round(time.time() - t0, 1)
    return rec


def cells(arch: Optional[str] = None, shape: Optional[str] = None):
    """Every assigned (arch, shape) cell, or the one named."""
    if arch is not None:
        return [(arch, shape)]
    return [(a, s.name) for a in ASSIGNED
            for s in applicable_shapes(get_config(a))]


def table(recs) -> str:
    """Markdown table of per-device gigabytes, one row per cell: for each
    mesh the replicated gigabytes, then for each (mesh, remat policy) the
    total (arguments + temporaries) and whether it fits."""
    meshes = sorted({r["mesh"] for r in recs}, key=list(MESHES).index)
    remats = list(dict.fromkeys(r["remat"] for r in recs))
    by = {(r["arch"], r["shape"], r["mesh"], r["remat"]): r for r in recs}
    groups = [(m, p) for m in meshes for p in remats]
    head = "| arch | shape | " + " | ".join(
        f"{m} replicated GB" for m in meshes) + " | " + " | ".join(
        f"{m} {p}: total GB (args + temp), fits" for m, p in groups) + " |"
    lines = [head, "|" + "---|" * (2 + len(meshes) + len(groups))]
    for a, s in dict.fromkeys((r["arch"], r["shape"]) for r in recs):
        mems = {g: by[(a, s, *g)]["mem"] for g in groups
                if (a, s, *g) in by and by[(a, s, *g)]["ok"]}
        row = [a, s]
        for m in meshes:    # the same under every policy
            mem = next((v for (mm, _), v in mems.items() if mm == m), None)
            row.append("error" if mem is None
                       else f"{mem['replicated_by_port_gb']:.1f}")
        for g in groups:
            mem = mems.get(g)
            row.append("error" if mem is None else
                       f"{mem['total_gb']:.1f} ({mem['argument_gb']:.1f} + "
                       f"{mem['temp_gb']:.1f}), "
                       + ("yes" if mem["fits_h100"] else "no"))
        lines.append("| " + " | ".join(row) + " |")
    return "\n".join(lines)


@contextlib.contextmanager
def _remat_env(policy: Optional[str]):
    """``REPRO_REMAT=policy`` for the block (``None``: as it is)."""
    prev = os.environ.get("REPRO_REMAT")
    if policy is not None:
        os.environ["REPRO_REMAT"] = policy
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("REPRO_REMAT", None)
        else:
            os.environ["REPRO_REMAT"] = prev


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default=",".join(MESHES),
                    help=f"comma-separated, of {', '.join(MESHES)}")
    ap.add_argument("--remat", default=None,
                    help="comma-separated REPRO_REMAT policies (none, dots, "
                    "full) to run each cell under; default the "
                    "environment's")
    ap.add_argument("--smoke", action="store_true", help="reduced configs")
    ap.add_argument("--out", default=None,
                    help="write one JSON record per cell here")
    ap.add_argument("--table", action="store_true",
                    help="print the per-device GB table at the end")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --all, or --arch and --shape")
    out_dir = Path(args.out) if args.out else None
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
    recs = []
    for arch, shape_name in cells(None if args.all else args.arch,
                                  args.shape):
        for mesh_name, policy in itertools.product(
                args.mesh.split(","),
                args.remat.split(",") if args.remat else [None]):
            with _remat_env(policy):
                rec = run_cell(arch, shape_name, mesh_name, smoke=args.smoke)
            recs.append(rec)
            tag = f"{arch}__{shape_name}__{mesh_name}__{rec['remat']}"
            if out_dir is not None:
                (out_dir / f"{tag}.json").write_text(json.dumps(rec,
                                                                indent=1))
            if rec["ok"]:
                m = rec["mem"]
                status = (f"ok, {m['total_gb']:.2f} GB a device "
                          f"({m['argument_gb']:.2f} held, "
                          f"{m['replicated_by_port_gb']:.2f} replicated by "
                          f"the port), {rec['trace']['flops']:.3e} FLOPs")
                if rec["numeric"].get("seq"):
                    status += ", the sequence split over model"
                if rec["numeric"].get("norm_gather_bytes"):
                    status += (", SSD norm gathers "
                               f"{rec['numeric']['norm_gather_bytes'] / 1e9:.2f}"
                               " GB a step")
            else:
                status = f"FAIL ({rec['error']})"
            print(f"[done] {tag}: {status} in {rec['total_s']}s",
                  flush=True)
    if args.table:
        print(table(recs))
    return recs


if __name__ == "__main__":
    main()
