"""Layer 1: contracts of the traced step (RA1xx; the port's counterpart
of ``repro.analysis.jaxpr_lint``).

The reference traces its entry points to jaxprs; eager torch runs them.
This layer runs the port's real entry points at the smoke geometry under
``launch.trace_analysis.tracing`` (a dispatch mode that sees every aten
op, the backward included, and every ``torch.distributed`` call with its
stack): the lm100m analog train step on one device, the same step sharded
over a 2x2 mesh of gloo CPU ranks (four processes), and the serve decode
step, digital and analog.  The contracts:

RA101  no float64/complex128 tensor in any dispatched op.
RA102  ``split_tapes`` containment (``train.analog_lm`` step, one
       device): the differentiated tree holds tape slots only, every
       frozen container has g/ref/w_scale, and after the backward no
       conductance tensor requires grad or holds a ``.grad``.
RA103  every ``torch.distributed`` call of the exact-mode sharded step
       carries an inline ``# audit: allow RA103 -- ...`` at its source
       line.  The line is the first frame outside the transport
       (``launch.mesh.Mesh.gather_blocks`` and
       ``core.shardctx.combine_partials_exact``, which move whatever they
       are given): the use of the ordered combine, not the combine
       itself, is what is justified, so a bare gather of a conductance
       tensor (``launch.sharding.unshard``) is a finding.  The unsharded
       step and the decode steps may make no call at all.  The shard
       context's own count of gathers and received bytes
       (``core.shardctx.GATHERED``) must agree with what was recorded.
RA105  the step's count of dispatched aten ops stays under
       :data:`MAX_STEP_OPS` (measured on this tree, with the reference's
       ~1.6x headroom): per-layer unrolling or a de-fused read chain
       multiplies it.  The reference's other half, pjit-wrapped clip and
       round, has no counterpart: eager torch wraps nothing.
RA107  at batch 1, seq 4, every collective payload of the sharded step
       stays below the smallest sharded conductance block: partial sums
       scale with the tokens, conductances never move.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import List, Optional, Tuple

from .findings import Finding, relativize

#: RA105: dispatched aten ops of the lm100m smoke analog step (64x64
#: tiles, batch 2 x 16, forward, backward and writes).  Measured on this
#: tree under the default per-layer remat (``REPRO_REMAT=full``, the
#: backward's recomputed forward included): 3711 on one device, 4093 on
#: a 2x2 mesh (its block cuts, combines and rail count); 3115 and 3265
#: without remat.  The budget is about 1.3x the larger.  It exists to
#: catch per-layer unrolling (which multiplies the count by the layers)
#: and a de-fused read chain, not drift.
MAX_STEP_OPS = 5200

_SMOKE_ARCH = "lm100m"

#: Frames that only carry a collective (file, function): RA103 anchors
#: at the first frame outside them.
TRANSPORT = {("src/repro_torch/launch/mesh.py", "gather_blocks"),
             ("src/repro_torch/core/shardctx.py", "combine_partials_exact"),
             ("src/repro_torch/kernels/xbar_vmm.py", "combine")}

_HOISTED = ("g", "ref", "w_scale")
_TAPES = ("x_tape", "d_tape", "x_tape_scale", "d_tape_scale")


def _site(frames) -> Tuple[Optional[str], Optional[int]]:
    """(repo-relative file, line) of the first frame outside the
    transport, innermost first."""
    for path, line, func in frames:
        rel = relativize(path)
        if rel is not None and (rel, func) not in TRANSPORT:
            return rel, line
    return None, None


def check_no_f64(trace, entry: str) -> List[Finding]:
    """RA101 on one trace."""
    out = []
    for op, dtype, frames in trace.wide:
        f, ln = _site(frames)
        out.append(Finding("RA101", f"{op} touches {dtype} (a dtype "
                           "promotion in the traced program)",
                           file=f, line=ln, entry=entry))
    return out


def check_collectives(trace, entry: str) -> List[Finding]:
    """RA103 on one trace: every recorded collective is a finding; the
    ones whose site carries a justification are allowlisted there."""
    out = []
    for c in trace.collectives:
        f, ln = _site(c.stack)
        out.append(Finding("RA103", f"collective '{c.kind}' of "
                           f"{c.nbytes} bytes over {c.group_size} ranks",
                           file=f, line=ln, entry=entry))
    return out


def check_gathered(trace, gathered: dict, entry: str) -> List[Finding]:
    """RA103: ``core.shardctx.GATHERED``'s count of ordered gathers and
    bytes received (``gathered``, its change over the traced block)
    against the recorded ``all_gather_into_tensor`` calls."""
    calls = [c for c in trace.collectives
             if c.kind == "all_gather_into_tensor"]
    got = (len(calls), int(sum(c.link_bytes for c in calls)))
    want = (gathered["gathers"], gathered["bytes"])
    if got != want:
        return [Finding("RA103", f"recorded gathers (calls, bytes "
                        f"received) {got} disagree with core.shardctx."
                        f"GATHERED {want}", entry=entry)]
    return []


def check_op_budget(trace, entry: str, max_ops: int = MAX_STEP_OPS
                    ) -> List[Finding]:
    """RA105 on one trace."""
    if trace.n_ops > max_ops:
        return [Finding("RA105", f"step dispatched {trace.n_ops} aten ops "
                        f"(budget {max_ops}): per-layer unrolling or a "
                        "de-fused read chain?", entry=entry)]
    return []


def check_tape_containment(diff, frozen, entry: str) -> List[Finding]:
    """RA102 over the (diff, frozen) trees from ``split_tapes``."""
    findings: List[Finding] = []

    def walk_diff(p, path):
        if not isinstance(p, dict):
            return
        if "x_tape" in p or "d_tape" in p:
            leaked = sorted(set(p) - set(_TAPES))
            if leaked:
                findings.append(Finding(
                    "RA102", f"tape site {'/'.join(path)} carries non-tape "
                    f"leaves {leaked} in the differentiated tree "
                    "(conductances re-enter autograd)", entry=entry))
        elif any(k in p for k in _HOISTED):
            found = sorted(k for k in _HOISTED if k in p)
            findings.append(Finding(
                "RA102", f"{'/'.join(path)} holds {found} in the "
                "differentiated tree: split_tapes failed to hoist",
                entry=entry))
        else:
            for k, v in p.items():
                walk_diff(v, path + (k,))

    def walk_frozen(p, path):
        if not isinstance(p, dict):
            return
        if any(k in p for k in _HOISTED):
            missing = sorted(k for k in _HOISTED if k not in p)
            if missing:
                findings.append(Finding(
                    "RA102", f"frozen container {'/'.join(path)} missing "
                    f"{missing}", entry=entry))
            return
        for k, v in p.items():
            walk_frozen(v, path + (k,))

    walk_diff(diff, ())
    walk_frozen(frozen, ())
    return findings


def check_conductance_grads(frozen, entry: str) -> List[Finding]:
    """RA102 after the backward: no conductance tensor of the frozen tree
    requires grad or holds a ``.grad``."""
    findings: List[Finding] = []

    def walk(p, path):
        if not isinstance(p, dict):
            return
        if any(k in p for k in _HOISTED):
            for k in (*_HOISTED, "g_carry"):
                t = p.get(k)
                if getattr(t, "requires_grad", False) \
                        or getattr(t, "grad", None) is not None:
                    findings.append(Finding(
                        "RA102", f"{'/'.join(path + (k,))} requires grad "
                        "or holds a .grad (a conductance in autograd)",
                        entry=entry))
            return
        for k, v in p.items():
            walk(v, path + (k,))
    walk(frozen, ())
    return findings


def check_parameter_sized_collectives(trace, min_param_bytes: int,
                                      entry: str) -> List[Finding]:
    """RA107 on one trace: no collective's payload reaches the smallest
    sharded conductance block."""
    out = []
    for kind, nbytes in trace.collective_payloads():
        if nbytes >= min_param_bytes:
            out.append(Finding(
                "RA107", f"the exact-mode sharded step moves a "
                f"parameter-sized collective: {kind} of {nbytes} bytes "
                f"(smallest sharded conductance block: {min_param_bytes} "
                "bytes)", entry=entry))
    return out


# --------------------------------------------------------------------------
# Entries
# --------------------------------------------------------------------------

def _analog_cfg(arch: str = _SMOKE_ARCH):
    from repro_torch.configs.registry import get_config
    return get_config(arch, smoke=True).replace(
        dtype="float32", analog=True, analog_mode="device",
        analog_device="taox", analog_rows=64, analog_cols=64)


def _batch(cfg, batch: int = 2, seq: int = 16):
    import torch
    gen = torch.Generator().manual_seed(0)
    return {k: torch.randint(0, cfg.vocab, (batch, seq), generator=gen)
            for k in ("tokens", "labels")}


class _Splits:
    """Records every ``split_tapes`` result of the analog step."""

    def __init__(self):
        self.seen = []

    def __enter__(self):
        from repro_torch.train import analog_lm as TA
        self._real = TA.split_tapes

        def record(*a, **kw):
            out = self._real(*a, **kw)
            self.seen.append(out)
            return out
        TA.split_tapes = record
        return self

    def __exit__(self, *exc):
        from repro_torch.train import analog_lm as TA
        TA.split_tapes = self._real


def _audit_unsharded_step(arch: str) -> List[Finding]:
    from repro_torch.launch.trace_analysis import tracing
    from repro_torch.train import analog_lm as TA

    entry = f"train_step[{arch},exact,unsharded]"
    cfg = _analog_cfg(arch)
    step = TA.AnalogTrainStep(cfg, lr=1e-3)
    state = TA.init_state(0, cfg, device="cpu")
    with _Splits() as splits, tracing() as trace:
        step(state, _batch(cfg), 1234)
    findings = check_no_f64(trace, entry)
    findings += check_collectives(trace, entry)
    findings += check_op_budget(trace, entry)
    for diff, frozen in splits.seen:
        findings += check_tape_containment(diff, frozen, entry)
        findings += check_conductance_grads(frozen, entry)
    if not splits.seen:
        findings.append(Finding("RA102", "the step never split its tree "
                                "(split_tapes not reached)", entry=entry))
    return findings


def _sharded_rank(rank: int, world: int, shape, arch: str, rdv: str,
                  out_dir: str) -> None:
    """One gloo rank of the 2x2 audit: the exact-mode sharded step at
    batch 2 x 16 (RA101, RA103, RA105) and at 1 x 4 (RA107)."""
    import torch

    torch.set_num_threads(1)
    from repro_torch.core import shardctx
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.launch.trace_analysis import tracing
    from repro_torch.train import analog_lm as TA

    init_distributed("cpu", f"file://{rdv}", rank, world)
    try:
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        shardctx.set_shard_context(mesh, None)
        cfg = _analog_cfg(arch)
        tag = "x".join(map(str, shape))
        step = TA.AnalogTrainStep(cfg, lr=1e-3, mesh=mesh)
        state = step.shard_state(TA.init_state(0, cfg, device="cpu"))
        entry = f"train_step[{arch},exact,{tag}]"
        before = {k: shardctx.GATHERED[k] for k in ("gathers", "bytes")}
        with tracing() as trace:
            state, _ = step(state, _batch(cfg), 1234)
        gathered = {k: shardctx.GATHERED[k] - before[k] for k in before}
        findings = check_no_f64(trace, entry)
        findings += check_collectives(trace, entry)
        findings += check_gathered(trace, gathered, entry)
        findings += check_op_budget(trace, entry)
        with tracing() as small:
            step(state, _batch(cfg, 1, 4), 1235)
        blocks = []
        for spec, gshape in step._cspecs.values():
            shards = 1
            for names in spec["g"]:
                for a in names or ():
                    shards *= mesh.shape[a]
            if shards > 1:
                n = 1
                for d in gshape:
                    n *= d
                blocks.append(n * 4 // shards)
        small_entry = f"train_step[{arch},exact,{tag},b1s4]"
        if blocks:
            findings += check_parameter_sized_collectives(
                small, min(blocks), small_entry)
        else:
            findings.append(Finding("RA107", "no container is sharded at "
                                    "this geometry: nothing to bound",
                                    entry=small_entry))
        summary = {"ops": trace.n_ops, "collectives": len(trace.collectives),
                   "min_block_bytes": min(blocks, default=0),
                   "max_payload_bytes": max(
                       (n for _, n in small.collective_payloads()),
                       default=0)}
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump({"findings": [x.__dict__ for x in findings],
                       "summary": summary}, f)
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()


def audit_sharded_step(arch: str = _SMOKE_ARCH, shape=(2, 2),
                       summary: Optional[dict] = None) -> List[Finding]:
    """The exact-mode sharded step on a ``shape`` mesh of gloo CPU ranks
    (one process each): every rank's findings, deduplicated.  ``summary``
    (a dict) receives each rank's figures by rank: dispatched ops,
    collectives, the smallest sharded block and the largest payload at
    batch 1 x 4."""
    import torch.multiprocessing as mp

    world = shape[0] * shape[1]
    tmp = tempfile.mkdtemp(prefix="trace_lint_")
    try:
        mp.spawn(_sharded_rank, args=(world, tuple(shape), arch,
                                      os.path.join(tmp, "rdv"), tmp),
                 nprocs=world, join=True)
        findings = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                got = json.load(f)
            findings += [Finding(**d) for d in got["findings"]]
            if summary is not None:
                summary[r] = got["summary"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return list(dict.fromkeys(findings))


def _decode_entry(cfg, params, entry: str) -> List[Finding]:
    import numpy as np
    import torch

    from repro_torch.launch.trace_analysis import tracing
    from repro_torch.serve.engine import ContinuousEngine

    eng = ContinuousEngine(cfg, params, n_slots=2, max_len=64,
                           prefill_chunk=16)
    tok = torch.zeros((2,), dtype=torch.long)
    with tracing() as trace:
        eng._decode(tok, np.zeros((2,), np.float32))
    return check_no_f64(trace, entry) + check_collectives(trace, entry)


def _audit_serve_decode(arch: str) -> List[Finding]:
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M

    cfg = get_config(arch, smoke=True)
    return _decode_entry(cfg, M.init_params(cfg, 0, "cpu"),
                         f"serve_decode[{arch}]")


def _audit_analog_serve_decode(arch: str) -> List[Finding]:
    """The analog backend's decode step: containers programmed from
    digital weights, read by the plain read on the CPU."""
    from repro_torch.models import model as M

    cfg = _analog_cfg(arch).replace(analog_device="taox-nonoise")
    params = M.program_digital(M.init_params(cfg.digital(), 0, "cpu"), cfg)
    return _decode_entry(cfg, params, f"serve_decode[{arch},analog]")


def audit_trace(arch: str = _SMOKE_ARCH,
                summary: Optional[dict] = None) -> List[Finding]:
    """Layer 1 over the real entry points, the sharded step on a 2x2 gloo
    mesh among them (its ranks' figures into ``summary``)."""
    findings: List[Finding] = []
    for entry, audit in (
            ("train_step", _audit_unsharded_step),
            ("serve_decode", _audit_serve_decode),
            ("serve_decode[analog]", _audit_analog_serve_decode),
            ("train_step[2x2]",
             lambda a: audit_sharded_step(a, summary=summary))):
        try:
            findings += audit(arch)
        except Exception as e:   # noqa: BLE001 - a failed trace is a finding
            findings.append(Finding(
                "RA101", f"tracing failed: {type(e).__name__}: {e}",
                entry=entry))
    return findings
