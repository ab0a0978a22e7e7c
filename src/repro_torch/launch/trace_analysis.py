"""Roofline terms of the program that actually runs (the port's
counterpart of ``repro.launch.hlo_analysis``).

The reference parses compiled HLO text; eager torch has none.  Here the
step itself is recorded: :func:`tracing` installs a
``TorchDispatchMode`` that sees every aten op the step dispatches, its
backward included, on real tensors or on ``meta`` tensors (shapes and
dtypes only: the dry run).  Per traced block it counts

  * FLOPs, as ``torch.utils.flop_counter`` counts them (its formula per
    op: matmuls, batched matmuls, convolutions, attention);
  * bytes moved: each op's tensor inputs and outputs, once each (an
    expanded input at its storage's size).  Views and other aliasing ops
    (``view``, ``transpose``, ``expand``, ``detach``, ...) move nothing
    and are excluded, as ``hlo_analysis`` excludes aliasing instructions;
    so are the allocators of uninitialised memory (``empty``);
  * the peak of live tensor bytes the block allocated (a storage counts
    from the op that creates it until it is freed; the arguments the
    block was given do not count, its outputs do while they live);
  * the collectives, recorded at the ``torch.distributed`` calls (each
    one's kind, operand bytes, group size and call stack): the
    counterparts of ``count_collectives``, ``collective_byte_volume`` and
    ``collective_payloads``, and link bytes with ring factors.

On ``meta`` tensors a data-dependent op has no shape rule; the ones the
port calls get one here (``bincount`` with ``minlength``: the expert
counts of the MoE dispatch, whose ids are all below it).

The plain versions stand in for the kernels on ``meta`` and CPU tensors:
their FLOPs are the function's, but their temporaries (a padded
conductance difference, the fakequant read's per-tile products) are the
plain version's, not the kernel's scratch.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import sys
import weakref
from typing import Dict, List, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

aten = torch.ops.aten

#: Ops that move no bytes: allocators of uninitialised memory and views
#: whose schema does not say so.
_NO_TRAFFIC = {aten.empty.memory_format, aten.empty_like.default,
               aten.empty_strided.default, aten.new_empty.default,
               aten.new_empty_strided.default, aten._unsafe_view.default,
               aten.lift_fresh.default, aten.detach.default,
               aten.alias.default}

#: The ``torch.distributed`` calls recorded, and the argument holding
#: each one's operand (what this rank contributes).
COLLECTIVES = {"all_reduce": 0, "all_gather": 1,
               "all_gather_into_tensor": 1, "reduce_scatter_tensor": 1,
               "broadcast": 0, "all_to_all_single": 1}

#: The repository's root (frames under it are the program's own).
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))


def _flop_registry() -> dict:
    from torch.utils import flop_counter
    reg = getattr(flop_counter, "flop_registry", None)
    return reg if reg is not None else flop_counter.FlopCounterMode(
        display=False).flop_registry


def _aliasing(func) -> bool:
    if func in _NO_TRAFFIC:
        return True
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def _nbytes(t: torch.Tensor) -> int:
    """Bytes of a tensor as an op reads or writes it: its elements, or its
    storage where that is smaller (an expanded view)."""
    n = t.numel() * t.element_size()
    try:
        return min(n, t.untyped_storage().nbytes())
    except (RuntimeError, NotImplementedError):
        return n


@dataclasses.dataclass
class Collective:
    """One recorded ``torch.distributed`` call."""
    kind: str
    nbytes: int                 # operand bytes this rank contributes
    group_size: int
    stack: Tuple[Tuple[str, int, str], ...]   # repo frames, innermost first

    @property
    def link_bytes(self) -> float:
        """Bytes this rank sends over the links, with ring factors:
        all-reduce 2(n-1)/n, reduce-scatter and all-to-all (n-1)/n of the
        operand, all-gather (n-1) operands (the bytes it receives), a
        broadcast its operand."""
        n = self.group_size
        if n <= 1:
            return 0.0
        return self.nbytes * {"all_reduce": 2 * (n - 1) / n,
                              "all_gather": n - 1.0,
                              "all_gather_into_tensor": n - 1.0,
                              "reduce_scatter_tensor": (n - 1) / n,
                              "all_to_all_single": (n - 1) / n,
                              "broadcast": 1.0}[self.kind]


@dataclasses.dataclass
class Trace:
    """What one traced block dispatched."""
    flops: int = 0
    traffic_bytes: int = 0
    peak_bytes: int = 0
    live_bytes: int = 0
    n_ops: int = 0
    ops: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    wide: List[Tuple[str, str, Tuple]] = dataclasses.field(
        default_factory=list)   # (op, dtype, repo frames) of f64/c128
    collectives: List[Collective] = dataclasses.field(default_factory=list)

    def count_collectives(self) -> Dict[str, int]:
        """``{kind: n}`` plus ``"total"``."""
        out = collections.Counter(c.kind for c in self.collectives)
        return {**out, "total": sum(out.values())}

    def collective_byte_volume(self) -> Dict[str, int]:
        """Operand bytes per kind (no ring factors) plus ``"total"``."""
        out: Dict[str, int] = collections.Counter()
        for c in self.collectives:
            out[c.kind] += c.nbytes
        return {**out, "total": sum(out.values())}

    def collective_payloads(self) -> List[Tuple[str, int]]:
        """(kind, operand bytes) of every collective call."""
        return [(c.kind, c.nbytes) for c in self.collectives]

    def collective_link_bytes(self) -> float:
        return sum(c.link_bytes for c in self.collectives)

    def summary(self) -> dict:
        return {"flops": self.flops, "traffic_bytes": self.traffic_bytes,
                "peak_bytes": self.peak_bytes,
                "live_at_end_bytes": self.live_bytes, "n_ops": self.n_ops,
                "collectives": self.count_collectives(),
                "collective_bytes": self.collective_link_bytes(),
                "collective_operand_bytes":
                    self.collective_byte_volume()["total"]}


def repo_frames(limit: int = 24) -> Tuple[Tuple[str, int, str], ...]:
    """The calling stack's frames in the repository (the port's package,
    its tests and scripts; not torch's), innermost first, this module's
    own frames skipped."""
    out = []
    f = sys._getframe(1)
    here = os.path.abspath(__file__)
    while f is not None and len(out) < limit:
        path = os.path.abspath(f.f_code.co_filename)
        if path.startswith(_ROOT + os.sep) and path != here \
                and "site-packages" not in path:
            out.append((path, f.f_lineno, f.f_code.co_name))
        f = f.f_back
    return tuple(out)


class _Recorder(TorchDispatchMode):
    def __init__(self, trace: Trace):
        super().__init__()
        self.trace = trace
        self.flops = _flop_registry()
        self._live: Dict[int, int] = {}

    def _free(self, key: int) -> None:
        self.trace.live_bytes -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is aten.bincount.default and args[0].is_meta:
            out = torch.empty((int(kwargs.get("minlength", args[2] if
                                              len(args) > 2 else 0)),),
                              dtype=torch.int64, device="meta")
        else:
            out = func(*args, **kwargs)
        tr = self.trace
        tr.n_ops += 1
        tr.ops[str(func.overloadpacket)] += 1
        ins = [a for a in tree_flatten((args, kwargs))[0]
               if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_flatten(out)[0]
                if isinstance(o, torch.Tensor)]
        wide = [t.dtype for t in ins + outs
                if t.dtype in (torch.float64, torch.complex128)]
        if wide:
            tr.wide.append((str(func), str(wide[0]), repo_frames()))
        packet = func.overloadpacket
        if packet in self.flops:
            tr.flops += int(self.flops[packet](*args, **kwargs,
                                               out_val=out))
        if not _aliasing(func):
            tr.traffic_bytes += sum(_nbytes(t) for t in ins + outs)
        seen = {id(t.untyped_storage()) for t in ins}
        for o in outs:
            st = o.untyped_storage()
            key = id(st)
            if key in seen or key in self._live:
                continue
            self._live[key] = st.nbytes()
            tr.live_bytes += st.nbytes()
            weakref.finalize(st, self._free, key)
        tr.peak_bytes = max(tr.peak_bytes, tr.live_bytes)
        return out


def _recording(trace: Trace, name: str, real, dry: bool, group_size):
    pos = COLLECTIVES[name]

    def call(*args, **kwargs):
        operand = args[pos] if len(args) > pos else \
            kwargs.get("tensor", kwargs.get("input_tensor"))
        group = kwargs.get("group")
        if dry:     # a dry mesh names its axis's size as the group
            n = group if isinstance(group, int) else group_size
        else:
            n = dist.get_world_size(group)
        trace.collectives.append(Collective(
            name, _nbytes(operand), int(n), repo_frames()))
        if dry:
            return None
        return real(*args, **kwargs)
    return call


@contextlib.contextmanager
def tracing(dry: bool = False, group_size: int = 1):
    """Record the block into the yielded :class:`Trace`.

    The ``torch.distributed`` calls are recorded too.  With ``dry`` they
    are recorded and not made (no process group is needed:
    the dry run reckons a rank's step alone), their group size taken as
    ``group_size`` (or the ``group=`` a dry mesh passes: its axis's
    size); an all-reduce then leaves its operand as it was.
    Otherwise each call's group (its ``group=`` keyword, the default
    group without one) gives the size."""
    trace = Trace()
    saved = {}
    for name in COLLECTIVES:
        real = getattr(dist, name)
        saved[name] = real
        setattr(dist, name, _recording(trace, name, real, dry, group_size))
    try:
        with _Recorder(trace):
            yield trace
    finally:
        for name, real in saved.items():
            setattr(dist, name, real)


__all__ = ["Collective", "Trace", "tracing", "repo_frames", "COLLECTIVES"]
