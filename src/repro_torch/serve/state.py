"""Serve-side state: digital weights or programmed crossbars + drift (port
of ``repro.serve.state``).

``ServeState`` is what an engine serves from.  For the digital backend it
is a parameter tree; for the analog backend it also carries the
deployment-lifetime bookkeeping:

* ``g_target`` — a copy of every container's ``g`` and ``ref`` taken at
  programming time.  Recalibration restores them from it bit for bit,
  which on a nonoise device restores the served tokens exactly.
* per-container device age, read counts and cumulative reprogramming
  pulses, keyed on the registry's :func:`container_paths`.

``AnalogServeRuntime`` is the maintenance engine over one ServeState: it
applies wall-clock retention drift lazily (the power-law factor of
``core.endurance`` composes across applications) and drains
recalibration sweeps one container per scheduler tick, in the tick's
prefill lane, so in-flight requests keep decoding.  Drift and
recalibration work in place on the live tensors, container by container
and layer slice by layer slice, so a full-size model's transient fields
stay one layer's size.
"""
from __future__ import annotations

import collections
import dataclasses
import zlib
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import AnalogMode, resolve_analog_mode
from repro_torch.core.analog_registry import container_paths
from repro_torch.core.endurance import (RetentionSpec, recalibration_pulses,
                                        retention_factors)
from repro_torch.core.tiled_analog import crossbar_from_model

Tensor = torch.Tensor
Path = Tuple[str, ...]

BACKENDS = ("digital", "analog")


@dataclasses.dataclass
class ServeState:
    """What an engine serves from; build with :func:`make_serve_state`
    (or ``train.checkpoint.to_serve_state`` / ``from_checkpoint``), which
    validates that backend and parameters agree and takes ``g_target``."""

    params: Any
    backend: str = "digital"
    retention: Optional[RetentionSpec] = None
    # ---- analog-only bookkeeping (empty for the digital backend) ----
    paths: Tuple[Path, ...] = ()
    # path -> {"g": ..., "ref": ...} programming targets
    g_target: Dict[Path, Dict[str, Tensor]] = dataclasses.field(
        default_factory=dict)
    clock_s: float = 0.0                 # simulated wall clock
    age_s: Dict[Path, float] = dataclasses.field(default_factory=dict)
    reads: Dict[Path, int] = dataclasses.field(default_factory=dict)
    reads_unapplied: Dict[Path, int] = dataclasses.field(
        default_factory=dict)
    pulses: Dict[Path, float] = dataclasses.field(default_factory=dict)

    @property
    def is_analog(self) -> bool:
        return self.backend == "analog"


def make_serve_state(cfg, params, *, backend: Optional[str] = None,
                     retention: Optional[RetentionSpec] = None
                     ) -> ServeState:
    """Wrap a parameter tree as a ServeState.

    ``backend=None`` infers from the tree: any crossbar container means
    ``"analog"``.  An explicit backend that contradicts the tree raises.
    Idempotent on an existing ServeState.
    """
    if isinstance(params, ServeState):
        if backend is not None and backend != params.backend:
            raise ValueError(
                f"ServeState already has backend={params.backend!r}; "
                f"cannot rewrap as {backend!r}")
        return params
    if params is None:
        raise ValueError("make_serve_state needs a parameter tree")
    paths = container_paths(params)
    backend = backend or ("analog" if paths else "digital")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    if backend == "analog" and not paths:
        raise ValueError(
            "backend='analog' needs programmed crossbar containers; "
            "program a digital tree with models.model.program_digital")
    if backend == "digital" and paths:
        raise ValueError(
            "backend='digital' got conductance containers; serve with "
            "backend='analog', or read them out first with "
            "models.model.readout_digital")
    if backend == "digital":
        return ServeState(params=params, backend="digital")
    if resolve_analog_mode(cfg) is not AnalogMode.DEVICE:
        raise ValueError(
            "analog serving needs a device-mode config (analog=True, "
            "analog_mode='device'); got resolved mode "
            f"{resolve_analog_mode(cfg).value!r}")
    # Targets are independent buffers: maintenance rewrites the live
    # tensors in place.  Both columns are kept — drift relaxes both, and
    # recalibration reprograms both.
    g_target = {p: {k: _tree_get(params, p)[k].clone() for k in ("g", "ref")}
                for p in paths}
    return ServeState(
        params=params, backend="analog",
        retention=retention or RetentionSpec(),
        paths=paths, g_target=g_target,
        age_s={p: 0.0 for p in paths},
        reads={p: 0 for p in paths},
        reads_unapplied={p: 0 for p in paths},
        pulses={p: 0.0 for p in paths})


def _tree_get(params, path: Path):
    for k in path:
        params = params[k]
    return params


def _slices(t: Tensor):
    """Views of ``t`` one leading index at a time ((K, N) blocks of a
    stacked container), or ``t`` itself when it is one matrix."""
    if t.ndim <= 2:
        return [t]
    return [s for i in range(t.shape[0]) for s in _slices(t[i])]


class AnalogServeRuntime:
    """Drift + recalibration maintenance over one ServeState.

    Engine contract:

    * :meth:`note_reads` once per model application (decode tick /
      prefill chunk / static step) — accumulates read-disturb counts.
    * :meth:`advance_clock` whenever simulated wall time passes.
    * :meth:`tick` once per scheduler tick; it applies any pending drift
      tree-wide, runs AT MOST ONE container recalibration, and returns
      the parameter tree (the same tensors, rewritten in place).

    Everything is deterministic: drift and disturb are closed-form
    factors, the sweep order is the registry's sorted container
    enumeration, and recalibration copies ``g_target`` back verbatim.
    ``metrics`` counts ``sim_seconds``, ``drift_applications``,
    ``recal_sweeps``, ``recal_containers`` and ``recal_pulses``.
    """

    def __init__(self, state: ServeState, cfg):
        if not state.is_analog:
            raise ValueError("AnalogServeRuntime needs an analog "
                             "ServeState")
        self.state = state
        self.cfg = cfg
        self.dev = crossbar_from_model(cfg).device
        self.spec = state.retention or RetentionSpec()
        self.metrics: collections.Counter = collections.Counter()
        self._pending_s = 0.0
        self._since_recal_s = 0.0
        self._queue: collections.deque = collections.deque()

    # ------------------------------------------------ engine-facing API
    def advance_clock(self, seconds: float) -> None:
        """Advance the simulated wall clock; drift is applied lazily at
        the next tick, and a recalibration sweep is scheduled whenever
        the retention spec's interval elapses."""
        if seconds < 0:
            raise ValueError("cannot advance the clock backwards")
        self._pending_s += seconds
        self._since_recal_s += seconds
        self.state.clock_s += seconds
        self.metrics["sim_seconds"] += seconds
        if self._since_recal_s >= self.spec.recal_interval_s:
            self.schedule_recalibration()

    def note_reads(self, n: int = 1) -> None:
        """Count ``n`` inference reads of every container (one model
        application reads each projection's array once)."""
        for p in self.state.paths:
            self.state.reads[p] += n
            self.state.reads_unapplied[p] += n

    def schedule_recalibration(self) -> None:
        """Queue a full sweep at container granularity; :meth:`tick`
        drains it one container per call."""
        pending = set(self._queue)
        for p in self.state.paths:
            if p not in pending:
                self._queue.append(p)
        self._since_recal_s = 0.0
        self.metrics["recal_sweeps"] += 1

    @property
    def recal_pending(self) -> int:
        return len(self._queue)

    @property
    def pending_drift_s(self) -> float:
        return self._pending_s

    def tick(self):
        """One maintenance tick; returns the current parameter tree."""
        if self._pending_s > 0.0:
            self._apply_drift()
        if self._queue:
            self._recal_one(self._queue.popleft())
        return self.state.params

    # ---------------------------------------------------------- internals
    @torch.no_grad()
    def _apply_drift(self) -> None:
        dt = self._pending_s
        self._pending_s = 0.0
        for p in self.state.paths:
            a0 = self.state.age_s[p]
            self.drift_container(p, a0, a0 + dt,
                                 self.state.reads_unapplied[p])
            self.state.age_s[p] = a0 + dt
            self.state.reads_unapplied[p] = 0
        self.metrics["drift_applications"] += 1

    @torch.no_grad()
    def drift_container(self, path: Path, age0_s: float, age1_s: float,
                        n_reads: int) -> None:
        """Relax one container's ``g`` and ``ref`` in place, one (K, N)
        block at a time: block ``i`` uses the exponents of the cells at
        flat indices ``[i K N, (i + 1) K N)`` of the container's fields,
        so the result equals one application to the whole container."""
        cont = _tree_get(self.state.params, path)
        salt = zlib.crc32("/".join(path).encode())
        floor = float(self.dev.gmin)
        g_blocks, r_blocks = _slices(cont["g"]), _slices(cont["ref"])
        # a float32 count, as the reference's runtime passes it
        reads = torch.tensor(float(n_reads), dtype=torch.float32,
                             device=cont["g"].device)
        offset = 0
        for g, r in zip(g_blocks, r_blocks):
            f_g, f_r = retention_factors(g.shape, r.shape, age0_s, age1_s,
                                         reads, self.spec, salt,
                                         device=g.device, offset=offset)
            g.copy_(floor + (g - floor) * f_g)
            del f_g
            r.copy_(floor + (r - floor) * f_r)
            offset += g.numel()

    @torch.no_grad()
    def _recal_one(self, path: Path) -> None:
        cont = _tree_get(self.state.params, path)
        target = self.state.g_target[path]
        n_pulses = 0.0
        for k in ("g", "ref"):
            for live, want in zip(_slices(cont[k]), _slices(target[k])):
                n_pulses += float(recalibration_pulses(live, want,
                                                       self.dev))
                live.copy_(want)
        self.state.age_s[path] = 0.0
        self.state.reads[path] = 0
        self.state.reads_unapplied[path] = 0
        self.state.pulses[path] += n_pulses
        self.metrics["recal_containers"] += 1
        self.metrics["recal_pulses"] += n_pulses
