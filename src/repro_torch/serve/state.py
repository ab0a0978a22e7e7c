"""Serve-side state: digital weights or programmed crossbars (port of
``repro.serve.state``, without the maintenance runtime).

``ServeState`` is what an engine serves from.  The reference also keeps
pristine ``g_target`` copies and per-container age / read / pulse
counters for its ``AnalogServeRuntime`` (retention drift, read disturb,
recalibration); that runtime and ``core/endurance.py`` are queued in
ROADMAP.md, so this slice keeps the validated parameter tree and the
container enumeration only.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

from repro_torch.configs.base import AnalogMode, resolve_analog_mode
from repro_torch.core.analog_registry import container_paths

Path = Tuple[str, ...]

BACKENDS = ("digital", "analog")


@dataclasses.dataclass
class ServeState:
    """What an engine serves from; build with :func:`make_serve_state`,
    which validates that backend and parameters agree."""

    params: Any
    backend: str = "digital"
    paths: Tuple[Path, ...] = ()

    @property
    def is_analog(self) -> bool:
        return self.backend == "analog"


def make_serve_state(cfg, params, *,
                     backend: Optional[str] = None) -> ServeState:
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
    return ServeState(params=params, backend="analog", paths=paths)
