"""Analog resistive-memory device models (paper §V): the configuration.

Port of the dataclass and presets of ``repro.core.device``.  Only the
fields are carried over in this slice: the forward read needs the
conductance window (``gmin``/``gmax``).  The update physics
(``apply_update``, the pulse train) waits for the training slice
(``ROADMAP.md``).  Conductances are normalised: ``g`` in ``[0, 1]`` maps
onto the physical window.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DeviceConfig:
    """Static hyper-parameters of a resistive device model.

    ``kind``: ``ideal``, ``taox`` (nonlinear, asymmetric, stochastic),
    ``linearized`` (state dependence removed, noise kept) or ``lut``.
    """

    kind: str = "taox"
    nu_set: float = 5.0
    nu_reset: float = 5.0
    gain_set: float = 1.0
    gain_reset: float = 1.0
    write_noise: float = 0.3
    pulse_dg: float = 1.0 / 256.0
    read_noise: float = 0.0
    gmin: float = 0.0
    gmax: float = 1.0

    def replace(self, **kw) -> "DeviceConfig":
        return dataclasses.replace(self, **kw)


IDEAL = DeviceConfig(kind="ideal", write_noise=0.0, read_noise=0.0)
TAOX = DeviceConfig(kind="taox", nu_set=5.0, nu_reset=5.0,
                    gain_set=1.0, gain_reset=1.0, write_noise=0.3)
TAOX_NONOISE = TAOX.replace(write_noise=0.0)
LINEARIZED = DeviceConfig(kind="linearized", write_noise=0.3)
