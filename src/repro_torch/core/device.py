"""Analog resistive-memory device models (paper §V).

Port of ``repro.core.device``: the configuration, its presets and the
aggregate write (``apply_update``), the host twin of the update kernel's
epilogue (``kernels.xbar_update._device_epilogue``), and the pulse-train
write (``pulse_train_counts``, ``apply_pulse_train``), the host twin of
its ``update_mode="pulse_train"`` epilogue.  The lookup-table device
waits for its slice (``ROADMAP.md``).
Conductances are normalised: ``g`` in ``[0, 1]`` maps onto the physical
window.

Constants are grouped as in the reference: ``exp(-nu)`` and the centre
normaliser are formed in Python doubles and enter float32 once, so the
float32 operations match the reference's one for one.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

Tensor = torch.Tensor


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


def _norm_state(g: Tensor, cfg: DeviceConfig) -> Tensor:
    """Position of g inside the window, in [0, 1]."""
    return (g - cfg.gmin) / (cfg.gmax - cfg.gmin)


def set_factor(x: Tensor, nu: float) -> Tensor:
    """State-dependent SET slope ``(exp(-nu x) - e^-nu) / (1 - e^-nu)``,
    normalised so that ``f(1/2) = 1``; ``nu -> 0`` gives ``2 (1 - x)``."""
    if nu < 1e-6:
        return 2.0 * (1.0 - x)
    e = np.exp(-nu)
    mid = (np.exp(-0.5 * nu) - e) / (1.0 - e)
    return (torch.exp(-nu * x) - e) / (1.0 - e) / mid


def reset_factor(x: Tensor, nu: float) -> Tensor:
    """State-dependent RESET slope: mirror image of SET."""
    return set_factor(1.0 - x, nu)


def _deterministic_dg(g: Tensor, dg_req: Tensor,
                      cfg: DeviceConfig) -> Tensor:
    """Mean conductance change for a requested update ``dg_req``."""
    if cfg.kind in ("ideal", "linearized"):
        return dg_req
    if cfg.kind != "taox":
        raise NotImplementedError(
            f"device kind {cfg.kind!r} is not ported yet (ROADMAP.md)")
    x = _norm_state(g, cfg)
    up = cfg.gain_set * set_factor(x, cfg.nu_set)
    dn = cfg.gain_reset * reset_factor(x, cfg.nu_reset)
    return torch.where(dg_req >= 0, dg_req * up, dg_req * dn)


def write_noise_sigma(dg_req: Tensor, cfg: DeviceConfig) -> Tensor:
    """Random-walk noise sigma for an update of magnitude ``|dg_req|``."""
    if cfg.write_noise == 0.0:
        return torch.zeros_like(dg_req)
    n_pulses = torch.abs(dg_req) / cfg.pulse_dg
    return cfg.write_noise * cfg.pulse_dg * torch.sqrt(n_pulses)


def apply_update(g: Tensor, dg_req: Tensor, cfg: DeviceConfig,
                 noise: Optional[Tensor] = None) -> Tensor:
    """Apply a requested conductance update through the device model.

    ``noise`` is the standard-normal field of the write stochasticity, of
    ``g``'s shape (required unless the device is noiseless): the reference
    draws it from its key, the port takes it as an input so both can be
    fed the same field.  Returns new conductances clipped to [gmin, gmax].
    """
    dg = _deterministic_dg(g, dg_req, cfg)
    if cfg.write_noise > 0.0:
        if noise is None:
            raise ValueError("stochastic device model requires a noise "
                             "field")
        dg = dg + write_noise_sigma(dg_req, cfg) * noise
    return torch.clamp(g + dg, cfg.gmin, cfg.gmax)


# ---------------------------------------------------------------------------
# Pulse-train writes (sign-decomposed 4-phase stochastic update).
#
# For the signed outer product ``acc = sum_b x_b d_b``, its magnitude twin
# ``A = sum_b |x_b| |d_b|`` and a signed learning-rate scale ``m``, the
# per-cell SET / RESET magnitudes
#
#     S = (A |m| + acc m) / 2 >= 0,   R = (A |m| - acc m) / 2 >= 0
#
# satisfy S - R = acc m (the requested update) and S + R = A |m| (the
# total pulse count that drives the random-walk write noise).  Magnitudes
# are quantised to integer event counts n = round(S / pulse_dg), the clock
# cycles the column driver holds its enable line.
# ---------------------------------------------------------------------------

def pulse_train_counts(set_mag: Tensor, reset_mag: Tensor,
                       cfg: DeviceConfig):
    """Integer SET/RESET clock-cycle event counts for the requested
    per-cell magnitudes (both >= 0, in normalised conductance units),
    rounded half to even."""
    n_set = torch.round(set_mag / cfg.pulse_dg)
    n_reset = torch.round(reset_mag / cfg.pulse_dg)
    return n_set, n_reset


def apply_pulse_train(g: Tensor, set_mag: Tensor, reset_mag: Tensor,
                      cfg: DeviceConfig,
                      noise: Optional[Tensor] = None) -> Tensor:
    """Apply a 4-phase pulse-train write through the device model.

    The SET and RESET phases fire separately: ``n_set`` pulses through the
    state-dependent SET slope and ``n_reset`` through the RESET slope, each
    an integer number of ``pulse_dg`` events, and the write noise
    accumulates over ``n_set + n_reset`` pulses (a cell whose phases cancel
    still random-walks).  ``noise`` is the standard-normal field, as in
    :func:`apply_update`.
    """
    n_set, n_reset = pulse_train_counts(set_mag, reset_mag, cfg)
    if cfg.kind in ("ideal", "linearized"):
        up = torch.ones_like(g)
        dn = torch.ones_like(g)
    elif cfg.kind == "taox":
        x = _norm_state(g, cfg)
        up = cfg.gain_set * set_factor(x, cfg.nu_set)
        dn = cfg.gain_reset * reset_factor(x, cfg.nu_reset)
    else:
        raise NotImplementedError(
            f"device kind {cfg.kind!r} is not ported yet (ROADMAP.md)")
    dg = cfg.pulse_dg * (n_set * up - n_reset * dn)
    if cfg.write_noise > 0.0:
        if noise is None:
            raise ValueError("stochastic device model requires a noise "
                             "field")
        sigma = cfg.write_noise * cfg.pulse_dg * torch.sqrt(n_set + n_reset)
        dg = dg + sigma * noise
    return torch.clamp(g + dg, cfg.gmin, cfg.gmax)
