"""Analog resistive-memory device models (paper §V).

Port of ``repro.core.device``: the configuration, its presets and the
aggregate write (``apply_update``), the host twin of the update kernel's
epilogue (``kernels.xbar_update._device_epilogue``), and the pulse-train
write (``pulse_train_counts``, ``apply_pulse_train``), the host twin of
its ``update_mode="pulse_train"`` epilogue; the pulse-voltage model
(``VoltageModel``, paper Eq. 6) and the lookup-table device (``LutDevice``,
paper §V.C) with its two builders.  ``kind="lut"`` in a ``DeviceConfig``
takes the analytic TaOx slope, as every kind but ``ideal`` /
``linearized`` does in the reference; the table itself is
:class:`LutDevice`, applied on its own.
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
    ``linearized`` (state dependence removed, noise kept) or ``lut``
    (which the writes take as ``taox``, as the reference's do: the table
    is a :class:`LutDevice`).
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
    else:
        x = _norm_state(g, cfg)
        up = cfg.gain_set * set_factor(x, cfg.nu_set)
        dn = cfg.gain_reset * reset_factor(x, cfg.nu_reset)
    dg = cfg.pulse_dg * (n_set * up - n_reset * dn)
    if cfg.write_noise > 0.0:
        if noise is None:
            raise ValueError("stochastic device model requires a noise "
                             "field")
        sigma = cfg.write_noise * cfg.pulse_dg * torch.sqrt(n_set + n_reset)
        dg = dg + sigma * noise
    return torch.clamp(g + dg, cfg.gmin, cfg.gmax)


# ---------------------------------------------------------------------------
# ΔG(V): pulse-voltage dependence, paper Eq. (6).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class VoltageModel:
    """ΔG(V) = exp(d1 (V - Vmin_p)) - 1 above threshold (SET) and the
    mirrored expression below the negative threshold (RESET); 0 between.
    The write encoding (hwmodel) picks pulse voltages and lengths with
    it."""

    d1: float = 4.0
    d2: float = 4.0
    vmin_p: float = 0.8
    vmin_n: float = -0.8

    def delta_g(self, v: Tensor) -> Tensor:
        up = torch.exp(self.d1 * (v - self.vmin_p)) - 1.0
        dn = -(torch.exp(self.d2 * (self.vmin_n - v)) - 1.0)
        zero = torch.zeros_like(up)
        return torch.where(v > self.vmin_p, up,
                           torch.where(v < self.vmin_n, dn, zero))

    def voltage_for(self, dg: Tensor, direction: int) -> Tensor:
        """Inverse of :meth:`delta_g` for a write direction (+1/-1)."""
        dg = torch.abs(dg)
        if direction >= 0:
            return self.vmin_p + torch.log1p(dg) / self.d1
        return self.vmin_n - torch.log1p(dg) / self.d2


# ---------------------------------------------------------------------------
# Lookup-table device (paper §V.C): binned G0 -> ΔG mean/std heat-map.
# ---------------------------------------------------------------------------

def _interp(x: Tensor, xp: Tensor, fp: Tensor) -> Tensor:
    """``jnp.interp(x, xp, fp)`` step for step: the bin from a right-sided
    search clipped to [1, len - 1], the lerp ``fp[i-1] + (delta / dx) *
    df`` with its multiply-add fused as XLA fuses it (the product exact
    in float64, one rounding to float32 after the add: a double rounding
    that can sit one ulp off a true FMA, which no test input hits), and
    the ends clamped to ``fp[0]`` / ``fp[-1]``."""
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1,
                    len(xp) - 1)
    lo, f_lo = xp[i - 1], fp[i - 1]
    df, dx = fp[i] - f_lo, xp[i] - lo
    dx0 = torch.abs(dx) <= float(np.spacing(np.finfo(np.float32).eps))
    q = (x - lo) / torch.where(dx0, torch.ones_like(dx), dx)
    f = (f_lo.double() + q.double() * df.double()).to(x.dtype)
    f = torch.where(dx0, f_lo, f)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


@dataclasses.dataclass(frozen=True)
class LutDevice:
    """Device model backed by binned pulse data.

    ``centers`` are bin centres over the normalised window; ``mean_set`` /
    ``std_set`` give the per-single-pulse ΔG distribution at each bin for
    a SET pulse (likewise RESET): the artefact the paper builds from
    1M-10M measured pulses (Fig. 12).  :func:`lut_from_analytic` builds
    one from the analytic model, :func:`lut_from_pulse_train` from a
    measured trace.  The tables are numpy arrays, as the reference's are
    (a reference ``LutDevice`` carries across field by field); they enter
    float32 in :meth:`_interp`, as ``jnp.asarray`` takes them there.
    """

    centers: np.ndarray
    mean_set: np.ndarray
    std_set: np.ndarray
    mean_reset: np.ndarray
    std_reset: np.ndarray
    gmin: float = 0.0
    gmax: float = 1.0

    def _interp(self, table: np.ndarray, g: Tensor) -> Tensor:
        x = (g - self.gmin) / (self.gmax - self.gmin)

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=g.device)
        return _interp(x, f32(self.centers), f32(table))

    def apply_update(self, g: Tensor, dg_req: Tensor,
                     noise: Optional[Tensor] = None,
                     pulse_dg: float = 1.0 / 256.0) -> Tensor:
        """Apply ``dg_req`` as ``n = |dg_req| / pulse_dg`` effective
        pulses at the initial state; ``noise`` is the standard-normal
        field of the pulses' spread (the reference's draw from its key;
        ``None``: noiseless)."""
        n = torch.abs(dg_req) / pulse_dg
        up = dg_req >= 0
        mean_up = self._interp(self.mean_set, g)
        mean_dn = self._interp(self.mean_reset, g)
        dg = torch.where(up, n * mean_up, n * mean_dn)
        if noise is not None:
            std_up = self._interp(self.std_set, g)
            std_dn = self._interp(self.std_reset, g)
            sigma = torch.sqrt(n) * torch.where(up, std_up, std_dn)
            dg = dg + sigma * noise
        return torch.clamp(g + dg, self.gmin, self.gmax)


def _factor_table(x: np.ndarray, nu: float) -> np.ndarray:
    """The reference's ``set_factor`` on a float64 numpy array with
    64-bit JAX off: ``-nu x`` in float64, then float32 from the ``exp``
    on (a float64 array for a linear side, which takes no ``exp``)."""
    if nu < 1e-6:
        return 2.0 * (1.0 - x)
    e = np.exp(-nu)
    mid = (np.exp(-0.5 * nu) - e) / (1.0 - e)
    t = torch.exp(torch.from_numpy((-nu * x).astype(np.float32)))
    return ((t - e) / (1.0 - e) / mid).numpy()


def lut_from_analytic(cfg: DeviceConfig, n_bins: int = 64) -> LutDevice:
    """Bin the analytic model into a LUT (round-trip consistency
    testing)."""
    centers = np.linspace(0.0, 1.0, n_bins)
    pulse = cfg.pulse_dg
    mean_set = pulse * cfg.gain_set * _factor_table(centers, cfg.nu_set)
    mean_reset = -pulse * cfg.gain_reset * _factor_table(1.0 - centers,
                                                         cfg.nu_reset)
    std = np.full_like(centers, cfg.write_noise * pulse)
    return LutDevice(centers=centers, mean_set=mean_set, std_set=std,
                     mean_reset=mean_reset, std_reset=std,
                     gmin=cfg.gmin, gmax=cfg.gmax)


def lut_from_pulse_train(g_trace: np.ndarray, n_bins: int = 64,
                         gmin: Optional[float] = None,
                         gmax: Optional[float] = None) -> LutDevice:
    """Build a LUT from a measured conductance-vs-pulse trace (numpy, in
    float64).

    ``g_trace``: (n_cycles, 2 n_pulses), each row one SET train followed
    by one RESET train, the measurement protocol of paper §V.B.
    """
    g_trace = np.asarray(g_trace, dtype=np.float64)
    gmin = float(g_trace.min()) if gmin is None else gmin
    gmax = float(g_trace.max()) if gmax is None else gmax
    half = g_trace.shape[1] // 2
    edges = np.linspace(gmin, gmax, n_bins + 1)
    centers01 = (0.5 * (edges[:-1] + edges[1:]) - gmin) / (gmax - gmin)

    def _bin(seg_g0: np.ndarray, seg_dg: np.ndarray):
        mean = np.zeros(n_bins)
        std = np.zeros(n_bins)
        idx = np.clip(np.digitize(seg_g0, edges) - 1, 0, n_bins - 1)
        for b in range(n_bins):
            sel = seg_dg[idx == b]
            if sel.size:
                mean[b] = sel.mean()
                std[b] = sel.std()
        return mean, std

    g0 = g_trace[:, :-1].ravel()
    dg = np.diff(g_trace, axis=1).ravel()
    set_mask = np.tile(np.arange(g_trace.shape[1] - 1) < half,
                       g_trace.shape[0])
    m_s, s_s = _bin(g0[set_mask], dg[set_mask])
    m_r, s_r = _bin(g0[~set_mask], dg[~set_mask])
    scale = gmax - gmin
    return LutDevice(centers=centers01, mean_set=m_s / scale,
                     std_set=s_s / scale, mean_reset=m_r / scale,
                     std_reset=s_r / scale, gmin=0.0, gmax=1.0)
