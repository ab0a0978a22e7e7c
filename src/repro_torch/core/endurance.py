"""Device wearout and physical write-current constraints (paper §V.E-F).

Port of ``repro.core.endurance``.

§V.E: training at ~100 kHz with the 8-bit scheme can apply up to 2^8 = 256
pulses per update cycle; a year of continuous operation needs ~8e14 unit
pulses worst-case, ~4e13 expected-case (128 pulses on 10 % of cycles) —
against ~2e12 equivalent nudges demonstrated in the literature.

§V.F: parallel updates of an N-row column must respect the M1
electromigration limit (~33 µA at 14/16 nm): I_nudge <= I_limit / N, i.e.
R_ON >= N * V_write / I_limit (~33 MΩ for a 1000-row array at 1.1 V
effective write drive — the paper quotes ~33 nA / 33 MΩ).

``pulse_stats`` measures the *actual* nudge distribution of a training run
(mean pulses per update from requested ΔG), refining §V.E's assumed 128.

The per-cell drift exponents (:func:`cell_nu`) come from the port's own
counter PRNG, a pure function of ``(seed, salt, cell index)``: the
reference draws them from ``jax.random``, which torch cannot reproduce,
so parity tests hand the reference's fields to :func:`apply_retention`
(``nu=``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.xbar_update import (_M32, _mix32, _mul32,
                                             _pair_normals, _u32)

from .device import DeviceConfig

Tensor = torch.Tensor

SECONDS_PER_YEAR = 3600 * 24 * 365


@dataclasses.dataclass(frozen=True)
class EnduranceSpec:
    update_rate_hz: float = 100e3      # training cycle rate (§V.E)
    bits: int = 8                      # temporal-coding precision
    duty: float = 0.10                 # fraction of cycles touching a cell
    mean_pulses: float = 128.0         # pulses per touched cycle
    years: float = 1.0


def pulses_required(spec: EnduranceSpec = EnduranceSpec(),
                    worst_case: bool = False) -> float:
    """Unit pulses a device must survive (paper §V.E arithmetic)."""
    cycles = spec.update_rate_hz * SECONDS_PER_YEAR * spec.years
    if worst_case:
        return cycles * float(2 ** spec.bits)
    return cycles * spec.duty * spec.mean_pulses


def demonstrated_nudges(memory_cycles: float = 1e12) -> float:
    """Literature endurance translated to nudges: one full G_MIN->G_MAX->
    G_MIN memory cycle counts as two nudges (§V.E)."""
    return 2.0 * memory_cycles


def endurance_margin(spec: EnduranceSpec = EnduranceSpec(),
                     memory_cycles: float = 1e12) -> float:
    """>1 means demonstrated endurance covers the training requirement."""
    return demonstrated_nudges(memory_cycles) / pulses_required(spec)


def pulse_stats(dg_req: Tensor, dev: DeviceConfig) -> Dict[str, Tensor]:
    """Nudge statistics of a requested conductance-update tensor."""
    pulses = torch.abs(dg_req) / dev.pulse_dg
    touched = pulses > 0.5
    return {
        "mean_pulses_per_update": torch.mean(pulses),
        "mean_pulses_when_touched":
            torch.sum(torch.where(touched, pulses, 0.0))
            / torch.clamp(torch.sum(touched), min=1),
        "duty": torch.mean(touched.float()),
        "max_pulses": torch.amax(pulses),
    }


# ---------------------------------------------------------------------------
# §V.F electromigration / parallel-write current limits
# ---------------------------------------------------------------------------

def max_parallel_write_current(n_rows: int,
                               i_limit: float = 33e-6) -> float:
    """Max per-device nudge current so a full column write stays under the
    M1 electromigration limit."""
    return i_limit / n_rows


def min_on_resistance(n_rows: int, v_write: float = 1.1,
                      i_limit: float = 33e-6) -> float:
    """R_ON floor implied by the current limit (paper: ~33 MΩ at N=1000)."""
    return v_write / max_parallel_write_current(n_rows, i_limit)


def check_write_current(write_current: float, n_rows: int,
                        i_limit: float = 33e-6) -> bool:
    """Does a device/write-current choice permit fully-parallel updates?"""
    return write_current <= max_parallel_write_current(n_rows, i_limit)


# ---------------------------------------------------------------------------
# Long-horizon retention / read-disturb (serving lifetime, not training)
# ---------------------------------------------------------------------------
#
# Once a trained array moves to serving, no pulses refresh the cells and
# two slow mechanisms erode the programmed state:
#
# * retention drift — every cell's excess conductance over the floor,
#   g - g_floor, relaxes following the power law
#   G(t) = G0 * ((t + t0)/t0)^-nu, with a *per-cell* exponent (a fixed
#   device property, dispersed cell to cell).  Programmed and reference
#   cells drift independently, so the differential readout's
#   common-mode cancellation degrades over time.
# * read disturb — every inference read applies a small bias stress;
#   modelled as a deterministic multiplicative loss of excess
#   conductance per read, (1 - eps)^n_reads.
#
# Both act multiplicatively on (g - g_floor) with exponents/rates fixed
# per cell, so they compose across incremental applications:
# drift_factor(a0, a1) * drift_factor(a1, a2) == drift_factor(a0, a2)
# up to float32 rounding.  That is what lets the serve runtime apply
# decay lazily, on a wall-clock schedule, instead of every tick.


@dataclasses.dataclass(frozen=True)
class RetentionSpec:
    """Retention / read-disturb model parameters for served conductances.

    ``nu_sigma`` is the device-to-device dispersion of the drift
    exponent: a uniform decay rescales every projection alike, while
    dispersed per-cell exponents distort the weights relative to each
    other.  Each cell's exponent is a fixed device property, a pure
    function of ``seed``, the container's salt and the cell's index.
    """

    t0_s: float = 3600.0           # power-law onset time (s since program)
    nu: float = 0.02               # mean drift exponent (deviation decay)
    nu_sigma: float = 0.5          # relative per-cell dispersion of nu
    read_disturb: float = 0.0      # fractional deviation loss per read
    recal_interval_s: float = 7 * 24 * 3600.0  # scheduled sweep cadence
    seed: int = 0                  # per-cell exponent field


def _field_seed(seed: int, salt: int, device) -> Tensor:
    """The 32-bit word that keys one container's exponent field."""
    h = _mix32(_u32(seed, device) ^ 0x9E3779B9)
    return _mix32((h + _mul32(_u32(salt & _M32, device), 0x85EBCA77))
                  & _M32)


def cell_normals(seed: int, salt: int, n: int, offset: int = 0,
                 device=None) -> Tensor:
    """Standard normals of the flat cell indices ``[offset, offset + n)``:
    cells 2i and 2i + 1 share one Box–Muller draw of the hashed word
    ``_mix32(i ^ field_seed)`` (cosine and sine legs), so any slice of a
    field equals the same slice of the whole field."""
    first, last = offset // 2, (offset + n + 1) // 2
    pid = torch.arange(first, last, dtype=torch.int64, device=device) & _M32
    z0, z1 = _pair_normals(_mix32(pid ^ _field_seed(seed, salt, device)))
    z = torch.stack([z0, z1], dim=-1).reshape(-1)
    return z[offset - 2 * first:offset - 2 * first + n]


def cell_nu(spec: RetentionSpec, shape, salt: int = 0, device=None,
            offset: int = 0) -> Tensor:
    """Per-cell drift exponents ``nu * max(0, 1 + nu_sigma * z)`` of a
    block of ``shape`` whose first cell has flat index ``offset`` in its
    container; ``z`` from :func:`cell_normals`.

    ``salt`` (a CRC of the container path) decorrelates containers; the
    field is a pure function of ``(seed, salt, cell index)`` — a fixed
    device property, never re-rolled between applications, and equal on
    the card and on the CPU (integer hash; Box–Muller within a few ulp).
    """
    n = 1
    for s in shape:
        n *= int(s)
    u = cell_normals(spec.seed, salt, n, offset, device).reshape(shape)
    return spec.nu * torch.clamp(1.0 + spec.nu_sigma * u, min=0.0)


def _f32(v, device) -> Tensor:
    if isinstance(v, Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.tensor(v, dtype=torch.float32, device=device)


def drift_factor(age0_s, age1_s, spec: RetentionSpec, nu=None,
                 device=None) -> Tensor:
    """Multiplicative decay of (g - g_ref) between device ages age0->age1,
    in float32.

    ``nu`` (scalar or per-cell tensor from :func:`cell_nu`) defaults to
    the spec mean.  Monotone non-increasing in ``age1_s`` and composable:
    consecutive applications multiply to the single-span factor.
    """
    if device is None and isinstance(nu, Tensor):
        device = nu.device
    a0 = torch.clamp(_f32(age0_s, device), min=0.0)
    a1 = torch.maximum(_f32(age1_s, device), a0)
    nu = spec.nu if nu is None else nu
    ratio = (a1 + spec.t0_s) / (a0 + spec.t0_s)
    return torch.pow(ratio, -nu)


def read_disturb_factor(n_reads, spec: RetentionSpec,
                        device=None) -> Tensor:
    """Deviation retained after ``n_reads`` inference reads, as a float32
    tensor.  As in the reference, a Python count is raised in double
    precision and a tensor count (the runtime's) in float32."""
    if isinstance(n_reads, Tensor):
        return torch.pow(_f32(1.0 - spec.read_disturb, n_reads.device),
                         n_reads.float())
    return _f32((1.0 - spec.read_disturb) ** n_reads, device)


def retention_factors(g_shape, ref_shape, age0_s, age1_s, n_reads,
                      spec: RetentionSpec, salt: int = 0,
                      nu: Optional[Tuple[Tensor, Tensor]] = None,
                      device=None, offset: int = 0):
    """The factors ``(f_g, f_r)`` that :func:`apply_retention` multiplies
    the excess conductances by (scalars without dispersion)."""
    rd = read_disturb_factor(n_reads, spec, device)
    if spec.nu_sigma == 0.0:
        f = drift_factor(age0_s, age1_s, spec, device=device) * rd
        return f, f
    if nu is None:
        nu = (cell_nu(spec, g_shape, salt, device, offset),
              cell_nu(spec, ref_shape, salt ^ 0x5EED, device, offset))
    return (drift_factor(age0_s, age1_s, spec, nu[0]) * rd,
            drift_factor(age0_s, age1_s, spec, nu[1]) * rd)


def apply_retention(g: Tensor, ref: Tensor, age0_s, age1_s, n_reads,
                    spec: RetentionSpec, salt: int = 0,
                    g_floor: float = 0.0,
                    nu: Optional[Tuple[Tensor, Tensor]] = None) -> tuple:
    """Relax a conductance block *and its reference column* toward the
    conductance floor; returns ``(g, ref)``.

    Every cell — programmed and reference alike — loses excess
    conductance ``(g - g_floor)`` by its own power-law factor.  With
    ``nu_sigma == 0`` the differential readout ``(g - ref)`` just shrinks
    by the common factor; with dispersion the common-mode cancellation
    breaks.

    ``age0_s`` is the device age drift was last applied up to,
    ``age1_s`` the new age, ``n_reads`` the reads accumulated since the
    last application.  ``salt`` decorrelates the exponent fields between
    containers (``ref``'s field takes ``salt ^ 0x5EED``).  ``nu`` is an
    explicit ``(nu_g, nu_r)`` pair of exponent fields in place of
    :func:`cell_nu`'s.
    """
    f_g, f_r = retention_factors(g.shape, ref.shape, age0_s, age1_s,
                                 n_reads, spec, salt, nu, g.device)
    return (g_floor + (g - g_floor) * f_g,
            g_floor + (ref - g_floor) * f_r)


def recalibration_pulses(g_drifted: Tensor, g_target: Tensor,
                         dev: DeviceConfig) -> Tensor:
    """Total programming pulses a closed-loop re-write sweep needs to
    restore a drifted block to its stored target (§V.E pulse
    arithmetic; feeds the serve runtime's maintenance accounting)."""
    return torch.sum(torch.abs(g_target - g_drifted) / dev.pulse_dg)
