"""Crossbar weight <-> conductance mapping and tiling (paper §III).

Port of ``repro.core.crossbar``.  Signed weights sit on unipolar
conductances paired with a reference array at the window midpoint; the
read drives the reference with the opposite polarity, so the integrator
sees ``q_j = sum_i x_i (G_ij - G_ref_ij)``.  Matrices larger than one
physical array are tiled onto ``rows x cols`` crossbars, each with its own
integrator and ADC; tile partial sums are accumulated digitally.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .adc import AdcConfig
from .device import TAOX, DeviceConfig

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class CrossbarConfig:
    """Static description of the analog tile and its I/O path.

    The reference's fields for the read and the rank-k write; ``carry``
    containers are read through :func:`core.tiled_analog.effective_g`.
    ``upd_col_bits`` is the voltage-coding precision of the column write
    driver (paper §IV.C: 3 magnitude bits + sign in the 8-bit variant);
    ``update_mode`` is ``"outer"`` (one aggregate write per cell) or
    ``"pulse_train"`` (sign-decomposed SET/RESET trains with integer event
    counts, ``kernels.xbar_update._pulse_epilogue``).
    """

    rows: int = 1024
    cols: int = 1024
    adc: AdcConfig = dataclasses.field(default_factory=AdcConfig)
    device: DeviceConfig = dataclasses.field(default_factory=lambda: TAOX)
    ref_sigma: float = 0.0
    upd_col_bits: int = 4
    update_mode: str = "outer"
    carry: bool = False
    carry_base: float = 4.0

    def replace(self, **kw) -> "CrossbarConfig":
        return dataclasses.replace(self, **kw)

    @property
    def g_mid(self) -> float:
        return 0.5 * (self.device.gmin + self.device.gmax)

    @property
    def w_swing(self) -> float:
        """Max |w| in conductance units (half window)."""
        return 0.5 * (self.device.gmax - self.device.gmin)


def weights_to_conductance(w: Tensor, cfg: CrossbarConfig,
                           w_max=None) -> Tuple[Tensor, Tensor]:
    """Map float weights onto the conductance window.

    Returns ``(g, w_scale)`` with ``w ≈ (g - g_mid) / w_scale`` and
    ``w_scale = w_swing / w_max``; ``w_max`` defaults to ``max|w|``.
    """
    if w_max is None:
        w_max = torch.clamp(w.abs().amax(), min=1e-12)
    w_scale = cfg.w_swing / w_max
    if not isinstance(w_scale, Tensor):
        w_scale = torch.tensor(w_scale, dtype=w.dtype, device=w.device)
    g = cfg.g_mid + torch.clamp(w * w_scale, -cfg.w_swing, cfg.w_swing)
    return g, w_scale.to(w.dtype)


def conductance_to_weights(g: Tensor, w_scale,
                           cfg: CrossbarConfig) -> Tensor:
    """Inverse of :func:`weights_to_conductance`: ``(g - g_mid) /
    w_scale``."""
    return (g - cfg.g_mid) / w_scale


def make_reference(shape: Tuple[int, ...], cfg: CrossbarConfig,
                   generator: Optional[torch.Generator] = None,
                   device=None) -> Tensor:
    """Reference array conductances (midpoint plus optional variability,
    drawn from ``generator``; not the reference package's draws)."""
    ref = torch.full(shape, cfg.g_mid, dtype=torch.float32, device=device)
    if cfg.ref_sigma > 0.0:
        if generator is None:
            raise ValueError("ref_sigma > 0 requires a torch.Generator")
        ref = ref + cfg.ref_sigma * torch.randn(
            shape, generator=generator, device=device)
    return ref


def pad_to_tiles(m: Tensor, rows: int, cols: int) -> Tensor:
    """Zero-pad a (K, N) matrix so both dims are tile multiples."""
    k, n = m.shape
    pk, pn = (-k) % rows, (-n) % cols
    if pk or pn:
        m = torch.nn.functional.pad(m, (0, pn, 0, pk))
    return m


def tile_grid(k: int, n: int, cfg: CrossbarConfig) -> Tuple[int, int]:
    """Number of crossbar tiles covering a (K, N) weight matrix."""
    return -(-k // cfg.rows), -(-n // cfg.cols)
