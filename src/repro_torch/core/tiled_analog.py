"""Tiled-crossbar parameter containers for whole-model analog execution.

Port of ``repro.core.tiled_analog`` (serving slice: forward read only).
Any projection matrix of the transformer is *programmed* onto a grid of
physical ``rows x cols`` crossbar tiles.  The container is a plain dict
that rides inside the parameter tree, stacked per layer or not:

    {"g": (..., K, N) conductances, "ref": (..., K, N) reference,
     "w_scale": (...) weight scale}

``analog_project`` reads it in-array (VMM, paper Fig. 3a).  The taped
backward pass and the rank-k write belong to the training slice
(``ROADMAP.md``).
"""
from __future__ import annotations

from functools import lru_cache
from typing import Dict, Optional

import torch

from .adc import AdcConfig
from .crossbar import CrossbarConfig, make_reference, weights_to_conductance
from .device import IDEAL, LINEARIZED, TAOX, TAOX_NONOISE, DeviceConfig
from .xbar_ops import vmm

Tensor = torch.Tensor

#: Device models selectable from a ModelConfig (``analog_device``).
DEVICE_MODELS: Dict[str, DeviceConfig] = {
    "ideal": IDEAL,
    "taox": TAOX,
    "taox-nonoise": TAOX_NONOISE,
    "linearized": LINEARIZED,
}


def device_model(name: str) -> DeviceConfig:
    """Resolve an ``analog_device`` name to a :class:`DeviceConfig`.

    ``<base>:wn<mult>`` scales the base model's write noise by a float
    multiplier (``taox:wn16`` is TaOx with 16x its write noise).
    """
    if ":wn" in name:
        base, mult = name.split(":wn", 1)
        dev = DEVICE_MODELS[base]
        return dev.replace(write_noise=dev.write_noise * float(mult))
    return DEVICE_MODELS[name]


@lru_cache(maxsize=None)
def crossbar_from_model(cfg) -> CrossbarConfig:
    """The physical tile description of a (frozen) ModelConfig."""
    return CrossbarConfig(
        rows=cfg.analog_rows, cols=cfg.analog_cols,
        device=device_model(cfg.analog_device),
        adc=AdcConfig(in_bits=cfg.analog_in_bits,
                      out_bits=cfg.analog_out_bits,
                      sat_sigmas=cfg.analog_sat_sigmas),
        carry=cfg.analog_carry, carry_base=cfg.analog_carry_base)


def program_linear(w: Tensor, cfg: CrossbarConfig,
                   generator: Optional[torch.Generator] = None,
                   w_max=None) -> dict:
    """Program a digitally initialised (K, N) weight matrix onto the grid.

    ``w_max`` fixes the weight <-> conductance window; the default leaves
    8x-rms headroom, computed from the weights, so programming a digital
    checkpoint round-trips exactly.
    """
    w = w.float()
    if w_max is None:
        w_max = 8.0 * torch.sqrt(torch.mean(w * w) + 1e-12)
    g, w_scale = weights_to_conductance(w, cfg, w_max=w_max)
    ref = make_reference(tuple(w.shape), cfg, generator=generator,
                         device=w.device)
    p = {"g": g, "ref": ref, "w_scale": w_scale}
    if cfg.carry:
        p["g_carry"] = ref.clone()
    return p


def program_stacked(w: Tensor, cfg: CrossbarConfig, w_max=None) -> dict:
    """Program a stack of weight matrices, (L, K, N) or deeper lead dims,
    one tile grid and one calibration per matrix."""
    if w.ndim == 2:
        return program_linear(w, cfg, w_max=w_max)
    parts = [program_stacked(wi, cfg, w_max=w_max) for wi in w]
    return {k: torch.stack([p[k] for p in parts]) for k in parts[0]}


def is_analog_container(p) -> bool:
    return isinstance(p, dict) and {"g", "ref", "w_scale"} <= set(p)


def effective_g(p: dict, cfg: CrossbarConfig) -> Tensor:
    """Conductances the read sees: the primary array plus, with a
    periodic-carry array, its deviation one significance level down."""
    gc = p.get("g_carry")
    if gc is None:
        return p["g"]
    return p["g"] + (gc - p["ref"]) / cfg.carry_base


def readout(p: dict, cfg: CrossbarConfig) -> Tensor:
    """Digital serial read of the programmed weights (stacked or not)."""
    w_scale = torch.as_tensor(p["w_scale"])[..., None, None]
    return (effective_g(p, cfg) - p["ref"]) / w_scale


def analog_project(p: dict, x: Tensor, cfg: CrossbarConfig) -> Tensor:
    """Apply a programmed (K, N) container to activations (..., K): one
    fused read over all tokens, returned in ``x.dtype``."""
    k, n = p["g"].shape
    y = vmm(x.reshape(-1, k).float(), effective_g(p, cfg), p["ref"],
            p["w_scale"], cfg)
    return y.reshape(*x.shape[:-1], n).to(x.dtype)
