"""Crossbar physics and the tiled-crossbar containers (torch)."""
from .adc import AdcConfig
from .crossbar import (CrossbarConfig, make_reference, pad_to_tiles,
                       tile_grid, weights_to_conductance)
from .device import IDEAL, LINEARIZED, TAOX, TAOX_NONOISE, DeviceConfig

__all__ = ["AdcConfig", "CrossbarConfig", "DeviceConfig", "IDEAL",
           "LINEARIZED", "TAOX", "TAOX_NONOISE", "make_reference",
           "pad_to_tiles", "tile_grid", "weights_to_conductance"]
