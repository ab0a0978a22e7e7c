"""Architecture configs (``--arch <id>``)."""
from .base import (SHAPE_BY_NAME, SHAPES, AnalogMode, ModelConfig, ShapeSpec,
                   applicable_shapes, make_smoke, resolve_analog_mode)
from .registry import ARCHS, ASSIGNED, get_config

__all__ = ["AnalogMode", "ModelConfig", "ShapeSpec", "SHAPES",
           "SHAPE_BY_NAME", "applicable_shapes", "make_smoke",
           "resolve_analog_mode", "ARCHS", "ASSIGNED", "get_config"]
