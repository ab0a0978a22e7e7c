"""Architecture configs (``--arch <id>``)."""
from .base import AnalogMode, ModelConfig, make_smoke, resolve_analog_mode
from .registry import ARCHS, get_config

__all__ = ["AnalogMode", "ModelConfig", "make_smoke", "resolve_analog_mode",
           "ARCHS", "get_config"]
