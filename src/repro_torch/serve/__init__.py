"""Serving: one ``make_engine`` entry point over digital or analog state."""
from .engine import (ContinuousEngine, Engine, Request, SamplingParams,
                     make_engine)
from .state import AnalogServeRuntime, ServeState, make_serve_state

__all__ = ["AnalogServeRuntime", "ContinuousEngine", "Engine", "Request",
           "SamplingParams", "ServeState", "make_engine",
           "make_serve_state"]
