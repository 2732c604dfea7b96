"""Continuous-batching serving of the port (port of `repro.serving`)."""
from .scheduler import EngineStats, KnobMove, Request, ServingEngine

__all__ = ["EngineStats", "KnobMove", "Request", "ServingEngine"]
