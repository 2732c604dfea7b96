"""Optimizer substrate of the port (port of `repro.optim`): AdamW with
global-norm clipping, the LR schedules, and the int8 gradient compression
with error feedback and its data-parallel all-reduce."""
from . import adamw, compress, schedule
from .adamw import AdamWConfig, AdamWState

__all__ = ["adamw", "compress", "schedule", "AdamWConfig", "AdamWState"]
