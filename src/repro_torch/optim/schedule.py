"""LR schedules, pure functions of the step (port of
`repro.optim.schedule`), computed in float32 as the JAX package computes
them. The step may be an int or a 0-d tensor on the card (a train step's
counter); the result is a 0-d float32 tensor on the step's device."""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(step, *, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1) -> torch.Tensor:
    step = _step(step)
    warm = torch.clamp(step / max(warmup_steps, 1), max=1.0)
    progress = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * progress))
    return warm * (min_ratio + (1 - min_ratio) * cos)


def constant(step, **_) -> torch.Tensor:
    return torch.ones_like(_step(step))
