"""Step functions: prefill and serve (one-token decode) (port of the
serving half of `repro.launch.steps`).

JAX jits these; eager PyTorch has nothing to compile, so the counterpart
of "a knob move recompiles nothing" is that no caller builds a new step
after construction: `builds()` counts every step built, and the serving
tests and `obs_overhead` pin its difference across knob moves and tracing
at 0. The train steps come with the model zoo and training (ROADMAP Queue
1 item 6), the sharded serve step with multi-GPU (item 5).
"""
from __future__ import annotations

from typing import Callable

import torch

from ..models.lm import Model

_BUILDS = [0]


def builds() -> int:
    """Step functions built so far in this process."""
    return _BUILDS[0]


def make_prefill_step(model: Model, max_len: int) -> Callable:
    """(params, batch) -> (last logits (B, V), a cache of max_len)."""
    _BUILDS[0] += 1

    def prefill_step(params, batch):
        return model.prefill(params, dict(batch, max_len=max_len))

    return prefill_step


def make_serve_step(model: Model) -> Callable:
    """One-token decode: (params, cache, tokens (B,), pos) ->
    (next_tokens (B,) int32, logits (B, V), the cache updated in place)."""
    _BUILDS[0] += 1

    def serve_step(params, cache, tokens, pos: int):
        logits, new_cache = model.decode_step(params, cache, tokens, pos)
        next_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tokens, logits, new_cache

    return serve_step
