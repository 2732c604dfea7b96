"""The port's warm-up/median-of-k timer (counterpart of `repro.obs.timing`).

`measure(fn, *args, device=...)` calls `fn` `warmup` times, then times
`repeats` calls and returns the chosen statistic:

  * on a CUDA device each timed call sits between a pair of
    `torch.cuda.Event`s recorded on the current stream, and the end event is
    synchronized before its time is read: PyTorch returns before the device
    finishes, so a host clock alone would time the enqueue;
  * on the CPU each call is timed with `time.perf_counter`.

The statistic defaults to the median; `stat="min"` gives the best-of-N the
sweep harness uses. When tracing is enabled, each measurement emits one
span named by `span` (or "obs.measure") carrying the per-repeat times.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Tuple

import torch

from . import trace


@dataclass(frozen=True)
class Measurement:
    """Result of `measure()`: the chosen statistic in seconds, the raw
    per-repeat times, and the value returned by the final timed call."""

    seconds: float
    times: Tuple[float, ...] = field(default=())
    value: Any = None


def _stat(times: List[float], stat: str) -> float:
    if stat == "median":
        s = sorted(times)
        return s[len(s) // 2]
    if stat == "min":
        return min(times)
    if stat == "mean":
        return sum(times) / len(times)
    raise ValueError(f"unknown stat {stat!r} (median|min|mean)")


def _timed_call(fn: Callable, args, kwargs, on_cuda: bool):
    if on_cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        value = fn(*args, **kwargs)
        end.record()
        end.synchronize()
        return value, start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    value = fn(*args, **kwargs)
    return value, time.perf_counter() - t0


def measure(fn: Callable, *args, device, warmup: int = 2, repeats: int = 5,
            stat: str = "median", span: Optional[str] = None,
            **kwargs) -> Measurement:
    """Time `fn(*args, **kwargs)` on `device` (a torch device or its name)
    with warm-up; return the `stat` over `repeats` timed calls.

    `repeats=0` means "warm but don't time" and reports seconds=0.0 with no
    samples.
    """
    on_cuda = torch.device(device).type == "cuda"
    value = None
    for _ in range(warmup):
        value = fn(*args, **kwargs)
    if on_cuda:
        torch.cuda.synchronize()
    times: List[float] = []
    for _ in range(repeats):
        value, dt = _timed_call(fn, args, kwargs, on_cuda)
        times.append(dt)
    seconds = _stat(times, stat) if times else 0.0
    if trace.enabled():
        with trace.span(span or "obs.measure", warmup=warmup,
                        repeats=repeats, stat=stat, seconds=seconds,
                        times=list(times)):
            pass
    return Measurement(seconds=seconds, times=tuple(times), value=value)
