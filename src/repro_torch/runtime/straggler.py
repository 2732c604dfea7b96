"""Straggler detection + preemption handling (port of
`repro.runtime.straggler`, host only, line for line).

At 1000+ nodes, slow hosts (thermal throttling, failing HBM, noisy
neighbors) stretch every synchronous step. The monitor keeps a rolling
per-step duration window; a step slower than `threshold x median` raises a
flag with an attribution hook (in multi-host deployments, per-host step
barriers timestamps feed `record_host`); the supervisor can then evict/
replace the host and the elastic restore path (checkpoint.manager +
runtime.elastic) brings the job back on the surviving mesh.
"""
from __future__ import annotations

import collections
import dataclasses
import signal
import time
from typing import Callable, Deque, Dict, List, Optional


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration_s: float
    median_s: float
    host: Optional[int] = None

    @property
    def slowdown(self) -> float:
        return self.duration_s / max(self.median_s, 1e-9)


class StepMonitor:
    def __init__(self, window: int = 32, threshold: float = 2.5,
                 warmup_steps: int = 4):
        self.window: Deque[float] = collections.deque(maxlen=window)
        self.threshold = threshold
        self.warmup_steps = warmup_steps
        self.events: List[StragglerEvent] = []
        self._step = 0

    def record(self, duration_s: float,
               host: Optional[int] = None) -> Optional[StragglerEvent]:
        self._step += 1
        if self._step <= self.warmup_steps:
            self.window.append(duration_s)
            return None
        med = sorted(self.window)[len(self.window) // 2]
        event = None
        if duration_s > self.threshold * med:
            event = StragglerEvent(self._step, duration_s, med, host)
            self.events.append(event)
        else:
            # only healthy steps update the baseline -- a straggling phase
            # must not drag the median up and mask itself
            self.window.append(duration_s)
        return event

    def record_host_durations(self, durations: Dict[int, float]
                              ) -> List[StragglerEvent]:
        """Multi-host form: per-host step durations (from barrier
        timestamps); flags each host beyond threshold x cross-host median."""
        med = sorted(durations.values())[len(durations) // 2]
        out = []
        for host, d in durations.items():
            if d > self.threshold * med:
                ev = StragglerEvent(self._step, d, med, host)
                self.events.append(ev)
                out.append(ev)
        self._step += 1
        return out


class PreemptionGuard:
    """SIGTERM-aware context: cloud preemptions deliver a grace signal; the
    train loop polls `should_stop` each step and checkpoints before exit."""

    def __init__(self, install: bool = True):
        self._flag = False
        if install:
            try:
                signal.signal(signal.SIGTERM, self._handler)
                signal.signal(signal.SIGINT, self._handler)
            except ValueError:
                pass  # not on main thread (tests)

    def _handler(self, signum, frame):
        self._flag = True

    @property
    def should_stop(self) -> bool:
        return self._flag

    def trigger(self):  # for tests / manual drain
        self._flag = True
