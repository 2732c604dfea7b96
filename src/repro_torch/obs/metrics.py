"""Typed counters, gauges, and histograms with one snapshot schema.

A copy of `repro.obs.metrics` from the JAX package (pure Python), kept here
so the port imports nothing of that package.

The registry is process-ambient and ALWAYS ON for coarse call sites (one
increment per sweep, per autotune rung, per engine construction): host-side
tallies whose cost is a dict lookup. Hot-path instrumentation (the serving
tick's per-tick histograms) is additionally gated on `trace.enabled()` so
the disabled serving path stays zero-cost -- see docs/observability.md for
the contract and `benchmarks/obs_overhead.py` for the gate.

`snapshot()` renders everything into ONE schema:

    {"counters":   {name: float},
     "gauges":     {name: float},
     "histograms": {name: {"count", "mean", "min", "max", "p50", "p99"}}}

and `stamp(doc)` embeds that snapshot under `doc["obs"]` -- every
`BENCH_*.json` artifact carries it, so benchmark JSONs finally share a
metrics schema instead of inventing per-module keys.

`percentile()` is the repo's ONE percentile implementation: EngineStats'
latency summaries (`serving/scheduler.py`) and the histogram summaries here
both call it, with the edge cases (empty -> None, singleton, duplicate
values) pinned by tests/test_obs.py.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

SNAPSHOT_SCHEMA_VERSION = 1


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """Percentile of `values` (None when empty -- 'no samples yet' must
    stay distinguishable from 0.0). Singleton lists return their element
    for every q; duplicate-value lists return that value."""
    if not len(values):
        return None
    return float(np.percentile(np.asarray(values, np.float64), q))


class Counter:
    """Monotone tally."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, value: float = 1.0) -> None:
        self.value += value


class Gauge:
    """Last-written value (queue depth, live lanes, current rung)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)


class Histogram:
    """Value distribution summarized to count/mean/min/max/p50/p99."""

    __slots__ = ("name", "values")

    def __init__(self, name: str):
        self.name = name
        self.values: List[float] = []

    def observe(self, value: float) -> None:
        self.values.append(float(value))

    def summary(self) -> Dict[str, Optional[float]]:
        v = self.values
        return {
            "count": len(v),
            "mean": float(np.mean(v)) if v else None,
            "min": float(min(v)) if v else None,
            "max": float(max(v)) if v else None,
            "p50": percentile(v, 50),
            "p99": percentile(v, 99),
        }


class MetricsRegistry:
    """Get-or-create registry of typed metrics. A name registered as one
    type cannot be re-registered as another (that is a bug, not a merge)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def _get(self, store: Dict, name: str, cls):
        with self._lock:
            m = store.get(name)
            if m is None:
                for other in (self._counters, self._gauges,
                              self._histograms):
                    if other is not store and name in other:
                        raise ValueError(
                            f"metric {name!r} already registered as a "
                            f"different type")
                m = store[name] = cls(name)
            return m

    def counter(self, name: str) -> Counter:
        return self._get(self._counters, name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(self._gauges, name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(self._histograms, name, Histogram)

    def snapshot(self) -> Dict:
        """The single snapshot schema every consumer reads/embeds."""
        with self._lock:
            return {
                "counters": {n: c.value
                             for n, c in sorted(self._counters.items())},
                "gauges": {n: g.value
                           for n, g in sorted(self._gauges.items())},
                "histograms": {n: h.summary()
                               for n, h in sorted(self._histograms.items())},
            }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


_GLOBAL = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _GLOBAL


def snapshot() -> Dict:
    return _GLOBAL.snapshot()


def reset() -> None:
    _GLOBAL.reset()


# Device-to-host reads the technique state machines and the apps make on
# purpose (a BLOCK-level decision, a run length, a convergence test): one
# increment per read. A read forces the host to wait for the device, so it
# is the count that says how far a loop is from running ahead of the card.
HOST_READS = "technique.host_reads"


def count_host_read(n: int = 1) -> None:
    """Tally `n` deliberate device-to-host reads under `HOST_READS`."""
    _GLOBAL.counter(HOST_READS).inc(n)


def host_reads() -> int:
    """The `HOST_READS` tally so far (take differences around a run)."""
    return int(_GLOBAL.counter(HOST_READS).value)


def stamp(doc: Dict) -> Dict:
    """Return `doc` with the process metrics snapshot embedded under
    `doc["obs"]` -- the shared tail every BENCH_*.json artifact carries.
    (`benchmarks/run.py` resets the registry before each module, so a
    stamped artifact reflects that module's run.)"""
    out = dict(doc)
    out["obs"] = {"schema": SNAPSHOT_SCHEMA_VERSION, "metrics": snapshot()}
    return out
