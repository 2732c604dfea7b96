"""Span-based event tracing with Chrome/Perfetto `trace_event` export.

A copy of `repro.obs.trace` from the JAX package (pure Python), kept here so
the port imports nothing of that package. The contracts below are the
JAX package's and hold for this copy unchanged.

One module-global `Tracer` (installed with `enable()` / scoped with
`use()`) buffers three record kinds, all in the Chrome Trace Event
format (https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU)
so a saved file opens directly in `ui.perfetto.dev` or `chrome://tracing`:

  span(name, **args)     -- a timed region ("X" complete events with
                            microsecond ts/dur), used as a context manager;
  event(name, **args)    -- an instant ("i") event: QoS decisions, knob
                            moves, canary scores;
  counter(name, value)   -- a cumulative counter ("C" events): cache hits,
                            recompiles, canary ticks.

**Zero-cost-when-disabled contract.** With no tracer installed (the
default), `span()` returns a shared no-op context manager and `event()`/
`counter()` return immediately after one module-attribute read -- no
allocation beyond the kwargs dict, no locking, no time syscalls. Nothing
here may ever force a device->host transfer: payloads are stored AS GIVEN
(never `np.asarray`'d), which is also what lets lint rule A008 detect a
traced value leaking into an event payload (`docs/analysis.md`). The
serving tick's instrumentation rides this contract -- see the
`_cache_size()` + throughput-ratio regression gates in `tests/test_obs.py`
and `benchmarks/obs_overhead.py`.

Buffering is thread-safe (one lock around the append; `tid` records the
emitting thread) so the harness's thread-pool sweeps trace correctly.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, List, Optional

# The single active tracer. Read (not locked) on every span()/event()/
# counter() call -- module attribute reads are atomic in CPython, and the
# only mutation is install/uninstall.
_TRACER: Optional["Tracer"] = None


class _NullSpan:
    """Shared no-op context manager returned by `span()` when disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """A live timed region: records one "X" complete event on exit."""

    __slots__ = ("_tracer", "name", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: Dict):
        self._tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._tracer._complete(self.name, self._t0, time.perf_counter(),
                               self.args)
        return False


class Tracer:
    """Thread-safe buffer of Chrome trace events.

    Timestamps are microseconds relative to the tracer's construction
    (`perf_counter` deltas -- monotonic, sub-microsecond resolution).
    """

    def __init__(self):
        self._epoch = time.perf_counter()
        self._lock = threading.Lock()
        self._records: List[Dict] = []
        self._counters: Dict[str, float] = {}
        self._pid = os.getpid()

    # -- record sinks (called by the module-level API) -------------------

    def _us(self, t: float) -> float:
        return (t - self._epoch) * 1e6

    def _complete(self, name: str, t0: float, t1: float,
                  args: Dict) -> None:
        rec = {"name": name, "ph": "X", "ts": self._us(t0),
               "dur": (t1 - t0) * 1e6, "pid": self._pid,
               "tid": threading.get_ident()}
        if args:
            rec["args"] = args
        with self._lock:
            self._records.append(rec)

    def _instant(self, name: str, args: Dict) -> None:
        rec = {"name": name, "ph": "i", "s": "t",
               "ts": self._us(time.perf_counter()), "pid": self._pid,
               "tid": threading.get_ident()}
        if args:
            rec["args"] = args
        with self._lock:
            self._records.append(rec)

    def _count(self, name: str, value: float) -> None:
        with self._lock:
            total = self._counters.get(name, 0.0) + value
            self._counters[name] = total
            self._records.append({
                "name": name, "ph": "C",
                "ts": self._us(time.perf_counter()), "pid": self._pid,
                "tid": threading.get_ident(), "args": {"value": total}})

    # -- inspection ------------------------------------------------------

    @property
    def records(self) -> List[Dict]:
        """Snapshot of the buffered records (copy: safe to iterate while
        other threads keep tracing)."""
        with self._lock:
            return list(self._records)

    def counter_value(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    # -- export ----------------------------------------------------------

    def to_chrome(self) -> Dict:
        """The Perfetto/chrome://tracing document: an object with a
        `traceEvents` list (the "JSON Object Format", which both UIs
        accept and which leaves room for metadata)."""
        return {
            "traceEvents": self.records,
            "displayTimeUnit": "ms",
            "otherData": {"producer": "repro_torch.obs",
                          "schema": SCHEMA_VERSION},
        }

    def save(self, path: str) -> str:
        """Write the Chrome trace JSON. Non-JSON payload values fall back
        to `str()` -- a weird payload must never lose the whole trace."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_chrome(), f, default=str)
        os.replace(tmp, path)
        return path


SCHEMA_VERSION = 1


# --------------------------------------------------------------------------
# module-level API (what instrumented code calls)
# --------------------------------------------------------------------------

def enabled() -> bool:
    return _TRACER is not None


def get_tracer() -> Optional[Tracer]:
    return _TRACER


def enable(tracer: Optional[Tracer] = None) -> Tracer:
    """Install `tracer` (or a fresh one) as the active tracer."""
    global _TRACER
    _TRACER = tracer if tracer is not None else Tracer()
    return _TRACER


def disable() -> Optional[Tracer]:
    """Uninstall and return the active tracer (None if none was active)."""
    global _TRACER
    t, _TRACER = _TRACER, None
    return t


@contextlib.contextmanager
def use(tracer: Optional[Tracer] = None):
    """Scoped tracing: install for the block, restore the previous tracer
    after (tests and the A008 lint probe trace this way)."""
    global _TRACER
    prev = _TRACER
    _TRACER = tracer if tracer is not None else Tracer()
    try:
        yield _TRACER
    finally:
        _TRACER = prev


def span(name: str, **args) -> "_Span":
    """Timed region context manager; a shared no-op when disabled."""
    t = _TRACER
    if t is None:
        return _NULL_SPAN
    return _Span(t, name, args)


def event(name: str, **args) -> None:
    """Instant event (QoS decision, knob move, canary score, ...)."""
    t = _TRACER
    if t is None:
        return
    t._instant(name, args)


def counter(name: str, value: float = 1.0) -> None:
    """Increment a cumulative trace counter by `value`."""
    t = _TRACER
    if t is None:
        return
    t._count(name, value)
