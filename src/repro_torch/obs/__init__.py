"""repro_torch.obs -- tracing, metrics and the device timer of the port.

`trace`, `metrics` and `recorder` (the flight recorder) are copies of the
JAX package's pure-Python modules; `timing.measure` times with CUDA events
on the card and `perf_counter` on the CPU; `report` renders a trace or a
BENCH metrics stamp.
"""
from __future__ import annotations

from . import metrics, recorder, timing, trace  # noqa: F401
from .metrics import percentile, stamp  # noqa: F401
from .timing import Measurement, measure  # noqa: F401
from .trace import (  # noqa: F401
    Tracer, counter, disable, enable, enabled, event, get_tracer, span,
    use,
)


def count(name: str, value: float = 1.0) -> None:
    """Increment `name` in the always-on metrics registry AND (when
    tracing) as a trace counter track."""
    metrics.registry().counter(name).inc(value)
    trace.counter(name, value)
