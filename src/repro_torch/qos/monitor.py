"""Online quality estimation via canary sampling (port of
`repro.qos.monitor`, host logic line for line).

The offline harness knows the error of a configuration because it ran the
exact baseline; the serving path cannot afford that per request. The
standing AC answer (Leon et al. Part I, section "quality control"; Ben
Khadra's survey) is CANARY SAMPLING: re-execute a small, configurable
fraction of requests/steps through the precise path (the host-substrate
oracle) and compare.

`QualityMonitor` owns three things:

  * the deterministic sampling schedule -- fire on every floor-crossing
    of n * fraction, so canaries are evenly spaced, reproducible, and hit
    exactly floor(n * fraction) of the first n steps (no RNG, no seed drift between
    runs: an injected fault replays bit-identically);
  * the per-pair error, computed by the SAME `harness.mape` / `harness.mcr`
    functions the offline sweep used -- monitor estimates therefore match
    offline numbers bit for bit on the sampled pairs (pinned by
    tests/test_qos.py);
  * RSD-style drift statistics over a sliding window (the same
    sigma/|mu| statistic TAF itself uses to detect regime changes), which
    the controller uses to distinguish "steady headroom" (safe to loosen)
    from "drifting" (hold).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque

import numpy as np

from ..core.harness import ERROR_METRICS
from ..obs import trace


@dataclasses.dataclass(frozen=True)
class MonitorStats:
    """Snapshot of the monitor's state (all derived from the window except
    the lifetime aggregates)."""

    samples: int                 # lifetime canary pairs observed
    window_size: int             # pairs currently in the sliding window
    estimate: float              # mean error over the window
    drift: float                 # RSD (sigma/|mu|) of the window errors
    last: float                  # most recent canary error
    mean_error: float            # lifetime mean canary error (faults incl.)
    injected: int                # fault-injected samples among `samples`
    genuine_mean_error: float    # lifetime mean over NON-injected canaries


class QualityMonitor:
    """Sliding-window canary quality estimator.

    `sample_fraction` is the canary rate; `window` bounds how much history
    the estimate reacts to (smaller = faster fallback, noisier loosening).
    `phase` offsets the deterministic schedule (two monitors with different
    phases canary different steps).
    """

    def __init__(self, *, metric: str = "mape", sample_fraction: float = 0.1,
                 window: int = 32, phase: float = 0.0, eps: float = 1e-12):
        if metric not in ERROR_METRICS:
            raise ValueError(f"unknown metric {metric!r}; expected one of "
                             f"{sorted(ERROR_METRICS)}")
        if not (0.0 <= sample_fraction <= 1.0):
            raise ValueError("sample_fraction must be in [0, 1]")
        if window < 1:
            raise ValueError("window must be >= 1")
        self.metric = metric
        self.metric_fn = ERROR_METRICS[metric]
        self.sample_fraction = float(sample_fraction)
        self.eps = eps
        self._phase = float(phase) % 1.0
        self._schedule_steps = 0
        self._window: Deque[float] = collections.deque(maxlen=window)
        self.samples = 0
        self._err_sum = 0.0
        self.injected = 0
        self._injected_sum = 0.0

    # ------------------------------------------------------------------
    # canary schedule
    # ------------------------------------------------------------------

    def should_sample(self) -> bool:
        """Advance the schedule one step; True on canary steps.

        A canary fires whenever floor(n * fraction + phase) increments --
        evenly spaced and deterministic, and the first n steps contain
        EXACTLY floor(n * fraction + phase) - floor(phase) canaries. The
        product is computed fresh each step (one float rounding) rather
        than by accumulating `fraction` (n roundings): an accumulator
        drifts below the crossing points, e.g. ten additions of 0.1 sum
        to 0.9999999999999999 and the promised 1-in-10 canary never fires.
        """
        n = self._schedule_steps = self._schedule_steps + 1
        f, ph = self.sample_fraction, self._phase
        return int(n * f + ph) > int((n - 1) * f + ph)

    # ------------------------------------------------------------------
    # observation
    # ------------------------------------------------------------------

    def observe(self, exact_qoi, approx_qoi) -> float:
        """Score one canary pair with the offline error metric and fold it
        into the window. Returns the pair's error (bit-identical to
        `harness.mape(exact, approx)` / `harness.mcr(...)`)."""
        err = float(self.metric_fn(np.asarray(exact_qoi),
                                   np.asarray(approx_qoi)))
        self._record(err)
        if trace.enabled():
            trace.event("canary", metric=self.metric, error=err,
                        estimate=self.estimate(),
                        window=len(self._window))
        return err

    def record(self, error: float) -> None:
        """Fold an externally scored GENUINE canary error into the window
        (unlike `inject`, not counted as a fault). The sharded engine's
        per-class evidence monitors are fed this way: each canary pair is
        scored ONCE (by the shared monitor's metric) and the resulting
        error fans out to every class exposed to that shard's knob."""
        self._record(float(error))

    def inject(self, error: float) -> None:
        """Fold a pre-computed canary error into the window. The fault-
        injection hook: tests and the QoS benchmark use it to stage a
        deterministic quality spike and assert the controller's response.
        Injected samples are tracked separately so reports can tell genuine
        measured quality from drill faults."""
        self.injected += 1
        self._injected_sum += float(error)
        self._record(float(error))
        trace.event("fault_injected", metric=self.metric,
                    error=float(error))

    def _record(self, error: float) -> None:
        self._window.append(error)
        self.samples += 1
        self._err_sum += error

    # ------------------------------------------------------------------
    # statistics
    # ------------------------------------------------------------------

    @property
    def window(self) -> int:
        """Configured window capacity (the deque's maxlen) -- what a clone
        with the same evidence horizon should be constructed with."""
        return self._window.maxlen

    @property
    def window_size(self) -> int:
        """Canary pairs currently in the window -- the EVIDENCE count for
        the running configuration (unlike `samples`, it drops to zero on
        `reset_window`, so controllers gate moves on it)."""
        return len(self._window)

    def estimate(self) -> float:
        """Mean error over the sliding window (0.0 before any canary)."""
        if not self._window:
            return 0.0
        return float(np.mean(np.asarray(self._window, np.float64)))

    def drift(self) -> float:
        """RSD of the window errors: population sigma / max(|mu|, eps) --
        the same statistic TAF's stability detector uses. High drift means
        the estimate is not trustworthy enough to loosen on."""
        if len(self._window) < 2:
            return 0.0
        w = np.asarray(self._window, np.float64)
        mu = float(np.mean(w))
        sigma = float(np.std(w))
        return sigma / max(abs(mu), self.eps)

    def stats(self) -> MonitorStats:
        genuine = self.samples - self.injected
        return MonitorStats(
            samples=self.samples,
            window_size=len(self._window),
            estimate=self.estimate(),
            drift=self.drift(),
            last=self._window[-1] if self._window else 0.0,
            mean_error=self._err_sum / self.samples if self.samples else 0.0,
            injected=self.injected,
            genuine_mean_error=((self._err_sum - self._injected_sum)
                                / genuine if genuine else 0.0),
        )

    def reset_window(self) -> None:
        """Drop the window (lifetime aggregates survive). Used when the
        actuator moves so far that stale canaries no longer describe the
        running configuration (e.g. the hard precise fallback)."""
        self._window.clear()
