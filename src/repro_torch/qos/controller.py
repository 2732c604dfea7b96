"""The feedback loop: walk the policy ladder against the monitored error
(port of `repro.qos.controller`, host logic line for line).

The controller closes the loop the offline harness leaves open. Its state
is ONE integer -- the current ladder rung -- moved by three rules evaluated
each update, strictest first:

  violation   monitored estimate >= target       -> HARD FALLBACK: jump to
                                                    rung 0 (precise) and pin
                                                    there for `fallback_hold`
                                                    updates;
  pressure    estimate > headroom * target       -> step ONE rung toward
                                                    precise;
  headroom    estimate < backoff * target AND    -> step ONE rung toward
              drift (window RSD) <= drift_limit     aggressive (gated by
                                                    the offline prior; see
                                                    `trust_offline`).

Single-rung moves plus the `hold_ticks` hysteresis keep the actuator from
oscillating; the drift gate keeps it from loosening on a noisy estimate.
Because the ladder is a Pareto front, every tighten is the cheapest
quality-improving move available and every loosen the cheapest
performance-improving one.

Everything is deterministic: the same canary stream produces the same
trajectory (the closed-loop demo in tests/test_qos.py replays an injected
error spike and asserts the exact back-off sequence).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Union

from ..core.types import ApproxSpec
from ..obs import trace

from .monitor import QualityMonitor
from .policy import PolicyEntry, QosPolicy, QosTarget


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """Feedback-loop knobs (fractions are of the target's max_error)."""

    headroom: float = 0.8     # tighten above this fraction of the bound
    backoff: float = 0.5      # loosen below this fraction of the bound
    min_samples: int = 4      # no moves before this many canary pairs
    hold_ticks: int = 4       # min updates between consecutive moves
    fallback_hold: int = 8    # updates pinned precise after a violation
    drift_limit: float = 1.5  # max window RSD at which loosening is allowed
    # With trust_offline (default), loosening never steps onto a rung whose
    # OFFLINE error already violates the target: the sweep DB is a prior,
    # and probing a rung the harness measured as out-of-bound costs real
    # quality before the canary can react. The controller then loosens at
    # most back to the offline `select` choice (recovery after tighten/
    # fallback). trust_offline=False allows exploration past the prior --
    # for workloads whose offline error (e.g. trajectory-level) is known to
    # be pessimistic vs the online estimate (one-step canaries).
    trust_offline: bool = True

    def __post_init__(self):
        if not (0.0 < self.backoff < self.headroom <= 1.0):
            raise ValueError(
                "need 0 < backoff < headroom <= 1 "
                f"(got backoff={self.backoff}, headroom={self.headroom})")


@dataclasses.dataclass(frozen=True)
class TrajectoryPoint:
    """One update's outcome (the knob trajectory the benchmark emits)."""

    step: int
    index: int                # rung AFTER this update
    estimate: float
    drift: float
    event: str                # hold|warmup|tighten|loosen|fallback|cooldown

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


class QosController:
    """One request class's closed loop over a shared policy + monitor."""

    def __init__(self, policy: QosPolicy, monitor: QualityMonitor,
                 target: Union[QosTarget, float],
                 config: ControllerConfig = ControllerConfig()):
        if not isinstance(target, QosTarget):
            target = QosTarget(max_error=float(target), metric=policy.metric)
        if target.metric != monitor.metric:
            raise ValueError(
                f"target metric {target.metric!r} does not match the "
                f"monitor metric {monitor.metric!r}")
        self.policy = policy
        self.monitor = monitor
        self.target = target
        self.config = config
        # start from the OFFLINE choice: the fastest rung whose sweep-time
        # error met the bound -- the controller then corrects online.
        self.index = policy.select(target)
        self.steps = 0
        self._last_move = -config.hold_ticks
        self._cooldown = 0
        self.violations = 0
        self.fallback_ticks = 0
        self.moves = 0
        self.trajectory: List[TrajectoryPoint] = []

    # ------------------------------------------------------------------

    def rebind_monitor(self, monitor: QualityMonitor) -> None:
        """Point this controller's evidence reads -- and, crucially, its
        hard-fallback `reset_window` -- at a different monitor.
        `QosEngine.enable_sharding` gives each request class its own
        evidence monitor this way, so one class's fallback no longer wipes
        the shared window every other class judges its bound against. The
        metric contract is re-checked, same as at construction."""
        if monitor.metric != self.target.metric:
            raise ValueError(
                f"target metric {self.target.metric!r} does not match the "
                f"monitor metric {monitor.metric!r}")
        self.monitor = monitor

    # ------------------------------------------------------------------

    def entry(self) -> PolicyEntry:
        return self.policy.entries[self.index]

    def spec(self) -> ApproxSpec:
        return self.policy.spec_at(self.index)

    @property
    def in_fallback(self) -> bool:
        return self._cooldown > 0

    @property
    def fallback_rate(self) -> float:
        """Fraction of updates spent pinned precise by a violation."""
        return self.fallback_ticks / self.steps if self.steps else 0.0

    # ------------------------------------------------------------------

    def update(self, *, est: Optional[float] = None,
               drift: Optional[float] = None,
               window_size: Optional[int] = None) -> PolicyEntry:
        """One feedback evaluation; returns the (possibly new) rung.

        `est`/`drift`/`window_size` override the monitor reads: the engine
        snapshots them once per tick so that every class's controller
        judges the SAME evidence -- without the snapshot, one controller's
        fallback would reset the shared window and silently swallow a
        concurrent violation of another class's bound."""
        self.steps += 1
        cfg, bound = self.config, self.target.max_error
        if est is None:
            est = self.monitor.estimate()
        if drift is None:
            drift = self.monitor.drift()
        if window_size is None:
            window_size = self.monitor.window_size
        event = "hold"

        # Branch order: a violation preempts everything (the WINDOW
        # ESTIMATE at or over the bound triggers the hard fallback on
        # however little evidence -- it is not made to wait out the
        # min_samples gate; note it is the window mean, so a lone bad
        # canary in a full clean window must be large enough to move the
        # mean over the bound); the cooldown ticks
        # down ahead of the warmup gate so the pinned-precise duration is
        # `fallback_hold` updates as documented (the window reset below
        # empties the window, and a warmup-first order would freeze the
        # cooldown until min_samples fresh canaries arrived). The warmup
        # gate covers the move branches only: after a reset an empty
        # window estimates 0.0, which must read as "no evidence yet",
        # not "perfect quality".
        if est >= bound and window_size > 0:
            event = "fallback"
            self.violations += 1
            self._cooldown = cfg.fallback_hold
            if self.index != 0:
                self.index = 0
                self.moves += 1
                self._last_move = self.steps
            # The actuator just jumped to precise: the window's samples no
            # longer describe the running configuration. Dropping them
            # makes one spike count as ONE violation instead of repeating
            # the fallback until the spike ages out of the window.
            self.monitor.reset_window()
        elif self._cooldown > 0:
            event = "cooldown"
            self._cooldown -= 1
        elif window_size < cfg.min_samples:
            event = "warmup"
        elif est > cfg.headroom * bound:
            if (self.index > 0
                    and self.steps - self._last_move >= cfg.hold_ticks):
                self.index -= 1
                self.moves += 1
                self._last_move = self.steps
                event = "tighten"
        elif est < cfg.backoff * bound and drift <= cfg.drift_limit:
            admissible = (self.index < len(self.policy) - 1 and
                          (not cfg.trust_offline or
                           self.policy.entries[self.index + 1].error < bound))
            if (admissible
                    and self.steps - self._last_move >= cfg.hold_ticks):
                self.index += 1
                self.moves += 1
                self._last_move = self.steps
                event = "loosen"

        if event in ("fallback", "cooldown"):
            self.fallback_ticks += 1
        self.trajectory.append(TrajectoryPoint(
            step=self.steps, index=self.index, estimate=est, drift=drift,
            event=event))
        # decision events with reasons, for the Perfetto timeline; steady
        # "hold" steps stay out of the trace (they carry no decision) but
        # every state change -- including warmup/cooldown transitions --
        # lands with the evidence that drove it
        if event != "hold" and trace.enabled():
            trace.event("qos_decision",
                        request_class=self.target.request_class,
                        reason=event, index=self.index, estimate=est,
                        drift=drift, window=window_size,
                        bound=bound)
        return self.entry()

    # ------------------------------------------------------------------

    def trajectory_json(self) -> List[Dict]:
        return [p.to_json() for p in self.trajectory]

    def summary(self) -> Dict:
        ms = self.monitor.stats()
        return {
            "target": self.target.to_json(),
            "index": self.index,
            "spec": self.entry().spec,
            "updates": self.steps,
            "moves": self.moves,
            "violations": self.violations,
            "fallback_rate": self.fallback_rate,
            "estimate": ms.estimate,
            "mean_error": ms.mean_error,
            "canary_samples": ms.samples,
        }
