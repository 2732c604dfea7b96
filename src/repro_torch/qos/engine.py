"""QosEngine: the serving-side bundle of policy + monitor + controllers
(port of `repro.qos.engine`, host logic line for line, one shard).

One engine serves one continuous-batching loop. It owns:

  * a shared `QualityMonitor` (the decode loop has ONE canary stream --
    the precise re-execution of a sampled tick);
  * one `QosController` per REQUEST CLASS, each walking the shared policy
    ladder under its own error bound (per-request quality targets, the
    ROADMAP's "millions of users" requirement, not per-paper figures);
  * the per-tick actuation plan: live lanes are grouped by their class's
    current knob (`batching.group_lanes`), and -- because the decode loop
    runs ONE shared step per tick -- the engine actuates the STRICTEST live
    rung (min ladder index), which satisfies every live class's bound
    simultaneously. A multi-timeline engine would instead run one decode
    call per knob group; the plan exposes the groups so schedulers can.

The knob itself is data (the model's TAF threshold lives in the decode
cache as a tensor), so a knob move rebuilds nothing. The per-shard methods
(`enable_sharding`, `plan_shards`, `observe_shard`, `update_shards`,
`inject(..., shard=)`) come with the sharded engine (ROADMAP Queue 1 item
5).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..core import batching
from ..core.types import ApproxSpec
from ..obs import recorder as obs_recorder

from .controller import ControllerConfig, QosController
from .monitor import QualityMonitor
from .policy import (QosPolicy, QosTarget, spec_knob, validate_ladder_knobs)

TargetLike = Union[QosTarget, float]


@dataclasses.dataclass(frozen=True)
class TickPlan:
    """What one engine tick should run.

    `index`/`spec`/`knob` describe the chosen (strictest-live) rung; `knob`
    is None for precise. `groups` maps each static-structure key to the
    lane indices + stacked knobs that COULD run as one vmapped call;
    `precise_lanes` are the lanes whose class currently demands rung 0.

    """

    index: int
    spec: ApproxSpec
    knob: Optional[float]
    groups: Dict[Tuple, Tuple[List[int], List[float]]]
    precise_lanes: List[int]

    @property
    def n_groups(self) -> int:
        return len(self.groups) + (1 if self.precise_lanes else 0)


class QosEngine:
    """Quality-of-service control plane for a serving loop.

    targets: one bound (QosTarget or float max_error) or a dict mapping
    request-class names to bounds. A request whose class is missing from
    the dict is served under the "default" class (required when a dict is
    given).
    """

    def __init__(self, policy: QosPolicy,
                 targets: Union[TargetLike, Dict[str, TargetLike]], *,
                 sample_fraction: float = 0.1, window: int = 16,
                 config: ControllerConfig = ControllerConfig(),
                 monitor: Optional[QualityMonitor] = None):
        validate_ladder_knobs(policy)
        self.policy = policy
        self.monitor = monitor or QualityMonitor(
            metric=policy.metric, sample_fraction=sample_fraction,
            window=window)
        if not isinstance(targets, dict):
            targets = {"default": targets}
        if "default" not in targets:
            raise ValueError(
                "targets must include a 'default' request class "
                f"(got classes {sorted(targets)})")
        self.controllers: Dict[str, QosController] = {
            cls: QosController(policy, self.monitor, self._target(cls, t),
                               config)
            for cls, t in targets.items()}
        # per-class canary EXPOSURE: errors observed while the class had
        # live lanes. This is what the class's requests actually got --
        # the global monitor mean mixes phases served under other classes'
        # knobs, so it cannot show a per-class contract held.
        self._exposure: Dict[str, List[float]] = {
            cls: [] for cls in self.controllers}
        self._actuated_index: Optional[int] = None

    def _target(self, cls: str, t: TargetLike) -> QosTarget:
        """Normalize a bound to a QosTarget stamped with its class name
        (so serialized targets in reports name the class they bind)."""
        if not isinstance(t, QosTarget):
            t = QosTarget(max_error=float(t), metric=self.policy.metric)
        return dataclasses.replace(t, request_class=cls)

    # ------------------------------------------------------------------
    # per-class access
    # ------------------------------------------------------------------

    def controller(self, request_class: str = "default") -> QosController:
        return self.controllers.get(request_class,
                                    self.controllers["default"])

    def spec_for(self, request_class: str = "default") -> ApproxSpec:
        return self.controller(request_class).spec()

    def _norm_class(self, cls: str) -> str:
        return cls if cls in self.controllers else "default"

    # ------------------------------------------------------------------
    # the per-tick loop
    # ------------------------------------------------------------------

    def plan_tick(self, lane_classes: Sequence[str]) -> TickPlan:
        """Actuation plan for one tick given the live lanes' classes.

        Empty `lane_classes` plans the default class (an idle engine keeps
        its default posture)."""
        classes = list(lane_classes) or ["default"]
        specs = [self.spec_for(c) for c in classes]
        groups, precise = batching.group_lanes(specs)
        index = min(self.controller(c).index for c in classes)
        if index != self._actuated_index:
            # knob-regime change (a controller moved, or the live class
            # mix changed the strictest rung): the window's canaries
            # describe the OLD regime -- judging any class's bound against
            # them would fabricate violations (or headroom). Drop them;
            # the min_samples evidence gate holds moves until fresh ones.
            # EXCEPT when the stale window already crosses a live class's
            # bound (e.g. a fault injected since the last update): a
            # violation is never discarded -- the window survives so this
            # tick's update() fires the hard fallback. The asymmetry is
            # deliberate: a stale-evidence fallback costs speed, a
            # discarded violation costs the quality contract.
            if self._actuated_index is not None:
                bound = min(self.controller(c).target.max_error
                            for c in classes)
                if not (self.monitor.window_size > 0
                        and self.monitor.estimate() >= bound):
                    self.monitor.reset_window()
            self._actuated_index = index
        spec = self.policy.spec_at(index)
        return TickPlan(index=index, spec=spec, knob=spec_knob(spec),
                        groups=groups, precise_lanes=precise)

    def should_sample(self) -> bool:
        """Advance the canary schedule (call exactly once per tick)."""
        return self.monitor.should_sample()

    def _qoi(self, exact_logits, approx_logits):
        """Metric-specific QoI: for "mape" the logits tensor; for "mcr"
        the decoded token ids (argmax) -- the serving analogues of the
        offline metrics' QoI choices."""
        if self.monitor.metric == "mcr":
            return (np.argmax(np.asarray(exact_logits), axis=-1),
                    np.argmax(np.asarray(approx_logits), axis=-1))
        return np.asarray(exact_logits), np.asarray(approx_logits)

    def inject(self, error: float) -> None:
        """Stage a deterministic fault (equivalent to `monitor.inject`,
        the single-engine drill)."""
        self.monitor.inject(error)

    def observe_decode(self, exact_logits, approx_logits,
                       lane_classes: Sequence[str] = ()) -> float:
        """Score one canary tick. `lane_classes` (the live lanes' classes)
        attributes the canary to every class exposed to this tick's
        knob."""
        exact_q, approx_q = self._qoi(exact_logits, approx_logits)
        err = self.monitor.observe(exact_q, approx_q)
        for cls in {self._norm_class(c) for c in lane_classes}:
            self._exposure[cls].append(err)
        return err

    def update(self, lane_classes: Optional[Sequence[str]] = None) -> None:
        """One feedback evaluation. With `lane_classes` (the tick's live
        lanes), only the EXPOSED classes' controllers step: canary errors
        are measured under the actuated knob, and judging an absent class's
        bound against another class's phase would log spurious violations.
        `None` (no lane information) updates every controller."""
        if lane_classes is None:
            live = set(self.controllers)
        else:
            live = {c if c in self.controllers else "default"
                    for c in lane_classes}
        # Snapshot the evidence ONCE: a controller's hard fallback resets
        # the shared monitor window, and without the snapshot the classes
        # updating after it would see an empty window -- a concurrent
        # violation of their own bound silently swallowed, and the
        # trajectory dependent on set iteration order (hash-seed salted).
        # sorted() keeps the trajectory append order deterministic too.
        est = self.monitor.estimate()
        drift = self.monitor.drift()
        wsize = self.monitor.window_size
        for cls in sorted(live):
            self.controllers[cls].update(est=est, drift=drift,
                                         window_size=wsize)
        self._flight_note(sorted(live))

    def _flight_note(self, stepped: Sequence[str]) -> None:
        """Feed the flight recorder (when one is installed): one per-tick
        note of per-class control state, and a `trip()` dump on the tick a
        controller fires its hard fallback -- the incident the ring buffer
        exists for. Host-side dict work only; no-op without a recorder."""
        rec = obs_recorder.get_recorder()
        if rec is None:
            return
        classes = {}
        for cls, ctl in self.controllers.items():
            mon = self.monitor
            last = ctl.trajectory[-1] if ctl.trajectory else None
            classes[cls] = {
                "index": ctl.index,
                "knob": spec_knob(ctl.spec()),
                "bound": ctl.target.max_error,
                "estimate": mon.estimate(),
                "drift": mon.drift(),
                "window": mon.window_size,
                "event": last.event if last else None,
            }
        rec.note(classes=classes)
        for cls in stepped:
            t = self.controllers[cls].trajectory
            if t and t[-1].event == "fallback":
                rec.trip("fallback", request_class=cls,
                         estimate=t[-1].estimate, drift=t[-1].drift,
                         bound=self.controllers[cls].target.max_error,
                         step=t[-1].step)

    # ------------------------------------------------------------------
    # reporting
    # ------------------------------------------------------------------

    @property
    def fallback_rate(self) -> float:
        return max((c.fallback_rate for c in self.controllers.values()),
                   default=0.0)

    def summary(self) -> Dict:
        ms = self.monitor.stats()
        out = {
            "metric": self.monitor.metric,
            "sample_fraction": self.monitor.sample_fraction,
            "canary_samples": ms.samples,
            "mean_error": ms.mean_error,
            "genuine_mean_error": ms.genuine_mean_error,
            "injected_faults": ms.injected,
            "estimate": ms.estimate,
            "fallback_rate": self.fallback_rate,
            "classes": {cls: dict(
                ctl.summary(),
                exposed_canaries=len(self._exposure[cls]),
                exposed_mean_error=(float(np.mean(self._exposure[cls]))
                                    if self._exposure[cls] else 0.0))
                for cls, ctl in self.controllers.items()},
        }
        return out
