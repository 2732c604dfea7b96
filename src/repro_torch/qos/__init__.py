"""QoS control plane: online quality-guarded approximation (port of
`repro.qos`; docs/qos.md describes the design).

The offline harness proves "speedup with bounded quality loss" after the
fact; this subsystem enforces the bound at run time by closing the loop:

  policy.py     -- offline Pareto DB -> policy ladder (precise ... most
                   aggressive) + best-speedup-under-error selection per
                   quality target and request class;
  monitor.py    -- online error estimation: deterministic canary sampling
                   against the precise oracle, scored with the SAME
                   harness.mape/mcr, RSD drift over a sliding window;
  controller.py -- the feedback loop: tighten under pressure, loosen under
                   steady headroom, hard precise fallback on violation;
  engine.py     -- QosEngine, the serving-side bundle (per-request-class
                   controllers, per-tick lane grouping and actuation; one
                   shard);
  calibrate.py  -- the decode workload as a harness ApproxApp, so policy
                   DBs come from ordinary resumable sweeps.
"""
from .calibrate import (default_decode_cfg, make_decode_app,
                        set_decode_threshold, threshold_grid)
from .controller import ControllerConfig, QosController, TrajectoryPoint
from .engine import QosEngine, TickPlan
from .monitor import MonitorStats, QualityMonitor
from .policy import (PolicyChoice, PolicyEntry, QosPolicy, QosTarget,
                     spec_knob, validate_ladder_knobs, validate_ladder_taf)

__all__ = [
    "ControllerConfig", "MonitorStats", "PolicyChoice", "PolicyEntry",
    "QosController", "QosEngine", "QosPolicy", "QosTarget",
    "QualityMonitor", "TickPlan", "TrajectoryPoint", "default_decode_cfg",
    "make_decode_app", "set_decode_threshold", "spec_knob",
    "threshold_grid", "validate_ladder_knobs", "validate_ladder_taf",
]
