"""Regression gate for the obs layer's overhead contract (port of
`benchmarks/obs_overhead.py`, runner key `obs`).

Two promises, measured on a real `ServingEngine` decode loop and pinned by
``BENCH_obs.json``:

  * **zero-cost when disabled** -- with no tracer installed, the
    instrumented `tick()` must build no step and add no device read, and
    the tracing-enabled-vs-disabled tick throughput ratio must stay >=
    ``_RATIO_FLOOR``;
  * **nothing added when enabled** -- installing a tracer builds no step
    and reads nothing more from the device either (spans are host-side
    timers around unchanged calls).

JAX pins the first with the jit cache size (`extra_compiles_*`); eager
PyTorch compiles nothing, so the port counts what would break the same
promise: steps built (`launch.steps.builds()`) and device reads beyond the
engine's own per-tick reads (`obs.metrics.HOST_READS` against
`ServingEngine.host_reads_per_tick`), each with tracing off and on. All
four must be 0.

The two modes alternate tick by tick and each mode's throughput is its
ticks over the sum of their times, so a stall inside any tick (a tracer
flush, a buffer growing) counts in full, as it does in the JAX module's
phase sums. The JAX module alternates four phases of 24 ticks and takes
each mode's best phase; the card's host is shared, and a burst of load
there lasts longer than a phase, so phase-level interleaving measured
ratios from 0.88 to 1.03 on one tree, while tick-level interleaving sees
the same load in both modes. The decode threshold is 0 (no layer skips,
the detector still steps): a skip pattern's period would alias with the
two-tick alternation and hand one mode more skipped ticks than the other.
The ratio is gated as a boolean (``ratio_ok``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from .. import device as device_mod
from .. import qos
from ..launch import steps as steps_mod
from ..models import build
from ..obs import metrics as obs_metrics
from ..obs import trace
from ..serving import Request, ServingEngine

_TICKS = 128            # timed decode ticks per mode
_GEN = 2 * _TICKS + 24  # new tokens: a request outlives every timed tick
_SLOTS = 4
_PROMPT_LEN = 8
_RATIO_FLOOR = 0.95


def _engine(dev):
    # widened from the smoke config, as in the JAX module: the overhead is
    # measured against a realistically costed decode step
    cfg = dataclasses.replace(qos.default_decode_cfg(), n_layers=4,
                              d_model=256, d_ff=1024, n_heads=4,
                              n_kv_heads=2, head_dim=64)
    model = build(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    eng = ServingEngine(model, params, slots=_SLOTS,
                        max_len=_PROMPT_LEN + _GEN + 8,
                        prompt_len=_PROMPT_LEN)
    rng = np.random.RandomState(0)
    for i in range(_SLOTS):
        eng.submit(Request(
            uid=i,
            prompt=rng.randint(0, cfg.vocab_size, _PROMPT_LEN)
            .astype(np.int32),
            max_new_tokens=_GEN))
    return eng


def main(report, artifacts_dir: Optional[str] = None, device=None) -> Dict:
    dev = device_mod.resolve(device)
    eng = _engine(dev)
    eng.warmup()
    eng.tick()          # admission prefill + first decode, outside timing
    # every tick the same work: TAF's detector still steps and the step
    # still reads `remaining`, but no layer skips (see the module doc)
    qos.set_decode_threshold(eng.cache, 0.0)
    builds0 = steps_mod.builds()

    tracer = trace.Tracer()
    tick_s = {"off": [], "on": []}
    extra_builds = {"off": 0, "on": 0}
    extra_reads = {"off": 0, "on": 0}
    for mode in ("off", "on") * _TICKS:
        if mode == "on":
            trace.enable(tracer)
        reads0 = obs_metrics.host_reads()
        t0 = time.perf_counter()
        try:
            eng.tick()
        finally:
            if mode == "on":
                trace.disable()
        tick_s[mode].append(time.perf_counter() - t0)
        extra_reads[mode] += (obs_metrics.host_reads() - reads0
                              - eng.host_reads_per_tick)
        extra_builds[mode] = steps_mod.builds() - builds0

    off_tps, on_tps = (_TICKS / max(float(np.sum(tick_s[m])), 1e-9)
                       for m in ("off", "on"))
    ratio = on_tps / max(off_tps, 1e-9)
    events = len(tracer)

    report("obs_disabled_ticks_per_s", f"{1e6 / max(off_tps, 1e-9):.0f}",
           f"ticks_per_s={off_tps:.1f}")
    report("obs_enabled_ticks_per_s", f"{1e6 / max(on_tps, 1e-9):.0f}",
           f"ticks_per_s={on_tps:.1f},trace_events={events}")
    report("obs_overhead", "0",
           f"ratio={ratio:.3f},floor={_RATIO_FLOOR},"
           f"extra_step_builds_disabled={extra_builds['off']},"
           f"extra_step_builds_enabled={extra_builds['on']},"
           f"extra_host_reads_disabled={extra_reads['off']},"
           f"extra_host_reads_enabled={extra_reads['on']}")

    doc = obs_metrics.stamp({
        "metric": "obs_overhead",
        "ticks_per_mode": _TICKS,
        "slots": _SLOTS,
        "disabled_ticks_per_s": off_tps,
        "enabled_ticks_per_s": on_tps,
        "ratio": ratio,
        "ratio_floor": _RATIO_FLOOR,
        "ratio_ok": bool(ratio >= _RATIO_FLOOR),
        "extra_step_builds_disabled": int(extra_builds["off"]),
        "extra_step_builds_enabled": int(extra_builds["on"]),
        "extra_host_reads_disabled": int(extra_reads["off"]),
        "extra_host_reads_enabled": int(extra_reads["on"]),
        "trace_events": int(events),
    })
    if artifacts_dir:
        os.makedirs(artifacts_dir, exist_ok=True)
        path = os.path.join(artifacts_dir, "BENCH_obs.json")
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
        report("obs_json", "0", path)
    return doc


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--artifacts", default="chiprun_out/obs")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(lambda n, us, d="": print(f"{n},{us},{d}"),
         artifacts_dir=args.artifacts, device=args.device)
