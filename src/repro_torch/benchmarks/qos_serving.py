"""QoS-controlled serving against precise serving on an open-loop request
trace (port of `benchmarks/qos_serving.py`, runner key `qos`).

The closed loop end to end: a `harness.sweep` over decode-TAF thresholds
builds the offline Pareto DB; `QosPolicy` turns its front into a ladder; a
`QosEngine` serves a seeded open-loop trace (arrival ticks fixed up front)
with canary monitoring and feedback control, against the same trace
through a precise engine. Mid-run a deterministic error spike is injected
into the monitor, so the run also exercises the hard precise fallback and
the recovery.

Reports throughput (tokens/s), measured canary error against the target,
the fallback rate, the knob trajectory and TTFT / latency percentiles.
With `artifacts_dir`, writes ``BENCH_qos.json``; the committed H100 copy
under ``src/repro_torch/benchmarks/baselines/`` is what ``run
--check-regression`` gates against. `--devices` / `--shards` (the sharded
engine) come with multi-GPU (ROADMAP Queue 1 item 5).
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
from ..core.harness import sweep
from ..core.types import ApproxSpec
from ..models import build
from ..obs import metrics as obs_metrics
from ..obs import recorder as obs_recorder
from ..obs import trace as obs_trace
from ..serving import Request, ServingEngine

_THRESHOLDS = (0.02, 0.04, 0.06, 0.1, 0.3)
_METRIC = "mcr"         # token-mismatch rate: bounded, the serving contract
_TARGET = 0.10          # max one-step token-mismatch rate
_CANARY_FRACTION = 0.25
_N_REQUESTS = 10
_GEN = 8
_SLOTS = 4
_SPIKE_TICK = 22        # deterministic fault injection (monitor.inject),
#                         late in the batch-only phase: the knob is open,
#                         so the drill exercises a real back-off
_SPIKE_ERROR = 10.0
SHARDED_ITEM = "ROADMAP Queue 1 item 5 (multi-GPU)"


def _trace(cfg, seed: int = 0):
    """Seeded open-loop trace: arrival tick, prompt, class per request.
    Interactive ("default", tight bound) requests arrive first; a batch
    tail follows, so the run exercises both the strictest-live-lane
    actuation and the opened knob once only batch lanes remain."""
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(_N_REQUESTS):
        arrival = int(rng.randint(0, 3)) + (i * _GEN) // _SLOTS
        prompt = rng.randint(0, cfg.vocab_size, 8).astype(np.int32)
        cls = "default" if i < _N_REQUESTS // 2 else "batch"
        reqs.append((arrival, Request(uid=i, prompt=prompt,
                                      max_new_tokens=_GEN, qos_class=cls)))
    return reqs


def _serve_trace(engine, trace, *, spike_at: Optional[int] = None):
    """Open-loop drive: submissions happen at their arrival tick whether or
    not the engine kept up. Returns (stats, wall seconds). The caller must
    have called `engine.warmup()`."""
    pending = sorted(trace, key=lambda ar: ar[0])
    t0 = time.perf_counter()
    tick = 0
    while pending or engine.queue or any(engine.active):
        while pending and pending[0][0] <= tick:
            engine.submit(pending.pop(0)[1])
        if spike_at is not None and tick == spike_at and engine.qos:
            engine.qos.monitor.inject(_SPIKE_ERROR)
        engine.tick()
        tick += 1
        if tick > 10_000:
            raise RuntimeError("trace did not drain")
    return engine.stats, time.perf_counter() - t0


def drill(*, device=None, params=None, jobs: int = 1,
          db_path: Optional[str] = None,
          artifacts_dir: Optional[str] = None) -> Dict:
    """The whole drill on `device` (None means cuda): calibration sweep,
    policy, precise and QoS-controlled runs of the trace. The model's
    weights are its own init from seed 0 unless `params` is given (the
    parity tests pass the JAX model's weights). The flight recorder's
    dumps land in `artifacts_dir` when given. Returns the policy, both
    engines' stats and walls, the QoS engine and the flight recorder."""
    dev = device_mod.resolve(device)
    cfg = qos.default_decode_cfg()
    model = build(cfg, device=dev)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(0))

    # 1. offline: calibrate the decode workload through the normal harness
    app = qos.make_decode_app(cfg, gen=12, metric=_METRIC, device=dev,
                              params=params)
    recs = sweep(app, qos.threshold_grid(cfg, _THRESHOLDS), repeats=1,
                 db_path=db_path, jobs=max(jobs, 1))
    policy = qos.QosPolicy.from_records(recs, metric=_METRIC,
                                        use_modeled=True)

    # 2. precise baseline over the same trace (same params, TAF disabled)
    precise_model = build(dataclasses.replace(cfg,
                                              approx_decode=ApproxSpec()),
                          device=dev)
    precise_eng = ServingEngine(precise_model, params, slots=_SLOTS,
                                max_len=64, prompt_len=8)
    precise_eng.warmup()
    p_stats, p_wall = _serve_trace(precise_eng, _trace(cfg))

    # 3. QoS-controlled serving, same seeded trace + injected error spike
    engine_qos = qos.QosEngine(
        policy, {"default": _TARGET, "batch": 10 * _TARGET},
        sample_fraction=_CANARY_FRACTION, window=8,
        config=qos.ControllerConfig(min_samples=2, hold_ticks=2,
                                    fallback_hold=4))
    q_eng = ServingEngine(model, params, slots=_SLOTS, max_len=64,
                          prompt_len=8, qos=engine_qos)
    q_eng.warmup()
    flight = obs_recorder.install(capacity=32, out_dir=artifacts_dir)
    try:
        q_stats, q_wall = _serve_trace(q_eng, _trace(cfg),
                                       spike_at=_SPIKE_TICK)
    finally:
        obs_recorder.uninstall()
    return dict(policy=policy, precise_stats=p_stats, precise_wall=p_wall,
                qos_stats=q_stats, qos_wall=q_wall, qos_engine=engine_qos,
                serving_engine=q_eng, flight=flight)


def main(report, jobs: int = 1, db_path: Optional[str] = None,
         artifacts_dir: Optional[str] = None,
         devices: Optional[int] = None, shards: Optional[int] = None,
         device=None) -> Dict:
    if devices is not None or shards is not None:
        raise NotImplementedError(
            f"--devices / --shards (the sharded engine) are not ported yet "
            f"({SHARDED_ITEM})")
    r = drill(device=device, jobs=jobs, db_path=db_path,
              artifacts_dir=artifacts_dir)
    policy, engine_qos, q_eng = r["policy"], r["qos_engine"], \
        r["serving_engine"]
    p_stats, q_stats, flight = r["precise_stats"], r["qos_stats"], \
        r["flight"]
    report("qos_policy_ladder", f"{len(policy)}",
           ";".join(f"th={e.spec.get('thresh')}:err={e.error:.3f}"
                    for e in policy.entries[1:]) or "precise_only")
    report("qos_mesh", "0", f"devices=1,mesh_shape=None,shards=1,"
           f"slots={_SLOTS},requests={_N_REQUESTS}")

    summary = engine_qos.summary()
    traj = {cls: ctl.trajectory_json()
            for cls, ctl in engine_qos.controllers.items()}
    p_tps = p_stats.tokens_out / max(r["precise_wall"], 1e-9)
    q_tps = q_stats.tokens_out / max(r["qos_wall"], 1e-9)

    report("qos_precise_throughput", f"{1e6 / max(p_tps, 1e-9):.0f}",
           f"tokens_per_s={p_tps:.1f}")
    report("qos_approx_throughput", f"{1e6 / max(q_tps, 1e-9):.0f}",
           f"tokens_per_s={q_tps:.1f},skip_frac="
           f"{q_stats.taf_skip_fraction:.3f}")
    report("qos_measured_error", "0",
           f"genuine_mean={summary['genuine_mean_error']:.4f},"
           f"canaries={summary['canary_samples']},"
           f"injected_faults={summary['injected_faults']}")
    for cls, tgt in (("default", _TARGET), ("batch", 10 * _TARGET)):
        c = summary["classes"][cls]
        report(f"qos_class_{cls}", "0",
               f"target={tgt},exposed_error={c['exposed_mean_error']:.4f},"
               f"exposed_canaries={c['exposed_canaries']},"
               f"rung={c['index']}")
    report("qos_fallback", "0",
           f"rate={summary['fallback_rate']:.3f},knob_moves="
           f"{q_stats.knob_moves},flight_dumps={len(flight.dumps)}")
    lat = q_stats.latency_summary()
    report("qos_latency", "0",
           f"ttft_p50={lat['ttft_p50_s']:.3f}s,ttft_p99="
           f"{lat['ttft_p99_s']:.3f}s,p50={lat['latency_p50_s']:.3f}s,"
           f"p99={lat['latency_p99_s']:.3f}s")

    doc = obs_metrics.stamp({
        "target_max_error": _TARGET,
        "metric": policy.metric,
        "canary_fraction": _CANARY_FRACTION,
        "devices": 1,
        "mesh_shape": None,
        "shards": 1,
        "slots": _SLOTS,
        "requests": _N_REQUESTS,
        "policy_ladder": policy.to_json()["entries"],
        "precise": {"tokens_per_s": p_tps,
                    "latency": p_stats.latency_summary()},
        "approx": {"tokens_per_s": q_tps,
                   "taf_skip_fraction": q_stats.taf_skip_fraction,
                   "knob_moves": q_stats.knob_moves,
                   "canary_ticks": q_stats.canary_ticks,
                   "latency": q_stats.latency_summary()},
        "measured_error": summary["genuine_mean_error"],
        "measured_error_with_faults": summary["mean_error"],
        "injected_faults": summary["injected_faults"],
        "error_estimate": summary["estimate"],
        "fallback_rate": summary["fallback_rate"],
        "classes": {
            cls: {k: c[k] for k in
                  ("target", "exposed_mean_error", "exposed_canaries",
                   "index", "fallback_rate")}
            for cls, c in summary["classes"].items()},
        "knob_actuations": [
            {"tick": m.tick, "threshold": m.value, "reason": m.reason}
            for m in q_eng.knob_events],
        "knob_trajectory": traj,
        "knob_trajectory_per_shard": None,
        "shard_exposure": None,
        "flight_dumps": [
            {"reason": d["reason"], "context": d["context"],
             "ticks": len(d["ticks"])}
            for d in flight.dumps],
    })
    if artifacts_dir:
        os.makedirs(artifacts_dir, exist_ok=True)
        path = os.path.join(artifacts_dir, "BENCH_qos.json")
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
        report("qos_json", "0", path)
    return doc


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(
        description="QoS serving drill (the `qos` module of "
        "repro_torch.benchmarks.run, runnable standalone for tracing)")
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--db", default=None)
    ap.add_argument("--artifacts", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record a Chrome/Perfetto trace of the run")
    args = ap.parse_args()
    tracer = None
    if args.trace:
        tracer = obs_trace.Tracer()
        obs_trace.enable(tracer)
    try:
        main(lambda n, us, d="": print(f"{n},{us},{d}", flush=True),
             jobs=args.jobs, db_path=args.db, artifacts_dir=args.artifacts,
             device=args.device)
    finally:
        if tracer is not None:
            obs_trace.disable()
            tracer.save(args.trace)
            print(f"trace,{len(tracer)},{args.trace}", flush=True)
