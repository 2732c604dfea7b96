"""QoS quickstart: quality-guarded approximate serving (port of
`examples/approx_serving.py`).

Run:  PYTHONPATH=src python -m repro_torch.examples.approx_serving
      [--device cpu] [--db PATH]

The closed loop in four steps:

  1. OFFLINE -- calibrate the decode workload through the ordinary sweep
     harness (`qos.make_decode_app` wraps seeded greedy generation as an
     ApproxApp; the DB is resumable like any other);
  2. POLICY  -- `QosPolicy.from_db` turns the DB's Pareto front into a
     ladder from precise to aggressive, and `choose` picks the offline
     best rung per quality target;
  3. SERVE   -- a `ServingEngine` with a `QosEngine` hook runs a seeded
     two-class request trace. "interactive" traffic (the "default" class)
     carries a 1% token-mismatch target: no ladder rung meets it offline,
     so the plane refuses to approximate while such a lane is live.
     "batch" traffic tolerates 80%: once only batch lanes remain, the
     engine opens the knob to batch's rung and the canaries bound the
     damage online. The TAF threshold is a tensor in the decode cache, so
     every knob move reuses the same decode step;
  4. REPORT  -- the knob trajectory, measured error against each target,
     and latency / throughput stats.
"""
import argparse
import os
import tempfile

import numpy as np
import torch

from .. import device as device_mod
from .. import qos
from ..core.harness import sweep
from ..models import build
from ..serving import Request, ServingEngine

TARGETS = {"default": 0.01,   # interactive: <= 1% token mismatch
           "batch": 0.80}     # throughput tier: best effort


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--db", default=os.path.join(tempfile.gettempdir(),
                                                 "qos_decode_db_torch.json"))
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)

    # 1. offline calibration sweep (re-runs are served from the DB cache)
    cfg = qos.default_decode_cfg()
    app = qos.make_decode_app(cfg, gen=12, metric="mcr", device=dev)
    grid = qos.threshold_grid(cfg, (0.02, 0.04, 0.06, 0.1, 0.3))
    sweep(app, grid, repeats=1, db_path=args.db)

    # 2. the policy ladder + the offline choice per target, scoped to THIS
    #    app's workload fingerprint
    policy = qos.QosPolicy.from_db(args.db, app="taf_decode",
                                   workload=app.workload, metric="mcr",
                                   use_modeled=True)
    choices = {cls: policy.choose(t) for cls, t in TARGETS.items()}
    print(f"ladder ({len(policy)} rungs):")
    for i, e in enumerate(policy.entries):
        owners = ",".join(c for c, ch in choices.items() if ch.index == i)
        mark = f" <- offline choice for [{owners}]" if owners else ""
        print(f"  [{i}] thresh={e.spec.get('thresh', 'precise')}: "
              f"err={e.error:.3f} modeled={e.modeled_speedup:.2f}x{mark}")

    # 3. serve: 6 interactive requests, then 8 batch requests
    model = build(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    engine_qos = qos.QosEngine(
        policy, TARGETS, sample_fraction=0.5, window=8,
        config=qos.ControllerConfig(min_samples=2, hold_ticks=2))
    eng = ServingEngine(model, params, slots=4, max_len=64, prompt_len=8,
                        qos=engine_qos)
    rng = np.random.RandomState(0)
    for i in range(14):
        eng.submit(Request(
            uid=i, prompt=rng.randint(0, cfg.vocab_size, 8).astype(np.int32),
            max_new_tokens=10, qos_class="default" if i < 6 else "batch"))
    stats = eng.run_until_drained()

    # 4. report
    print("\nactuated knob trajectory (tick: threshold; 0.0 = precise):")
    print("  " + " -> ".join(f"t{t}:{v:g}" for t, v in eng.knob_log))
    print("controller events (hold/warmup elided):")
    for cls in ("default", "batch"):
        for p in engine_qos.controllers[cls].trajectory:
            if p.event not in ("hold", "warmup", "cooldown"):
                print(f"  [{cls}] tick {p.step:3d}: rung {p.index} "
                      f"{p.event:9s} est={p.estimate:.4f}")
    s = engine_qos.summary()
    lat = stats.latency_summary()
    print(f"\nserved {stats.finished} requests, {stats.tokens_out} tokens "
          f"in {stats.ticks} ticks "
          f"({100 * stats.taf_skip_fraction:.1f}% layer-steps skipped, "
          f"{stats.knob_moves} knob moves, no step rebuilt)")
    print(f"global canary error {s['genuine_mean_error']:.4f} over "
          f"{s['canary_samples']} canaries; per class (what each class's "
          "lanes were actually exposed to):")
    for cls in ("default", "batch"):
        c = s["classes"][cls]
        ok = "OK" if c["exposed_mean_error"] < TARGETS[cls] else "VIOLATED"
        print(f"  [{cls}] target={TARGETS[cls]} exposed_error="
              f"{c['exposed_mean_error']:.4f} ({ok}) over "
              f"{c['exposed_canaries']} canaries, rung {c['index']}, "
              f"fallback_rate={c['fallback_rate']:.2f}")
    print(f"ttft p50/p99: {lat['ttft_p50_s']:.3f}s/{lat['ttft_p99_s']:.3f}s, "
          f"latency p50/p99: {lat['latency_p50_s']:.3f}s/"
          f"{lat['latency_p99_s']:.3f}s")
    return eng, engine_qos


if __name__ == "__main__":
    main()
