"""Benchmark runner: one module per paper table or figure, with the
regression gate (port of `benchmarks/run.py`).

Prints ``name,value,derived`` CSV lines. Usage:

  PYTHONPATH=src python -m repro_torch.benchmarks.run [--only fig3,pareto]
      [--device cuda|cpu] [--full] [--jobs N] [--db PATH]
      [--substrate host|cuda] [--artifacts DIR]
      [--check-regression BASELINE] [--noise 0.8] [--trace OUT.json]
      [--predict]

``--device`` runs every module there (``cuda`` unless ``cpu`` is asked
for). ``--full`` adds each module's full-size rows: fig10c, fig11c and
fig12c at their public benchmarks' sizes, and `kernel` at its `full`
geometry (the main path's widths). ``--jobs`` and ``--db`` reach every
module whose ``main`` takes them (the sweep-based figures): the harness's
parallel evaluation width, and a persistent results database that makes
re-runs resumable. ``--substrate`` names the execution substrate (host |
cuda); a module must be able to measure that path -- see
``substrate_support()`` -- so the flag never silently measures another one.
``--artifacts`` names a directory for machine-readable outputs (`ffn`
writes ``BENCH_ffn.json``; `kernel` writes ``BENCH_kernel.json``,
``kernel_micro.json`` and the autotuner's ``tuning_cache.json``;
`costmodel` validates the app cost model against measured sweeps and
writes ``BENCH_costmodel.json``; `qos` runs the QoS serving drill and
writes ``BENCH_qos.json``; `obs` measures the obs layer's overhead on a
serving loop and writes ``BENCH_obs.json``). ``--predict`` switches predict-aware
modules (`ffn`) into cost-model pruned mode: only the predicted front band
of the grid is measured, and ``BENCH_ffn_predict.json`` is written instead
of the full-grid ``BENCH_ffn.json``.

``--devices N`` runs device-aware modules (`qos`) with the decode data
plane sharded over N ranks, one a device: start them with ``torchrun
--nproc-per-node N -m repro_torch.benchmarks.run --devices N ...`` (the
process group comes from torchrun's environment; only rank 0 prints and
writes artifacts).

``--check-regression <baseline-dir-or-file>`` compares the artifacts of
THIS run with committed baselines (``src/repro_torch/benchmarks/
baselines/``, taken on an H100) and exits 2 beyond the noise margin.
Structural numbers (counts, fractions, hypervolumes) are held to a tight
tolerance; ratios taken from walls only have to stay above
``(1 - noise) * baseline`` (default --noise 0.8: a 5x slowdown fails; the
gate catches order-of-magnitude regressions, not jitter between hosts).

A module that raises prints an ``ERROR`` row, the other modules still run,
and the process then exits 1. The JAX runner's `lint` and `roofline` are
not ported yet; naming one is an error that says so.
"""
from __future__ import annotations

import argparse
import glob
import inspect
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..core import substrate as substrate_mod
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from . import (approx_ffn_sweep, costmodel, fig3_table_memory,
               fig6_best_speedup, fig7_cg_sweep, fig8c_items_per_thread,
               fig10c_rsd_behavior, fig11c_hierarchy,
               fig12c_kmeans_convergence, kernel_micro, obs_overhead,
               pareto_refine, qos_serving)

MODULES = {
    "fig3": fig3_table_memory,
    "fig6": fig6_best_speedup,
    "fig7": fig7_cg_sweep,
    "fig8c": fig8c_items_per_thread,
    "fig10c": fig10c_rsd_behavior,
    "fig11c": fig11c_hierarchy,
    "fig12c": fig12c_kmeans_convergence,
    "kernel": kernel_micro,
    "ffn": approx_ffn_sweep,
    "pareto": pareto_refine,
    "costmodel": costmodel,
    "qos": qos_serving,
    "obs": obs_overhead,
}

# keys of the JAX runner that the port does not have yet, and the ROADMAP
# Queue 1 item that ports each
NOT_PORTED = {
    "roofline": "Queue 1 item 6b (the XLA-only tools)",
    "lint": "Queue 1 item 7 (analysis lint)",
}


def substrate_support() -> Dict[str, set]:
    """The substrates each module's measurements can come from. A module
    whose `main` takes `substrate` dispatches through `core.substrate`
    (host or cuda); `kernel` is cuda-native (it times the CUDA kernels and
    cannot emulate the host path); every other module runs the host
    technique state machines. `--substrate` fails fast when it names a
    path a selected module cannot measure, in either direction."""
    table = {key: set(substrate_mod.SUBSTRATES)
             if "substrate" in inspect.signature(mod.main).parameters
             else {substrate_mod.HOST}
             for key, mod in MODULES.items()}
    table["kernel"] = {substrate_mod.CUDA}
    return table


def select(only: Optional[str], substrate: Optional[str] = None
           ) -> List[str]:
    """The module keys `--only` names (all by default), validated: an
    unknown or not-yet-ported key, or a substrate a selected module cannot
    measure, raises ValueError before any module runs."""
    keys = [k.strip() for k in only.split(",")] if only else list(MODULES)
    for key in keys:
        if key in NOT_PORTED:
            raise ValueError(f"module {key!r} is not ported yet "
                             f"(ROADMAP {NOT_PORTED[key]})")
        if key not in MODULES:
            raise ValueError(f"unknown module {key!r} "
                             f"(choose from: {','.join(MODULES)})")
    if substrate:
        support = substrate_support()
        deaf = [k for k in keys if substrate not in support[k]]
        if deaf:
            raise ValueError(
                f"--substrate {substrate} cannot be honored by "
                f"{','.join(deaf)}: the flag would silently measure a "
                "different path. Per-module support: " + "; ".join(
                    f"{k}={'|'.join(sorted(support[k]))}" for k in keys))
    return keys


def run_modules(keys: Sequence[str], report: Callable[..., None], *,
                device=None, full: bool = False, jobs: int = 1,
                db_path: Optional[str] = None,
                substrate: Optional[str] = None,
                artifacts_dir: Optional[str] = None,
                predict: bool = False,
                devices: Optional[int] = None) -> Tuple[Dict, List[str]]:
    """Run each module of `keys` with the options its `main` takes.
    Returns ({key: what its main returned}, [keys that raised]); a module
    that raises reports an ERROR row and the others still run."""
    results, errors = {}, []
    for key in keys:
        mod = MODULES[key]
        accepted = inspect.signature(mod.main).parameters
        kw = {k: v for k, v in (
            ("jobs", jobs), ("db_path", db_path), ("substrate", substrate),
            ("artifacts_dir", artifacts_dir), ("device", device),
            ("full", full or None),
            ("geometry", "full" if full else None),
            ("predict", True if predict else None),
            ("devices", devices))
            if k in accepted and v is not None}
        # each module starts from a clean metrics registry, so the obs
        # snapshot stamped into its BENCH_*.json is that module's alone
        obs_metrics.reset()
        t0 = time.time()
        try:
            with obs_trace.span(f"bench.{key}"):
                results[key] = mod.main(report, **kw)
        except Exception as e:  # keep the harness running
            errors.append(key)
            report(key, "ERROR", f"{type(e).__name__}: {str(e)[:200]}")
        report(f"_{key}_total_s", f"{time.time() - t0:.1f}")
    return results, errors


# --------------------------------------------------------------------------
# regression gate: fresh artifacts vs committed baselines
# --------------------------------------------------------------------------

BASELINES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "baselines")

# Per-artifact check rules, by dotted path into the JSON the port's modules
# write:
#   exact    -- configuration identity: a mismatch means the benchmark no
#               longer measures the same thing as the baseline;
#   close    -- structural / quality numbers, deterministic up to float
#               rounding across hosts: |new - base| <= atol + rtol * |base|;
#   atleast  -- ratios taken from walls: new >= (1 - noise) * base.
_BASELINE_CHECKS = {
    # the QoS drill (the JAX rules): configuration exact; measured canary
    # error, fallback rate and skip fraction close; throughputs from walls
    "BENCH_qos.json": {
        "exact": ("metric", "devices", "shards", "slots", "requests"),
        "close": ("measured_error", "fallback_rate",
                  "approx.taf_skip_fraction"),
        "atleast": ("precise.tokens_per_s", "approx.tokens_per_s"),
    },
    "BENCH_ffn.json": {
        "exact": ("substrate", "n_records", "parity.taf", "parity.iact",
                  "parity.perfo"),
        "close": ("front.n_front", "front.hypervolume", "front.best_error",
                  "front.best_speedup"),
        "atleast": (),
    },
    # kernel microbenchmarks: oracle / pipeline parity and the rebuild
    # count are exact; the data-dependent executed fractions are
    # deterministic up to float rounding (close); tuned-vs-default speedups
    # come from walls and only have to stay above the noise margin
    # (absolute microseconds are never gated). The JAX rules' exact
    # `tuning.all_beat_default` is left out: on the card it is read off
    # the same walls (every speedup > 1), and on an H100 80GB HBM3 (700 W)
    # K4's tuned config beat its default by 3.8% at the full geometry,
    # inside the spread of a single call, so the verdict can flip between
    # runs of one tree.
    "BENCH_kernel.json": {
        "exact": ("metric", "substrate", "geometry", "oracle_match.taf",
                  "oracle_match.iact", "sweep.n", "sweep.recompiles",
                  "pipeline_parity.taf_matmul",
                  "pipeline_parity.perforated_matmul",
                  "pipeline_parity.perforated_attention"),
        "close": ("executed_grid_fraction.taf",
                  "executed_grid_fraction.iact"),
        "atleast": ("tuning.taf_matmul.speedup",
                    "tuning.iact_rowfn.speedup",
                    "tuning.perforated_matmul.speedup",
                    "tuning.perforated_attention.speedup"),
    },
    # the app cost model's validation (the JAX rules): kept / dropped grid
    # counts and the band are structural (exact); rank correlations and
    # the pruned sweep's front recovery are deterministic up to float
    # rounding (close). The machine profile the counts were taken on is
    # exact too: kept / dropped depend on it.
    "BENCH_costmodel.json": {
        "exact": ("machine", "apps.blackscholes.kept",
                  "apps.blackscholes.bound_holds",
                  "apps.binomial_options.bound_holds",
                  "apps.lavamd.bound_holds",
                  "ffn.n_grid", "ffn.kept", "ffn.dropped",
                  "ffn.band_budget", "ffn.band_measured", "ffn.recovered"),
        "close": ("apps.blackscholes.spearman",
                  "apps.binomial_options.spearman", "apps.kmeans.spearman",
                  "apps.lavamd.spearman", "apps.minife_cg.spearman",
                  "ffn.spearman", "ffn.front_recovery.ratio"),
        "atleast": (),
    },
    # the obs layer's overhead contract (the JAX rules): the 0.95 floor as
    # the boolean `ratio_ok`, exact; JAX's `extra_compiles_*` become the
    # steps built and the device reads added with tracing off and on,
    # each exactly 0.
    "BENCH_obs.json": {
        "exact": ("metric", "ratio_ok", "extra_step_builds_disabled",
                  "extra_step_builds_enabled", "extra_host_reads_disabled",
                  "extra_host_reads_enabled"),
        "close": (),
        "atleast": ("disabled_ticks_per_s", "enabled_ticks_per_s"),
    },
}


def _lookup(doc, dotted):
    cur = doc
    for part in dotted.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    return cur


def _load(path: str, what: str, name: str, failures: List[str]):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        failures.append(f"{name}: {what} unreadable "
                        f"({type(e).__name__}: {e})")
        return None


def _number(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def check_regression(artifacts_dir: str, baseline: str, *,
                     noise: float = 0.8, rtol: float = 0.25,
                     atol: float = 0.05) -> List[str]:
    """Compare this run's artifacts with committed baselines. Returns the
    failures as readable strings (empty = the gate passed), ALWAYS covering
    every baseline file: an unreadable artifact is a failure for its module
    and the scan goes on, so one broken artifact cannot hide regressions in
    the modules after it. Every baseline needs a fresh counterpart: a
    module dropped from the run is itself a regression."""
    if os.path.isdir(baseline):
        base_files = sorted(glob.glob(os.path.join(baseline,
                                                   "BENCH_*.json")))
    else:
        base_files = [baseline] if os.path.exists(baseline) else []
    if not base_files:
        return [f"no BENCH_*.json baselines found under {baseline}"]
    failures: List[str] = []
    for bf in base_files:
        name = os.path.basename(bf)
        af = os.path.join(artifacts_dir, name)
        rules = _BASELINE_CHECKS.get(name)
        if rules is None:
            failures.append(f"{name}: no check rules registered in "
                            "repro_torch.benchmarks.run._BASELINE_CHECKS")
            continue
        if not os.path.exists(af):
            failures.append(f"{name}: baseline committed but no fresh "
                            f"artifact in {artifacts_dir} (module not run?)")
            continue
        base = _load(bf, "baseline", name, failures)
        new = _load(af, "fresh artifact", name, failures)
        if base is None or new is None:
            continue
        for key in rules["exact"]:
            b, n = _lookup(base, key), _lookup(new, key)
            if b != n:
                failures.append(f"{name}:{key}: expected {b!r}, got {n!r}")
        for key in rules["close"]:
            b, n = _lookup(base, key), _lookup(new, key)
            if not (_number(b) and _number(n)):
                failures.append(f"{name}:{key}: non-numeric "
                                f"(base={b!r}, new={n!r})")
            elif abs(n - b) > atol + rtol * abs(b):
                failures.append(
                    f"{name}:{key}: {n:.6g} vs baseline {b:.6g} "
                    f"(tolerance atol={atol} rtol={rtol})")
        for key in rules["atleast"]:
            b, n = _lookup(base, key), _lookup(new, key)
            if not (_number(b) and _number(n)):
                failures.append(f"{name}:{key}: non-numeric "
                                f"(base={b!r}, new={n!r})")
            elif n < (1.0 - noise) * b:
                failures.append(
                    f"{name}:{key}: {n:.6g} below {(1 - noise):.0%} of "
                    f"baseline {b:.6g} (noise margin {noise})")
    return failures


def _report(name: str, value, derived: str = "") -> None:
    print(f"{name},{value},{derived}", flush=True)


def _quiet(name: str, value, derived: str = "") -> None:
    pass


def main(argv: Optional[Sequence[str]] = None) -> int:
    """The command line; returns the exit code (0 ok, 1 a module raised,
    2 the regression gate failed)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None,
                    help="comma-separated module keys "
                    f"(default all: {','.join(MODULES)})")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--full", action="store_true",
                    help="add the full-size rows (fig10c, fig11c, fig12c; "
                    "kernel at its full geometry)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="parallel evaluation width for sweep-based modules")
    ap.add_argument("--db", default=None,
                    help="path to a persistent sweep DB (enables resume)")
    ap.add_argument("--substrate", default=None,
                    choices=list(substrate_mod.SUBSTRATES),
                    help="execution substrate for kernel-aware modules")
    ap.add_argument("--artifacts", default=None,
                    help="directory for machine-readable outputs (JSON)")
    ap.add_argument("--check-regression", default=None, metavar="BASELINE",
                    help="after the run, compare --artifacts against this "
                    "baseline dir/file and exit 2 on regression")
    ap.add_argument("--noise", type=float, default=0.8,
                    help="noise margin for --check-regression (fail below "
                    "(1-noise)*baseline; default 0.8)")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record a Chrome/Perfetto trace of the whole run "
                    "(one span per module plus every repro_torch.obs span "
                    "the modules emit) and write it to this path")
    ap.add_argument("--devices", type=int, default=None,
                    help="shard device-aware modules (qos) over N ranks "
                    "(start them with torchrun --nproc-per-node N)")
    ap.add_argument("--predict", action="store_true",
                    help="cost-model pruned mode for predict-aware modules "
                    "(ffn: measure only the predicted front band, a fifth "
                    "of the grid, and write BENCH_ffn_predict.json)")
    args = ap.parse_args(argv)
    if args.check_regression and not args.artifacts:
        ap.error("--check-regression needs --artifacts (the gate compares "
                 "the artifacts THIS run writes)")
    try:
        keys = select(args.only, args.substrate)
    except ValueError as e:  # before any module burns sweep time
        ap.error(str(e))

    report = _report
    if args.devices is not None:
        from ..runtime import elastic
        elastic.init_from_env(args.device)
        if elastic.require_world(args.devices, args.device) != 0:
            report = _quiet     # rank 0 speaks for the group
    if report is _report:
        print("name,value,derived")
    tracer = obs_trace.enable() if args.trace else None
    try:
        _, errors = run_modules(
            keys, report, device=args.device, full=args.full,
            jobs=args.jobs, db_path=args.db, substrate=args.substrate,
            artifacts_dir=args.artifacts, predict=args.predict,
            devices=args.devices)
    finally:
        if tracer is not None:
            obs_trace.disable()
    if tracer is not None:
        tracer.save(args.trace)
        _report("trace", len(tracer), args.trace)

    if args.check_regression and report is _report:
        # outside the per-module guard: the gate fails the process, it
        # never becomes an ERROR row
        fails = check_regression(args.artifacts, args.check_regression,
                                 noise=args.noise)
        for f in fails:
            _report("regression", "FAIL", f)
        if fails:
            print(f"regression gate FAILED ({len(fails)} check(s)):",
                  file=sys.stderr)
            for f in fails:
                print(f"  {f}", file=sys.stderr)
            return 2
        _report("regression", "OK", f"artifacts match "
                f"{args.check_regression} (noise={args.noise})")
    if errors:
        print(f"modules failed: {','.join(errors)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
