"""Kernel-substrate sweep of the approx_ffn app (port of
`benchmarks/approx_ffn_sweep.py`).

Runs the same 30-spec grid through the harness on the port's kernels and
reports, per technique, the best-speedup-under-10%-error row (modeled
speedup = the structural FLOP bound), the Pareto front summary, and one
host-parity probe per technique: the kernel's approx mask must equal the
oracle's (`kernels/ref.py`) bit for bit.

Modeled speedups do not depend on the machine, so the front must equal the
committed one of the JAX package, `benchmarks/baselines/BENCH_ffn.json`;
`check_front` states that comparison.

    PYTHONPATH=src python -m repro_torch.benchmarks.approx_ffn_sweep \\
        [--device cuda|cpu] [--substrate cuda|host] [--jobs N] [--db PATH]
        [--predict]

`--predict` measures only the band the app cost model predicts
(`costmodel.ffn_model().select_band`, a fifth of the grid) and writes
BENCH_ffn_predict.json beside, never over, BENCH_ffn.json.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Callable, Dict, List, Optional

from ..apps import approx_ffn
from ..core import pareto
from ..core.harness import (best_speedup_under_error, iact_grid, sweep,
                            taf_grid)
from ..core.types import (ApproxSpec, Level, PerforationKind,
                          PerforationParams, Technique)

TECHNIQUES = ("taf", "iact", "perfo")
HV_TOL = 1e-4  # hypervolume agreement with the committed front


def grid() -> List[ApproxSpec]:
    """The JAX benchmark's 30-spec grid (`approx_ffn_sweep._grid`)."""
    taf = taf_grid(h_sizes=(2, 3), p_sizes=(2, 4),
                   thresholds=(0.01, 0.05, 0.2, 1.0),
                   levels=(Level.BLOCK,))
    iact = iact_grid(t_sizes=(2, 4), thresholds=(0.05, 0.2, 0.5, 5.0),
                     tables_per_block=(1,), levels=(Level.BLOCK,))
    perfo = [ApproxSpec(Technique.PERFORATION, Level.BLOCK,
                        perforation=PerforationParams(kind=k, fraction=f))
             for k in (PerforationKind.INI, PerforationKind.FINI)
             for f in (0.25, 0.5, 0.75)]
    return taf + iact + perfo


def _report(name: str, value: str, derived: str) -> None:
    print(f"{name},{value},{derived}")


def predict_main(report: Callable[[str, str, str], None] = _report,
                 jobs: int = 1, db_path: Optional[str] = None,
                 substrate: Optional[str] = "cuda", device=None,
                 artifacts_dir: Optional[str] = None) -> Dict:
    """Cost-model pruned sweep: measure only the predicted front band (a
    fifth of the grid, `costmodel.ffn_model().select_band`) and report its
    recovery of the committed front's hypervolume. Writes
    BENCH_ffn_predict.json, never BENCH_ffn.json."""
    from . import costmodel

    app = approx_ffn.make_app(substrate=substrate, device=device)
    specs = grid()
    budget = max(1, len(specs) // 5)
    band = costmodel.ffn_model().select_band(specs, budget=budget)
    recs = sweep(app, band, repeats=1, db_path=db_path, jobs=max(jobs, 1))
    fs = pareto.front_summary(recs, use_modeled=True)
    base_hv = costmodel.baseline_hypervolume()
    ratio = fs["hypervolume"] / base_hv
    recovered = ratio >= costmodel.FRONT_TOLERANCE
    report("approx_ffn_predict_band", f"{len(band)}",
           f"budget={budget},grid={len(specs)}")
    report("approx_ffn_predict_front", f"{len(recs)}",
           f"n_front={fs['n_front']},hv={fs['hypervolume']:.7f},"
           f"recovery={ratio:.6f},tol={costmodel.FRONT_TOLERANCE}")
    summary = {
        "substrate": app.workload["substrate"],
        "n_grid": len(specs),
        "band_budget": budget,
        "n_records": len(recs),
        "front": fs,
        "front_recovery": {
            "hv_band": fs["hypervolume"],
            "hv_baseline": base_hv,
            "ratio": ratio,
            "tolerance": costmodel.FRONT_TOLERANCE,
            "recovered": bool(recovered),
        },
    }
    if artifacts_dir:
        os.makedirs(artifacts_dir, exist_ok=True)
        path = os.path.join(artifacts_dir, "BENCH_ffn_predict.json")
        with open(path, "w") as f:
            json.dump(summary, f, indent=1)
        report("ffn_predict_json", "0", path)
    return summary


def main(report: Callable[[str, str, str], None] = _report, jobs: int = 1,
         db_path: Optional[str] = None, substrate: Optional[str] = "cuda",
         device=None, artifacts_dir: Optional[str] = None,
         predict: bool = False) -> Dict:
    """Sweep the grid; return (and with `artifacts_dir`, write as
    BENCH_ffn.json) the summary: record/front counts, hypervolume,
    best-under-10% rows and parity bits. `predict` runs `predict_main`
    instead."""
    if predict:
        return predict_main(report, jobs=jobs, db_path=db_path,
                            substrate=substrate, device=device,
                            artifacts_dir=artifacts_dir)
    app = approx_ffn.make_app(substrate=substrate, device=device)
    specs = grid()
    recs = sweep(app, specs, repeats=1, db_path=db_path, jobs=max(jobs, 1))

    best_rows = {}
    for tech in TECHNIQUES:
        rows = [r for r in recs if r.spec.get("technique") == tech]
        best = best_speedup_under_error(rows, max_error=0.10,
                                        use_modeled=True)
        best_rows[tech] = best
        derived = ("no_config_under_10pct" if best is None else
                   f"modeled={best.modeled_speedup:.2f}x,"
                   f"err={best.error:.4f},approx={best.approx_fraction:.2f}")
        wall = 0.0 if best is None else best.wall_time_s * 1e6
        report(f"approx_ffn_{tech}_{app.workload['substrate']}",
               f"{wall:.0f}", derived)

    fs = pareto.front_summary(recs, use_modeled=True)
    report("approx_ffn_front", f"{len(recs)}",
           f"n_front={fs['n_front']},hv={fs['hypervolume']:.7f}")

    # host-parity probes: one per technique, masks must match bit for bit
    host = approx_ffn.make_app(substrate="host", device=device)
    probes = [next(s for s in specs if s.technique == t)
              for t in (Technique.TAF, Technique.IACT,
                        Technique.PERFORATION)]
    prec = sweep(app, probes, repeats=1, db_path=db_path)
    hrec = sweep(host, probes, repeats=1)
    parity = {}
    for p, h in zip(prec, hrec):
        ok = p.extra.get("approx_mask") == h.extra.get("approx_mask")
        parity[p.spec.get("technique")] = bool(ok)
        report(f"approx_ffn_parity_{p.spec.get('technique')}", "0",
               f"mask_parity={ok},err_delta={abs(p.error - h.error):.2e}")

    summary = {
        "substrate": app.workload["substrate"],
        "n_records": len(recs),
        "front": fs,
        "best_under_10pct": {
            tech: (None if b is None else {
                "modeled_speedup": b.modeled_speedup,
                "error": b.error,
                "approx_fraction": b.approx_fraction,
                "spec": b.spec})
            for tech, b in best_rows.items()},
        "parity": parity,
    }
    if artifacts_dir:
        os.makedirs(artifacts_dir, exist_ok=True)
        path = os.path.join(artifacts_dir, "BENCH_ffn.json")
        with open(path, "w") as f:
            json.dump(summary, f, indent=1)
        report("ffn_json", "0", path)
    return summary


def check_front(summary: Dict, baseline: Dict) -> List[str]:
    """Where `summary` departs from the committed front `baseline` (the
    JAX package's BENCH_ffn.json): record and front counts equal,
    hypervolume within HV_TOL, each technique's best-under-10% approx
    fraction equal, parity true. Returns the failures (empty = agrees)."""
    bad = []
    if summary["n_records"] != baseline["n_records"]:
        bad.append(f"n_records {summary['n_records']} != "
                   f"{baseline['n_records']}")
    if summary["front"]["n_front"] != baseline["front"]["n_front"]:
        bad.append(f"n_front {summary['front']['n_front']} != "
                   f"{baseline['front']['n_front']}")
    hv, hv0 = (summary["front"]["hypervolume"],
               baseline["front"]["hypervolume"])
    if abs(hv - hv0) > HV_TOL:
        bad.append(f"hypervolume {hv} vs {hv0} (tol {HV_TOL})")
    for tech in TECHNIQUES:
        got, want = (summary["best_under_10pct"][tech],
                     baseline["best_under_10pct"][tech])
        if got is None or got["approx_fraction"] != want["approx_fraction"]:
            bad.append(f"best {tech} approx_fraction "
                       f"{None if got is None else got['approx_fraction']} "
                       f"!= {want['approx_fraction']}")
        if not summary["parity"].get(tech):
            bad.append(f"parity {tech} false")
    return bad


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--substrate", default="cuda")
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--db", default=None)
    ap.add_argument("--artifacts", default=None)
    ap.add_argument("--predict", action="store_true",
                    help="measure only the cost model's predicted band")
    a = ap.parse_args()
    main(jobs=a.jobs, db_path=a.db, substrate=a.substrate, device=a.device,
         artifacts_dir=a.artifacts, predict=a.predict)
