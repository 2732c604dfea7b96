"""Paper Figure 6: best speedup with error < 10%, per app x technique (port
of `benchmarks/fig6_best_speedup.py`, with the same apps, sizes and grids).

Sweeps a reduced Table-2-style grid per technique over each app and reports
the fastest configuration under the 10% error bound, by measured wall time
on the device and by modeled speedup (1 / executed fraction: the bound on a
machine where skipped work is free). Modeled speedups, errors and approx
fractions do not depend on the machine, so they must equal the JAX
package's rows in `fig6_fig7_reference.json`; `check` states that
comparison.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig6_best_speedup \\
        [--device cuda|cpu] [--apps blackscholes,kmeans] [--jobs N]
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Callable, Dict, List, Optional, Sequence

from ..apps import binomial_options, blackscholes, kmeans, lavamd
from ..core.harness import (Record, best_speedup_under_error, iact_grid,
                            sweep, taf_grid)
from ..core.types import Level

REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "fig6_fig7_reference.json")

APPS = {
    "blackscholes": (blackscholes.make_app, dict(n_elements=512, steps=48)),
    "binomial": (binomial_options.make_app,
                 dict(n_elements=48, steps=16, tree_steps=96)),
    "kmeans": (kmeans.make_app, dict(n=1024, d=6, k=8)),
    "lavamd": (lavamd.make_app, dict(nx=4)),
}

TAF_GRID = taf_grid(h_sizes=(2, 3), p_sizes=(8, 64),
                    thresholds=(0.1, 0.5, 1.5),
                    levels=(Level.ELEMENT, Level.BLOCK))
IACT_GRID = iact_grid(t_sizes=(2, 4), thresholds=(0.3, 0.9),
                      tables_per_block=(0, 8),
                      levels=(Level.ELEMENT, Level.BLOCK))
GRIDS = (("taf", TAF_GRID), ("iact", IACT_GRID))

SPEEDUP_RTOL = 0.01   # modeled speedup against the JAX row
ERROR_ATOL = 1e-4     # error (MAPE / MCR) against the JAX row
FRACTION_ATOL = 0.005  # every row's approx fraction against the JAX row


def row(r: Record) -> Dict:
    """What the figure keeps of a record (the reference file's schema)."""
    return {"spec": r.spec, "spec_hash": r.spec_hash,
            "modeled_speedup": r.modeled_speedup, "error": r.error,
            "approx_fraction": r.approx_fraction}


def figure_rows(recs: Sequence[Record]) -> Dict:
    """Every row of one app x technique sweep and its best under 10%."""
    best = best_speedup_under_error(recs, 0.10, use_modeled=True)
    return {"rows": [row(r) for r in recs],
            "best": None if best is None else dict(row(best),
                                                   speedup=best.speedup)}


def _report(name: str, value: str, derived: str = "") -> None:
    print(f"{name},{value},{derived}")


def main(report: Callable[..., None] = _report, jobs: int = 1,
         db_path: Optional[str] = None, device=None,
         apps: Optional[Sequence[str]] = None, repeats: int = 2) -> Dict:
    """Sweep each app of `apps` (default: all four) on `device`; report each
    app x technique's best row and return {app: {workload, taf, iact}}."""
    out: Dict = {}
    for name in apps or APPS:
        make, kw = APPS[name]
        app = make(**kw, device=device)
        out[name] = {"workload": dict(app.workload)}
        for tech, grid in GRIDS:
            recs = sweep(app, grid, repeats=repeats, jobs=jobs,
                         db_path=db_path)
            fig = out[name][tech] = figure_rows(recs)
            best = fig["best"]
            if best is None:
                report("fig6_best_speedup", f"{name}/{tech}",
                       "no config under 10% error")
                continue
            report("fig6_best_speedup", f"{name}/{tech}",
                   f"modeled={best['modeled_speedup']:.2f}x,"
                   f"wall={best['speedup']:.2f}x,err={best['error']:.3%},"
                   f"level={best['spec']['level']}")
    return out


def load_reference(path: str = REFERENCE) -> Dict:
    with open(path) as f:
        return json.load(f)


def check(result: Dict, reference: Dict) -> List[str]:
    """Where `result` (from `main`) departs from the JAX rows of
    `reference["fig6"]`: each app x technique's best spec equal, its
    modeled speedup within SPEEDUP_RTOL and error within ERROR_ATOL; every
    row's approx fraction within FRACTION_ATOL. Returns the failures."""
    bad = []
    for name, got_app in result.items():
        want_app = reference["fig6"][name]
        for tech, _ in GRIDS:
            got, want = got_app[tech], want_app[tech]
            gb, wb = got["best"], want["best"]
            where = f"fig6 {name}/{tech}"
            if (gb is None) != (wb is None):
                bad.append(f"{where}: best {gb and gb['spec']} vs "
                           f"{wb and wb['spec']}")
            elif gb is not None:
                if gb["spec_hash"] != wb["spec_hash"]:
                    bad.append(f"{where}: best spec {gb['spec']} vs "
                               f"{wb['spec']}")
                if abs(gb["modeled_speedup"] - wb["modeled_speedup"]) > \
                        SPEEDUP_RTOL * abs(wb["modeled_speedup"]):
                    bad.append(f"{where}: modeled speedup "
                               f"{gb['modeled_speedup']} vs "
                               f"{wb['modeled_speedup']}")
                if abs(gb["error"] - wb["error"]) > ERROR_ATOL:
                    bad.append(f"{where}: error {gb['error']} vs "
                               f"{wb['error']}")
            want_rows = {r["spec_hash"]: r for r in want["rows"]}
            for r in got["rows"]:
                w = want_rows.get(r["spec_hash"])
                if w is None:
                    bad.append(f"{where}: row {r['spec']} not in the "
                               "reference")
                elif abs(r["approx_fraction"] - w["approx_fraction"]) > \
                        FRACTION_ATOL:
                    bad.append(f"{where}: {r['spec']} approx fraction "
                               f"{r['approx_fraction']} vs "
                               f"{w['approx_fraction']}")
    return bad


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--apps", default=",".join(APPS))
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--db", default=None)
    a = ap.parse_args()
    res = main(jobs=a.jobs, db_path=a.db, device=a.device,
               apps=a.apps.split(","))
    failures = check(res, load_reference())
    print(json.dumps({"matches_reference": not failures,
                      "failures": failures}))
