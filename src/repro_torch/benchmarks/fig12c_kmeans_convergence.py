"""Paper Figure 12c: K-Means' speedup comes from early convergence (port of
`benchmarks/fig12c_kmeans_convergence.py`, with the same app, size and
grid).

Runs 4 TAF and 2 iACT ELEMENT configs over K-Means and correlates the
convergence speedup (iters_exact / iters_approx) with the wall-time speedup
(the paper: R^2 = 0.95). The iteration counts, approx fractions and errors
(MCR) do not depend on the machine and equal the JAX rows (`check`); R^2
comes from the device's walls and is reported, never compared. With
`full=True` the sweep runs again at 494020 x 34, k 5 (the shape of Rodinia
kmeans' kdd_cup input, `chip_smoke.py` phase 8's).

    PYTHONPATH=src python -m \\
        repro_torch.benchmarks.fig12c_kmeans_convergence \\
        [--device cuda|cpu] [--full] [--jobs N] [--db PATH]
"""
from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, List, Optional

import numpy as np

from ..apps import kmeans
from ..core.harness import iact_grid, sweep, taf_grid
from ..core.types import Level
from .fig6_best_speedup import ERROR_ATOL, FRACTION_ATOL, _report

GRID = taf_grid(h_sizes=(2, 3), p_sizes=(8,), thresholds=(0.3, 1.5),
                levels=(Level.ELEMENT,)) + \
    iact_grid(t_sizes=(4,), thresholds=(0.5, 3.0), tables_per_block=(0,),
              levels=(Level.ELEMENT,))
APP = dict(n=1024, d=6, k=8)
FULL_APP = dict(n=494020, d=34, k=5)


def convergence(report: Callable[..., None], device, jobs: int,
                db_path: Optional[str], **app_kw) -> Dict:
    app = kmeans.make_app(**app_kw, device=device)
    iters_exact = app.exact().extra["iters"]
    recs = sweep(app, GRID, repeats=1, jobs=jobs, db_path=db_path)
    rows = []
    for r in recs:
        it = r.extra.get("iters", iters_exact)
        rows.append({"spec": r.spec, "spec_hash": r.spec_hash, "iters": it,
                     "conv_speedup": iters_exact / max(it, 1),
                     "wall_speedup": r.speedup,
                     "approx_fraction": r.approx_fraction,
                     "error": r.error})
    conv = np.asarray([r["conv_speedup"] for r in rows])
    wall = np.asarray([r["wall_speedup"] for r in rows])
    r2 = (float(np.corrcoef(conv, wall)[0, 1] ** 2)
          if len(rows) > 2 and conv.std() > 0 and wall.std() > 0
          else float("nan"))
    report("fig12c_kmeans_convergence", f"n={app_kw['n']},r_squared",
           f"{r2:.3f} over {len(rows)} configs "
           f"(conv_speedup range {conv.min():.1f}..{conv.max():.1f})")
    return {"workload": dict(app.workload), "iters_exact": iters_exact,
            "rows": rows, "r_squared": r2}


def main(report: Callable[..., None] = _report, jobs: int = 1,
         db_path: Optional[str] = None, device=None,
         full: bool = False) -> Dict:
    """The sweep at the JAX size, and with `full` at FULL_APP's."""
    out = {"jax_size": convergence(report, device, jobs, db_path, **APP)}
    if full:
        out["full"] = convergence(report, device, jobs, db_path, **FULL_APP)
    return out


def check(result: Dict, reference: Dict) -> List[str]:
    """Where the JAX-size rows of `result` depart from
    `reference["fig12c"]`: the exact run's and every config's iteration
    count equal, approx fraction within FRACTION_ATOL and error within
    ERROR_ATOL. Returns the failures."""
    got, want = result["jax_size"], reference["fig12c"]
    bad = []
    if got["workload"] != want["workload"] or \
            got["iters_exact"] != want["iters_exact"]:
        bad.append(f"fig12c workload / exact iters {got['workload']} "
                   f"{got['iters_exact']} vs {want['workload']} "
                   f"{want['iters_exact']}")
    if [r["spec_hash"] for r in got["rows"]] != \
            [w["spec_hash"] for w in want["rows"]]:
        return bad + ["fig12c configs differ from the reference's"]
    for r, w in zip(got["rows"], want["rows"]):
        where = f"fig12c {r['spec']}"
        if r["iters"] != w["iters"]:
            bad.append(f"{where}: iters {r['iters']} vs {w['iters']}")
        if abs(r["approx_fraction"] - w["approx_fraction"]) > FRACTION_ATOL:
            bad.append(f"{where}: approx fraction {r['approx_fraction']} "
                       f"vs {w['approx_fraction']}")
        if abs(r["error"] - w["error"]) > ERROR_ATOL:
            bad.append(f"{where}: error {r['error']} vs {w['error']}")
    return bad


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--db", default=None)
    a = ap.parse_args()
    print(json.dumps(main(jobs=a.jobs, db_path=a.db, device=a.device,
                          full=a.full)))
