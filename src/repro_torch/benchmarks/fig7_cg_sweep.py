"""Paper Figure 7/9c analogue: the implicit-solver case, MiniFE (port of
`benchmarks/fig7_cg_sweep.py`, with the same app, size and grid).

Sweeps TAF + perforation over the CG solve and reports the error
distribution -- the paper's finding that iterative implicit solvers amplify
local approximation error, making them hostile AC targets.

A solve that blows up amplifies float32 rounding without bound: two correct
implementations then agree on the row's class (under 10%, blown up past
100%, not finite) but not on its digits, so `check` compares digits only
for errors under 1.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig7_cg_sweep \\
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import math
from typing import Callable, Dict, List, Optional

import numpy as np

from ..apps import minife_cg
from ..core.harness import perfo_grid, sweep, taf_grid
from ..core.types import Level, PerforationKind
from .fig6_best_speedup import (ERROR_ATOL, FRACTION_ATOL, SPEEDUP_RTOL,
                                _report, load_reference, row)

N = 48
GRID = taf_grid(h_sizes=(3,), p_sizes=(8,), thresholds=(0.5, 5.0),
                levels=(Level.ELEMENT,)) + \
    perfo_grid(skips=(4, 16), fractions=(0.1,),
               kinds=(PerforationKind.SMALL, PerforationKind.INI))


def main(report: Callable[..., None] = _report, jobs: int = 1,
         db_path: Optional[str] = None, device=None) -> Dict:
    """Sweep the grid on `device`; report the error range, the diverged
    count and the configs under 10%; return {minife_cg: {workload,
    rows}}."""
    app = minife_cg.make_app(n=N, device=device)
    recs = sweep(app, GRID, repeats=1, jobs=jobs, db_path=db_path)
    errs = np.asarray([r.error for r in recs])
    finite = errs[np.isfinite(errs)]
    report("fig7_cg_sweep", "error_range",
           f"min={finite.min():.3g},max={finite.max():.3g},"
           f"n_diverged={int((~np.isfinite(errs)).sum())}/{len(errs)}")
    under = [r for r in recs if r.error < 0.10]
    report("fig7_cg_sweep", "configs_under_10pct",
           f"{len(under)}/{len(recs)}"
           " (implicit solvers amplify AC error -- matches paper)")
    return {"minife_cg": {"workload": dict(app.workload),
                          "rows": [row(r) for r in recs]}}


def _kind(err: float) -> str:
    if not math.isfinite(err):
        return "not finite"
    return "under 10%" if err < 0.10 else (
        "under 1" if err < 1.0 else "blown up")


def check(result: Dict, reference: Dict) -> List[str]:
    """Where `result` departs from the JAX rows of `reference["fig7"]`:
    per spec, the same error class, the error within ERROR_ATOL when it is
    under 1, the modeled speedup within SPEEDUP_RTOL and the approx
    fraction within FRACTION_ATOL. Returns the failures."""
    bad = []
    want_rows = {r["spec_hash"]: r for r in
                 reference["fig7"]["minife_cg"]["rows"]}
    for r in result["minife_cg"]["rows"]:
        w = want_rows.get(r["spec_hash"])
        where = f"fig7 {r['spec']}"
        if w is None:
            bad.append(f"{where}: not in the reference")
            continue
        if _kind(r["error"]) != _kind(w["error"]):
            bad.append(f"{where}: error {r['error']} ({_kind(r['error'])})"
                       f" vs {w['error']} ({_kind(w['error'])})")
        elif w["error"] < 1.0 and abs(r["error"] - w["error"]) > ERROR_ATOL:
            bad.append(f"{where}: error {r['error']} vs {w['error']}")
        if abs(r["modeled_speedup"] - w["modeled_speedup"]) > \
                SPEEDUP_RTOL * abs(w["modeled_speedup"]):
            bad.append(f"{where}: modeled speedup {r['modeled_speedup']} "
                       f"vs {w['modeled_speedup']}")
        if abs(r["approx_fraction"] - w["approx_fraction"]) > FRACTION_ATOL:
            bad.append(f"{where}: approx fraction {r['approx_fraction']} "
                       f"vs {w['approx_fraction']}")
    return bad


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    failures = check(main(device=a.device), load_reference())
    print(json.dumps({"matches_reference": not failures,
                      "failures": failures}))
