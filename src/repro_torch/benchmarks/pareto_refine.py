"""Pareto-aware adaptive search on Blackscholes / TAF (port of
`benchmarks/pareto_refine.py`, with the same app, size, grid and budget).

Sweeps a deliberately coarse threshold grid, then lets `pareto.refine`
spend a small extra budget subdividing parameter neighbourhoods around the
error / speedup front: the successive-halving replacement for densifying
the grid by brute force. Reports the front's size and hypervolume before
and after, and how many extra evaluations the budget bought. The front
uses modeled speedups, so every number equals the JAX rows (`check`).

With `db_path` the coarse sweep and the refinement write through one keyed
cache, so re-runs are incremental.

    PYTHONPATH=src python -m repro_torch.benchmarks.pareto_refine \\
        [--device cuda|cpu] [--jobs N] [--db PATH]
"""
from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, List, Optional

from ..apps import blackscholes
from ..core.harness import sweep, taf_grid
from ..core.pareto import front_summary, refine
from ..core.types import Level
from .fig6_best_speedup import _report

COARSE = taf_grid(h_sizes=(3,), p_sizes=(8, 64), thresholds=(0.1, 1.5),
                  levels=(Level.ELEMENT,))
APP = dict(n_elements=256, steps=32)
HV_RTOL = 1e-4  # hypervolume against the JAX row, relative


def main(report: Callable[..., None] = _report, jobs: int = 1,
         db_path: Optional[str] = None, device=None) -> Dict:
    """Sweep COARSE, refine with budget 8 over 2 rounds; report and return
    both front summaries and the refined specs."""
    app = blackscholes.make_app(**APP, device=device)
    recs = sweep(app, COARSE, repeats=1, jobs=jobs, db_path=db_path)
    before = front_summary(recs, use_modeled=True)
    report("pareto_refine", "coarse_front",
           f"n={before['n_front']}/{before['n_records']},"
           f"hv={before['hypervolume']:.3f}")
    new = refine(app, recs, budget=8, rounds=2, repeats=1, jobs=jobs,
                 db_path=db_path, use_modeled=True)
    after = front_summary(list(recs) + new, use_modeled=True)
    report("pareto_refine", "refined_front",
           f"n={after['n_front']}/{after['n_records']},"
           f"hv={after['hypervolume']:.3f},new_evals={len(new)}")
    return {"workload": dict(app.workload), "coarse": before,
            "refined": after, "new_evals": len(new),
            "new_specs": [r.spec_hash for r in new]}


def check(result: Dict, reference: Dict) -> List[str]:
    """Where `result` departs from `reference["pareto"]`: the same counts
    (records, front, new evaluations, refined specs) and each hypervolume
    within HV_RTOL relative. Returns the failures."""
    want = reference["pareto"]
    bad = []
    for key in ("workload", "new_evals", "new_specs"):
        if result[key] != want[key]:
            bad.append(f"pareto {key} {result[key]} vs {want[key]}")
    for stage in ("coarse", "refined"):
        g, w = result[stage], want[stage]
        for key in ("n_records", "n_front"):
            if g[key] != w[key]:
                bad.append(f"pareto {stage} {key} {g[key]} vs {w[key]}")
        if abs(g["hypervolume"] - w["hypervolume"]) > \
                HV_RTOL * abs(w["hypervolume"]):
            bad.append(f"pareto {stage} hypervolume {g['hypervolume']} vs "
                       f"{w['hypervolume']}")
    return bad


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--db", default=None)
    a = ap.parse_args()
    print(json.dumps(main(jobs=a.jobs, db_path=a.db, device=a.device)))
