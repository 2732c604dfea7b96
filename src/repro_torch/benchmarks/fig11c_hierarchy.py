"""Paper Figure 11c: the decision level against speedup, on LavaMD (port of
`benchmarks/fig11c_hierarchy.py`, with the same app, size and specs).

Thread-level (ELEMENT) decisions save nothing where the approximated
elements still run with the others (masked lanes; on a GPU, a divergent
warp); group decisions (BLOCK) skip whole invocations. TAF (3, 16, T) runs
at ELEMENT and BLOCK at equal thresholds: a wall-time speedup appears only
at BLOCK (the paper: up to 2.27x median at warp level).

Approx fractions equal the JAX rows. Errors equal them within ERROR_ATOL
below 1 and by class above it (LavaMD's cancelling sums amplify rounding,
as `fig7_cg_sweep.check` says). The wall speedups are the device's own:
each wall is the median of `repeats` runs (each run one warm-up and one
timed call), and they are never compared with the JAX rows. With
`full=True` the comparison runs again at nx = 10 (1000 boxes, Rodinia
lavaMD `-boxes1d 10`).

    PYTHONPATH=src python -m repro_torch.benchmarks.fig11c_hierarchy \\
        [--device cuda|cpu] [--full]
"""
from __future__ import annotations

import argparse
import json
import statistics
from typing import Callable, Dict, List

from ..apps import lavamd
from ..core.harness import mape
from ..core.types import ApproxSpec, Level, TAFParams, Technique
from .fig6_best_speedup import ERROR_ATOL, FRACTION_ATOL, _report
from .fig7_cg_sweep import _kind

THRESHOLDS = (0.3, 1.0, 3.0)
LEVELS = (Level.ELEMENT, Level.BLOCK)
APP = dict(nx=4, seed=2)
FULL_APP = dict(nx=10, seed=2)


def compare_levels(report: Callable[..., None], device, repeats: int,
                   **app_kw) -> Dict:
    app = lavamd.make_app(**app_kw, device=device)

    def median_run(spec):
        runs = [app.run(spec) for _ in range(repeats)]
        return runs[-1], statistics.median(r.wall_time_s for r in runs)

    exact, exact_wall = median_run(ApproxSpec())
    rows = []
    for t in THRESHOLDS:
        row = {"T": t}
        for level in LEVELS:
            r, wall = median_run(ApproxSpec(Technique.TAF, level,
                                            taf=TAFParams(3, 16, t)))
            row[level.value] = {"error": mape(exact.qoi, r.qoi),
                                "approx_fraction": r.approx_fraction,
                                "wall_ms": wall * 1e3,
                                "wall_speedup": exact_wall / max(wall, 1e-9)}
        rows.append(row)
        e, b = row["element"], row["block"]
        report("fig11c_hierarchy", f"nx={app_kw['nx']},T={t}",
               f"element:wall={e['wall_speedup']:.2f}x"
               f"(frac={e['approx_fraction']:.2f},err={e['error']:.2%});"
               f"block:wall={b['wall_speedup']:.2f}x"
               f"(frac={b['approx_fraction']:.2f},err={b['error']:.2%})")
    return {"workload": dict(app.workload), "repeats": repeats,
            "exact_wall_ms": exact_wall * 1e3, "rows": rows}


def main(report: Callable[..., None] = _report, device=None,
         full: bool = False, repeats: int = 5) -> Dict:
    """Both levels at the JAX size, and with `full` at FULL_APP's."""
    out = {"jax_size": compare_levels(report, device, repeats, **APP)}
    if full:
        out["full"] = compare_levels(report, device, repeats, **FULL_APP)
    return out


def check(result: Dict, reference: Dict) -> List[str]:
    """Where the JAX-size rows of `result` depart from
    `reference["fig11c"]`: per threshold and level, the approx fraction
    within FRACTION_ATOL and the error's class, and its value within
    ERROR_ATOL under 1. Returns the failures."""
    got, want = result["jax_size"], reference["fig11c"]
    if got["workload"] != want["workload"] or \
            [r["T"] for r in got["rows"]] != [w["T"] for w in want["rows"]]:
        return [f"fig11c workload / thresholds {got['workload']} "
                f"{[r['T'] for r in got['rows']]}"]
    bad = []
    for r, w in zip(got["rows"], want["rows"]):
        for level in LEVELS:
            g, x = r[level.value], w[level.value]
            where = f"fig11c T={r['T']} {level.value}"
            if abs(g["approx_fraction"] - x["approx_fraction"]) > \
                    FRACTION_ATOL:
                bad.append(f"{where}: approx fraction "
                           f"{g['approx_fraction']} vs "
                           f"{x['approx_fraction']}")
            if _kind(g["error"]) != _kind(x["error"]):
                bad.append(f"{where}: error {g['error']} "
                           f"({_kind(g['error'])}) vs {x['error']} "
                           f"({_kind(x['error'])})")
            elif x["error"] < 1.0 and \
                    abs(g["error"] - x["error"]) > ERROR_ATOL:
                bad.append(f"{where}: error {g['error']} vs {x['error']}")
    return bad


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true")
    a = ap.parse_args()
    print(json.dumps(main(device=a.device, full=a.full)))
