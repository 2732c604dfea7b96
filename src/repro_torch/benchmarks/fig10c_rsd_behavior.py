"""Paper Figure 10c: TAF's RSD threshold behaves unintuitively (port of
`benchmarks/fig10c_rsd_behavior.py`, with the same app, size and specs).

Blackscholes under TAF (5, 16, T) at ELEMENT level over six thresholds. One
would expect the error to rise with the threshold, but a low threshold can
turn approximation on exactly when the window happens to be flat while the
signal is about to move, giving a HIGHER error than a generous one (the
paper's T = 3.0 anomaly). Errors, approx fractions and the count of steps
where the error falls do not depend on the machine and equal the JAX rows
(`check`). With `full=True` the sweep runs again at 65536 x 64 (the CUDA
Samples BlackScholes size, `chip_smoke.py` phase 8's), and its rows are
the device's own.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig10c_rsd_behavior \\
        [--device cuda|cpu] [--full]
"""
from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, List

from ..apps import blackscholes
from ..core.harness import mape
from ..core.types import ApproxSpec, Level, TAFParams, Technique
from .fig6_best_speedup import ERROR_ATOL, FRACTION_ATOL, _report

THRESHOLDS = (0.1, 0.3, 1.0, 3.0, 5.0, 20.0)
APP = dict(n_elements=512, steps=64, seed=3, volatility=6.0)
FULL_APP = dict(APP, n_elements=65536)


def sweep_thresholds(report: Callable[..., None], device, **app_kw) -> Dict:
    app = blackscholes.make_app(**app_kw, device=device)
    exact = app.exact()
    rows, prev, non_monotone = [], None, 0
    for t in THRESHOLDS:
        r = app.run(ApproxSpec(Technique.TAF, Level.ELEMENT,
                               taf=TAFParams(5, 16, t)))
        err = mape(exact.qoi, r.qoi)
        if prev is not None and err < prev:
            non_monotone += 1
        prev = err
        rows.append({"T": t, "error": err,
                     "approx_fraction": r.approx_fraction,
                     "wall_ms": r.wall_time_s * 1e3})
        report("fig10c_rsd_behavior", f"n={app_kw['n_elements']},T={t}",
               f"err={err:.4%},approx_frac={r.approx_fraction:.2f},"
               f"wall={r.wall_time_s * 1e3:.3f}ms")
    report("fig10c_rsd_behavior", "non_monotone_steps",
           f"{non_monotone} (unintuitive RSD interactions -- matches paper)")
    return {"workload": dict(app.workload), "rows": rows,
            "non_monotone_steps": non_monotone,
            "exact_wall_ms": exact.wall_time_s * 1e3}


def main(report: Callable[..., None] = _report, device=None,
         full: bool = False) -> Dict:
    """The sweep at the JAX size, and with `full` at FULL_APP's."""
    out = {"jax_size": sweep_thresholds(report, device, **APP)}
    if full:
        out["full"] = sweep_thresholds(report, device, **FULL_APP)
    return out


def check(result: Dict, reference: Dict) -> List[str]:
    """Where the JAX-size rows of `result` depart from
    `reference["fig10c"]`: the same thresholds, error within ERROR_ATOL,
    approx fraction within FRACTION_ATOL, the same count of non-monotone
    steps. Returns the failures."""
    got, want = result["jax_size"], reference["fig10c"]
    bad = []
    if [r["T"] for r in got["rows"]] != [w["T"] for w in want["rows"]]:
        return [f"fig10c thresholds {[r['T'] for r in got['rows']]}"]
    if got["workload"] != want["workload"]:
        bad.append(f"fig10c workload {got['workload']} vs "
                   f"{want['workload']}")
    for r, w in zip(got["rows"], want["rows"]):
        where = f"fig10c T={r['T']}"
        if abs(r["error"] - w["error"]) > ERROR_ATOL:
            bad.append(f"{where}: error {r['error']} vs {w['error']}")
        if abs(r["approx_fraction"] - w["approx_fraction"]) > FRACTION_ATOL:
            bad.append(f"{where}: approx fraction {r['approx_fraction']} "
                       f"vs {w['approx_fraction']}")
    if got["non_monotone_steps"] != want["non_monotone_steps"]:
        bad.append(f"fig10c non_monotone_steps {got['non_monotone_steps']} "
                   f"vs {want['non_monotone_steps']}")
    return bad


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true")
    a = ap.parse_args()
    print(json.dumps(main(device=a.device, full=a.full)))
