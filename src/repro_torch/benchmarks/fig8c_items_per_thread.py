"""Paper Figure 8c: approximation potential against parallelism (port of
`benchmarks/fig8c_items_per_thread.py`, with the same workload and spec).

A fixed workload of TOTAL Binomial options; `items` is the number of options
an element prices one after another. More items an element give TAF a
longer history a state slot, hence a larger approximated fraction; fewer
elements leave less parallelism to hide latency. `approx_frac`, `modeled`
(1 / (1 - approx_frac)) and `util` do not depend on the machine and equal
the JAX rows (`check`). `util` keeps the JAX module's penalty, elements over
LANES = 128, the width of a TPU VREG row, for parity's sake; `effective` is
modeled x util. Beside them stands the device's own answer to what
`effective` models: the measured wall of the whole TAF run at each `items`
value (the median of `repeats` timed runs after a warm-up; CUDA events on
the card).

    PYTHONPATH=src python -m repro_torch.benchmarks.fig8c_items_per_thread \\
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, List

from .. import convert, device as device_mod
from ..apps import binomial_options
from ..core import taf as taf_mod
from ..core.types import Level, TAFParams
from ..obs import timing
from .fig6_best_speedup import FRACTION_ATOL, SPEEDUP_RTOL, _report

TOTAL = 2048
TREE_STEPS = 64
ITEMS = (2, 8, 32, 128, 512)
LANES = 128  # a TPU VREG row: the JAX module's under-utilization threshold
SPEC = TAFParams(history_size=2, prediction_size=32, rsd_threshold=0.5)


def main(report: Callable[..., None] = _report, device=None,
         repeats: int = 5) -> Dict:
    """Run TAF over each `items` split on `device`; report and return
    {device, rows}."""
    dev = device_mod.resolve(device)

    def price(x):
        return binomial_options.binomial_price(x, TREE_STEPS)

    def run(xs):
        return taf_mod.run_sequence(SPEC, xs, price, Level.ELEMENT)[2]

    rows = []
    for items in ITEMS:
        n_elem = TOTAL // items
        xs = convert.to_tensor(
            binomial_options.gen_inputs(n_elem, items, seed=1), dev)
        m = timing.measure(run, xs, device=dev, warmup=1, repeats=repeats)
        frac = float(m.value)
        modeled = 1.0 / max(1.0 - frac, 1e-3)
        util = min(n_elem / LANES, 1.0)
        rows.append({"items": items, "n_elements": n_elem,
                     "approx_frac": frac, "modeled": modeled, "util": util,
                     "effective": modeled * util, "wall_ms": m.seconds * 1e3})
        report("fig8c_items_per_thread", f"items={items}",
               f"approx_frac={frac:.2f},modeled={modeled:.2f}x,"
               f"util={util:.2f},effective={modeled * util:.2f}x,"
               f"wall={m.seconds * 1e3:.3f}ms")
    return {"device": device_mod.name(dev), "rows": rows}


def check(result: Dict, reference: Dict) -> List[str]:
    """Where `result` departs from the JAX rows of `reference["fig8c"]`:
    the same items and elements, approx fraction within FRACTION_ATOL,
    modeled speedup within SPEEDUP_RTOL, util equal. Returns the
    failures."""
    bad = []
    want = reference["fig8c"]["rows"]
    if [r["items"] for r in result["rows"]] != [w["items"] for w in want]:
        return [f"fig8c items {[r['items'] for r in result['rows']]}"]
    for r, w in zip(result["rows"], want):
        where = f"fig8c items={r['items']}"
        if r["n_elements"] != w["n_elements"] or r["util"] != w["util"]:
            bad.append(f"{where}: elements / util {r['n_elements']} "
                       f"{r['util']} vs {w['n_elements']} {w['util']}")
        if abs(r["approx_frac"] - w["approx_frac"]) > FRACTION_ATOL:
            bad.append(f"{where}: approx fraction {r['approx_frac']} vs "
                       f"{w['approx_frac']}")
        if abs(r["modeled"] - w["modeled"]) > SPEEDUP_RTOL * w["modeled"]:
            bad.append(f"{where}: modeled {r['modeled']} vs {w['modeled']}")
    return bad


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    print(json.dumps(main(device=a.device)))
