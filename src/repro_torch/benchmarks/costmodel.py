"""approxcost validation: predicted against measured on the HPC apps and
the ffn (port of `benchmarks/costmodel.py`).

Two claims are checked, the statically predicted numbers against the same
measured `Record` stream every other benchmark reads:

1. **Ranking.** Per app, the analytical predictor
   (`analysis.cost.AppCostModel`, region costs counted by `trace_cost`
   over the port app's own region function -- no hand-counted FLOPs) must
   rank a TAF threshold grid as the measured structural speedups
   (`Record.modeled_speedup`) do: Spearman rank correlation, reported per
   app and pinned by the regression gate.

2. **Pruned front recovery.** For the ffn app, `select_band` picks
   ``len(grid) // 5`` specs of the 30-spec sweep grid; only those are
   measured (on the ``cuda`` substrate by default, so on the card K1-K3
   run them), and the band's Pareto hypervolume must recover the
   committed full-grid front (``baselines/BENCH_ffn.json``) within
   ``FRONT_TOLERANCE``.

The models take a machine profile (`analysis.machine`; default ``h100``).
Kept / dropped counts depend on it: at the reference ffn size every
predicted speedup on ``h100`` lies within 1e-3 of 1 (its dispatch floor
dominates), so ``select`` keeps every spec there, where the JAX package's
``tpu-v5e`` profile drops two.

Writes ``BENCH_costmodel.json`` for ``repro_torch.benchmarks.run
--check-regression``.

    PYTHONPATH=src python -m repro_torch.benchmarks.run --only costmodel \\
        [--device cpu] [--artifacts DIR]
"""
from __future__ import annotations

import json
import math
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..analysis.cost import AppCostModel, CostVector, Site, trace_cost
from ..analysis.machine import get_machine
from ..apps import (approx_ffn, binomial_options, blackscholes, kmeans,
                    lavamd, minife_cg)
from ..core import pareto
from ..core.harness import spec_from_dict, sweep, taf_grid
from ..core.types import Level, Technique
from ..obs import metrics as obs_metrics

# the ffn front recovery's acceptance: the measured band's hypervolume must
# reach this fraction of the committed full-grid front's hypervolume
FRONT_TOLERANCE = 0.90

# Small validation workloads: the predictor only reads structure (traced
# region cost, invocation counts), so scaled-down shapes validate the same
# model the full-size sweeps would use. Blackscholes runs the
# regime-switching walk (volatility > 1, as in fig10c) so the RSD
# activation discriminates across the grid.
_WORKLOADS = {
    "blackscholes": dict(n_elements=128, steps=32, volatility=2.0),
    "binomial_options": dict(n_elements=32, steps=16, tree_steps=64),
    "kmeans": dict(n=256, d=4, k=4, max_iters=10),
    "lavamd": dict(nx=3),
    "minife_cg": dict(n=32, iters=20),
}

# per-app TAF threshold grids, inside each workload's RSD activation range
_THRESHOLDS = {
    "blackscholes": (0.005, 0.05, 0.2, 1.0),
    "binomial_options": (0.0002, 0.001, 0.005, 0.02),
    "kmeans": (0.05, 0.2, 0.5, 1.0),
    "lavamd": (0.05, 0.2, 0.5, 1.0),
    "minife_cg": (0.05, 0.2, 0.5, 1.0),
}

_APPS = {"blackscholes": blackscholes,
         "binomial_options": binomial_options, "kmeans": kmeans,
         "lavamd": lavamd, "minife_cg": minife_cg}


# --------------------------------------------------------------------------
# per-app cost models (region costs traced, not hand-counted)
# --------------------------------------------------------------------------

def _ones(*shape) -> torch.Tensor:
    return torch.ones(shape, dtype=torch.float32)


def blackscholes_model(n_elements: int = 128, steps: int = 32,
                       volatility: float = 1.0,
                       machine=None) -> AppCostModel:
    """One TAF / iACT decision per sequence step over the bs_price region.
    `volatility` shapes the data, not the program. Option prices cross
    zero, so the QoI's relative error is heavy-tailed: `qoi_condition`
    floors the residual."""
    del volatility
    region = trace_cost(blackscholes.bs_price, _ones(n_elements, 5))
    site = Site(region=region, invocations=float(steps), in_dim=5,
                qoi_condition=0.05)
    return AppCostModel(
        name="blackscholes", total=region * float(steps),
        sites={Technique.TAF: site, Technique.IACT: site},
        machine=get_machine(machine), dispatches=1.0)


def binomial_options_model(n_elements: int = 32, steps: int = 16,
                           tree_steps: int = 64,
                           machine=None) -> AppCostModel:
    region = trace_cost(
        lambda x: binomial_options.binomial_price(x, tree_steps),
        _ones(n_elements, 5))
    site = Site(region=region, invocations=float(steps), in_dim=5)
    return AppCostModel(
        name="binomial_options", total=region * float(steps),
        sites={Technique.TAF: site, Technique.IACT: site},
        machine=get_machine(machine), dispatches=1.0)


def kmeans_model(n: int = 256, d: int = 4, k: int = 4,
                 max_iters: int = 10, machine=None) -> AppCostModel:
    """The assignment is the approximable region, once per Lloyd
    iteration."""
    region = trace_cost(kmeans._assign_exact, _ones(n, d), _ones(k, d))
    site = Site(region=region, invocations=float(max_iters), in_dim=d)
    return AppCostModel(
        name="kmeans", total=region * float(max_iters),
        sites={Technique.TAF: site, Technique.IACT: site},
        machine=get_machine(machine), dispatches=float(max_iters))


def lavamd_model(nx: int = 3, seed: int = 0, machine=None) -> AppCostModel:
    """27 neighbour-box force invocations; one decision each."""
    region_fn, xs, _nb = lavamd.region_setup(nx, seed, "cpu")
    region = trace_cost(region_fn, xs[0])
    site = Site(region=region, invocations=27.0, in_dim=int(xs.shape[-1]))
    return AppCostModel(
        name="lavamd", total=region * 27.0,
        sites={Technique.TAF: site, Technique.IACT: site},
        machine=get_machine(machine), dispatches=1.0)


def minife_cg_model(n: int = 32, iters: int = 20,
                    machine=None) -> AppCostModel:
    """The stencil matvec dominates each CG iteration. An error injected in
    one iteration feeds every later one through the residual recurrence,
    so the site's amplification is the iteration count."""
    region = trace_cost(minife_cg.poisson_matvec, _ones(n, n))
    site = Site(region=region, invocations=float(iters), in_dim=n,
                n_iters=iters, amplification=float(iters))
    return AppCostModel(
        name="minife_cg", total=region * float(iters),
        sites={Technique.TAF: site, Technique.PERFORATION: site},
        machine=get_machine(machine), dispatches=float(iters))


def ffn_model(seq: int = 128, d: int = 32, d_h: int = 64,
              machine=None) -> AppCostModel:
    """Three sites, one per technique, as `approx_ffn._flop_fraction`
    counts them: TAF gates the projection's row blocks, iACT memoizes the
    FFN's row blocks, perforation drops attention KV blocks."""
    proj, attn, ffn = approx_ffn._flops(seq, d, d_h)
    total = CostVector(proj + attn + ffn,
                       4.0 * (seq * d * 4 + d * d + 2 * d * d_h))
    n_rows = float(seq // approx_ffn._BLOCK_M)
    n_kv = seq // approx_ffn._BLOCK_ATTN
    sites = {
        Technique.TAF: Site(region=CostVector(proj / n_rows,
                                              4.0 * seq * d / n_rows),
                            invocations=n_rows, in_dim=d),
        Technique.IACT: Site(region=CostVector(ffn / n_rows,
                                               4.0 * seq * d / n_rows),
                             invocations=n_rows, in_dim=d),
        Technique.PERFORATION: Site(region=CostVector(attn, 4.0 * seq * d),
                                    invocations=1.0, n_iters=n_kv),
    }
    return AppCostModel(name="approx_ffn", total=total, sites=sites,
                        machine=get_machine(machine), dispatches=3.0)


MODEL_BUILDERS = {
    "blackscholes": blackscholes_model,
    "binomial_options": binomial_options_model,
    "kmeans": kmeans_model,
    "lavamd": lavamd_model,
    "minife_cg": minife_cg_model,
}


def make_app(name: str, device=None):
    """The app `name` at its validation workload on `device`."""
    return _APPS[name].make_app(**_WORKLOADS[name], device=device)


def spearman(xs, ys) -> float:
    """Spearman rank correlation (average ranks for ties; no scipy)."""
    def _ranks(v):
        v = np.asarray(v, np.float64)
        order = np.argsort(v, kind="mergesort")
        ranks = np.empty_like(v)
        ranks[order] = np.arange(len(v), dtype=np.float64)
        for val in np.unique(v):
            m = v == val
            ranks[m] = ranks[m].mean()
        return ranks
    rx, ry = _ranks(xs), _ranks(ys)
    rx -= rx.mean()
    ry -= ry.mean()
    denom = math.sqrt(float((rx * rx).sum()) * float((ry * ry).sum()))
    if denom == 0.0:
        return 1.0 if np.allclose(rx, ry) else 0.0
    return float((rx * ry).sum() / denom)


def validation_grid(name: str):
    """The per-app grid: one structural TAF group over four thresholds
    (rank correlation is within one technique, as the predictor ranks)."""
    return taf_grid(h_sizes=(2,), p_sizes=(4,),
                    thresholds=_THRESHOLDS[name],
                    levels=(Level.ELEMENT,))


def spec_of(rec):
    return spec_from_dict(rec.spec)


def baseline_hypervolume() -> float:
    """The committed full-grid ffn front's hypervolume
    (`baselines/BENCH_ffn.json`)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baselines", "BENCH_ffn.json")
    with open(path) as f:
        return float(json.load(f)["front"]["hypervolume"])


def app_row(name: str, device=None, machine=None, jobs: int = 1,
            db_path: Optional[str] = None) -> Dict:
    """One app's validation: the model's kept / dropped counts on its
    grid, the Spearman correlation of predicted and measured structural
    speedups over the kept specs, and whether every error bound holds
    (MAPE apps other than MiniFE; None elsewhere)."""
    app = make_app(name, device=device)
    model = MODEL_BUILDERS[name](**_WORKLOADS[name], machine=machine)
    grid = validation_grid(name)
    kept, dropped = model.select(grid)
    recs = sweep(app, kept, repeats=1, db_path=db_path, jobs=max(jobs, 1))
    preds = [model.predict(spec_of(r)) for r in recs]
    rho = spearman([p.speedup for p in preds],
                   [r.modeled_speedup for r in recs])
    bound_ok = None
    if app.error_metric == "mape" and name != "minife_cg":
        bound_ok = all(p.error_bound >= r.error for p, r in zip(preds, recs))
    return {"n_grid": len(grid), "kept": len(kept), "dropped": len(dropped),
            "spearman": rho, "bound_holds": bound_ok}


def ffn_row(device=None, machine=None, substrate: Optional[str] = "cuda",
            jobs: int = 1, db_path: Optional[str] = None) -> Dict:
    """The ffn's pruned sweep: kept / dropped on the 30-spec grid, the
    predicted band (a fifth of the grid) measured alone on `substrate`, its
    front's recovery of the committed hypervolume, and the band's Spearman
    correlation."""
    from .approx_ffn_sweep import grid as ffn_grid

    grid = ffn_grid()
    model = ffn_model(machine=machine)
    budget = len(grid) // 5
    kept, dropped = model.select(grid)
    band = model.select_band(grid, budget=budget)
    app = approx_ffn.make_app(substrate=substrate, device=device)
    recs = sweep(app, band, repeats=1, db_path=db_path, jobs=max(jobs, 1))
    fs = pareto.front_summary(recs, use_modeled=True)
    base_hv = baseline_hypervolume()
    ratio = fs["hypervolume"] / base_hv if base_hv else 0.0
    rho = spearman([model.predict(spec_of(r)).speedup for r in recs],
                   [r.modeled_speedup for r in recs])
    return {
        "n_grid": len(grid), "kept": len(kept), "dropped": len(dropped),
        "band_budget": budget, "band_measured": len(recs),
        "band": [r.spec for r in recs],
        "spearman": rho,
        "front_recovery": {"hv_band": fs["hypervolume"],
                           "hv_baseline": base_hv, "ratio": ratio},
        "recovered": bool(ratio >= FRONT_TOLERANCE),
    }


def main(report: Callable[..., None], jobs: int = 1,
         db_path: Optional[str] = None, artifacts_dir: Optional[str] = None,
         device=None, substrate: Optional[str] = "cuda",
         machine=None) -> Dict:
    """Validate every app model and the ffn band; return (and with
    `artifacts_dir`, write as BENCH_costmodel.json) the document."""
    prof = get_machine(machine)
    doc: Dict = {"machine": prof.name, "apps": {},
                 "front_tolerance": FRONT_TOLERANCE}
    for name in MODEL_BUILDERS:
        row = app_row(name, device=device, machine=prof, jobs=jobs,
                      db_path=db_path)
        doc["apps"][name] = row
        report(f"costmodel_{name}", f"{row['kept']}",
               f"spearman={row['spearman']:.3f},"
               f"kept={row['kept']}/{row['n_grid']},"
               f"bound_holds={row['bound_holds']}")
    ffn = ffn_row(device=device, machine=prof, substrate=substrate,
                  jobs=jobs, db_path=db_path)
    doc["ffn"] = ffn
    ratio = ffn["front_recovery"]["ratio"]
    report("costmodel_ffn", f"{ffn['band_measured']}",
           f"band={ffn['band_measured']}/{ffn['n_grid']},"
           f"kept={ffn['kept']},dropped={ffn['dropped']},"
           f"hv_ratio={ratio:.6f},spearman={ffn['spearman']:.3f},"
           f"recovered={ffn['recovered']}")
    if artifacts_dir:
        os.makedirs(artifacts_dir, exist_ok=True)
        path = os.path.join(artifacts_dir, "BENCH_costmodel.json")
        with open(path, "w") as f:
            json.dump(obs_metrics.stamp(doc), f, indent=1)
        report("costmodel_json", "0", path)
    return doc
