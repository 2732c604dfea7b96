"""Approximation autotuning (port of `repro.core.autotune`) -- the paper's
stated future work (section 4.2): "smart search/optimization techniques
[...] to reduce parameter exploration costs."

`successive_halving` replaces the exhaustive Cartesian sweep with a
multi-fidelity race: all configs are evaluated on a cheap fidelity (few
repeats), the best `1/eta` survive to the next rung at higher fidelity.
`random_search` is the budget-capped baseline. Both emit the same Record
stream as harness.sweep (via `harness._make_record`, the scoring path of
`harness.evaluate_spec`) and dispatch evaluations through
`harness.run_specs`, so `jobs > 1` uses an app's batched runner. For
front-guided refinement of a coarse grid, see `pareto.refine`.

The JAX package's `predict=` (an app cost model that prunes the pool before
it runs) waits for the port of `analysis.cost.AppCostModel`.
"""
from __future__ import annotations

import random
from typing import Callable, List, Optional, Sequence

from ..obs import trace
from . import substrate as substrate_mod
from .harness import AppResult, ApproxApp, Record, _make_record, run_specs
from .types import ApproxSpec


def _evaluate_all(app: ApproxApp, specs: Sequence[ApproxSpec],
                  exact: AppResult, repeats: int, jobs: int,
                  substrate: Optional[str] = None) -> List[Record]:
    """Score a pool of specs via harness.run_specs -- the same dispatch as
    sweep. `substrate` scopes the ambient execution substrate."""
    results = run_specs(app, specs, repeats, jobs, substrate=substrate)
    return [_make_record(app, s, res, exact)
            for s, res in zip(specs, results)]


def _score(rec: Record, max_error: float) -> float:
    """Tuning objective: modeled speedup, zeroed when over the error bound
    (the paper's 'best speedup with error < 10%' criterion)."""
    if not (rec.error < max_error):
        return 0.0
    return rec.modeled_speedup


def successive_halving(app: ApproxApp, specs: Sequence[ApproxSpec], *,
                       max_error: float = 0.10, eta: int = 3,
                       base_repeats: int = 1, jobs: int = 1,
                       seed: int = 0,
                       substrate: Optional[str] = None) -> List[Record]:
    """Multi-fidelity race over `specs`: each rung costs ~n_base cheap
    evaluations (the pool shrinks by eta while fidelity grows by eta).
    Returns the FINAL rung's records, best first. `jobs > 1` evaluates each
    rung's pool concurrently; `substrate` scopes every evaluation."""
    rng = random.Random(seed)
    pool = list(specs)
    with substrate_mod.use(substrate):
        exact = app.exact()
    rng.shuffle(pool)
    repeats = base_repeats
    rung_records: List[Record] = []
    rung = 0
    while pool:
        with trace.span("autotune.rung", app=app.name, rung=rung,
                        pool=len(pool), repeats=repeats):
            rung_records = _evaluate_all(app, pool, exact, repeats, jobs,
                                         substrate)
        rung += 1
        ranked = sorted(zip(rung_records, pool),
                        key=lambda rs: -_score(rs[0], max_error))
        keep = max(1, len(pool) // eta)
        if len(pool) == keep or keep == 1 and len(pool) <= eta:
            rung_records = [r for r, _ in ranked[:keep]]
            break
        pool = [s for _, s in ranked[:keep]]
        repeats *= eta
    return sorted(rung_records, key=lambda r: -_score(r, max_error))


def random_search(app: ApproxApp, sampler: Callable[[random.Random],
                                                    ApproxSpec], *,
                  budget: int = 20, max_error: float = 0.10,
                  repeats: int = 1, jobs: int = 1,
                  seed: int = 0,
                  substrate: Optional[str] = None) -> List[Record]:
    """Budget-capped random search with a spec sampler. `substrate` scopes
    every evaluation."""
    rng = random.Random(seed)
    with substrate_mod.use(substrate):
        exact = app.exact()
    specs = [sampler(rng) for _ in range(budget)]
    with trace.span("autotune.random_search", app=app.name,
                    budget=len(specs), repeats=repeats):
        records = _evaluate_all(app, specs, exact, repeats, jobs, substrate)
    return sorted(records, key=lambda r: -_score(r, max_error))
