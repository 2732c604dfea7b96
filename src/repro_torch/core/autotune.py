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
front-guided refinement of a coarse grid, see `pareto.refine`. Both take
`predict=` (an `analysis.cost.AppCostModel`), which prunes what the cost
model rejects before anything runs.
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
                       substrate: Optional[str] = None,
                       predict=None) -> List[Record]:
    """Multi-fidelity race over `specs`: each rung costs ~n_base cheap
    evaluations (the pool shrinks by eta while fidelity grows by eta).
    Returns the FINAL rung's records, best first. `jobs > 1` evaluates each
    rung's pool concurrently; `substrate` scopes every evaluation.

    `predict` (an `analysis.cost.AppCostModel`) prunes the STARTING pool
    before the first rung runs: specs predicted sub-1x, or whose error
    bound already exceeds `max_error`, never consume evaluations."""
    rng = random.Random(seed)
    pool = list(specs)
    if predict is not None:
        from ..analysis.cost import filter_specs
        pool, _ = filter_specs(predict, pool, max_error=max_error,
                               context=f"autotune:{app.name}")
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
                  substrate: Optional[str] = None,
                  predict=None) -> List[Record]:
    """Budget-capped random search with a spec sampler. `substrate` scopes
    every evaluation.

    With `predict`, sampled specs that the cost model rejects (sub-1x
    predicted speedup or error bound over `max_error`) are re-drawn
    instead of measured, so the evaluation budget is spent only on
    plausible candidates (bounded redraws: a sampler whose whole support
    is rejected degrades to the unpredicted behavior)."""
    rng = random.Random(seed)
    with substrate_mod.use(substrate):
        exact = app.exact()
    if predict is None:
        specs = [sampler(rng) for _ in range(budget)]
    else:
        from ..analysis.cost import filter_specs
        specs, attempts = [], 0
        while len(specs) < budget and attempts < 20 * budget:
            draw = [sampler(rng) for _ in range(budget - len(specs))]
            attempts += len(draw)
            kept, _ = filter_specs(predict, draw, max_error=max_error,
                                   context=f"autotune:{app.name}")
            specs.extend(kept)
        specs = specs[:budget] or [sampler(rng) for _ in range(budget)]
    with trace.span("autotune.random_search", app=app.name,
                    budget=len(specs), repeats=repeats):
        records = _evaluate_all(app, specs, exact, repeats, jobs, substrate)
    return sorted(records, key=lambda r: -_score(r, max_error))
