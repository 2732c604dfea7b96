"""Pareto-front extraction and front-guided adaptive refinement (port of
`repro.core.pareto`).

The AC surveys (Leon et al., arXiv:2307.11124 / 2307.11128) frame technique
selection as a quality-vs-performance *Pareto* problem: no single "best"
configuration exists, only the non-dominated error/speedup trade-off curve.
This module makes the harness Pareto-aware:

  pareto_front(records)  -- the non-dominated subset (min error, max speedup)
  hypervolume(front)     -- 2-D dominated-area indicator (front quality)
  refine(app, records)   -- spend an extra evaluation budget subdividing
                            parameter neighborhoods around the current front
                            (successive-halving style: only front members
                            spawn candidates, fidelity grows per round)
  front_summary(records) -- front size and hypervolume, as the benchmarks
                            report them

All functions consume the same `Record` stream (or DB rows) as
`harness.sweep`, and `refine` writes through the same keyed DB cache.
"""
from __future__ import annotations

import logging
import math
import os
from typing import Dict, List, Optional, Sequence, Union

from .harness import (ApproxApp, Record, db_index, load_db, spec_from_dict,
                      spec_hash, sweep)
from .types import ApproxSpec

log = logging.getLogger("repro_torch.core.pareto")

RecordLike = Union[Record, Dict]

# Numeric knobs eligible for neighborhood subdivision, per technique.
# name -> (is_integer, hard_lower_bound)
_KNOBS = {
    "taf": {"hSize": (True, 1), "pSize": (True, 1), "thresh": (False, 0.0)},
    "iact": {"tSize": (True, 1), "thresh": (False, 0.0),
             "tPerBlock": (True, 0)},
    "perfo": {"skip": (True, 2), "fraction": (False, 0.0)},
}


def _get(r: RecordLike, field: str):
    return r[field] if isinstance(r, dict) else getattr(r, field)


def _hash_of(r: RecordLike) -> str:
    """Cache hash of a record or DB row (v1 rows lack spec_hash: recompute)."""
    h = r.get("spec_hash") if isinstance(r, dict) else r.spec_hash
    return h or spec_hash(_get(r, "spec"))


def _perf(r: RecordLike, use_modeled: bool) -> float:
    return _get(r, "modeled_speedup" if use_modeled else "speedup")


def dominates(a: RecordLike, b: RecordLike, *,
              use_modeled: bool = False) -> bool:
    """True iff `a` is at least as good as `b` on both axes (error down,
    speedup up) and strictly better on at least one."""
    ea, eb = _get(a, "error"), _get(b, "error")
    sa, sb = _perf(a, use_modeled), _perf(b, use_modeled)
    return (ea <= eb and sa >= sb) and (ea < eb or sa > sb)


def pareto_front(records: Sequence[RecordLike], *,
                 use_modeled: bool = False) -> List[RecordLike]:
    """Non-dominated subset of `records`, sorted by ascending error.

    Accepts Record objects or raw DB rows (dicts). Records with non-finite
    error are excluded (they cannot trade off against anything). Duplicate
    (error, speedup) points keep a single representative.
    """
    finite = [r for r in records if math.isfinite(_get(r, "error"))]
    ranked = sorted(finite,
                    key=lambda r: (_get(r, "error"), -_perf(r, use_modeled)))
    front: List[RecordLike] = []
    best = -math.inf
    for r in ranked:
        s = _perf(r, use_modeled)
        if s > best:
            front.append(r)
            best = s
    return front


def hypervolume(front: Sequence[RecordLike], *, ref_error: float = 1.0,
                ref_speedup: float = 1.0, use_modeled: bool = False) -> float:
    """Area dominated by `front` relative to reference point
    (ref_error, ref_speedup) -- larger is better. Points at or beyond the
    reference on either axis contribute nothing."""
    pts = sorted({(_get(r, "error"), _perf(r, use_modeled)) for r in front})
    hv, prev_spd = 0.0, ref_speedup
    for err, spd in pts:  # error ascending; on a front speedup ascends too
        if err >= ref_error or spd <= prev_spd:
            continue
        hv += (ref_error - err) * (spd - prev_spd)
        prev_spd = spd
    return hv


def _neighbor_values(value, seen: Sequence, is_int: bool, lower) -> List:
    """Midpoints between `value` and its nearest distinct seen values on
    each side; when a side has no neighbor, extrapolate by the half/1.5x
    rule so the search can escape the initial grid's hull."""
    out = []
    below = [v for v in seen if v < value]
    above = [v for v in seen if v > value]
    cands = [(value + max(below)) / 2 if below else value / 2,
             (value + min(above)) / 2 if above else value * 1.5]
    for c in cands:
        c = int(round(c)) if is_int else float(c)
        if c >= lower and c != value and c not in seen:
            out.append(c)
    return out


def propose_candidates(records: Sequence[RecordLike], *,
                       use_modeled: bool = False,
                       max_candidates: Optional[int] = None
                       ) -> List[ApproxSpec]:
    """Subdivision candidates around the current front.

    For every front member and every numeric knob of its technique, propose
    the midpoints between the member's value and the nearest distinct values
    observed anywhere in `records`. Candidates are deduped by canonical
    spec hash and exclude anything already measured. With
    `max_candidates`, front members contribute round-robin so every front
    point keeps some of its neighborhood.
    """
    measured = {_hash_of(r) for r in records}
    front = pareto_front(records, use_modeled=use_modeled)

    seen_values: Dict[tuple, set] = {}
    for r in records:
        spec = _get(r, "spec")
        tech = spec.get("technique")
        for knob in _KNOBS.get(tech, {}):
            if knob in spec:
                seen_values.setdefault((tech, knob), set()).add(spec[knob])

    per_member: List[List[ApproxSpec]] = []
    proposed = set(measured)
    for r in front:
        spec = dict(_get(r, "spec"))
        tech = spec.get("technique")
        mine: List[ApproxSpec] = []
        for knob, (is_int, lower) in _KNOBS.get(tech, {}).items():
            if knob not in spec:
                continue
            seen = sorted(seen_values.get((tech, knob), set()))
            for v in _neighbor_values(spec[knob], seen, is_int, lower):
                cand = dict(spec)
                cand[knob] = v
                h = spec_hash(cand)
                if h in proposed:
                    continue
                try:
                    mine.append(spec_from_dict(cand))
                except (ValueError, KeyError):
                    continue  # violates a param constraint; not a candidate
                proposed.add(h)
        per_member.append(mine)

    # round-robin interleave across front members, then cap
    out: List[ApproxSpec] = []
    i = 0
    while any(per_member):
        for mine in per_member:
            if i < len(mine):
                out.append(mine[i])
        if not any(i < len(m) for m in per_member):
            break
        i += 1
    if max_candidates is not None:
        out = out[:max_candidates]
    return out


def refine(app: ApproxApp, records: Sequence[RecordLike], *,
           budget: int = 16, rounds: int = 2, repeats: int = 1, eta: int = 2,
           jobs: int = 1, db_path: Optional[str] = None,
           use_modeled: bool = False, verbose: bool = False,
           substrate: Optional[str] = None,
           predict=None, predict_band: float = 0.10) -> List[Record]:
    """Front-guided adaptive densification (successive-halving style).

    Starting from coarse-grid `records`, run up to `rounds` rounds; each
    round proposes subdivision candidates around the *current* front,
    evaluates at most the remaining budget of them via the resumable
    `sweep`, folds the results in, and raises fidelity by `eta` for the next
    round. `substrate` scopes the ambient execution substrate.

    `predict` (an `analysis.cost.AppCostModel`) turns refinement into a
    predicted-front seeding strategy: each round's candidates are ranked
    by their regret against the PREDICTED (error bound, speedup) front
    and only those within `predict_band` relative regret -- capped at the
    remaining budget -- are measured.

    Returns only the newly-EXECUTED Records: candidates served from the DB
    cache fold into the working front but cost no budget.
    """
    pool: List[RecordLike] = list(records)
    new: List[Record] = []
    remaining = budget
    fidelity = repeats
    for _ in range(max(1, rounds)):
        if remaining <= 0:
            break
        cands = propose_candidates(pool, use_modeled=use_modeled,
                                   max_candidates=None if predict is not None
                                   else remaining)
        if predict is not None and cands:
            n_all = len(cands)
            cands = predict.select_band(cands, budget=remaining,
                                        band=predict_band)
            log.info("predict[refine:%s]: kept %d / dropped %d of %d "
                     "candidates (band=%.3g)", app.name, len(cands),
                     n_all - len(cands), n_all, predict_band)
        if not cands:
            break
        already = set()
        if db_path and os.path.exists(db_path):
            already = {k[1] for k in db_index(load_db(db_path))
                       if k[0] == app.name and k[2] == app.workload_hash}
        recs = sweep(app, cands, repeats=fidelity, db_path=db_path,
                     verbose=verbose, jobs=jobs, resume=True,
                     substrate=substrate)
        fresh = [r for r in recs if r.spec_hash not in already]
        remaining -= len(fresh)
        pool.extend(recs)
        new.extend(fresh)
        fidelity *= eta
    return new


def front_summary(records: Sequence[RecordLike], *, use_modeled: bool = False,
                  ref_error: float = 1.0) -> Dict:
    """Compact description of a record set's front (used by benchmarks)."""
    front = pareto_front(records, use_modeled=use_modeled)
    return {
        "n_records": len(records),
        "n_front": len(front),
        "hypervolume": hypervolume(front, ref_error=ref_error,
                                   use_modeled=use_modeled),
        "best_error": min((_get(r, "error") for r in front), default=None),
        "best_speedup": max((_perf(r, use_modeled) for r in front),
                            default=None),
    }
