"""Pareto-front extraction (port of `repro.core.pareto`; front-guided
refinement, `refine`, waits for the autotuners' port).

The AC surveys (Leon et al., arXiv:2307.11124 / 2307.11128) frame technique
selection as a quality-vs-performance *Pareto* problem: no single "best"
configuration exists, only the non-dominated error/speedup trade-off curve.
This module makes the harness Pareto-aware:

  pareto_front(records)  -- the non-dominated subset (min error, max speedup)
  hypervolume(front)     -- 2-D dominated-area indicator (front quality)
  front_summary(records) -- both, as the benchmarks report them

All functions consume the same `Record` stream (or DB rows) as
`harness.sweep`.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Union

from .harness import Record

RecordLike = Union[Record, Dict]


def _get(r: RecordLike, field: str):
    return r[field] if isinstance(r, dict) else getattr(r, field)


def _perf(r: RecordLike, use_modeled: bool) -> float:
    return _get(r, "modeled_speedup" if use_modeled else "speedup")


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
