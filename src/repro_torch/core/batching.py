"""The batched-runner protocol: one evaluation per spec *group* (port of
`repro.core.batching`).

Most of a sweep grid varies only a scalar knob (the TAF RSD threshold, the
iACT distance threshold, the perforation fraction) while the structural
parameters -- which shape the technique state -- stay fixed. The port's
kernels take those knobs as device tensors, so every spec of a group runs
the same launch path.

  static_key(spec)   -- hashable (technique, level, structural-params) key;
                        None when the spec has no knob (skip-driven
                        perforation) and must run serially.
  traced_param(spec) -- the spec's knob.
  group_specs(specs) -- indices grouped by static_key + the serial leftovers.
  make_run_batch(..) -- assembles an `ApproxApp.run_batch` from an app's
                        `make_group_fn(key) -> fn(knobs)` factory.

An app's `make_group_fn(key)` returns a callable mapping a (B,) float32
tensor of knobs to `(qoi_stack, frac_stack)` (optionally a third dict of
stacked per-spec extras), or None to decline the group. Where the JAX
package `vmap`s the knobs through one compiled program, the port's group
function loops over the lanes and launches each kernel once per lane; a
kernel with a lane grid dimension is later work.
"""
from __future__ import annotations

import inspect
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs import timing, trace
from .harness import AppResult
from .perforation import FRACTION_KINDS
from .types import (ApproxSpec, IACTParams, PerforationParams, TAFParams,
                    Technique)


def static_key(spec: ApproxSpec) -> Optional[Tuple]:
    """Hashable static-structure key, or None when the spec has no knob and
    must be evaluated serially. Two specs with the same key differ ONLY in
    their knob."""
    if spec.technique == Technique.TAF:
        return (Technique.TAF, spec.level, spec.taf.history_size,
                spec.taf.prediction_size)
    if spec.technique == Technique.IACT:
        return (Technique.IACT, spec.level, spec.iact.table_size,
                spec.iact.tables_per_block)
    if spec.technique == Technique.PERFORATION:
        p = spec.perforation
        if p.kind in FRACTION_KINDS:
            return (Technique.PERFORATION, spec.level, p.kind, p.herded,
                    p.seed)
        return None  # small/large: `skip` is structural, nothing to stack
    return None


def params_from_key(key: Tuple):
    """Reconstruct a static key's technique params, knob zeroed (it is
    supplied per lane). The single inverse of `static_key`."""
    tech = key[0]
    if tech == Technique.TAF:
        return TAFParams(key[2], key[3], 0.0)
    if tech == Technique.IACT:
        return IACTParams(key[2], 0.0, key[3])
    if tech == Technique.PERFORATION:
        return PerforationParams(kind=key[2], herded=key[3], seed=key[4])
    raise ValueError(f"not a batchable static key: {key}")


def spec_from_key(key: Tuple) -> ApproxSpec:
    """The static key as an ApproxSpec (knob zeroed)."""
    tech, level = key[0], key[1]
    p = params_from_key(key)
    return ApproxSpec(tech, level,
                      taf=p if tech == Technique.TAF else None,
                      iact=p if tech == Technique.IACT else None,
                      perforation=p if tech == Technique.PERFORATION
                      else None)


def traced_param(spec: ApproxSpec) -> float:
    """The spec's knob (the parameter a batched runner stacks)."""
    if spec.technique == Technique.TAF:
        return float(spec.taf.rsd_threshold)
    if spec.technique == Technique.IACT:
        return float(spec.iact.threshold)
    if spec.technique == Technique.PERFORATION and \
            spec.perforation.kind in FRACTION_KINDS:
        return float(spec.perforation.fraction)
    raise ValueError(f"spec {spec} has no traced parameter")


def group_specs(specs: Sequence[ApproxSpec], min_group: int = 2
                ) -> Tuple[Dict[Tuple, List[int]], List[int]]:
    """Partition spec indices into groups and serial leftovers. Groups
    smaller than `min_group` are demoted to the serial list."""
    groups: Dict[Tuple, List[int]] = {}
    serial: List[int] = []
    for i, spec in enumerate(specs):
        key = static_key(spec)
        if key is None:
            serial.append(i)
        else:
            groups.setdefault(key, []).append(i)
    for key in [k for k, idxs in groups.items() if len(idxs) < min_group]:
        serial.extend(groups.pop(key))
    return groups, sorted(serial)


def _default_result(qoi: np.ndarray, frac: float, extra: Dict,
                    wall: float) -> AppResult:
    return AppResult(qoi=qoi, wall_time_s=wall, approx_fraction=frac,
                     flop_fraction=max(1.0 - frac, 1e-3), extra=extra)


def _to_numpy(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _per_spec_extra(extras: Dict, j: int) -> Dict:
    out = {}
    for k, v in extras.items():
        vj = _to_numpy(v)[j]
        out[k] = vj.item() if np.ndim(vj) == 0 else vj
    return out


def run_batch_grouped(
        specs: Sequence[ApproxSpec],
        run_one: Callable[[ApproxSpec], AppResult],
        make_group_fn: Callable[[Tuple], Optional[Callable]],
        result_builder: Callable[..., AppResult] = _default_result,
        min_group: int = 2, device="cuda") -> List[AppResult]:
    """Evaluate `specs`, running each static-structure group through its
    group function and falling back to `run_one` for the rest.

    Per group: `fn = make_group_fn(key)` is called twice on the stacked
    knobs (a float32 tensor on `device`) -- once to warm up, once timed --
    and the batch time is amortized per spec. `fn` returns
    `(qoi_stack, frac_stack)` or `(qoi_stack, frac_stack, extras_dict)`
    with every stack's leading dim == len(group).

    `result_builder(qoi, frac, extra, wall[, spec])` assembles each
    AppResult; builders that declare a 5th parameter also receive the spec.
    """
    wants_spec = len(inspect.signature(result_builder).parameters) >= 5
    results: List[Optional[AppResult]] = [None] * len(specs)
    groups, serial = group_specs(specs, min_group=min_group)
    for i in serial:
        results[i] = run_one(specs[i])
    for key, idxs in groups.items():
        fn = make_group_fn(key)
        if fn is None:
            for i in idxs:
                results[i] = run_one(specs[i])
            continue
        params = torch.tensor([traced_param(specs[i]) for i in idxs],
                              dtype=torch.float32, device=device)
        with trace.span("batching.group_warmup", key=str(key),
                        specs=len(idxs)):
            fn(params)
        m = timing.measure(fn, params, device=device, warmup=0, repeats=1,
                           span="batching.group_run")
        out, wall = m.value, m.seconds / len(idxs)
        qois, fracs = _to_numpy(out[0]), _to_numpy(out[1])
        extras = out[2] if len(out) > 2 else {}
        if qois.shape[0] != len(idxs) or fracs.shape[0] != len(idxs):
            raise ValueError(
                f"group runner for {key} returned leading dim "
                f"{qois.shape[0]}/{fracs.shape[0]} for {len(idxs)} specs")
        for j, i in enumerate(idxs):
            args = (qois[j], float(fracs[j]), _per_spec_extra(extras, j),
                    wall)
            results[i] = (result_builder(*args, specs[i]) if wants_spec
                          else result_builder(*args))
    return results


def make_run_batch(run_one, make_group_fn,
                   result_builder: Callable[..., AppResult] = _default_result,
                   min_group: int = 2, device="cuda"):
    """Build an `ApproxApp.run_batch` from an app's group-runner factory;
    the knobs are stacked on `device`."""
    def run_batch(specs: Sequence[ApproxSpec]) -> List[AppResult]:
        return run_batch_grouped(specs, run_one, make_group_fn,
                                 result_builder=result_builder,
                                 min_group=min_group, device=device)
    return run_batch
