"""K-Means (Rodinia) under approximation (port of `examples/apps/kmeans.py`).

The approximated region is the per-iteration distance/assignment kernel.
QoI: final cluster id per observation; error metric: MCR (paper Eq. 2).
The paper's key finding (Figure 12c): approximation herds observations into
stable clusters => EARLY CONVERGENCE. This app therefore reports
iterations-to-converge in `extra`.

Two runners, as in the JAX app. `run_kmeans` is the host convergence loop:
it breaks on the first repeated assignment, one device-to-host read an
iteration (tallied in `obs.metrics.HOST_READS`). The batched runner cannot
break per lane, so `_converging_scan` runs every iteration with a frozen
carry: once a lane's assignment repeats, its centers, state and assignment
stop updating and its iteration count is pinned. The two give the same
assignment, `iters` and mean approx fraction lane for lane.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import device as device_mod
from ..core import batching, hierarchy
from ..core import iact as iact_mod
from ..core import taf as taf_mod
from ..core.harness import AppResult, ApproxApp
from ..core.types import ApproxSpec, Technique
from ..obs import metrics
from .common import timed


def gen_data(n: int = 2048, d: int = 8, k: int = 12, seed: int = 0):
    rng = np.random.RandomState(seed)
    centers = rng.standard_normal((k, d)) * 4.0
    assign = rng.randint(0, k, n)
    pts = centers[assign] + rng.standard_normal((n, d))
    return pts.astype(np.float32), k


def _assign_exact(pts: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    d2 = ((pts[:, None, :] - centers[None]) ** 2).sum(dim=-1)
    return torch.argmin(d2, dim=1)


def _init_state(technique, params, n, d, device):
    if technique == Technique.TAF:
        return taf_mod.init(params, n, (), torch.float32, device)
    if technique == Technique.IACT:
        n_tab = iact_mod.n_tables_for(params, n)
        return iact_mod.init(params, n_tab, d, (), torch.float32, device)
    return None


def _make_step(pts: torch.Tensor, k: int, technique, params, level):
    """One Lloyd iteration: approximated assignment + centroid update.

    step(centers, state, th) takes the technique's knob `th` (None = the
    params' value); shared by the host loop and the batched runner. Returns
    (new_centers, assign, new_state, approx fraction as a 0-d tensor).
    """
    n = pts.shape[0]

    def step(centers, state, th=None):
        if technique == Technique.TAF:
            out, new_state, mask = taf_mod.step(
                state, lambda: _assign_exact(pts, centers).float(), params,
                level, rsd_threshold=th)
            assign = out.int()
        elif technique == Technique.IACT:
            out, new_state, mask = iact_mod.step(
                state, pts, lambda x: _assign_exact(x, centers).float(),
                params, level, threshold=th)
            assign = out.int()
        else:
            assign = _assign_exact(pts, centers).int()
            new_state = state
            mask = torch.zeros((n,), dtype=torch.bool, device=pts.device)
        onehot = torch.nn.functional.one_hot(assign.long(), k).float()
        counts = torch.clamp(onehot.sum(dim=0), min=1.0)
        new_centers = (onehot.T @ pts) / counts[:, None]
        return new_centers, assign, new_state, hierarchy.fraction(mask)

    return step


def _spec_params(spec: ApproxSpec):
    if spec.technique == Technique.TAF:
        return spec.taf
    if spec.technique == Technique.IACT:
        return spec.iact
    return None


def _init_centers(pts: np.ndarray, k: int, device) -> torch.Tensor:
    rng = np.random.RandomState(1)
    return torch.from_numpy(
        pts[rng.choice(pts.shape[0], k, replace=False)]).to(device)


def run_kmeans(pts: torch.Tensor, k: int, spec: ApproxSpec,
               max_iters: int = 40):
    """Lloyd's algorithm on `pts`' device; the distance kernel output is the
    approximated region, per element (observation). Returns (assignment
    (N,) int32 tensor, iterations, mean approx fraction): the per-iteration
    float32 fractions stay on the device and are averaged in float64 once,
    at the end, as the JAX loop averages its floats."""
    n, dim = pts.shape
    params = _spec_params(spec)
    state = _init_state(spec.technique, params, n, dim, pts.device)
    step = _make_step(pts, k, spec.technique, params, spec.level)
    centers = _init_centers(pts.cpu().numpy(), k, pts.device)
    prev = None
    fracs = []
    iters = max_iters
    for it in range(max_iters):
        centers, assign, state, frac = step(centers, state)
        fracs.append(frac)
        if prev is not None:
            metrics.count_host_read()
            if torch.equal(assign, prev):
                iters = it + 1
                break
        prev = assign
    frac = float(np.mean(torch.stack(fracs).cpu().numpy().astype(
        np.float64)))
    return prev if prev is not None else assign, iters, frac


def _converging_scan(step, centers0, state0, n, max_iters, device):
    """The host convergence loop with a frozen carry: fn(th) -> (final
    assignment, mean approx fraction, {'iters': iters}), all device
    tensors, equal to `run_kmeans`' lane for lane, with no read of the
    convergence test."""
    def freeze(done, new, old):
        if isinstance(new, tuple):
            return type(new)(*(freeze(done, a, b) for a, b in zip(new, old)))
        return torch.where(done, old, new)

    def one(th):
        centers, state = centers0, state0
        prev = torch.zeros((n,), dtype=torch.int32, device=device)
        has_prev = torch.zeros((), dtype=torch.bool, device=device)
        done = torch.zeros((), dtype=torch.bool, device=device)
        iters = torch.full((), max_iters, dtype=torch.int32, device=device)
        fsum = torch.zeros((), dtype=torch.float32, device=device)
        nexec = torch.zeros((), dtype=torch.int32, device=device)
        for t in range(max_iters):
            new_centers, assign, new_state, frac = step(centers, state, th)
            conv = has_prev & torch.all(assign == prev)
            take = ~done
            centers = freeze(done, new_centers, centers)
            state = freeze(done, new_state, state)
            prev = torch.where(done, prev, assign)
            iters = torch.where(take & conv, t + 1, iters)
            fsum = fsum + torch.where(take, frac, 0.0)
            nexec = nexec + take.int()
            has_prev = has_prev | take
            done = done | conv
        frac = fsum / torch.clamp(nexec, min=1).float()
        return prev, frac, {"iters": iters}

    return one


def make_app(n: int = 2048, d: int = 8, k: int = 12, seed: int = 0,
             max_iters: int = 40, device=None) -> ApproxApp:
    """`device`: ``cuda`` unless the caller passes ``"cpu"``."""
    dev = device_mod.resolve(device)
    pts_np, k = gen_data(n, d, k, seed)
    pts = torch.from_numpy(pts_np).to(dev)

    def _result(qoi, frac, iters, wall, extra=None):
        return AppResult(qoi=qoi, wall_time_s=wall, approx_fraction=frac,
                         flop_fraction=max(iters / max_iters * (1 - frac),
                                           1e-3),
                         extra=dict(extra or {}, iters=iters))

    def run(spec: ApproxSpec) -> AppResult:
        (assign, iters, frac), wall, reads = timed(
            run_kmeans, pts, k, spec, max_iters, device=dev)
        return _result(assign.cpu().numpy(), float(frac), iters, wall,
                       {"host_reads": reads})

    def make_group_fn(key):
        tech, level = key[0], key[1]
        if tech not in (Technique.TAF, Technique.IACT):
            return None
        params = batching.params_from_key(key)
        step = _make_step(pts, k, tech, params, level)
        one = _converging_scan(step, _init_centers(pts_np, k, dev),
                               _init_state(tech, params, n, d, dev), n,
                               max_iters, dev)
        return batching.lanes(one)

    run_batch = batching.make_run_batch(
        run, make_group_fn,
        result_builder=lambda qoi, frac, extra, wall: _result(
            qoi, frac, int(extra.get("iters", max_iters)), wall),
        device=dev)

    return ApproxApp(name="kmeans", run=run, error_metric="mcr",
                     run_batch=run_batch,
                     workload=dict(n=n, d=d, k=k, seed=seed,
                                   max_iters=max_iters))
