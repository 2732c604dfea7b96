"""MiniFE-like implicit finite-element solve: CG on a 2-D Poisson stencil
(port of `examples/apps/minife_cg.py`).

The approximated region is the sparse matvec inside CG. The paper found
MiniFE hostile to AC: "locally introduced errors propagate through
subsequent iterations, causing high error rates". Perforating or
TAF-memoizing the matvec corrupts the Krylov subspace and the residual
diverges. QoI: final solution vector (the residual norm is in `extra`).

Row-block TAF: each of the grid's NBLOCKS row blocks is an element.
Perforation drops row blocks of the matvec through the port's
`perforation.execute_mask` / `traced_execute_mask`. The CG loop has a fixed
trip count and makes no device-to-host read at ELEMENT and TILE level.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import device as device_mod
from ..core import batching, hierarchy
from ..core import taf as taf_mod
from ..core.harness import AppResult, ApproxApp
from ..core.perforation import execute_mask, traced_execute_mask
from ..core.types import ApproxSpec, Technique
from .common import timed

NBLOCKS = 8  # row-blocks of the grid = TAF elements


def poisson_matvec(x2d: torch.Tensor) -> torch.Tensor:
    """5-point stencil matvec on an (n, n) grid with Dirichlet boundary."""
    out = 4.0 * x2d
    out = out - F.pad(x2d[1:, :], (0, 0, 0, 1))
    out = out - F.pad(x2d[:-1, :], (0, 0, 1, 0))
    out = out - F.pad(x2d[:, 1:], (0, 1))
    out = out - F.pad(x2d[:, :-1], (1, 0))
    return out


def cg_solve(b2d: torch.Tensor, spec: ApproxSpec, iters: int = 60,
             rsd_threshold=None, fraction=None):
    """CG with an (optionally approximated) matvec. A stable row block's
    matvec output is memoized (function-output memoization applied to the
    sparse matvec).

    `rsd_threshold` (TAF) / `fraction` (ini/fini/random perforation)
    override the spec's value (floats or 0-d tensors). Returns (x,
    residual_norm, mean_approx_fraction), all device tensors.
    """
    n = b2d.shape[0]
    rows = n // NBLOCKS
    dev = b2d.device

    taf_state = None
    if spec.technique == Technique.TAF:
        taf_state = taf_mod.init(spec.taf, NBLOCKS, (rows, n), torch.float32,
                                 dev)

    perfo_mask = None
    if spec.technique == Technique.PERFORATION:
        if fraction is not None:
            block_mask = traced_execute_mask(NBLOCKS, spec.perforation,
                                             fraction, device=dev)
        else:
            block_mask = torch.as_tensor(
                execute_mask(NBLOCKS, spec.perforation), device=dev)
        perfo_mask = block_mask.repeat_interleave(rows)[:, None]

    def matvec(x2d, state):
        if spec.technique == Technique.TAF:
            def accurate():
                return poisson_matvec(x2d).reshape(NBLOCKS, rows, n)
            out, new_state, mask = taf_mod.step(state, accurate, spec.taf,
                                                spec.level,
                                                rsd_threshold=rsd_threshold)
            return out.reshape(n, n), new_state, hierarchy.fraction(mask)
        y = poisson_matvec(x2d)
        if perfo_mask is not None:
            y = torch.where(perfo_mask, y, 0.0)  # dropped rows contribute 0
            return y, state, 1.0 - hierarchy.fraction(perfo_mask)
        return y, state, torch.zeros((), dtype=torch.float32, device=dev)

    x = torch.zeros_like(b2d)
    r = b2d - 0.0
    p = r
    rs = (r * r).sum()
    fracs = []
    state = taf_state
    for _ in range(iters):
        ap, state, frac = matvec(p, state)
        fracs.append(frac)
        alpha = rs / torch.clamp((p * ap).sum(), min=1e-30)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = (r * r).sum()
        p = r + (rs_new / torch.clamp(rs, min=1e-30)) * p
        rs = rs_new
    # XLA's mean: the sum times float32(1/n)
    return x, torch.sqrt(rs), torch.stack(fracs).sum() * (1.0 / max(iters,
                                                                    1))


def _gen_b(n: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    return rng.standard_normal((n, n)).astype(np.float32)


def make_app(n: int = 64, seed: int = 0, iters: int = 60,
             device=None) -> ApproxApp:
    """`device`: ``cuda`` unless the caller passes ``"cpu"``."""
    dev = device_mod.resolve(device)
    b = torch.from_numpy(_gen_b(n, seed)).to(dev)

    def run(spec: ApproxSpec) -> AppResult:
        (x, res, frac), wall, reads = timed(cg_solve, b, spec, iters,
                                            device=dev)
        frac = float(frac)
        return AppResult(qoi=x.cpu().numpy(), wall_time_s=wall,
                         approx_fraction=frac,
                         flop_fraction=max(1.0 - frac, 1e-3),
                         extra={"residual": float(res),
                                "host_reads": reads})

    def make_group_fn(key):
        tech = key[0]
        if tech not in (Technique.TAF, Technique.PERFORATION):
            return None
        spec = batching.spec_from_key(key)
        hook = "rsd_threshold" if tech == Technique.TAF else "fraction"

        def lane(knob):
            x, res, frac = cg_solve(b, spec, iters, **{hook: knob})
            return x, frac, {"residual": res}

        return batching.lanes(lane)

    run_batch = batching.make_run_batch(run, make_group_fn, device=dev)

    return ApproxApp(name="minife_cg", run=run, error_metric="mape",
                     run_batch=run_batch,
                     workload=dict(n=n, seed=seed, iters=iters))
