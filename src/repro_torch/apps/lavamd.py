"""LavaMD-like particle potential/force computation (Rodinia), port of
`examples/apps/lavamd.py`.

Particles live in boxes; each box accumulates forces from its neighbor
boxes. The approximated region is the per-(box, neighbor) force kernel.
QoI: final per-particle force vectors; metric MAPE.

Elements = boxes; an element's invocation sequence enumerates its 27
neighbor contributions (temporal locality: neighboring boxes have similar
densities). `PPB = 16` particles per box is the app's own width.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import device as device_mod
from ..analysis import cost
from ..core import batching
from ..core.harness import AppResult, ApproxApp
from ..core.types import ApproxSpec
from .common import memo_group, run_memo, timed

PPB = 16  # particles per box


def gen_boxes(nx: int = 6, seed: int = 0):
    """Grid of nx^3 boxes; returns positions (NB, PPB, 3) + neighbor ids."""
    rng = np.random.RandomState(seed)
    nb = nx ** 3
    centers = np.stack(np.meshgrid(*([np.arange(nx)] * 3),
                                   indexing="ij"), -1).reshape(-1, 3)
    pos = centers[:, None, :] + rng.uniform(0, 1, (nb, PPB, 3))
    neigh = []
    for b in range(nb):
        c = centers[b]
        ids = []
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    q = c + np.array([dx, dy, dz])
                    if ((q >= 0) & (q < nx)).all():
                        ids.append(int(q[0] * nx * nx + q[1] * nx + q[2]))
        while len(ids) < 27:
            ids.append(b)  # pad with self (force contribution ~ small)
        neigh.append(ids)
    return pos.astype(np.float32), np.asarray(neigh, np.int32)


def pair_force(own: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
    """LJ-like force of `other` box particles on `own` box particles.
    own/other: (NB, PPB, 3) -> force (NB, PPB, 3)."""
    d = own[:, :, None, :] - other[:, None, :, :]       # (NB, P, P, 3)
    r2 = (d * d).sum(dim=-1) + 0.25
    inv = torch.reciprocal(r2)
    inv2 = torch.square(inv)
    # inv ** 4 as XLA's integer power computes it: (x*x)*(x*x) (a square
    # is x*x exactly, and counts as the JAX package's integer_pow)
    mag = torch.square(inv2) - 0.5 * inv2
    return sum_in_order(mag[..., None] * d, dim=2)


@cost.reduction
def sum_in_order(t: torch.Tensor, dim: int) -> torch.Tensor:
    """`t.sum(dim)` added one slice after another, in index order: the
    order XLA's reduction takes on the CPU. The forces are sums of terms of
    order 1e3 that cancel, so another order moves them by 1e-4.
    `cost.trace_cost` counts it as the one reduction it is."""
    parts = t.unbind(dim)
    acc = parts[0]
    for part in parts[1:]:
        acc = acc + part
    return acc


def region_setup(nx: int, seed: int, device):
    """(region fn, invocation sequence (27, NB, 2*PPB*3), n_boxes): the
    region maps flattened own+other positions per box to the force."""
    pos_np, neigh_np = gen_boxes(nx, seed)
    nb = pos_np.shape[0]
    xs = np.concatenate([
        np.broadcast_to(pos_np.reshape(1, nb, PPB * 3), (27, nb, PPB * 3)),
        pos_np[neigh_np.T].reshape(27, nb, PPB * 3),
    ], axis=-1)

    def region(x):
        own = x[:, :PPB * 3].reshape(nb, PPB, 3)
        other = x[:, PPB * 3:].reshape(nb, PPB, 3)
        return pair_force(own, other).reshape(nb, PPB * 3)

    return region, torch.from_numpy(np.ascontiguousarray(xs)).to(device), nb


def make_app(nx: int = 5, seed: int = 0, device=None) -> ApproxApp:
    """`device`: ``cuda`` unless the caller passes ``"cpu"``."""
    dev = device_mod.resolve(device)
    region, xs, nb = region_setup(nx, seed, dev)

    def total(ys):
        return sum_in_order(ys, dim=0).reshape(nb, PPB, 3)

    def exact(xs_):
        return torch.stack([region(x) for x in xs_])

    def evaluate(spec):
        ys, frac = run_memo(spec, xs, region, exact)
        return total(ys), frac

    def run(spec: ApproxSpec) -> AppResult:
        (force, frac), wall, reads = timed(evaluate, spec, device=dev)
        frac = float(frac)
        return AppResult(qoi=force.cpu().numpy(), wall_time_s=wall,
                         approx_fraction=frac,
                         flop_fraction=max(1.0 - frac, 1e-3),
                         extra={"host_reads": reads})

    run_batch = batching.make_run_batch(
        run, lambda key: memo_group(key, xs, region, post=total), device=dev)

    return ApproxApp(name="lavamd", run=run, error_metric="mape",
                     run_batch=run_batch, workload=dict(nx=nx, seed=seed))
