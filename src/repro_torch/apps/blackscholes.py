"""Blackscholes (PARSEC) under HPAC-Offload-style approximation (port of
`examples/apps/blackscholes.py`).

The kernel prices European options analytically. GPU mapping (paper
section 3.1.3): each element ("thread") prices `steps` options over its
grid-stride iterations; option parameters follow a slow random walk, giving
the temporal output locality TAF exploits.

QoI: the computed prices (paper Table 1). Error: MAPE. The data comes from
numpy exactly as the JAX app makes it; the region is plain PyTorch on the
app's device (`jax.lax.erf` becomes `torch.erf`).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import convert, device as device_mod
from ..core import batching
from ..core.harness import AppResult, ApproxApp
from ..core.types import ApproxSpec
from .common import memo_group, run_memo, timed


def _phi(x):
    return 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def bs_price(inputs: torch.Tensor) -> torch.Tensor:
    """inputs: (N, 5) = [S, K, T, r, sigma] -> call prices (N,)."""
    s, k, t, r, sig = (inputs[:, i] for i in range(5))
    d1 = (torch.log(s / k) + (r + 0.5 * torch.square(sig)) * t) / \
        (sig * torch.sqrt(t))
    d2 = d1 - sig * torch.sqrt(t)
    return s * _phi(d1) - k * torch.exp(-r * t) * _phi(d2)


def gen_inputs(n_elements: int, steps: int, seed: int = 0,
               volatility: float = 1.0) -> np.ndarray:
    """(steps, n_elements, 5): random walk per element => temporal locality
    across an element's successive iterations. `volatility` scales the walk
    (regime-switching bursts appear above 1.0)."""
    rng = np.random.RandomState(seed)
    s0 = rng.uniform(20, 120, (n_elements,))
    k0 = s0 * rng.uniform(0.8, 1.2, (n_elements,))
    t0 = rng.uniform(0.2, 2.0, (n_elements,))
    r0 = np.full((n_elements,), 0.05)
    v0 = rng.uniform(0.1, 0.6, (n_elements,))
    base = np.stack([s0, k0, t0, r0, v0], axis=1)
    drift = rng.standard_normal((steps, n_elements, 5)) * \
        np.array([0.05, 0.0, 0.0, 0.0, 0.0005]) * min(volatility, 1.0)
    walk = base[None] * (1.0 + np.cumsum(drift, axis=0) * 0.01)
    if volatility > 1.0:
        # regime-switching: quiet stretches + occasional ~25% price jumps
        jumps = (rng.uniform(size=(steps, n_elements)) < 0.10) * \
            rng.standard_normal((steps, n_elements)) * 0.25
        factor = np.exp(np.clip(np.cumsum(jumps, axis=0), -0.15, 0.35))
        walk[..., 0] *= factor
    return np.maximum(walk, 1e-3).astype(np.float32)


def _exact(xs: torch.Tensor) -> torch.Tensor:
    return bs_price(xs.reshape(-1, 5)).reshape(xs.shape[:2])


def make_app(n_elements: int = 512, steps: int = 64, seed: int = 0,
             volatility: float = 1.0, device=None) -> ApproxApp:
    """`device`: ``cuda`` unless the caller passes ``"cpu"``."""
    dev = device_mod.resolve(device)
    xs = convert.to_tensor(gen_inputs(n_elements, steps, seed, volatility),
                           dev)

    def run(spec: ApproxSpec) -> AppResult:
        (ys, frac), wall, reads = timed(run_memo, spec, xs, bs_price, _exact,
                                        device=dev)
        frac = float(frac)
        return AppResult(qoi=ys.cpu().numpy(), wall_time_s=wall,
                         approx_fraction=frac,
                         flop_fraction=max(1.0 - frac, 1e-3),
                         extra={"host_reads": reads})

    # specs sharing static structure (TAF hSize/pSize, iACT
    # tSize/tPerBlock, level) run one lane after another over their knobs
    run_batch = batching.make_run_batch(
        run, lambda key: memo_group(key, xs, bs_price), device=dev)

    return ApproxApp(name="blackscholes", run=run, error_metric="mape",
                     run_batch=run_batch,
                     workload=dict(n_elements=n_elements, steps=steps,
                                   seed=seed, volatility=volatility))
