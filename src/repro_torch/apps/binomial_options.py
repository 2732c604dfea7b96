"""Binomial American option pricing (paper: CUDA SDK BinomialOptions),
port of `examples/apps/binomial_options.py`.

Each option price is an O(tree_steps^2) backward induction -- the paper's
"entire block collaboratively computes the price of a single option", hence
block-level decision-making only. The expensive region is the whole tree;
TAF/iACT memoize across an element's successive options.

The JAX app's `fori_loop` over tree steps is a Python loop here, about ten
elementwise launches a tree step on the app's device: at the CUDA Samples
size (1024 options, 2048 tree steps) a price call is bound by launches, not
by the card's arithmetic.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import convert, device as device_mod
from ..core import batching
from ..core.harness import AppResult, ApproxApp
from ..core.types import ApproxSpec
from .common import memo_group, run_memo, timed


def binomial_price(inputs: torch.Tensor, tree_steps: int = 128
                   ) -> torch.Tensor:
    """inputs: (N, 5) = [S, K, T, r, sigma] -> American put prices (N,)."""
    s, k, t, r, sig = (inputs[:, i] for i in range(5))
    dt = t / tree_steps
    u = torch.exp(sig * torch.sqrt(dt))
    d = 1.0 / u
    disc = torch.exp(-r * dt)
    p = (torch.exp(r * dt) - d) / (u - d)
    j = torch.arange(tree_steps + 1, dtype=torch.float32,
                     device=inputs.device)
    s_, u_, k_ = s[:, None], u[:, None], k[:, None]
    # terminal prices: (N, steps+1)
    st = s_ * u_ ** (2.0 * j[None, :] - tree_steps)
    vals = torch.clamp(k_ - st, min=0.0)
    # loop invariants of the JAX body, computed once (same values)
    disc_, p_, q_ = disc[:, None], p[:, None], 1 - p[:, None]
    two_j = 2.0 * j[None, :-1]
    for i in range(tree_steps):
        cont = disc_ * (p_ * vals[:, 1:] + q_ * vals[:, :-1])
        level = tree_steps - i - 1
        stl = s_ * u_ ** (two_j - level)
        ex = torch.clamp(k_ - stl, min=0.0)
        vals = F.pad(torch.maximum(cont, ex), (0, 1))
    return vals[:, 0]


def gen_inputs(n_elements: int, steps: int, seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    s0 = rng.uniform(20, 120, (n_elements,))
    base = np.stack([
        s0, s0 * rng.uniform(0.9, 1.1, (n_elements,)),
        rng.uniform(0.2, 2.0, (n_elements,)),
        np.full((n_elements,), 0.05),
        rng.uniform(0.1, 0.6, (n_elements,)),
    ], axis=1)
    drift = rng.standard_normal((steps, n_elements, 5)) * \
        np.array([0.03, 0.0, 0.0, 0.0, 0.0003])
    walk = base[None] * (1.0 + np.cumsum(drift, axis=0) * 0.01)
    return np.maximum(walk, 1e-3).astype(np.float32)


def make_app(n_elements: int = 64, steps: int = 32, tree_steps: int = 128,
             seed: int = 0, device=None) -> ApproxApp:
    """`device`: ``cuda`` unless the caller passes ``"cpu"``."""
    dev = device_mod.resolve(device)
    xs = convert.to_tensor(gen_inputs(n_elements, steps, seed), dev)

    def price(x):
        return binomial_price(x, tree_steps)

    def exact(xs_):
        return torch.stack([price(x) for x in xs_])

    def run(spec: ApproxSpec) -> AppResult:
        (ys, frac), wall, reads = timed(run_memo, spec, xs, price, exact,
                                        device=dev)
        frac = float(frac)
        return AppResult(qoi=ys.cpu().numpy(), wall_time_s=wall,
                         approx_fraction=frac,
                         flop_fraction=max(1.0 - frac, 1e-3),
                         extra={"host_reads": reads})

    run_batch = batching.make_run_batch(
        run, lambda key: memo_group(key, xs, price), device=dev)

    return ApproxApp(name="binomial_options", run=run, error_metric="mape",
                     run_batch=run_batch,
                     workload=dict(n_elements=n_elements, steps=steps,
                                   tree_steps=tree_steps, seed=seed))
