"""Relative standard deviation (RSD) -- TAF's activation statistic (port of
`repro.core.rsd`).

Paper footnote 1: RSD = sigma / mu for *population* standard deviation sigma
and population mean mu, computed over the sliding window of the last
`history_size` outputs of the accurate path.
"""
from __future__ import annotations

import torch


def rsd(window: torch.Tensor, dim: int = -1, eps: float = 1e-12
        ) -> torch.Tensor:
    """Population RSD along `dim`. Safe at mu ~ 0 (returns sigma/eps-scale).

    sigma is the population standard deviation (`correction=0`, as
    `jnp.std`'s ddof 0), taken in two passes as `jnp.std` takes it: the
    mean, then the mean of the squared deviations. RSD is scale-invariant:
    rsd(c*x) == rsd(x) for c > 0.
    """
    n = window.shape[dim]
    mu = window.sum(dim=dim, keepdim=True) / n
    var = ((window - mu) ** 2).sum(dim=dim) / n
    return torch.sqrt(var) / torch.clamp(mu.squeeze(dim).abs(), min=eps)


def rsd_scalar_summary(outputs: torch.Tensor) -> torch.Tensor:
    """Reduce a (possibly vector-valued) region output to the scalar tracked
    by the TAF window: the mean over every axis but the first (the memoized
    *value* is still the full tensor)."""
    if outputs.ndim > 1:
        return outputs.mean(dim=tuple(range(1, outputs.ndim)))
    return outputs


def welford_update(count, mean, m2, new_value):
    """Streaming mean/variance update (Welford): the O(1)-memory window of a
    kernel whose full window does not fit its fast memory."""
    count = count + 1
    delta = new_value - mean
    mean = mean + delta / count
    delta2 = new_value - mean
    m2 = m2 + delta * delta2
    return count, mean, m2
