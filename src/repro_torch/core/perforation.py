"""Loop perforation -- the port of `repro.core.perforation`.

Patterns:
  small(M): skip one of every M iterations.
  large(M): execute one of every M iterations.
  ini(f) / fini(f): drop the first / last fraction f of iterations.
  random(f): drop a pseudo-random fraction.

Herded perforation: every element drops the SAME iterations, so the kept
set is one 1-D mask. `execute_mask` / `kept_indices` are host-side numpy
(the structural form: the kernel enumerates only kept blocks);
`traced_execute_mask` builds the same mask as a device tensor from a
fraction that may itself be a device tensor, so the masked mode of a
kernel needs no host sync.

Fraction comparisons are float32 on both paths, and `RANDOM` draws from
numpy's `RandomState(seed).uniform` (never torch's generator), so both
masks equal the JAX package's bit for bit.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .types import PerforationKind, PerforationParams

# Kinds whose knob is the fraction (a tensor operand of the kernels);
# skip-driven kinds (small/large) are purely structural.
FRACTION_KINDS = (PerforationKind.INI, PerforationKind.FINI,
                  PerforationKind.RANDOM)


def _n_dropped(fraction, n_iters: int) -> int:
    """floor(fraction * n_iters) in float32, as `traced_execute_mask`
    computes it from a float32 fraction."""
    return int(np.floor(np.float32(fraction) * np.float32(n_iters)))


def _uniform(n_iters: int, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).uniform(size=n_iters)


def execute_mask(n_iters: int, params: PerforationParams) -> np.ndarray:
    """Static (host-side) bool mask, True = execute iteration."""
    i = np.arange(n_iters)
    k = params.kind
    if k == PerforationKind.SMALL:
        mask = (i % params.skip) != (params.skip - 1)
    elif k == PerforationKind.LARGE:
        mask = (i % params.skip) == 0
    elif k == PerforationKind.INI:
        mask = i >= _n_dropped(params.fraction, n_iters)
    elif k == PerforationKind.FINI:
        mask = i < (n_iters - _n_dropped(params.fraction, n_iters))
    elif k == PerforationKind.RANDOM:
        mask = _uniform(n_iters, params.seed).astype(np.float32) >= \
            np.float32(params.fraction)
    else:
        raise ValueError(f"unknown perforation kind {k}")
    return mask


def traced_execute_mask(n_iters: int, params: PerforationParams,
                        fraction=None,
                        device: Optional[torch.device] = None
                        ) -> torch.Tensor:
    """Execute-mask as a bool tensor whose `fraction` may be a tensor.

    Only the fraction-driven kinds (ini/fini/random) take a fraction
    operand. The mask lives on `fraction`'s device when it is a tensor,
    else on `device` (default CPU); no value is read back to the host.
    Equals `execute_mask` when `fraction == params.fraction`.
    """
    if fraction is None:
        fraction = params.fraction
    if isinstance(fraction, torch.Tensor):
        device = fraction.device
    fraction = torch.as_tensor(fraction, dtype=torch.float32, device=device)
    i = torch.arange(n_iters, device=fraction.device)
    k = params.kind
    if k == PerforationKind.INI:
        return i >= torch.floor(fraction * n_iters)
    if k == PerforationKind.FINI:
        return i < n_iters - torch.floor(fraction * n_iters)
    if k == PerforationKind.RANDOM:
        u = torch.as_tensor(_uniform(n_iters, params.seed),
                            dtype=torch.float32, device=fraction.device)
        return u >= fraction
    raise ValueError(
        f"perforation kind {k} has no traced fraction (skip is structural)")


def kept_indices(n_iters: int, params: PerforationParams) -> np.ndarray:
    """Indices of executed iterations -- the structural form used to build a
    genuinely smaller loop."""
    return np.nonzero(execute_mask(n_iters, params))[0]
