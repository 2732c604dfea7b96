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
kernel needs no host sync. `element_masks` gives every element its own row
(identical rows when herded), `perforated_bounds` the ini/fini loop bounds,
and `perforated_sum` reduces a tensor over its kept iterations only.

Fraction comparisons are float32 on both paths, and `RANDOM` draws from
numpy's `RandomState(seed).uniform` (never torch's generator), so both
masks equal the JAX package's bit for bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

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


def element_masks(n_iters: int, n_elements: int,
                  params: PerforationParams) -> np.ndarray:
    """(n_elements, n_iters) host masks. Herded: all rows identical.
    Non-herded: row e of SMALL / LARGE is rolled by e % skip, and row e of
    RANDOM draws from `RandomState(seed + e)` (private per-thread counters
    whose region-encounter counts differ: the divergent case herding
    removes). INI / FINI change loop bounds and stay uniform."""
    base = execute_mask(n_iters, params)
    if params.herded or params.kind in (PerforationKind.INI,
                                        PerforationKind.FINI):
        return np.broadcast_to(base, (n_elements, n_iters)).copy()
    if params.kind in (PerforationKind.SMALL, PerforationKind.LARGE):
        return np.stack([np.roll(base, e % params.skip)
                         for e in range(n_elements)])
    # float64 draws against the float64 fraction, as the JAX rows compare
    return np.stack([np.random.RandomState(params.seed + e).uniform(
        size=n_iters) >= params.fraction for e in range(n_elements)])


def perforated_bounds(n_iters: int, params: PerforationParams
                      ) -> Tuple[int, int]:
    """Loop bounds [lo, hi) for ini/fini (the paper: "the compiler
    generates code to change the lower or upper bounds of the loop"). The
    floor is taken in float64, as the JAX function takes it."""
    if params.kind == PerforationKind.INI:
        return int(np.floor(params.fraction * n_iters)), n_iters
    if params.kind == PerforationKind.FINI:
        return 0, n_iters - int(np.floor(params.fraction * n_iters))
    raise ValueError("perforated_bounds applies to ini/fini only")


def drop_fraction(n_iters: int, params: PerforationParams) -> float:
    """Fraction of iterations dropped = upper bound on FLOP savings."""
    return 1.0 - float(execute_mask(n_iters, params).mean())


def perforated_sum(xs: torch.Tensor, params: PerforationParams,
                   axis: int = 0, rescale: bool = True) -> torch.Tensor:
    """Reduce `xs` over `axis` using only the kept iterations, on `xs`'s
    device.

    `rescale` multiplies by n / kept -- the standard perforation
    extrapolation for additive reductions, so the QoI keeps its magnitude.
    """
    n = xs.shape[axis]
    keep = kept_indices(n, params)
    sub = xs.index_select(axis, torch.as_tensor(keep, device=xs.device))
    total = sub.sum(dim=axis)
    if rescale and len(keep) > 0:
        total = total * (n / len(keep))
    return total
