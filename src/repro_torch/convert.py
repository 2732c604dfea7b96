"""Carry data across from the JAX package to the port.

The JAX app `examples/apps/approx_ffn.py` builds its arrays `x, wp, w1, w2`
with numpy and holds them as JAX arrays. `ffn_arrays` turns them (or any
array numpy can read) into the port's float32 tensors on a device; the
port's own app builds its tensors through the same function, so both
packages compute on identical data.

`taf_state` / `iact_state` turn a technique state of the JAX package (its
`TAFState` / `IACTState`, or any object with the same fields holding arrays
numpy can read) into the port's state on a device, so both packages can
carry on from one mid-run state.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import device as device_mod
from .core import iact, taf


def to_tensor(a, device) -> torch.Tensor:
    """A float32 copy of array `a` on `device`."""
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def ffn_arrays(x, wp, w1, w2, *, device=None) -> Tuple[torch.Tensor, ...]:
    """(x, wp, w1, w2) as float32 tensors on `device` (None means cuda)."""
    dev = device_mod.resolve(device)
    return tuple(to_tensor(a, dev) for a in (x, wp, w1, w2))


def _exact(a, dtype, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device=dev, dtype=dtype)


def taf_state(state, *, device=None) -> taf.TAFState:
    """A `TAFState` (window, filled, remaining, memo) as the port's state on
    `device` (None means cuda): window float32, counters int32, memo in its
    own float type."""
    dev = device_mod.resolve(device)
    memo = np.array(state.memo)
    return taf.TAFState(
        window=_exact(state.window, torch.float32, dev),
        filled=_exact(state.filled, torch.int32, dev),
        remaining=_exact(state.remaining, torch.int32, dev),
        memo=torch.from_numpy(memo).to(dev))


def iact_state(state, *, device=None) -> iact.IACTState:
    """An `IACTState` (keys, values, valid, next_slot) as the port's state on
    `device` (None means cuda)."""
    dev = device_mod.resolve(device)
    return iact.IACTState(
        keys=_exact(state.keys, torch.float32, dev),
        values=torch.from_numpy(np.array(state.values)).to(dev),
        valid=_exact(state.valid, torch.bool, dev),
        next_slot=_exact(state.next_slot, torch.int32, dev))
