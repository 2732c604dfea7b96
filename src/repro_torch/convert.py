"""Carry data across from the JAX package to the port.

The JAX app `examples/apps/approx_ffn.py` builds its arrays `x, wp, w1, w2`
with numpy and holds them as JAX arrays. `ffn_arrays` turns them (or any
array numpy can read) into the port's float32 tensors on a device; the
port's own app builds its tensors through the same function, so both
packages compute on identical data.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import device as device_mod


def to_tensor(a, device) -> torch.Tensor:
    """A float32 copy of array `a` on `device`."""
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def ffn_arrays(x, wp, w1, w2, *, device=None) -> Tuple[torch.Tensor, ...]:
    """(x, wp, w1, w2) as float32 tensors on `device` (None means cuda)."""
    dev = device_mod.resolve(device)
    return tuple(to_tensor(a, dev) for a in (x, wp, w1, w2))
