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

`lm_params` turns the parameter tree of any JAX model family (`Model.init`,
layers stacked on leading axes) into the port's, so both packages compute
on identical weights; `adamw_state` does the same for a JAX `AdamWState`,
so both packages can carry on training from one mid-run state.
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


def lm_params(jax_params, cfg, *, device=None, masters: bool = False):
    """The JAX LM's parameter tree of any family (arrays numpy can read,
    each layer stack on leading axes) as the port's parameters on `device`
    (None means cuda): a stack becomes a list of per-layer dicts (nested
    lists for the hybrid's (n_groups, mamba_per_group) stack, `None` where
    JAX has None), and each leaf is held as the port's `Model.init` holds
    it (`Model.hold`: the compute dtype, norm leaves in the param dtype,
    the modules' float32 leaves in float32). With `masters=True` each leaf
    is kept as `Model.masters` keeps it (`Model.store`: the dtype JAX
    stores it in), so it equals the JAX leaf exactly."""
    from .models import lm
    model = lm.build(cfg, device=device)
    put = model.store if masters else model.hold
    return _port_tree(jax_params, model, lambda name, a: put(
        name, torch.from_numpy(np.array(a, np.float32))))


def _port_tree(jax_tree, model, leaf):
    """`leaf(name, array)` over a JAX parameter-shaped tree, its layer
    stacks (`model.STACKS`) split into the port's per-layer lists."""
    def tree(node, path, index=()):
        if node is None:
            return None
        if isinstance(node, dict):
            depth = 0 if index else model.STACKS.get(path, 0)
            if depth:
                lead = np.shape(next(iter(_leaves(node))))[:depth]
                return _grid(lambda ix: tree(node, path, ix), lead)
            return {k: tree(v, path + (k,), index) for k, v in node.items()}
        return leaf(path[-1], np.asarray(node)[index] if index else node)

    return tree(jax_tree, ())


def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    elif node is not None:
        yield node


def _grid(fn, lead, index=()):
    """Nested lists of `fn(index)` over the index grid `lead`."""
    if len(index) == len(lead):
        return fn(index)
    return [_grid(fn, lead, index + (i,)) for i in range(lead[len(index)])]


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


def adamw_state(state, cfg, *, device=None):
    """A JAX `AdamWState` (step, m, v over the model's parameter tree) as
    the port's `optim.adamw.AdamWState` on `device` (None means cuda):
    the step an int32 0-d tensor, the moments float32 (exactly) in the
    port's layer lists (`lm_params`' layout)."""
    from .models import lm
    from .optim import adamw
    model = lm.build(cfg, device=device)
    dev = model.device

    def moments(tree):
        return _port_tree(tree, model,
                          lambda name, a: _exact(a, torch.float32, dev))

    return adamw.AdamWState(step=_exact(state.step, torch.int32, dev),
                            m=moments(state.m), v=moments(state.v))
