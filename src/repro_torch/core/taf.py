"""TAF: Temporal Approximate Function (output) memoization -- paper section
3.1.3; port of `repro.core.taf`.

State machine (paper section 2.3 + TAF [51]):

  ACCURATE: run the accurate path, push the output's scalar summary into a
            sliding window of the last `history_size` outputs. Once the
            window is full and RSD(window) < rsd_threshold, enter STABLE.
  STABLE:   approximate (return the last accurately-computed output) for the
            next `prediction_size` invocations, then fall back to ACCURATE.

Each *element* (GPU thread) tracks its own state across its grid-stride
iterations (paper Figure 4d). The state is a NamedTuple of tensors on one
device. Hierarchical voting (level TILE/BLOCK) follows paper section 3.3:
the group approximates iff the majority of its elements' criteria hold.

Where the JAX package scans with `lax.scan` and skips with `lax.cond`, the
port runs a Python loop that never waits for the card at ELEMENT and TILE
level (outputs and masks go into preallocated device tensors, the approx
fraction stays a device scalar), and at BLOCK level reads one 0-d value
per accurate step (`run_sequence`): an approximated step changes nothing
but `remaining -= 1`, so the length of the run of approximated steps that
follows an accurate step is known from `remaining` alone. Every such read
is tallied in `repro_torch.obs.metrics.HOST_READS`.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..obs import metrics
from . import hierarchy
from .rsd import rsd
from .types import Level, TAFParams


class TAFState(NamedTuple):
    """Per-element TAF state. Leading dim = element slots (N,)."""

    window: torch.Tensor     # (N, history_size) float32 recent summaries
    filled: torch.Tensor     # (N,) int32: valid entries in window
    remaining: torch.Tensor  # (N,) int32: approximations left (STABLE)
    memo: torch.Tensor       # (N, *out_shape) last accurate output

    @property
    def in_stable_regime(self) -> torch.Tensor:
        return self.remaining > 0


def init(params: TAFParams, n_elements: int, out_shape: Tuple[int, ...] = (),
         dtype=torch.float32, device=None) -> TAFState:
    """Fresh (all-ACCURATE) TAF state for `n_elements` slots on `device`.

    Memory per slot = history_size + prod(out_shape) scalars: state is sized
    by decision slots, never by total logical iterations (paper Figure 3).
    """
    return TAFState(
        window=torch.zeros((n_elements, params.history_size),
                           dtype=torch.float32, device=device),
        filled=torch.zeros((n_elements,), dtype=torch.int32, device=device),
        remaining=torch.zeros((n_elements,), dtype=torch.int32,
                              device=device),
        memo=torch.zeros((n_elements,) + tuple(out_shape), dtype=dtype,
                         device=device),
    )


def activation(state: TAFState) -> torch.Tensor:
    """Per-element activation criterion: approximate while STABLE."""
    return state.remaining > 0


def knob(value, device) -> torch.Tensor:
    """A quality knob as a 0-d float32 tensor on `device`. A Python number
    is written by a fill kernel, never copied from the host, so making a
    knob does not wait for the card."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(value), dtype=torch.float32, device=device)


def _summary(y: torch.Tensor) -> torch.Tensor:
    """Scalar summary per element of a (N, ...) accurate output."""
    if y.ndim == 1:
        return y.float()
    return y.float().mean(dim=tuple(range(1, y.ndim)))


def _bcast(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (like.ndim - 1))


def _post_accurate(state: TAFState, y: torch.Tensor, params: TAFParams,
                   updated_mask: torch.Tensor, rsd_threshold) -> TAFState:
    """Window push + regime evaluation for elements that ran accurately.
    `rsd_threshold` is a 0-d float32 tensor (see `knob`)."""
    s = _summary(y)
    new_window = torch.cat([state.window[:, 1:], s[:, None]], dim=1)
    window = torch.where(updated_mask[:, None], new_window, state.window)
    filled = torch.where(updated_mask,
                         torch.clamp(state.filled + 1,
                                     max=params.history_size),
                         state.filled)
    stable = (rsd(window, dim=1) < rsd_threshold) & \
        (filled >= params.history_size)
    remaining = torch.where(updated_mask & stable,
                            torch.full_like(state.remaining,
                                            params.prediction_size),
                            state.remaining)
    memo = torch.where(_bcast(updated_mask, y), y.to(state.memo.dtype),
                       state.memo)
    return TAFState(window, filled, remaining, memo)


def _accurate_all(state: TAFState, y: torch.Tensor, params: TAFParams,
                  th: torch.Tensor) -> TAFState:
    updated = torch.ones_like(state.remaining, dtype=torch.bool)
    return _post_accurate(state, y, params, updated, th)


def step(state: TAFState, accurate_fn: Callable[[], torch.Tensor],
         params: TAFParams, level: Level = Level.ELEMENT,
         tile_size: Optional[int] = None,
         rsd_threshold=None) -> Tuple[torch.Tensor, TAFState, torch.Tensor]:
    """One invocation of a TAF-approximated region over all element slots.

    accurate_fn: () -> (N, ...) accurate outputs for every slot.
    `rsd_threshold` (a float or a 0-d tensor) overrides
    params.rsd_threshold. Returns (outputs, new_state, approx_mask).

    ELEMENT/TILE: the accurate path runs for every slot and is masked; the
    step makes no device-to-host read. BLOCK: the scalar vote decides
    whether `accurate_fn` runs at all. As a single invocation, that needs
    one host read of the vote per call (tallied in
    `obs.metrics.HOST_READS`); `run_sequence` needs one per accurate step
    instead.
    """
    th = knob(params.rsd_threshold if rsd_threshold is None
              else rsd_threshold, state.remaining.device)
    elem_act = activation(state)

    if level == Level.BLOCK:
        decision = hierarchy.block_majority(elem_act)
        metrics.count_host_read()
        if bool(decision):
            rem = torch.clamp(state.remaining - 1, min=0)
            out = state.memo
            new_state = state._replace(remaining=rem)
        else:
            y = accurate_fn()
            new_state = _accurate_all(state, y, params, th)
            out = y.to(state.memo.dtype)
        return out, new_state, decision.expand(elem_act.shape)

    approx_mask = hierarchy.vote(elem_act, level, tile_size=tile_size)
    y = accurate_fn()
    out = torch.where(_bcast(approx_mask, y), state.memo,
                      y.to(state.memo.dtype))
    # approximating slots burn one prediction credit (even if group-forced
    # with remaining == 0: clamp at 0, a saturating counter); accurate
    # slots update window/memo/regime
    new_state = _post_accurate(state, y, params, ~approx_mask, th)
    remaining = torch.where(approx_mask,
                            torch.clamp(new_state.remaining - 1, min=0),
                            new_state.remaining)
    return out, new_state._replace(remaining=remaining), approx_mask


def block_run_length(state: TAFState) -> torch.Tensor:
    """How many BLOCK-level steps from `state` approximate before the next
    accurate one, as a 0-d device tensor: the (floor(N/2)+1)-th largest
    `remaining`. An approximated step only decrements `remaining` (floored
    at 0), and the block approximates while more than half the elements
    have `remaining` above the number of steps taken."""
    r = state.remaining
    n = r.numel()
    return torch.kthvalue(r, n - n // 2).values


def run_sequence(params: TAFParams, xs: torch.Tensor,
                 fn: Callable[[torch.Tensor], torch.Tensor],
                 level: Level = Level.ELEMENT,
                 out_shape: Tuple[int, ...] = (),
                 tile_size: Optional[int] = None,
                 rsd_threshold=None):
    """Apply fn over a sequence of invocations (T, N, ...) with TAF.

    Invocation t of element n is grid-stride iteration t of GPU thread n
    (paper Figure 4d). Returns (outputs (T, N, ...), final_state,
    approx_fraction) with the fraction a 0-d device tensor. `out_shape` is
    accepted for the JAX signature's sake: the state takes its shape from
    the first output.

    The first step of a fresh state is always accurate, so the state is
    built from that step's output (no extra call of `fn` to learn its
    shape). ELEMENT/TILE: no device-to-host read. BLOCK: every accurate
    step reads one 0-d value, the length of the run of approximated steps
    that follows it (`block_run_length`); those steps write the memo and do
    not call `fn`.
    """
    del out_shape
    n_steps = xs.shape[0]
    dev = xs.device
    th = knob(params.rsd_threshold if rsd_threshold is None
              else rsd_threshold, dev)
    y0 = fn(xs[0])
    state = init(params, xs.shape[1], tuple(y0.shape[1:]), y0.dtype, dev)
    ys = torch.empty((n_steps,) + tuple(y0.shape), dtype=y0.dtype,
                     device=dev)
    masks = torch.zeros((n_steps, xs.shape[1]), dtype=torch.bool,
                        device=dev)

    if level == Level.BLOCK:
        t, y = 0, y0
        while True:
            ys[t] = y
            state = _accurate_all(state, y, params, th)
            t += 1
            k = int(block_run_length(state))
            metrics.count_host_read()
            k = min(k, n_steps - t)
            if k:
                ys[t:t + k] = state.memo
                masks[t:t + k] = True
                state = state._replace(
                    remaining=torch.clamp(state.remaining - k, min=0))
                t += k
            if t >= n_steps:
                break
            y = fn(xs[t])
        return ys, state, hierarchy.fraction(masks)

    for t in range(n_steps):
        first = t == 0
        out, state, mask = step(state, (lambda: y0) if first
                                else (lambda t=t: fn(xs[t])),
                                params, level, tile_size=tile_size,
                                rsd_threshold=th)
        ys[t] = out
        masks[t] = mask
    return ys, state, hierarchy.fraction(masks)
