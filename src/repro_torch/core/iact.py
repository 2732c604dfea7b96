"""iACT: approximate input memoization -- paper sections 2.3, 3.1.4, 3.3;
port of `repro.core.iact`.

Cache (input, output) pairs per table; a new invocation whose input lies
within `threshold` Euclidean distance of a cached input returns the cached
output, skipping the region.

GPU adaptations reproduced here:
  * Table sharing (paper `tperwarp` -> `tables_per_block`): elements are
    partitioned into groups that share one table.
  * Two-phase access (paper section 3.3): a read phase where all elements
    probe their table, then a write phase where a SINGLE writer per table --
    the computed element with the largest distance from any table value --
    inserts, with round-robin replacement.
  * Hierarchical activation: the hit mask is voted per Level before use.

The distance compared with `threshold` is the square root of the summed
squares, as in the JAX package (the K3 kernel compares squared distances;
the two can differ at the boundary). Invalid slots score `inf`; `argmin` /
`argmax` take the first index. State is a NamedTuple of tensors on one
device.

`run_sequence` makes no device-to-host read at ELEMENT and TILE level. At
BLOCK level the table does not change while the block approximates, so one
batched read phase over the next chunk of steps, against the fixed table,
gives the length of the run of approximated steps with one 0-d read
(tallied in `repro_torch.obs.metrics.HOST_READS`): reads <= accurate steps
+ chunks. A chunk is one step after an accurate step and doubles while the
block keeps approximating, so a block that never approximates probes no
step twice.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..obs import metrics
from . import hierarchy
from .taf import knob
from .types import IACTParams, Level

# bytes the chunked BLOCK-level read phase may hold in its distance tensor
_CHUNK_BYTES = 256 << 20
_MAX_CHUNK = 64


class IACTState(NamedTuple):
    """`n_tables` memo tables of `table_size` entries each."""

    keys: torch.Tensor       # (T, S, in_dim) float32 cached inputs
    values: torch.Tensor     # (T, S, *out_shape) cached outputs
    valid: torch.Tensor      # (T, S) bool
    next_slot: torch.Tensor  # (T,) int32 round-robin cursor


def init(params: IACTParams, n_tables: int, in_dim: int,
         out_shape: Tuple[int, ...] = (), dtype=torch.float32,
         device=None) -> IACTState:
    return IACTState(
        keys=torch.zeros((n_tables, params.table_size, in_dim),
                         dtype=torch.float32, device=device),
        values=torch.zeros((n_tables, params.table_size) + tuple(out_shape),
                           dtype=dtype, device=device),
        valid=torch.zeros((n_tables, params.table_size), dtype=torch.bool,
                          device=device),
        next_slot=torch.zeros((n_tables,), dtype=torch.int32,
                              device=device),
    )


def n_tables_for(params: IACTParams, n_elements: int) -> int:
    """Paper `tperwarp` semantics: tables_per_block == 0 -> one private
    table per element; otherwise `tables_per_block` tables (at most one per
    element) serve the whole population."""
    if params.tables_per_block == 0:
        return n_elements
    return max(1, min(n_elements, params.tables_per_block))


def _read_phase(state: IACTState, x: torch.Tensor, threshold: torch.Tensor):
    """All elements probe their table. x: (..., T, G, in_dim) grouped
    inputs (leading dims batch steps against the same table).

    Returns (hit (..., T, G), best_value (..., T, G, *out),
    min_dist (..., T, G)).
    """
    diff = x[..., :, :, None, :] - state.keys[:, None, :, :]
    dist = torch.sqrt((diff * diff).sum(dim=-1))            # (..., T, G, S)
    dist = torch.where(state.valid[:, None, :], dist,
                       torch.full_like(dist, float("inf")))
    best = torch.argmin(dist, dim=-1)  # first index on ties
    min_dist = torch.gather(dist, -1, best[..., None])[..., 0]
    t_idx = torch.arange(state.keys.shape[0],
                         device=x.device).reshape(-1, 1)
    best_value = state.values[t_idx, best]                  # (..., T, G, *)
    return min_dist < threshold, best_value, min_dist


def read_phase(state: IACTState, x: torch.Tensor, threshold):
    """The read phase of one invocation, per element: (hit (N,), best value
    (N, *out), min_dist (N,)) for x (N, in_dim) against `state`'s tables --
    the numbers behind a decision (min_dist - threshold is its margin)."""
    hit, best_value, min_dist = _read_phase(
        state, _grouped(state, x), knob(threshold, state.keys.device))
    n = x.shape[0]
    return (hit.reshape(n), best_value.reshape((n,) + best_value.shape[2:]),
            min_dist.reshape(n))


def _write_phase(state: IACTState, x: torch.Tensor, y: torch.Tensor,
                 computed: torch.Tensor, min_dist: torch.Tensor
                 ) -> IACTState:
    """Single writer per table: the computed element farthest from any
    cached value inserts at the round-robin cursor (paper section 3.3).
    x: (T, G, in_dim), y: (T, G, *out), computed / min_dist: (T, G)."""
    big = torch.finfo(torch.float32).max
    score = torch.where(
        computed,
        torch.where(torch.isinf(min_dist), torch.full_like(min_dist, big),
                    min_dist),
        torch.full_like(min_dist, float("-inf")))
    writer = torch.argmax(score, dim=1)                     # (T,)
    any_writer = computed.any(dim=1)                        # (T,)
    t_idx = torch.arange(state.keys.shape[0], device=x.device)
    slot = state.next_slot.long()
    wx = x[t_idx, writer]                                   # (T, in_dim)
    wy = y[t_idx, writer]                                   # (T, *out)
    old_k = state.keys[t_idx, slot]
    old_v = state.values[t_idx, slot]
    keys = state.keys.index_put(
        (t_idx, slot), torch.where(any_writer[:, None], wx, old_k))
    values = state.values.index_put(
        (t_idx, slot),
        torch.where(any_writer.reshape((-1,) + (1,) * (old_v.ndim - 1)),
                    wy.to(old_v.dtype), old_v))
    valid = state.valid.index_put(
        (t_idx, slot), state.valid[t_idx, slot] | any_writer)
    next_slot = torch.where(any_writer,
                            (state.next_slot + 1) % state.keys.shape[1],
                            state.next_slot)
    return IACTState(keys, values, valid, next_slot)


def _grouped(state: IACTState, x: torch.Tensor) -> torch.Tensor:
    """(..., N, in_dim) -> (..., T, G, in_dim) float32."""
    n_tab = state.keys.shape[0]
    n = x.shape[-2]
    if n % n_tab != 0:
        raise ValueError(
            f"n_elements {n} must be divisible by n_tables {n_tab}")
    return x.reshape(x.shape[:-2] + (n_tab, n // n_tab, -1)).float()


def step(state: IACTState, x: torch.Tensor,
         accurate_fn: Callable[[torch.Tensor], torch.Tensor],
         params: IACTParams, level: Level = Level.ELEMENT,
         tile_size: Optional[int] = None, threshold=None):
    """One invocation over all elements. x: (N, in_dim); accurate_fn:
    (N, in_dim) -> (N, *out). Elements are grouped contiguously onto
    tables: group g = elements [g*G, (g+1)*G) with G = N / n_tables.

    `threshold` (a float or a 0-d tensor) overrides params.threshold.
    Returns (outputs (N, *out), new_state, approx_mask (N,)).

    ELEMENT/TILE: dense compute + select, no device-to-host read. BLOCK:
    one host read of the vote per call decides whether `accurate_fn` runs
    (tallied in `obs.metrics.HOST_READS`).
    """
    th = knob(params.threshold if threshold is None else threshold,
              state.keys.device)
    n = x.shape[0]
    xg = _grouped(state, x)
    n_tab, g = xg.shape[0], xg.shape[1]
    hit, best_value, min_dist = _read_phase(state, xg, th)

    if level == Level.BLOCK:
        decision = hierarchy.block_majority(hit)
        metrics.count_host_read()
        if bool(decision):
            out = best_value.reshape((n,) + best_value.shape[2:])
            return out, state, decision.expand((n,))
        y = accurate_fn(x)
        yg = y.reshape((n_tab, g) + tuple(y.shape[1:]))
        computed = torch.ones((n_tab, g), dtype=torch.bool, device=x.device)
        new_state = _write_phase(state, xg, yg.to(state.values.dtype),
                                 computed, min_dist)
        return y.to(state.values.dtype), new_state, decision.expand((n,))

    approx_mask = hierarchy.vote(hit.reshape(-1), level, tile_size=tile_size)
    approx_g = approx_mask.reshape(n_tab, g)
    y = accurate_fn(x)
    yg = y.reshape((n_tab, g) + tuple(y.shape[1:])).to(state.values.dtype)
    sel = approx_g.reshape(approx_g.shape + (1,) * (yg.ndim - 2))
    out_g = torch.where(sel, best_value, yg)
    new_state = _write_phase(state, xg, yg, ~approx_g, min_dist)
    return (out_g.reshape((n,) + tuple(yg.shape[2:])), new_state,
            approx_mask)


def _chunk(state: IACTState, in_dim: int, n: int) -> int:
    """The most steps one batched BLOCK-level read phase takes: as many as
    keep the distance tensor under `_CHUNK_BYTES`."""
    per_step = 4 * n * state.keys.shape[1] * max(in_dim, 1)
    return max(1, min(_MAX_CHUNK, _CHUNK_BYTES // max(per_step, 1)))


def run_sequence(params: IACTParams, xs: torch.Tensor,
                 fn: Callable[[torch.Tensor], torch.Tensor],
                 level: Level = Level.ELEMENT,
                 tile_size: Optional[int] = None, threshold=None):
    """`step` over invocations xs: (T_steps, N, in_dim).

    `threshold` (a float or a 0-d tensor) overrides params.threshold.
    Returns (outputs, final_state, approx_fraction), the fraction a 0-d
    device tensor. The first step of a fresh state always computes (its
    tables are empty), so the state is built from that step's output.
    ELEMENT/TILE make no device-to-host read; BLOCK reads one 0-d run
    length per batched read phase (see the module docstring).
    """
    n_steps, n = xs.shape[0], xs.shape[1]
    dev = xs.device
    th = knob(params.threshold if threshold is None else threshold, dev)
    y0 = fn(xs[0])
    state = init(params, n_tables_for(params, n), xs.shape[-1],
                 tuple(y0.shape[1:]), y0.dtype, dev)
    ys = torch.empty((n_steps,) + tuple(y0.shape), dtype=y0.dtype,
                     device=dev)
    masks = torch.zeros((n_steps, n), dtype=torch.bool, device=dev)

    if level != Level.BLOCK:
        for t in range(n_steps):
            out, state, mask = step(state, xs[t], (lambda x: y0) if t == 0
                                    else fn, params, level,
                                    tile_size=tile_size, threshold=th)
            ys[t] = out
            masks[t] = mask
        return ys, state, hierarchy.fraction(masks)

    xg = _grouped(state, xs)                                # (T, Tt, G, d)
    n_tab, g = xg.shape[1], xg.shape[2]
    computed = torch.ones((n_tab, g), dtype=torch.bool, device=dev)

    def accurate(t, y, min_dist):
        ys[t] = y
        yg = y.reshape((n_tab, g) + tuple(y.shape[1:]))
        return _write_phase(state, xg[t], yg, computed, min_dist)

    # step 0: empty tables, every distance inf, nothing hits
    _, _, min_dist0 = _read_phase(state, xg[0], th)
    state = accurate(0, y0, min_dist0)
    t = 1
    most = _chunk(state, xs.shape[-1], n)
    chunk = 1  # doubles while the block keeps approximating
    while t < n_steps:
        c = min(chunk, n_steps - t)
        hit, best_value, min_dist = _read_phase(state, xg[t:t + c], th)
        approx = hit.reshape(c, -1).sum(dim=1) * 2 > n      # (c,)
        stop = ~approx
        run = torch.where(stop.any(), stop.int().argmax(),
                          torch.full((), c, dtype=torch.long, device=dev))
        j = int(run)
        metrics.count_host_read()
        if j:
            ys[t:t + j] = best_value[:j].reshape(
                (j, n) + tuple(best_value.shape[3:]))
            masks[t:t + j] = True
            t += j
        if j < c:
            state = accurate(t, fn(xs[t]), min_dist[j])
            t += 1
            chunk = 1
        else:
            chunk = min(2 * chunk, most)
    return ys, state, hierarchy.fraction(masks)
