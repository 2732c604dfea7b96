"""iACT input-memoized row function (K3): the wrapper of `csrc/iact_memo.cu`.

Replaces the Pallas kernel `src/repro/kernels/iact_memo.py::iact_rowfn`.
y = gelu_tanh(x @ w1) @ w2 per block of `block_rows` rows, with one memo
table carried across every block: squared-distance probe against
threshold², majority vote, nearest cached value on the approximate path,
compute plus a single round-robin writer on the accurate path.

The table's decisions depend on x alone (its keys are earlier rows of x and
a value slot holds the computed y of its key's row), so on this card one
call is four launches whatever `block_rows` is: `iact_schedule` walks the
blocks and decides every mask entry, the list of computed blocks and, for
each approximated row, the computed row it copies (`src`); two GEMM
launches compute the FFN over the computed rows only; `iact_fill` copies
y[src[r]] into the approximated rows. See the source note in
`csrc/iact_memo.cu`.

Lanes: an (L,) threshold tensor runs L thresholds in one call (the JAX
package's `jax.vmap` of the kernel over a knob stack): one `iact_schedule`
cluster of 8 CTAs per lane, side by side, then the two GEMM launches and
`iact_fill`. Lanes that share x, w1 and w2 (the app's group) compute each
block's FFN rows once for every lane that computes it (`iact_union` lists
the union first: five launches); with a stacked operand the GEMMs take the
lane in grid z (four). y is (L, N, d_out), the mask (L, N/block_rows).

Plain versions: `ref.iact_rowfn_ref` (the sequential table, taken for CPU
tensors; `ref.iact_rowfn_lanes_ref` for a lane stack), `schedule_plain` (of `iact_schedule`) and `iact_rowfn_plain`
(schedule, FFN on the computed rows, fill). The threshold reaches the
kernel as a float32 device tensor.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from . import _build
from .ref import gelu_tanh
from .ref import iact_rowfn_lanes_ref as plain_lanes
from .ref import iact_rowfn_ref as plain
from .ref import lane_count

SOURCE = "src/repro_torch/kernels/csrc/iact_memo.cu"
REPLACES = "src/repro/kernels/iact_memo.py:103"
COUNTER = _build.Counter("iact_rowfn")
CUDA_KERNELS = ("iact_schedule", "iact_ffn1", "iact_ffn2", "iact_fill")
# a lane stack that shares every operand also lists the union of its lanes'
# computed blocks first
LANE_CUDA_KERNELS = CUDA_KERNELS + ("iact_union",)

_ROWFN_ARGTYPES = [_build.P] * 11 + [_build.I] * 10 + [_build.P] * 3
_SCHEDULE_ARGTYPES = [_build.P] * 7 + [_build.I] * 4 + [_build.P]
_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
_BIG = 3.4e38  # the score of an empty slot


def schedule_smem(block_rows: int, table_size: int) -> int:
    """Bytes of shared memory one `iact_schedule` CTA takes: two buffers of
    float64 partial distances (block_rows x table_size), best per row and a
    row index per slot."""
    return 8 * 2 * block_rows * table_size + 4 * (block_rows + table_size)


def _schedule_fits(block_rows: int, table_size: int, d_in: int
                   ) -> Optional[str]:
    if d_in % 4:
        return (f"iact_rowfn kernel takes a d_in that is a multiple of 4, "
                f"got {d_in}")
    smem = schedule_smem(block_rows, table_size)
    if smem > _SMEM_LIMIT - 1024:  # the schedule's static shared memory
        return (f"iact_rowfn schedule needs {smem} bytes of shared memory "
                f"for block_rows={block_rows}, table_size={table_size}")
    return None


def launchable(shapes: Sequence[Sequence[int]], config: Dict[str, int],
               table_size: int = 4) -> Optional[str]:
    """None if the kernel launches at `config` (block_rows) on operands of
    `shapes` (x, w1, w2) with a table of `table_size` slots (the tuner's
    precise calls take the default 4), else the reason: the widths are
    multiples of 4 (16-byte copies) and a schedule CTA's distances fit its
    shared memory."""
    (_, d_in), (_, d_h), (_, d_out) = shapes[0], shapes[1], shapes[2]
    if d_h % 4 or d_out % 4:
        return (f"iact_rowfn kernel takes widths that are multiples of 4, "
                f"got d_h={d_h}, d_out={d_out}")
    return _schedule_fits(config["block_rows"], table_size, d_in)


def _check(x, w1, w2, block_rows, table_size):
    n, d_in = x.shape[-2:]
    d_h = w1.shape[-1]
    if w1.shape[-2] != d_in or w2.shape[-2] != d_h:
        raise ValueError(
            f"iact_rowfn layer width mismatch: x is (N={n}, d_in={d_in}) so "
            f"w1 must be (d_in, d_h) and w2 (d_h, d_out); got "
            f"w1.shape={tuple(w1.shape)}, w2.shape={tuple(w2.shape)}")
    if n % block_rows:
        raise ValueError(
            f"iact_rowfn block_rows={block_rows} does not divide the row "
            f"count N={n}")
    if table_size < 1:
        raise ValueError("table_size must be >= 1")


def schedule_plain(x: torch.Tensor, block_rows: int, table_size: int,
                   threshold) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The plain version of `iact_schedule`: (mask (N/R,) bool, computed
    blocks in order (int32), src (N,) int32).

    The table holds row indices of x. d2 sums float32 squared differences
    in float64 and rounds to float32, as the kernel does; ties take the
    first index; an empty slot scores 3.4e38. For a row of an approximated
    block, src is the row held in slot best[r] (-1 for an empty slot); for
    a computed row, the row itself. Decisions are read back to the host: a
    reference, not a fast path."""
    n = x.shape[0]
    xf = x.float()
    thr = torch.as_tensor(threshold, dtype=torch.float32)
    thr2 = float(thr * thr)
    slot_row = [-1] * table_size
    cursor = n_valid = 0
    mask = torch.zeros((n // block_rows,), dtype=torch.bool)
    computed = []
    src = torch.arange(n, dtype=torch.int32)
    for b in range(n // block_rows):
        r0 = b * block_rows
        d2 = torch.full((block_rows, table_size), _BIG, dtype=torch.float32)
        if n_valid:
            diff = xf[r0:r0 + block_rows, None, :] - \
                xf[torch.as_tensor(slot_row[:n_valid])][None]
            d2[:, :n_valid] = (diff * diff).double().sum(-1).float().cpu()
        min_d2, best = d2.min(dim=1)
        hits = int((min_d2 < thr2).sum()) if n_valid else 0
        if hits * 2 > block_rows:
            mask[b] = True
            src[r0:r0 + block_rows] = torch.as_tensor(slot_row,
                                                    dtype=torch.int32)[best]
            continue
        computed.append(b)
        writer = int(min_d2.clamp(max=_BIG).argmax())
        slot_row[cursor] = r0 + writer
        cursor = (cursor + 1) % table_size
        n_valid = min(n_valid + 1, table_size)
    dev = x.device
    return (mask.to(dev), torch.as_tensor(computed, dtype=torch.int32,
                                          device=dev), src.to(dev))


def iact_rowfn_plain(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, *,
                     block_rows: int, table_size: int, threshold,
                     out_dtype=torch.float32
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's composition in plain PyTorch: `schedule_plain`, the FFN
    over the computed rows in one product each, then y[r] = y[src[r]] for
    the approximated rows (zeros for an empty slot)."""
    _check(x, w1, w2, block_rows, table_size)
    mask, computed, src = schedule_plain(x, block_rows, table_size,
                                         threshold)
    dev = x.device
    rows = (computed.long()[:, None] * block_rows
            + torch.arange(block_rows, device=dev)).reshape(-1)
    y = torch.zeros((x.shape[0], w2.shape[1]), dtype=torch.float32,
                    device=dev)
    y[rows] = gelu_tanh(x.float()[rows] @ w1.float()) @ w2.float()
    copy = mask.repeat_interleave(block_rows)
    s = src.long()[copy]
    y[copy] = torch.where((s >= 0)[:, None], y[s.clamp(min=0)],
                          torch.zeros((), device=dev))
    return y.to(out_dtype), mask


def schedule(x: torch.Tensor, block_rows: int, table_size: int, threshold
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`iact_schedule` alone: (mask, computed blocks, src) as
    `schedule_plain` returns them. A CPU `x` takes the plain version; a
    CUDA `x` launches the kernel (reading the computed count back)."""
    if x.device.type != "cuda":
        return schedule_plain(x, block_rows, table_size, threshold)
    n, d_in = x.shape
    why = _schedule_fits(block_rows, table_size, d_in)
    if why or n % block_rows:
        raise ValueError(why or f"block_rows={block_rows} does not divide "
                         f"N={n}")
    dev = x.device
    xf = _build.operand(x)
    thr = _build.knob_operand(threshold, 0, dev)
    i32 = dict(dtype=torch.int32, device=dev)
    mask = torch.empty((n // block_rows,), **i32)
    lst = torch.empty((n // block_rows,), **i32)
    n_comp = torch.empty((1,), **i32)
    src = torch.empty((n,), **i32)
    work = torch.zeros((1,), dtype=torch.int64, device=dev)
    fn = _build.function("iact_schedule_f32", _SCHEDULE_ARGTYPES)
    p = _build.ptr
    _build.check("iact_schedule", fn(
        p(xf), p(thr), p(mask), p(lst), p(n_comp), p(src), p(work), n, d_in,
        block_rows, table_size, _build.stream(dev)))
    return mask.bool(), lst[:int(n_comp.item())], src


def iact_rowfn(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, *,
               block_rows: int, table_size: int = 4, threshold=0.5,
               out_dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (N, d_out), block_approx_mask (N/block_rows,) bool); with
    an (L,) `threshold`, (y (L, N, d_out), mask (L, N/block_rows)).

    A CPU `x` takes the plain version; a CUDA `x` launches the kernels."""
    _check(x, w1, w2, block_rows, table_size)
    lanes = lane_count(threshold, (x, 2), (w1, 2), (w2, 2))
    if x.device.type != "cuda":
        fn = plain_lanes if lanes else plain
        return fn(x, w1, w2, block_rows=block_rows, table_size=table_size,
                  threshold=threshold, out_dtype=out_dtype)
    dev = x.device
    if w1.device != dev or w2.device != dev:
        raise ValueError("iact_rowfn: x, w1 and w2 must share one device")
    n, d_in = x.shape[-2:]
    d_h, d_out = w1.shape[-1], w2.shape[-1]
    why = launchable(((n, d_in), (d_in, d_h), (d_h, d_out)),
                     dict(block_rows=block_rows), table_size)
    if why:
        raise ValueError(why)
    n_l = max(lanes, 1)
    xf, w1f, w2f = (_build.operand(t) for t in (x, w1, w2))
    thr = _build.knob_operand(threshold, lanes, dev)
    i32 = dict(dtype=torch.int32, device=dev)
    y = torch.empty((n_l, n, d_out), dtype=torch.float32, device=dev)
    mask = torch.empty((n_l, n // block_rows), **i32)
    lst = torch.empty((n_l, n // block_rows), **i32)
    n_comp = torch.empty((n_l,), **i32)
    src = torch.empty((n_l, n), **i32)
    h = torch.empty((n_l, n, d_h), dtype=torch.float32, device=dev)
    lst_u = torch.empty((n // block_rows,), **i32)
    n_u = torch.empty((1,), **i32)
    work = COUNTER.work_buffer(dev)
    fn = _build.function("iact_rowfn_f32", _ROWFN_ARGTYPES)
    p = _build.ptr
    err = fn(p(xf), p(w1f), p(w2f), p(y), p(mask), p(lst), p(n_comp),
             p(src), p(h), p(thr), p(work), n, d_in, d_h, d_out, block_rows,
             table_size, n_l, int(x.dim() == 3), int(w1.dim() == 3),
             int(w2.dim() == 3), p(lst_u), p(n_u), _build.stream(dev))
    COUNTER.launched(lanes)
    _build.check("iact_rowfn", err)
    if not lanes:
        y, mask = y[0], mask[0]
    return y.to(out_dtype), mask.bool()
