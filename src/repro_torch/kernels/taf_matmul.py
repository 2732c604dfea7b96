"""TAF-memoized matmul (K2): the wrapper of `csrc/taf_matmul.cu`.

Replaces the Pallas kernel `src/repro/kernels/taf_matmul.py::taf_matmul`.
Y = X @ W in (block_m, block_n) tiles; for each column block the row blocks
run in temporal order, and once the RSD of the last `history_size` tile
means falls below the threshold, the next `prediction_size` tiles reuse the
memoized tile and skip their product.

On this card the sequence is a chain of one launch per row block: a grid
over the tile's column slices, whose last CTA to finish updates the state,
so the product of one tile spreads over many SMs while the decision chain
stays in order without a host sync. See the source note in
`csrc/taf_matmul.cu` for the design and what bounds it.

Plain version: `ref.taf_matmul_ref`, taken for CPU tensors. The threshold
reaches the kernel as a float32 device tensor, never a compile-time
constant.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from .ref import taf_matmul_ref as plain

SOURCE = "src/repro_torch/kernels/csrc/taf_matmul.cu"
REPLACES = "src/repro/kernels/taf_matmul.py:86"
COUNTER = _build.Counter("taf_matmul")

_ARGTYPES = [_build.P] * 11 + [_build.I] * 8 + [_build.P]


def column_slice(block_n: int) -> int:
    """Columns of a tile that one CTA computes: the widest power of two
    <= 32 (one per lane of a warp, `tile_product` in common.cuh) that
    divides block_n."""
    cols = 32
    while block_n % cols:
        cols //= 2
    return cols


def _check(x, w, block_m, block_n, history_size, prediction_size):
    m, k = x.shape
    k2, n = w.shape
    if k != k2:
        raise ValueError(
            f"taf_matmul contraction mismatch: x has K={k} columns but w "
            f"has K={k2} rows")
    if m % block_m or n % block_n:
        raise ValueError(
            f"taf_matmul block shape ({block_m}, {block_n}) does not divide "
            f"the output geometry ({m}, {n})")
    if history_size < 1 or prediction_size < 1:
        raise ValueError("history_size and prediction_size must be >= 1")


def taf_matmul(x: torch.Tensor, w: torch.Tensor, *, block_m: int,
               block_n: int, history_size: int = 3, prediction_size: int = 8,
               rsd_threshold=0.5, out_dtype=torch.float32
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (M, N), approx_mask (M/block_m, N/block_n) bool).

    A CPU `x` takes the plain version; a CUDA `x` launches the kernel (its
    operands are cast to float32 first, as the Pallas kernel casts them)."""
    _check(x, w, block_m, block_n, history_size, prediction_size)
    if x.device.type != "cuda":
        return plain(x, w, block_m=block_m, block_n=block_n,
                     history_size=history_size,
                     prediction_size=prediction_size,
                     rsd_threshold=rsd_threshold, out_dtype=out_dtype)
    if w.device != x.device:
        raise ValueError(f"taf_matmul: w is on {w.device}, x on {x.device}")
    dev = x.device
    m, k = x.shape
    n = w.shape[1]
    cols = column_slice(block_n)
    num_i, num_j = m // block_m, n // block_n
    xf = x.float().contiguous()
    wf = w.float().contiguous()
    thr = torch.as_tensor(rsd_threshold, dtype=torch.float32,
                          device=dev).reshape(1)
    y = torch.empty((m, n), dtype=torch.float32, device=dev)
    mask = torch.empty((num_i, num_j), dtype=torch.int32, device=dev)
    memo = torch.empty((num_j, block_m, block_n), dtype=torch.float32,
                       device=dev)
    partials = torch.empty((num_j * (block_n // cols),), dtype=torch.float64,
                           device=dev)
    state = torch.empty((2 * num_j,), dtype=torch.int32, device=dev)
    window = torch.empty((num_j * history_size,), dtype=torch.float64,
                         device=dev)
    tickets = torch.empty((num_j,), dtype=torch.int32, device=dev)
    work = COUNTER.work_buffer(dev)
    fn = _build.function("taf_matmul_f32", _ARGTYPES)
    p = _build.ptr
    err = fn(p(xf), p(wf), p(y), p(mask), p(memo), p(partials), p(state),
             p(window), p(tickets), p(thr), p(work), m, k, n, block_m,
             block_n, cols, history_size, prediction_size,
             _build.stream(dev))
    COUNTER.launches += 1
    _build.check("taf_matmul", err)
    return y.to(out_dtype), mask.bool()
