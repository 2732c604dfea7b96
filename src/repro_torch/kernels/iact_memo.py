"""iACT input-memoized row function (K3): the wrapper of `csrc/iact_memo.cu`.

Replaces the Pallas kernel `src/repro/kernels/iact_memo.py::iact_rowfn`.
y = gelu_tanh(x @ w1) @ w2 per block of `block_rows` rows, with one memo
table carried across every block: squared-distance probe against
threshold², majority vote, nearest cached value on the approximate path,
compute plus a single round-robin writer on the accurate path.

On this card each block is a chain of four launches (probe, first product,
second product or gather, insert); an approximated block skips both
products. See the source note in `csrc/iact_memo.cu`.

Plain version: `ref.iact_rowfn_ref`, taken for CPU tensors. The threshold
reaches the kernel as a float32 device tensor.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from .ref import iact_rowfn_ref as plain
from .taf_matmul import column_slice

SOURCE = "src/repro_torch/kernels/csrc/iact_memo.cu"
REPLACES = "src/repro/kernels/iact_memo.py:103"
COUNTER = _build.Counter("iact_rowfn")

_ARGTYPES = [_build.P] * 14 + [_build.I] * 8 + [_build.P]
_MAX_PROBE = 2048  # rows * table_size the probe holds (iact_memo.cu)


def _check(x, w1, w2, block_rows, table_size):
    n, d_in = x.shape
    d_h = w1.shape[1]
    if w1.shape[0] != d_in or w2.shape[0] != d_h:
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


def iact_rowfn(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, *,
               block_rows: int, table_size: int = 4, threshold=0.5,
               out_dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (N, d_out), block_approx_mask (N/block_rows,) bool).

    A CPU `x` takes the plain version; a CUDA `x` launches the kernel."""
    _check(x, w1, w2, block_rows, table_size)
    if x.device.type != "cuda":
        return plain(x, w1, w2, block_rows=block_rows, table_size=table_size,
                     threshold=threshold, out_dtype=out_dtype)
    dev = x.device
    if w1.device != dev or w2.device != dev:
        raise ValueError("iact_rowfn: x, w1 and w2 must share one device")
    if block_rows * table_size > _MAX_PROBE:
        raise ValueError(
            f"iact_rowfn kernel takes block_rows * table_size <= "
            f"{_MAX_PROBE}, got {block_rows} * {table_size}")
    n, d_in = x.shape
    d_h, d_out = w1.shape[1], w2.shape[1]
    cols1 = column_slice(d_h)
    cols2 = column_slice(d_out)
    xf, w1f, w2f = (t.float().contiguous() for t in (x, w1, w2))
    thr = torch.as_tensor(threshold, dtype=torch.float32,
                          device=dev).reshape(1)
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    y = torch.empty((n, d_out), **f32)
    mask = torch.empty((n // block_rows,), **i32)
    keys = torch.empty((table_size, d_in), **f32)
    vals = torch.empty((table_size, d_out), **f32)
    h = torch.empty((block_rows, d_h), **f32)
    min_d2 = torch.empty((block_rows,), **f32)
    meta = torch.empty((2,), **i32)
    flag = torch.empty((1,), **i32)
    best = torch.empty((block_rows,), **i32)
    work = COUNTER.work_buffer(dev)
    fn = _build.function("iact_rowfn_f32", _ARGTYPES)
    p = _build.ptr
    err = fn(p(xf), p(w1f), p(w2f), p(y), p(mask), p(keys), p(vals), p(h),
             p(min_d2), p(meta), p(flag), p(best), p(thr), p(work), n, d_in,
             d_h, d_out, block_rows, table_size, cols1, cols2,
             _build.stream(dev))
    COUNTER.launches += 1
    _build.check("iact_rowfn", err)
    return y.to(out_dtype), mask.bool()
