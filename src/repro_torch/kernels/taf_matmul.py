"""TAF-memoized matmul (K2): the wrapper of `csrc/taf_matmul.cu`.

Replaces the Pallas kernel `src/repro/kernels/taf_matmul.py::taf_matmul`.
Y = X @ W in (block_m, block_n) tiles; for each column block the row blocks
run in temporal order, and once the RSD of the last `history_size` tile
means falls below the threshold, the next `prediction_size` tiles reuse the
memoized tile and skip their product.

On this card one call is one persistent cooperative launch: a team of CTAs
owns each column block for the whole call, each CTA a fixed slice of at
most 16 columns with its slice of W and of the memo in shared memory; the
team walks the row blocks on the device, meets at a barrier of its own
after each computed tile to make the same state update, and copies its memo
for the predicted tiles without a barrier. See the source note in
`csrc/taf_matmul.cu` for the design and what bounds it.

Lanes: an (L,) threshold tensor runs L thresholds in one call (the JAX
package's `jax.vmap` of the kernel over a knob stack). x and w are each
shared ((M, K), (K, N)) or stacked per lane ((L, M, K), (L, K, N)); y is
(L, M, N) and the mask (L, M/bm, N/bn). Lanes that share x and w share
each computed product (a step is computed once if any lane computes it);
with a stacked operand the teams take (lane, column block) units in
rounds. One launch (`taf_lanes`; a single call runs `taf_persistent`)
serves every lane, and each lane's mask equals a single
call's at its threshold. The device tally counts products computed.

Plain version: `ref.taf_matmul_ref` (`ref.taf_matmul_lanes_ref` for a
lane stack), taken for CPU tensors. The threshold reaches the kernel as a
float32 device tensor, never a compile-time constant.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from . import _build
from .ref import lane_count
from .ref import taf_matmul_lanes_ref as plain_lanes
from .ref import taf_matmul_ref as plain

SOURCE = "src/repro_torch/kernels/csrc/taf_matmul.cu"
REPLACES = "src/repro/kernels/taf_matmul.py:86"
COUNTER = _build.Counter("taf_matmul")

CUDA_KERNELS = ("taf_persistent",)
LANE_CUDA_KERNELS = ("taf_lanes",)  # what a call with L > 1 lanes runs

_ARGTYPES = [_build.P] * 8 + [_build.I] * 11 + [_build.P]
_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
_N_SM = 132          # SMs of an H100 SXM: co-resident CTAs at one an SM
# the kernel's dynamic shared memory outside the W slices and memo (bytes):
# five x stages of 16 x 264 floats (the k-split sums reuse them)
_FIXED_SMEM = 4 * 5 * 16 * 264
_W_STAGES = 4 * 5 * 256 * 16  # five staged chunks of W when not resident


def column_slice(block_n: int) -> int:
    """Columns of a tile that one CTA computes: the widest power of two
    <= 16 (four float4 columns of the slice product in csrc/taf_matmul.cu)
    that divides block_n."""
    cols = 16
    while block_n % cols:
        cols //= 2
    return cols


def slices_per_cta(block_n: int, n_ctas: int = _N_SM) -> int:
    """The fewest contiguous slices of a column block one CTA takes so that
    the team fits `n_ctas` co-resident CTAs (the kernel's host side takes
    the count from the card's occupancy instead)."""
    n_sub = block_n // column_slice(block_n)
    return next(s for s in range(1, n_sub + 1)
                if n_sub % s == 0 and n_sub // s <= n_ctas)


def launchable(shapes: Sequence[Sequence[int]],
               config: Dict[str, int]) -> Optional[str]:
    """None if the kernel launches at `config` (block_m, block_n) on
    operands of `shapes` ((M, K), (K, N)), else the reason: K, N and
    block_n are multiples of 4 (16-byte copies), and the memo slices of one
    CTA (block_m x 16 floats each, `slices_per_cta` of them at one CTA an
    SM) fit its shared memory beside the staging buffers."""
    (_, k), (_, n) = shapes[0], shapes[1]
    bm, bn = config["block_m"], config["block_n"]
    if k % 4 or n % 4 or bn % 4:
        return (f"taf_matmul kernel takes K, N and block_n that are "
                f"multiples of 4, got K={k}, N={n}, block_n={bn}")
    memo = 4 * slices_per_cta(bn) * bm * 16
    if _FIXED_SMEM + _W_STAGES + memo + 64 > _SMEM_LIMIT:
        return (f"taf_matmul: the memo of block_m={bm} takes {memo} bytes "
                f"of a CTA's shared memory, more than the kernel has beside "
                f"its staging buffers")
    return None


def _check(x, w, block_m, block_n, history_size, prediction_size):
    m, k = x.shape[-2:]
    k2, n = w.shape[-2:]
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
    """Returns (y (M, N), approx_mask (M/block_m, N/block_n) bool); with an
    (L,) `rsd_threshold`, (y (L, M, N), approx_mask (L, M/bm, N/bn)).

    A CPU `x` takes the plain version; a CUDA `x` launches the kernel (its
    operands are cast to float32 first, as the Pallas kernel casts them)."""
    _check(x, w, block_m, block_n, history_size, prediction_size)
    lanes = lane_count(rsd_threshold, (x, 2), (w, 2))
    if x.device.type != "cuda":
        fn = plain_lanes if lanes else plain
        return fn(x, w, block_m=block_m, block_n=block_n,
                  history_size=history_size, prediction_size=prediction_size,
                  rsd_threshold=rsd_threshold, out_dtype=out_dtype)
    if w.device != x.device:
        raise ValueError(f"taf_matmul: w is on {w.device}, x on {x.device}")
    m, k = x.shape[-2:]
    n = w.shape[-1]
    why = launchable(((m, k), (k, n)),
                     dict(block_m=block_m, block_n=block_n))
    if why:
        raise ValueError(why)
    dev = x.device
    cols = column_slice(block_n)
    num_i, num_j = m // block_m, n // block_n
    n_l = max(lanes, 1)
    xf = _build.operand(x)
    wf = _build.operand(w)
    thr = _build.knob_operand(rsd_threshold, lanes, dev)
    y = torch.empty((n_l, m, n), dtype=torch.float32, device=dev)
    mask = torch.empty((n_l, num_i, num_j), dtype=torch.int32, device=dev)
    partials = torch.empty((2 * n_l * (n // cols),), dtype=torch.float64,
                           device=dev)
    arrive = torch.empty((n_l * num_j,), dtype=torch.int32, device=dev)
    work = COUNTER.work_buffer(dev)
    fn = _build.function("taf_matmul_f32", _ARGTYPES)
    p = _build.ptr
    err = fn(p(xf), p(wf), p(y), p(mask), p(partials), p(arrive), p(thr),
             p(work), m, k, n, block_m, block_n, cols, history_size,
             prediction_size, n_l, int(x.dim() == 3), int(w.dim() == 3),
             _build.stream(dev))
    COUNTER.launched(lanes)
    _build.check("taf_matmul", err)
    if not lanes:
        y, mask = y[0], mask[0]
    return y.to(out_dtype), mask.bool()
