"""Herded-perforated matmul (K4): the wrapper of `csrc/perforated_matmul.cu`.

Replaces the Pallas kernel
`src/repro/kernels/perforated_matmul.py::perforated_matmul`. Y ~= X @ W
computing only the kept K blocks, the same blocks for every output tile.
Two perforation modes share one kernel:

  * structural (`fraction=None`): the enumerated list holds only the kept
    K blocks (`perforation.kept_indices`), so dropped blocks are never
    visited; dropping every block raises;
  * masked (`fraction=` a float or tensor; ini/fini/random kinds): the list
    holds every block and a liveness vector, built on the device by
    `perforation.traced_execute_mask`, gates each one; `n_live` and the
    rescale factor are computed on the device too, so any fraction runs
    the same launch and nothing is read back to the host.

`rescale` multiplies by nk / n_enum (structural) or nk / max(n_live, 1)
(masked). Only `block_k` is semantic: one CTA computes one (block_m,
block_n) output tile, each side 16, 32, 64 or 128 (`TILE_SIDES`); a larger
block would only repeat the 128 launch, so `launchable` rejects it.

Plain version: `ref.perforated_matmul_plain` on the same operands (kept
list, liveness vector, factor tensor), taken for CPU tensors.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from . import _build
from ..core.types import PerforationParams
from .ref import perforated_matmul_operands
from .ref import perforated_matmul_plain as plain

SOURCE = "src/repro_torch/kernels/csrc/perforated_matmul.cu"
REPLACES = "src/repro/kernels/perforated_matmul.py:66"
COUNTER = _build.Counter("perforated_matmul")

_ARGTYPES = [_build.P] * 7 + [_build.I] * 7 + [_build.P]
_KC = 16          # k of one shared-memory stage (perforated_matmul.cu)
_PAD = 4          # floats of padding per row of the A stage
# CTA tile sides the kernel is instantiated for (16 x 16 threads, one
# register tile each)
TILE_SIDES = (16, 32, 64, 128)
_MAX_GRID_Y = 65535
_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper


def smem_bytes(config: Dict[str, int]) -> int:
    """Static shared memory of one CTA: the A and B stages, float32."""
    return 4 * _KC * (config["block_m"] + _PAD + config["block_n"])


def launchable(shapes: Sequence[Sequence[int]],
               config: Dict[str, int]) -> Optional[str]:
    """None if the kernel launches at `config` on operands of `shapes`
    ((M, K), (K, N)), else the reason."""
    m = int(shapes[0][0])
    for key in ("block_m", "block_n"):
        if config[key] not in TILE_SIDES:
            return (f"{key}={config[key]} is not a CTA tile side "
                    f"{TILE_SIDES}")
    if m // config["block_m"] > _MAX_GRID_Y:
        return f"M={m} needs more than {_MAX_GRID_Y} CTA rows"
    if smem_bytes(config) > _SMEM_LIMIT:
        return (f"{smem_bytes(config)} bytes of shared memory, more than "
                f"the {_SMEM_LIMIT} a block may use")
    return None


def _check(x, w, block_m, block_n, block_k):
    m, k = x.shape
    k2, n = w.shape
    if k != k2:
        raise ValueError(
            f"perforated_matmul contraction mismatch: x has K={k} columns "
            f"but w has K={k2} rows (x.shape={tuple(x.shape)}, "
            f"w.shape={tuple(w.shape)})")
    if m % block_m or n % block_n or k % block_k:
        raise ValueError(
            f"perforated_matmul block shape (block_m={block_m}, "
            f"block_n={block_n}, block_k={block_k}) does not divide the "
            f"operand geometry (M={m}, N={n}, K={k}): each block must "
            "divide its axis. kernels.tuning.search_space() enumerates "
            "only divisor-valid shapes for these operands.")


def perforated_matmul(x: torch.Tensor, w: torch.Tensor, *, block_m: int,
                      block_n: int, block_k: int,
                      perfo: Optional[PerforationParams] = None,
                      fraction=None, rescale: bool = False,
                      out_dtype=torch.float32) -> torch.Tensor:
    """x (M, K), w (K, N); returns (M, N) in `out_dtype`, accumulated in
    float32 (operands are cast to float32, as the Pallas kernel casts
    them). A CPU `x` takes the plain version; a CUDA `x` launches the
    kernel."""
    _check(x, w, block_m, block_n, block_k)
    m, k = x.shape
    n = w.shape[1]
    kept, live, factor = perforated_matmul_operands(
        k // block_k, perfo, fraction, rescale, device=x.device)
    if x.device.type != "cuda":
        return plain(x, w, kept, live, factor, block_k=block_k,
                     out_dtype=out_dtype)
    if w.device != x.device:
        raise ValueError(
            f"perforated_matmul: w is on {w.device}, x on {x.device}")
    config = dict(block_m=block_m, block_n=block_n, block_k=block_k)
    why = launchable((x.shape, w.shape), config)
    if why:
        raise ValueError(f"perforated_matmul kernel: {why}")
    dev = x.device
    xf, wf = x.float().contiguous(), w.float().contiguous()
    y = torch.empty((m, n), dtype=torch.float32, device=dev)
    work = COUNTER.work_buffer(dev)
    fn = _build.function("perforated_matmul_f32", _ARGTYPES)
    p = _build.ptr
    err = fn(p(xf), p(wf), p(y), p(kept), p(live), p(factor), p(work), m, k,
             n, block_m, block_n, block_k,
             int(kept.shape[0]), _build.stream(dev))
    COUNTER.launches += 1
    _build.check("perforated_matmul", err)
    return y.to(out_dtype)
