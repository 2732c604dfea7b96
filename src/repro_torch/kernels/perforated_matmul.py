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
block_n) output tile, each side 32, 64 or 128 (`TILE_SIDES`), on the
tensor cores in 3xTF32 (float32 accuracy); `launchable` rejects other
sides and a block_k that is not a multiple of the kernel's 32-deep
chunk.

Plain version: `ref.perforated_matmul_plain` on the same operands (kept
list, liveness vector, factor tensor), taken for CPU tensors.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from . import _build
from ..core.types import PerforationParams
from .ref import perforated_matmul_operands
from .ref import perforated_matmul_plain as plain

SOURCE = "src/repro_torch/kernels/csrc/perforated_matmul.cu"
REPLACES = "src/repro/kernels/perforated_matmul.py:66"
COUNTER = _build.Counter("perforated_matmul")
CUDA_KERNELS = ("perf_matmul",)  # the CUDA kernel one call launches

_ARGTYPES = [_build.P] * 7 + [_build.I] * 7 + [_build.P]
_BK = 32          # k of one chunk of the ring (perforated_matmul.cu):
                  # block_k must be a multiple
_STAGES = 4       # chunks in the ring
_PAD_A, _PAD_B = 8, 4  # floats of padding per row of the A and B chunks
# CTA tile sides the kernel is instantiated for (32 x 32 warp tiles, or
# 64 x 32 at 128 x 128)
TILE_SIDES = (32, 64, 128)
_MAX_GRID_Y = 65535
_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper


def smem_bytes(config: Dict[str, int], n_blocks: int) -> int:
    """Dynamic shared memory of one CTA: the ring of A and B chunks
    (float32), the list of live K blocks (int32, one per enumerated block)
    and its length."""
    stage = (config["block_m"] * (_BK + _PAD_A)
             + _BK * (config["block_n"] + _PAD_B))
    return 4 * (_STAGES * stage + n_blocks + 1)


def launchable(shapes: Sequence[Sequence[int]],
               config: Dict[str, int]) -> Optional[str]:
    """None if the kernel launches at `config` on operands of `shapes`
    ((M, K), (K, N)), else the reason."""
    m, k = int(shapes[0][0]), int(shapes[0][1])
    for key in ("block_m", "block_n"):
        if config[key] not in TILE_SIDES:
            return (f"{key}={config[key]} is not a CTA tile side "
                    f"{TILE_SIDES}")
    if config["block_k"] % _BK:
        return (f"block_k={config['block_k']} is not a multiple of the "
                f"{_BK}-deep chunk")
    if m // config["block_m"] > _MAX_GRID_Y:
        return f"M={m} needs more than {_MAX_GRID_Y} CTA rows"
    smem = smem_bytes(config, k // config["block_k"])
    if smem > _SMEM_LIMIT:
        return (f"{smem} bytes of shared memory, more than the "
                f"{_SMEM_LIMIT} a block may use")
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
    if x.device.type != "cuda":
        kept, live, factor = perforated_matmul_operands(
            k // block_k, perfo, fraction, rescale, device=x.device)
        return plain(x, w, kept, live, factor, block_k=block_k,
                     out_dtype=out_dtype)
    kept, live, factor = _operands(k // block_k, perfo, fraction, rescale,
                                   x.device)
    if w.device != x.device:
        raise ValueError(
            f"perforated_matmul: w is on {w.device}, x on {x.device}")
    config = dict(block_m=block_m, block_n=block_n, block_k=block_k)
    why = launchable((x.shape, w.shape), config)
    if why:
        raise ValueError(f"perforated_matmul kernel: {why}")
    dev = x.device
    xf, wf = _build.operand(x), _build.operand(w)
    y = _build.empty((m, n), torch.float32, dev, "perforated_matmul y")
    work = COUNTER.work_buffer(dev)
    fn = _build.function("perforated_matmul_f32", _ARGTYPES)
    p = _build.ptr
    err = fn(p(xf), p(wf), p(y), p(kept), p(live), p(factor), p(work), m, k,
             n, block_m, block_n, block_k,
             int(kept.shape[0]), _build.stream(dev))
    COUNTER.launches += 1
    _build.check("perforated_matmul", err)
    return y.to(out_dtype)


# structural operands kept across calls, per (nk, perfo, rescale, device):
# they depend on nothing else, and the kernel only reads them
_STRUCTURAL: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor,
                               torch.Tensor]] = {}


def _operands(nk: int, perfo: Optional[PerforationParams], fraction,
              rescale: bool, dev: torch.device
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`perforated_matmul_operands` on `dev`; the structural mode's are
    built once. Masked mode builds liveness and factor from the fraction on
    the device at every call."""
    if fraction is not None:
        return perforated_matmul_operands(nk, perfo, fraction, rescale,
                                          device=dev)
    key = (nk, perfo, bool(rescale), dev)
    if key not in _STRUCTURAL:
        _STRUCTURAL[key] = perforated_matmul_operands(nk, perfo, None,
                                                      rescale, device=dev)
    return _STRUCTURAL[key]
