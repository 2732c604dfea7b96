"""Flash attention with herded KV-block perforation (K1): the wrapper of
`csrc/perforated_attention.cu`.

Replaces the Pallas kernel
`src/repro/kernels/perforated_attention.py::perforated_attention`, which
also serves the JAX package's `ops.flash_attention` (`perfo=None`).

Two perforation modes share one kernel:

  * structural (`fraction=None`): the enumerated list holds only the kept
    KV blocks (`perforation.kept_indices`), so dropped blocks are never
    visited; the list and its all-ones liveness vector are built once per
    (number of blocks, perforation, device) and kept;
  * masked (`fraction=` a float or tensor; ini/fini/random kinds): the list
    holds every block and a liveness vector, built on the device by
    `perforation.traced_execute_mask` from the fraction as a device tensor,
    gates each one -- any fraction runs the same launch and nothing is read
    back to the host.

Lanes (masked mode only): an (L,) fraction tensor runs L fractions in one
launch (the JAX package's `jax.vmap` over a knob stack), the lane in grid
z beside the batch, each lane's liveness vector built on the device from
its fraction. q, k and v are each shared ((B, H, S, D)) or stacked per
lane; the output is (L, B, Hq, Sq, D). Structural perforation has no knob
and keeps its single form.

The kernel runs on the tensor cores: 3xTF32 for float32 (float32
accuracy), bf16 in one pass for bfloat16. `launchable` says which head
dims and blocks it takes.

Plain version: `ref.attention_ref` (`ref.attention_lanes_ref` for a lane
stack), taken for CPU tensors.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build
from ..core.perforation import (FRACTION_KINDS, kept_indices,
                                traced_execute_mask)
from ..core.types import PerforationParams
from .ref import attention_lanes_ref as plain_lanes
from .ref import attention_ref as plain
from .ref import lane_count

SOURCE = "src/repro_torch/kernels/csrc/perforated_attention.cu"
REPLACES = "src/repro/kernels/perforated_attention.py:110"
COUNTER = _build.Counter("perforated_attention")
CUDA_KERNELS = ("attn_kernel",)  # the CUDA kernel one call launches
LANE_CUDA_KERNELS = CUDA_KERNELS  # a lane stack: the lane in grid z

_ARGTYPES = ([_build.P] * 7 + [_build.I] * 9 + [_build.F]
             + [_build.I] * 4 + [_build.P])
HEAD_DIMS = (16, 32, 64, 128)   # D the kernel is instantiated for
BLOCK_Q = (16, 32, 64, 128)     # 16 query rows a warp, at most 8 warps
_CHUNK = 32   # keys of one chunk: block_kv must be a multiple
_STAGES = 2   # chunk buffers
_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
_ENTRIES = {torch.float32: "attention_f32", torch.bfloat16: "attention_bf16"}


def smem_bytes(d: int, n_blocks: int, itemsize: int = 4) -> int:
    """Dynamic shared memory of one CTA: two chunk buffers of 32 K rows
    (padded by 8 elements) and 32 V rows (padded by 4 in float32, 8 in
    bf16), the list of visited KV blocks (int32, one per enumerated
    block) and its length (csrc/perforated_attention.cu)."""
    pad_v = 4 if itemsize == 4 else 8
    return (itemsize * _STAGES * _CHUNK * ((d + 8) + (d + pad_v))
            + 4 * (n_blocks + 1))


def _check(q, k, v, block_q, block_kv, perfo, fraction):
    b, hq, sq, d = q.shape[-4:]
    _, hkv, skv, dk = k.shape[-4:]
    if dk != d or v.shape != k.shape or k.shape[-4] != b or hq % hkv:
        raise ValueError(
            f"perforated_attention operand mismatch: q is "
            f"(B, Hq, Sq, D)={tuple(q.shape)} so k and v must share "
            f"(B, Hkv, Skv, D) with D={d} and Hq % Hkv == 0; got "
            f"k.shape={tuple(k.shape)}, v.shape={tuple(v.shape)}")
    if sq % block_q or skv % block_kv:
        raise ValueError(
            f"perforated_attention block shape (block_q={block_q}, "
            f"block_kv={block_kv}) does not divide the sequence geometry "
            f"(Sq={sq}, Skv={skv})")
    if fraction is not None and (perfo is None
                                 or perfo.kind not in FRACTION_KINDS):
        raise ValueError(
            "fraction is the knob of ini/fini/random perforation; "
            f"got perfo={perfo}")


def launchable(shapes: Sequence[Sequence[int]],
               config: Dict[str, int]) -> Optional[str]:
    """None if the kernel launches at `config` (block_q, block_kv) on
    operands of `shapes` ((B, Hq, Sq, D), (B, Hkv, Skv, D), ...), else the
    reason: D among the instantiated head dims, block_q whole warps of 16
    rows (at most 8), block_kv whole 32-key chunks, and the shared memory
    one block may use (float32, the larger case)."""
    d, skv = int(shapes[0][3]), int(shapes[1][2])
    block_q, block_kv = config["block_q"], config["block_kv"]
    if d not in HEAD_DIMS or block_q not in BLOCK_Q or block_kv % _CHUNK:
        return (f"perforated_attention kernel needs D in {HEAD_DIMS}, "
                f"block_q in {BLOCK_Q} and block_kv a multiple of "
                f"{_CHUNK}; got D={d}, block_q={block_q}, "
                f"block_kv={block_kv}")
    smem = smem_bytes(d, skv // block_kv)
    if smem > _SMEM_LIMIT:
        return (f"perforated_attention blocks (block_q={block_q}, "
                f"block_kv={block_kv}) at D={d}, Skv={skv} need {smem} "
                f"bytes of shared memory, more than the {_SMEM_LIMIT} a "
                "block may use")
    return None


def _check_kernel_geometry(q, k, v, block_q, block_kv):
    if q.dtype not in _ENTRIES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"perforated_attention kernel takes float32 or bfloat16 q/k/v "
            f"of one type; got {q.dtype}, {k.dtype}, {v.dtype}")
    why = launchable((q.shape[-4:], k.shape[-4:]),
                     dict(block_q=block_q, block_kv=block_kv))
    if why:
        raise ValueError(why)
    if k.device != q.device or v.device != q.device:
        raise ValueError("perforated_attention: q, k and v must share one "
                         "device")


def perforated_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, block_q: int, block_kv: int,
                         perfo: Optional[PerforationParams] = None,
                         fraction=None, causal: bool = True,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D) with Hq % Hkv == 0.

    Returns (B, Hq, Sq, D) in q.dtype. Queries sit at the END of the KV
    timeline (offset = Skv - Sq). `fraction` selects the masked mode; an
    (L,) `fraction` runs L lanes (q, k, v shared or stacked with a leading
    L) and returns (L, B, Hq, Sq, D).
    """
    _check(q, k, v, block_q, block_kv, perfo, fraction)
    lanes = lane_count(fraction, (q, 4), (k, 4), (v, 4))
    b, hq, sq, d = q.shape[-4:]
    hkv, skv = k.shape[-3], k.shape[-2]
    nkv = skv // block_kv
    if fraction is None and perfo is not None \
            and len(kept_indices(nkv, perfo)) == 0:
        raise ValueError("perforation dropped every KV block")
    if q.device.type != "cuda":
        fn = plain_lanes if lanes else plain
        return fn(q, k, v, causal=causal, block_kv=block_kv, perfo=perfo,
                  fraction=fraction, scale=scale)
    _check_kernel_geometry(q, k, v, block_q, block_kv)
    dev = q.device
    kept, live = launch_operands(nkv, perfo, fraction, lanes, dev)
    scale = scale if scale is not None else float(1.0 / np.sqrt(d))
    qc, kc, vc = (_build.aligned(t) for t in (q, k, v))
    n_l = max(lanes, 1)
    o = _build.empty((n_l, b, hq, sq, d), q.dtype, dev, "attention o")
    work = COUNTER.work_buffer(dev)
    fn = _build.function(_ENTRIES[q.dtype], _ARGTYPES)
    p = _build.ptr
    err = fn(p(qc), p(kc), p(vc), p(o), p(kept), p(live),
             p(work), b, hq, hkv, sq, skv, d, block_q, block_kv,
             int(kept.shape[0]), float(scale), int(causal), n_l,
             int(q.dim() == 5), int(k.dim() == 5), _build.stream(dev))
    COUNTER.launched(lanes)
    _build.check("perforated_attention", err)
    return o if lanes else o[0]


def launch_operands(nkv: int, perfo: Optional[PerforationParams],
                    fraction, lanes: int, dev: torch.device
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the KV blocks the kernel enumerates, their int32 liveness) on
    `dev`. Masked mode (`fraction` a number or a tensor): every block, with
    liveness built on the device from the fraction ((nkv,), or (L, nkv)
    for L lanes), so the fraction is launch data. Structural mode: the
    kept blocks, all live."""
    if fraction is not None:
        kept, _ = _enumeration(nkv, None, np.arange(nkv), dev)  # every block
        frac = (fraction.to(device=dev, dtype=torch.float32)
                if isinstance(fraction, torch.Tensor) else
                torch.full((), float(fraction), dtype=torch.float32,
                           device=dev))
        live = traced_execute_mask(nkv, perfo, frac[..., None]
                                   if lanes else frac).to(torch.int32)
        return kept, live
    kept_np = np.arange(nkv) if perfo is None else kept_indices(nkv, perfo)
    return _enumeration(nkv, perfo, kept_np, dev)


# the enumerated KV blocks and their all-ones liveness on the device, built
# once per (number of blocks, perforation, device): they depend on nothing
# else, and the kernel only reads them
_ENUMERATIONS: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _enumeration(nkv: int, perfo: Optional[PerforationParams],
                 kept_np: np.ndarray, dev: torch.device
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    key = (nkv, perfo, dev)
    if key not in _ENUMERATIONS:
        _ENUMERATIONS[key] = (
            torch.as_tensor(kept_np, dtype=torch.int32, device=dev),
            torch.ones((len(kept_np),), dtype=torch.int32, device=dev))
    return _ENUMERATIONS[key]
