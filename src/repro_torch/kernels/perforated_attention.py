"""Flash attention with herded KV-block perforation (K1): the wrapper of
`csrc/perforated_attention.cu`.

Replaces the Pallas kernel
`src/repro/kernels/perforated_attention.py::perforated_attention`, which
also serves the JAX package's `ops.flash_attention` (`perfo=None`).

Two perforation modes share one kernel:

  * structural (`fraction=None`): the enumerated list holds only the kept
    KV blocks (`perforation.kept_indices`), so dropped blocks are never
    visited;
  * masked (`fraction=` a float or tensor; ini/fini/random kinds): the list
    holds every block and a liveness vector, built on the device by
    `perforation.traced_execute_mask`, gates each one -- any fraction runs
    the same launch and nothing is read back to the host.

Plain version: `ref.attention_ref`, taken for CPU tensors.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import _build
from ..core.perforation import (FRACTION_KINDS, kept_indices,
                                traced_execute_mask)
from ..core.types import PerforationParams
from .ref import attention_ref as plain

SOURCE = "src/repro_torch/kernels/csrc/perforated_attention.cu"
REPLACES = "src/repro/kernels/perforated_attention.py:110"
COUNTER = _build.Counter("perforated_attention")

_ARGTYPES = [_build.P] * 7 + [_build.I] * 9 + [_build.F, _build.I,
                                                _build.P]
_TILE = 512   # outputs of one P . V row group: 128 threads x 4 columns
_MAX_ROWS = 16  # output rows a thread accumulates
_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
_ENTRIES = {torch.float32: "attention_f32", torch.bfloat16: "attention_bf16"}


def smem_bytes(block_q: int, block_kv: int, d: int) -> int:
    """q tile, padded K tile, V tile, scores, transposed probabilities and
    three row vectors, all float32 (csrc/perforated_attention.cu)."""
    return 4 * (block_q * d + block_kv * (d + 4) + block_kv * d +
                block_q * (block_kv + 1) + block_kv * (block_q + 4) +
                3 * block_q)


def _check(q, k, v, block_q, block_kv, perfo, fraction):
    b, hq, sq, d = q.shape
    _, hkv, skv, dk = k.shape
    if dk != d or v.shape != k.shape or k.shape[0] != b or hq % hkv:
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


def _check_kernel_geometry(q, k, v, block_q, block_kv):
    d = q.shape[3]
    if q.dtype not in _ENTRIES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"perforated_attention kernel takes float32 or bfloat16 q/k/v "
            f"of one type; got {q.dtype}, {k.dtype}, {v.dtype}")
    if d % 4 or _TILE % d or (block_q * d) % _TILE or \
            block_q * d > _MAX_ROWS * _TILE or block_q % 2 or block_kv % 32:
        raise ValueError(
            f"perforated_attention kernel needs D a multiple of 4 dividing "
            f"{_TILE}, block_q * D a multiple of {_TILE} and at most "
            f"{_MAX_ROWS * _TILE}, block_q even and block_kv a multiple of "
            f"32; got D={d}, block_q={block_q}, block_kv={block_kv}")
    if smem_bytes(block_q, block_kv, d) > _SMEM_LIMIT:
        raise ValueError(
            f"perforated_attention blocks (block_q={block_q}, "
            f"block_kv={block_kv}) at D={d} need "
            f"{smem_bytes(block_q, block_kv, d)} bytes of shared memory, "
            f"more than the {_SMEM_LIMIT} a block may use")
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
    timeline (offset = Skv - Sq). `fraction` selects the masked mode.
    """
    _check(q, k, v, block_q, block_kv, perfo, fraction)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    nkv = skv // block_kv
    kept_np = None
    if fraction is None:
        kept_np = np.arange(nkv) if perfo is None else kept_indices(nkv,
                                                                   perfo)
        if len(kept_np) == 0:
            raise ValueError("perforation dropped every KV block")
    if q.device.type != "cuda":
        return plain(q, k, v, causal=causal, block_kv=block_kv, perfo=perfo,
                     fraction=fraction, scale=scale)
    _check_kernel_geometry(q, k, v, block_q, block_kv)
    dev = q.device
    if fraction is not None:
        kept = torch.arange(nkv, dtype=torch.int32, device=dev)
        frac = torch.as_tensor(fraction, dtype=torch.float32, device=dev)
        live = traced_execute_mask(nkv, perfo, frac).to(torch.int32)
    else:
        kept = torch.as_tensor(kept_np, dtype=torch.int32, device=dev)
        live = torch.ones((len(kept_np),), dtype=torch.int32, device=dev)
    scale = scale if scale is not None else float(1.0 / np.sqrt(d))
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(qc)
    work = COUNTER.work_buffer(dev)
    fn = _build.function(_ENTRIES[q.dtype], _ARGTYPES)
    p = _build.ptr
    err = fn(p(qc), p(kc), p(vc), p(o), p(kept), p(live), p(work), b, hq,
             hkv, sq, skv, d, block_q, block_kv, int(kept.shape[0]),
             float(scale), int(causal), _build.stream(dev))
    COUNTER.launches += 1
    _build.check("perforated_attention", err)
    return o
