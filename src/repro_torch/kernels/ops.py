"""Public wrappers of the port's kernels (port of `repro.kernels.ops`).

Same signatures as the JAX package's wrappers:

  * block arguments default to None and are filled from `FALLBACK_BLOCKS`
    (a copy of the JAX package's `tuning.FALLBACK_BLOCKS`; the port has no
    tuning cache yet);
  * quality knobs (`rsd_threshold`, `threshold`, `fraction`) reach the
    kernels as float32 device tensors, never as compile-time constants;
  * `pipeline=` is accepted so the signatures match: every kernel here has
    one launch path, and both values run it.

A CPU tensor goes to the kernel's plain PyTorch version (`ref.py`); a CUDA
tensor goes to the kernel, and any failure raises. Each kernel module keeps
a `COUNTER` of its launches (`launch_counts`, `reset_counts`).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..core.types import PerforationParams
from . import iact_memo, perforated_attention as _attn_mod, taf_matmul as _taf_mod

FALLBACK_BLOCKS: Dict[str, Dict[str, int]] = {
    "taf_matmul": {"block_m": 128, "block_n": 128},
    "iact_rowfn": {"block_rows": 128},
    "perforated_attention": {"block_q": 128, "block_kv": 128},
}

KERNELS = {"taf_matmul": _taf_mod, "iact_rowfn": iact_memo,
           "perforated_attention": _attn_mod}


def resolve_blocks(kernel: str, **blocks: Optional[int]) -> Dict[str, int]:
    """Fill None block args from the fallbacks; explicit ints pass through."""
    fallback = FALLBACK_BLOCKS[kernel]
    return {k: int(fallback[k] if v is None else v)
            for k, v in blocks.items()}


def launch_counts() -> Dict[str, int]:
    return {name: mod.COUNTER.launches for name, mod in KERNELS.items()}


def work_counts() -> Dict[str, int]:
    """Device tallies: TAF tiles and iACT blocks whose product was computed,
    attention KV blocks visited. Reading them synchronizes."""
    return {name: mod.COUNTER.work() for name, mod in KERNELS.items()}


def reset_counts() -> None:
    for mod in KERNELS.values():
        mod.COUNTER.reset()


def taf_matmul(x, w, *, block_m: Optional[int] = None,
               block_n: Optional[int] = None, history_size=3,
               prediction_size=8, rsd_threshold=0.5,
               out_dtype=torch.float32, pipeline: Optional[bool] = None):
    """Returns (y, approx_mask (M/block_m, N/block_n) bool)."""
    del pipeline  # one launch path
    b = resolve_blocks("taf_matmul", block_m=block_m, block_n=block_n)
    return _taf_mod.taf_matmul(x, w, block_m=b["block_m"],
                               block_n=b["block_n"],
                               history_size=history_size,
                               prediction_size=prediction_size,
                               rsd_threshold=rsd_threshold,
                               out_dtype=out_dtype)


def iact_rowfn(x, w1, w2, *, block_rows: Optional[int] = None,
               table_size=4, threshold=0.5, out_dtype=torch.float32):
    """Returns (y, block_approx_mask (N/block_rows,) bool)."""
    b = resolve_blocks("iact_rowfn", block_rows=block_rows)
    return iact_memo.iact_rowfn(x, w1, w2, block_rows=b["block_rows"],
                                table_size=table_size, threshold=threshold,
                                out_dtype=out_dtype)


def perforated_attention(q, k, v, *, block_q: Optional[int] = None,
                         block_kv: Optional[int] = None,
                         perfo: Optional[PerforationParams] = None,
                         fraction=None, causal=True,
                         scale: Optional[float] = None,
                         pipeline: Optional[bool] = None):
    """`fraction` selects the masked mode (ini/fini/random): one launch path
    serves any fraction."""
    del pipeline  # one launch path
    b = resolve_blocks("perforated_attention", block_q=block_q,
                       block_kv=block_kv)
    return _attn_mod.perforated_attention(
        q, k, v, block_q=b["block_q"], block_kv=b["block_kv"], perfo=perfo,
        fraction=fraction, causal=causal, scale=scale)


def flash_attention(q, k, v, *, block_q: Optional[int] = None,
                    block_kv: Optional[int] = None, causal=True,
                    scale: Optional[float] = None,
                    pipeline: Optional[bool] = None):
    """Causal flash attention == perforated_attention with no drops."""
    return perforated_attention(q, k, v, block_q=block_q, block_kv=block_kv,
                                causal=causal, scale=scale,
                                pipeline=pipeline)
