"""Public wrappers of the port's kernels (port of `repro.kernels.ops`).

Same signatures as the JAX package's wrappers:

  * block arguments default to None, which resolves through the tuning
    cache (`kernels/tuning.py`): an exact (kernel, operand shapes, dtype,
    machine, substrate) hit supplies the autotuned block shape, anything
    else falls back to `tuning.FALLBACK_BLOCKS` (128 everywhere). Callers
    whose masks depend on the block geometry keep passing explicit blocks;
  * quality knobs (`rsd_threshold`, `threshold`, `fraction`) reach the
    kernels as float32 device tensors, never as compile-time constants;
  * `pipeline=` is accepted so the signatures match: every kernel here has
    one launch path, and both values run it;
  * lanes: an (L,) knob tensor runs L knobs in one wrapper call (one launch
    chain), the counterpart of the JAX package's `jax.vmap` of a kernel over
    a knob stack; operands are shared or stacked with a leading L, and the
    outputs gain a leading L. `launch_counts` counts one call per group.

A CPU tensor goes to the kernel's plain PyTorch version (`ref.py`); a CUDA
tensor goes to the kernel, and any failure raises. Each kernel module keeps
a `COUNTER` of its launches (`launch_counts`, `reset_counts`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch

from ..core.types import PerforationParams
from . import iact_memo, tuning
from . import perforated_attention as _attn_mod
from . import perforated_matmul as _pmm_mod
from . import taf_matmul as _taf_mod

KERNELS = {"taf_matmul": _taf_mod, "iact_rowfn": iact_memo,
           "perforated_matmul": _pmm_mod,
           "perforated_attention": _attn_mod}


# dimensions of each kernel's operands in a single call (one more when
# stacked over lanes)
_NDIM = {"taf_matmul": 2, "iact_rowfn": 2, "perforated_matmul": 2,
         "perforated_attention": 4}


def resolve_blocks(kernel: str, arrays: Sequence[torch.Tensor], dtype,
                   **blocks: Optional[int]) -> Dict[str, int]:
    """Fill None block args from the tuning cache (an exact-shape hit for
    the arrays' device, at one lane's shapes) or the fallbacks. Explicit
    ints pass through."""
    if all(v is not None for v in blocks.values()):
        return {k: int(v) for k, v in blocks.items()}
    nd = _NDIM[kernel]
    shapes = tuning.operand_shapes([a[0] if a.dim() > nd else a
                                    for a in arrays])
    tuned = tuning.tuned_config(kernel, shapes,
                                dtype=tuning.dtype_name(dtype),
                                device=arrays[0].device) or {}
    fallback = tuning.FALLBACK_BLOCKS[kernel]
    return {k: (int(v) if v is not None else int(tuned.get(k, fallback[k])))
            for k, v in blocks.items()}


def launch_counts() -> Dict[str, int]:
    return {name: mod.COUNTER.launches for name, mod in KERNELS.items()}


def lane_counts() -> Dict[str, int]:
    """Wrapper calls that ran a lane stack (one call for a group's L
    knobs), a part of `launch_counts`."""
    return {name: mod.COUNTER.lane_calls for name, mod in KERNELS.items()}


def work_counts() -> Dict[str, int]:
    """Device tallies: TAF tiles and iACT blocks whose product was computed,
    attention KV blocks visited, perforated-matmul K blocks accumulated
    (once a launch). Reading them synchronizes."""
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
    b = resolve_blocks("taf_matmul", (x, w), x.dtype, block_m=block_m,
                       block_n=block_n)
    return _taf_mod.taf_matmul(x, w, block_m=b["block_m"],
                               block_n=b["block_n"],
                               history_size=history_size,
                               prediction_size=prediction_size,
                               rsd_threshold=rsd_threshold,
                               out_dtype=out_dtype)


def iact_rowfn(x, w1, w2, *, block_rows: Optional[int] = None,
               table_size=4, threshold=0.5, out_dtype=torch.float32):
    """Returns (y, block_approx_mask (N/block_rows,) bool)."""
    b = resolve_blocks("iact_rowfn", (x, w1, w2), x.dtype,
                       block_rows=block_rows)
    return iact_memo.iact_rowfn(x, w1, w2, block_rows=b["block_rows"],
                                table_size=table_size, threshold=threshold,
                                out_dtype=out_dtype)


def perforated_matmul(x, w, *, block_m: Optional[int] = None,
                      block_n: Optional[int] = None,
                      block_k: Optional[int] = None,
                      perfo: Optional[PerforationParams] = None,
                      fraction=None, rescale=False, out_dtype=torch.float32,
                      pipeline: Optional[bool] = None):
    """`fraction` selects the masked mode (ini/fini/random): a liveness
    vector built on the device gates the K blocks, and one launch path
    serves any fraction."""
    del pipeline  # one launch path
    if fraction is not None and perfo is not None:
        # masked mode ignores perfo.fraction (the fraction operand carries
        # it): normalize the dead field, as the JAX wrapper does
        perfo = dataclasses.replace(perfo, fraction=0.0)
    b = resolve_blocks("perforated_matmul", (x, w), x.dtype,
                       block_m=block_m, block_n=block_n, block_k=block_k)
    return _pmm_mod.perforated_matmul(
        x, w, block_m=b["block_m"], block_n=b["block_n"],
        block_k=b["block_k"], perfo=perfo, fraction=fraction,
        rescale=rescale, out_dtype=out_dtype)


def perforated_attention(q, k, v, *, block_q: Optional[int] = None,
                         block_kv: Optional[int] = None,
                         perfo: Optional[PerforationParams] = None,
                         fraction=None, causal=True,
                         scale: Optional[float] = None,
                         pipeline: Optional[bool] = None):
    """`fraction` selects the masked mode (ini/fini/random): one launch path
    serves any fraction."""
    del pipeline  # one launch path
    b = resolve_blocks("perforated_attention", (q, k), q.dtype,
                       block_q=block_q, block_kv=block_kv)
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
