"""Execution-substrate selection: the oracles vs the CUDA kernels (port of
`repro.core.substrate`).

Two substrates run an approximated region:

  "host"  -- the plain PyTorch oracles in `kernels/ref.py`: sequential
             block semantics, runs anywhere, no kernel involved.
  "cuda"  -- the port's kernels through `kernels/ops.py`. Quality knobs
             (TAF rsd threshold, iACT distance threshold, perforation
             fraction) are float32 device tensors, so a sweep never
             rebuilds anything per knob value.

The process default comes from `$REPRO_SUBSTRATE` ("host" or "cuda"; any
other value raises), else "cuda". `use(substrate)` scopes another choice
(the harness entry points take `substrate=` and evaluate inside
`use(...)`), and `set_default` changes it for the process; `resolve(None)`
reads the ambient value at call time. The ambient value is a process-wide
global, not thread-local, so `run_specs(jobs>1)` worker threads see the
harness's scope; two concurrent sweeps with different substrates in one
process should pin the substrate on the app instead.

The `*_region` evaluators below are the kernel-backed counterparts of the
technique entry points: spec-driven, knob-aware, and uniform in what they
return -- (output, approx_mask). An (L,) knob tensor runs a structural
group's L knobs in one wrapper call (the kernels' lane grid); outputs and
masks then gain a leading L. `dispatch(technique)` names the one for a
technique.
"""
from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch

from ..kernels import ops
from . import perforation as perfo_mod
from .types import ApproxSpec, Technique

HOST = "host"
CUDA = "cuda"
SUBSTRATES = (HOST, CUDA)

_default: Optional[str] = None  # read from the environment on first use


def _env_default() -> str:
    sub = os.environ.get("REPRO_SUBSTRATE", CUDA).strip().lower()
    if sub not in SUBSTRATES:
        raise ValueError(
            f"$REPRO_SUBSTRATE={sub!r} is not one of {SUBSTRATES}")
    return sub


def get_default() -> str:
    """The ambient substrate (process default or innermost `use(...)`)."""
    global _default
    if _default is None:
        _default = _env_default()
    return _default


def set_default(substrate: str) -> None:
    """Set the process default (validated by `resolve`: host or cuda). It is
    process-wide; `use(...)` scopes a choice and restores the old one."""
    global _default
    _default = resolve(substrate)


def resolve(substrate: Optional[str]) -> str:
    """Validate an explicit choice; None means the ambient default."""
    if substrate is None:
        return get_default()
    if substrate not in SUBSTRATES:
        raise ValueError(
            f"unknown substrate {substrate!r}; expected one of {SUBSTRATES}")
    return substrate


@contextlib.contextmanager
def use(substrate: Optional[str]):
    """Scope the ambient substrate. `use(None)` is a no-op scope."""
    global _default
    if substrate is None:
        yield get_default()
        return
    prev = get_default()
    _default = resolve(substrate)
    try:
        yield _default
    finally:
        _default = prev


def taf_matmul_region(x, w, spec: ApproxSpec, *,
                      block_m: Optional[int] = None,
                      block_n: Optional[int] = None, rsd_threshold=None):
    """TAF-memoized projection y = x @ w under `spec.taf`.

    `rsd_threshold` overrides the spec's value (a float, a 0-d tensor or an
    (L,) knob stack). Returns (y, approx_mask (num_i, num_j) bool), each
    with a leading L for a knob stack.
    """
    if spec.technique != Technique.TAF:
        raise ValueError(f"taf_matmul_region needs a TAF spec, got {spec}")
    p = spec.taf
    th = p.rsd_threshold if rsd_threshold is None else rsd_threshold
    return ops.taf_matmul(x, w, block_m=block_m, block_n=block_n,
                          history_size=p.history_size,
                          prediction_size=p.prediction_size,
                          rsd_threshold=th)


def iact_ffn_region(x, w1, w2, spec: ApproxSpec, *,
                    block_rows: Optional[int] = None, threshold=None):
    """iACT-memoized FFN tile y = gelu_tanh(x @ w1) @ w2 under `spec.iact`.

    `threshold` overrides the spec's value (an (L,) stack runs L lanes).
    One table serves each row block. Returns (y, block_approx_mask
    (num_blocks,) bool), each with a leading L for a knob stack.
    """
    if spec.technique != Technique.IACT:
        raise ValueError(f"iact_ffn_region needs an IACT spec, got {spec}")
    p = spec.iact
    th = p.threshold if threshold is None else threshold
    return ops.iact_rowfn(x, w1, w2, block_rows=block_rows,
                          table_size=p.table_size, threshold=th)


def attention_region(q, k, v, spec: Optional[ApproxSpec], *,
                     block_q: Optional[int] = None,
                     block_kv: Optional[int] = None,
                     fraction=None, causal: bool = True):
    """(Perforated) flash attention under `spec.perforation` (None = exact).

    `fraction` (ini/fini/random kinds) flips the kernel into masked mode;
    an (L,) fraction stack runs L lanes, and o and the mask gain a leading
    L. Block args left None resolve through `ops.resolve_blocks` (the
    tuning cache, then the fallbacks) here, so the kept-mask granularity
    follows the block_kv the kernel runs. Returns
    (o, kept_block_mask (nkv,) bool on q's device), True = executed.
    """
    blocks = ops.resolve_blocks("perforated_attention", (q, k), q.dtype,
                                block_q=block_q, block_kv=block_kv)
    block_q, block_kv = blocks["block_q"], blocks["block_kv"]
    nkv = k.shape[-2] // block_kv
    if spec is None or spec.technique == Technique.NONE:
        o = ops.flash_attention(q, k, v, block_q=block_q, block_kv=block_kv,
                                causal=causal)
        return o, torch.ones((nkv,), dtype=torch.bool, device=q.device)
    if spec.technique != Technique.PERFORATION:
        raise ValueError(
            f"attention_region needs a perforation spec, got {spec}")
    p = spec.perforation
    o = ops.perforated_attention(q, k, v, block_q=block_q, block_kv=block_kv,
                                 perfo=p, fraction=fraction, causal=causal)
    if isinstance(fraction, torch.Tensor) and fraction.dim() == 1:
        mask = perfo_mod.traced_execute_mask(
            nkv, p, fraction.to(q.device)[:, None])
    elif fraction is not None:
        mask = perfo_mod.traced_execute_mask(nkv, p, fraction,
                                             device=q.device).to(q.device)
    else:
        mask = torch.as_tensor(perfo_mod.execute_mask(nkv, p),
                               device=q.device)
    return o, mask


_REGIONS = {
    Technique.TAF: taf_matmul_region,
    Technique.IACT: iact_ffn_region,
    Technique.PERFORATION: attention_region,
}


def dispatch(technique: Technique):
    """The kernel-backed region evaluator for `technique`; ValueError for a
    technique that has none (Technique.NONE)."""
    fn = _REGIONS.get(technique)
    if fn is None:
        raise ValueError(
            f"no cuda region evaluator for technique {technique}")
    return fn
