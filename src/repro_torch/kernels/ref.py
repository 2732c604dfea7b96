"""Plain PyTorch oracles for the port's kernels (port of `repro.kernels.ref`).

Each `*_ref` implements the exact block-level semantics of its kernel (same
block partitioning, same TAF/iACT state evolution, same perforation sets).
They serve three roles:

  * the "host" substrate of the app (`core/substrate.py`);
  * the PLAIN VERSION of each kernel: the wrappers in `kernels/ops.py` take
    it for a CPU tensor, and `chip_smoke.py` holds each CUDA kernel against
    it on the card;
  * the parity link to the JAX package, whose `ref.py` they follow line for
    line (tests/test_torch_kernels.py).

They run on whatever device their inputs live on. The TAF and iACT oracles
are sequential state machines: they read each decision back to the host, so
they are references, not fast paths.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.perforation import kept_indices, traced_execute_mask
from ..core.types import PerforationParams

_BIG = 3.4e38  # the iACT kernels' "no cached value" distance


def gelu_tanh(h: torch.Tensor) -> torch.Tensor:
    """The tanh GELU of `jax.nn.gelu` (torch's default is the erf form)."""
    return F.gelu(h, approximate="tanh")


def matmul_ref(x: torch.Tensor, w: torch.Tensor,
               out_dtype=torch.float32) -> torch.Tensor:
    return (x.float() @ w.float()).to(out_dtype)


# ----------------------------------------------------------------------------
# TAF matmul (block-level output memoization across row-blocks)
# ----------------------------------------------------------------------------

def taf_matmul_ref(x: torch.Tensor, w: torch.Tensor, *, block_m: int,
                   block_n: int, history_size: int, prediction_size: int,
                   rsd_threshold, out_dtype=torch.float32
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Oracle for kernels/taf_matmul.py.

    For each column block j, row blocks i = 0..M/bm-1 are a temporal
    sequence of invocations of the region. State per j: a window of the last
    `history_size` tile means; when RSD(window) < threshold the next
    `prediction_size` row blocks reuse the memoized tile. The tile mean is
    summed in float64 and rounded to float32, as the kernel does.
    Returns (y, approx_mask (M/bm, N/bn) bool).
    """
    m, k = x.shape
    k2, n = w.shape
    if k != k2 or m % block_m or n % block_n:
        raise ValueError(
            f"taf_matmul_ref: x {tuple(x.shape)}, w {tuple(w.shape)} and "
            f"blocks ({block_m}, {block_n}) do not fit")
    num_i, num_j = m // block_m, n // block_n
    xf, wf = x.float(), w.float()
    thr = float(rsd_threshold)
    y = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    approx = np.zeros((num_i, num_j), bool)
    for j in range(num_j):
        cols = slice(j * block_n, (j + 1) * block_n)
        window: list = []
        remaining = 0
        memo = torch.zeros((block_m, block_n), dtype=torch.float32,
                           device=x.device)
        for i in range(num_i):
            rows = slice(i * block_m, (i + 1) * block_m)
            if remaining > 0:
                y[rows, cols] = memo
                remaining -= 1
                approx[i, j] = True
                continue
            blk = xf[rows] @ wf[:, cols]
            y[rows, cols] = blk
            memo = blk
            window.append(float(blk.double().mean().float()))
            window = window[-history_size:]
            if len(window) == history_size:
                mu = float(np.mean(window))
                sigma = float(np.std(window))
                if sigma / max(abs(mu), 1e-12) < thr:
                    remaining = prediction_size
    return y.to(out_dtype), torch.as_tensor(approx, device=x.device)


# ----------------------------------------------------------------------------
# iACT memoized row function (two-phase, single-writer, round-robin)
# ----------------------------------------------------------------------------

def iact_rowfn_ref(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, *,
                   block_rows: int, table_size: int, threshold,
                   out_dtype=torch.float32
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Oracle for kernels/iact_memo.py.

    Region fn: y = gelu_tanh(x @ w1) @ w2 per row, in blocks of
    `block_rows` rows with one memo table carried across all blocks. Read
    phase -> majority vote -> (approx: nearest cached value | accurate:
    compute, then the single max-distance writer inserts round-robin).
    Returns (y, block_approx_mask (num_blocks,) bool).
    """
    n, d_in = x.shape
    d_out = w2.shape[1]
    if n % block_rows or w1.shape[0] != d_in or w2.shape[0] != w1.shape[1]:
        raise ValueError(
            f"iact_rowfn_ref: x {tuple(x.shape)}, w1 {tuple(w1.shape)}, "
            f"w2 {tuple(w2.shape)} and block_rows={block_rows} do not fit")
    num_b = n // block_rows
    dev = x.device
    xf, w1f, w2f = x.float(), w1.float(), w2.float()
    thr = float(threshold)
    keys = torch.zeros((table_size, d_in), dtype=torch.float32, device=dev)
    values = torch.zeros((table_size, d_out), dtype=torch.float32,
                         device=dev)
    valid = torch.zeros((table_size,), dtype=torch.bool, device=dev)
    any_valid = False
    cursor = 0
    y = torch.zeros((n, d_out), dtype=torch.float32, device=dev)
    approx = np.zeros((num_b,), bool)
    for b in range(num_b):
        rows = xf[b * block_rows:(b + 1) * block_rows]
        if any_valid:
            d = torch.linalg.vector_norm(rows[:, None, :] - keys[None],
                                         dim=-1)
            d[:, ~valid] = float("inf")
            mind, best = d.min(dim=1)
        else:
            best = torch.zeros((block_rows,), dtype=torch.long, device=dev)
            mind = torch.full((block_rows,), float("inf"), device=dev)
        hits = int((mind < thr).sum())
        if hits * 2 > block_rows:                           # majority-rules
            y[b * block_rows:(b + 1) * block_rows] = values[best]
            approx[b] = True
            continue
        out = gelu_tanh(rows @ w1f) @ w2f
        y[b * block_rows:(b + 1) * block_rows] = out
        # single writer: the row farthest from any cached value
        score = torch.where(torch.isinf(mind), torch.full_like(mind, _BIG),
                            mind)
        writer = int(score.argmax())
        keys[cursor] = rows[writer]
        values[cursor] = out[writer]
        valid[cursor] = True
        any_valid = True
        cursor = (cursor + 1) % table_size
    return y.to(out_dtype), torch.as_tensor(approx, device=dev)


# ----------------------------------------------------------------------------
# herded-perforated matmul (K-block dropping)
# ----------------------------------------------------------------------------

def perforated_matmul_ref(x: torch.Tensor, w: torch.Tensor, *, block_k: int,
                          perfo: Optional[PerforationParams],
                          rescale: bool = False,
                          out_dtype=torch.float32) -> torch.Tensor:
    """Oracle for the JAX package's kernels/perforated_matmul.py: drop the
    same K-blocks from the contraction for every output tile."""
    m, k = x.shape
    if k % block_k:
        raise ValueError(f"block_k={block_k} does not divide K={k}")
    nk = k // block_k
    kept = list(range(nk)) if perfo is None else list(kept_indices(nk, perfo))
    xf, wf = x.float(), w.float()
    acc = torch.zeros((m, w.shape[1]), dtype=torch.float32, device=x.device)
    for kb in kept:
        sl = slice(kb * block_k, (kb + 1) * block_k)
        acc = acc + xf[:, sl] @ wf[sl, :]
    if rescale and kept:
        acc = acc * (nk / len(kept))
    return acc.to(out_dtype)


# ----------------------------------------------------------------------------
# attention with herded KV-block perforation
# ----------------------------------------------------------------------------

def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, block_kv: Optional[int] = None,
                  perfo: Optional[PerforationParams] = None,
                  fraction=None, scale: Optional[float] = None,
                  out_dtype=None) -> torch.Tensor:
    """Oracle for kernels/perforated_attention.py.

    q: (B, Hq, Sq, D), k/v: (B, Hkv, Skv, D) with Hq % Hkv == 0 (query head
    h reads kv head h // (Hq // Hkv)). Queries sit at the END of the KV
    timeline (offset = Skv - Sq). When `perfo` is set, whole KV blocks of
    size `block_kv` are dropped for every query (herded); with `fraction`
    the kept blocks come from `traced_execute_mask` on the device (the
    kernel's masked mode), else from `kept_indices` (structural mode).
    Fully masked rows give 0.
    """
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / float(np.sqrt(d))
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    logits = (q.float() @ kf.transpose(-1, -2)) * scale
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        offset = skv - sq
        qi = torch.arange(sq, device=q.device)[:, None]
        ki = torch.arange(skv, device=q.device)[None, :]
        mask = mask & (ki <= qi + offset)
    if perfo is not None:
        if block_kv is None or skv % block_kv:
            raise ValueError("perforated attention needs a block_kv that "
                             f"divides Skv={skv}")
        nkv = skv // block_kv
        if fraction is not None:
            keepb = traced_execute_mask(nkv, perfo, fraction,
                                        device=q.device).to(q.device)
        else:
            keepb = torch.zeros((nkv,), dtype=torch.bool, device=q.device)
            keepb[torch.as_tensor(kept_indices(nkv, perfo),
                                  device=q.device)] = True
        mask = mask & keepb.repeat_interleave(block_kv)[None, :]
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.nan_to_num(probs, nan=0.0)  # fully-masked rows
    out = probs @ vf
    return out.to(out_dtype or q.dtype)
