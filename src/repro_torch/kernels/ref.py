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

from ..core.perforation import (FRACTION_KINDS, kept_indices,
                                traced_execute_mask)
from ..core.types import PerforationParams

_BIG = 3.4e38  # the iACT kernels' "no cached value" distance


def gelu_tanh(h: torch.Tensor) -> torch.Tensor:
    """The tanh GELU of `jax.nn.gelu` (torch's default is the erf form)."""
    return F.gelu(h, approximate="tanh")


def lane_count(knob, *operands: Tuple[torch.Tensor, int]) -> int:
    """L of a lane stack: the length of a 1-d `knob` (0 for a 0-d knob,
    the single-call path). Each (tensor, ndim) operand has `ndim`
    dimensions when shared and one more, of length L, when stacked; a
    stacked operand needs a 1-d knob of its length."""
    t = knob if isinstance(knob, torch.Tensor) else None
    lanes = 0 if t is None or t.dim() == 0 else int(t.shape[0])
    if t is not None and t.dim() > 1:
        raise ValueError(f"a knob is 0-d or (L,), got {tuple(t.shape)}")
    for op, nd in operands:
        if op.dim() == nd + 1 and op.shape[0] != lanes:
            raise ValueError(
                f"an operand stacked over {op.shape[0]} lanes needs an "
                f"(L,) knob of that length, got {lanes or 'a 0-d knob'}")
        if op.dim() not in (nd, nd + 1):
            raise ValueError(f"operand of shape {tuple(op.shape)}: expected "
                             f"{nd} dimensions, or {nd + 1} stacked")
    return lanes


def lane(t: torch.Tensor, i: int, ndim: int) -> torch.Tensor:
    """Lane `i`'s operand: `t[i]` when `t` is stacked (`ndim` + 1
    dimensions), else `t` itself (shared by every lane)."""
    return t[i] if t.dim() == ndim + 1 else t


def _stack_lanes(outs):
    return tuple(torch.stack(z) for z in zip(*outs))


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


def taf_matmul_lanes_ref(x: torch.Tensor, w: torch.Tensor, *,
                         rsd_threshold, **kw
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`taf_matmul_ref` over an (L,) threshold stack, lane by lane: x and w
    shared or stacked per lane. Returns (y (L, M, N), mask (L, M/bm,
    N/bn))."""
    th = torch.as_tensor(rsd_threshold, dtype=torch.float32)
    return _stack_lanes(
        taf_matmul_ref(lane(x, i, 2), lane(w, i, 2), rsd_threshold=th[i],
                       **kw)
        for i in range(th.shape[0]))


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


def iact_rowfn_lanes_ref(x: torch.Tensor, w1: torch.Tensor,
                         w2: torch.Tensor, *, threshold, **kw
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`iact_rowfn_ref` over an (L,) threshold stack, lane by lane: x, w1
    and w2 shared or stacked per lane. Returns (y (L, N, d_out), mask (L,
    N/block_rows))."""
    th = torch.as_tensor(threshold, dtype=torch.float32)
    return _stack_lanes(
        iact_rowfn_ref(lane(x, i, 2), lane(w1, i, 2), lane(w2, i, 2),
                       threshold=th[i], **kw)
        for i in range(th.shape[0]))


# ----------------------------------------------------------------------------
# herded-perforated matmul (K-block dropping)
# ----------------------------------------------------------------------------

def perforated_matmul_operands(nk: int,
                               perfo: Optional[PerforationParams],
                               fraction=None, rescale: bool = False,
                               device=None
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """(kept int32, live int32, factor float32 (1,)) on `device`: what the
    K4 kernel and its plain version take, built as the Pallas kernel builds
    its scalar-prefetch operands.

    Structural mode (`fraction=None`): `kept` lists the kept K blocks,
    `live` is all ones and the factor nk / len(kept) (rescale) or 1;
    dropping every block raises. Masked mode (`fraction` a float or a
    tensor; ini/fini/random kinds): `kept` enumerates every block, `live`
    comes from `traced_execute_mask` on the device and the factor
    nk / max(n_live, 1) is computed there, so nothing is read back to the
    host; dropping every block gives zeros.
    """
    if fraction is not None:
        if perfo is None or perfo.kind not in FRACTION_KINDS:
            raise ValueError(
                "fraction is a traced hook for ini/fini/random perforation; "
                f"got perfo={perfo}")
        if isinstance(fraction, torch.Tensor):
            fraction = fraction.to(device)
        live = traced_execute_mask(nk, perfo, fraction,
                                   device=device).to(torch.int32)
        kept = torch.arange(nk, dtype=torch.int32, device=live.device)
        if rescale:
            n_live = live.sum().clamp(min=1).to(torch.float32)
            factor = torch.div(torch.full((1,), float(nk),
                                          dtype=torch.float32,
                                          device=live.device), n_live)
        else:
            factor = torch.ones((1,), dtype=torch.float32,
                                device=live.device)
        return kept, live, factor
    kept_np = np.arange(nk) if perfo is None else kept_indices(nk, perfo)
    if len(kept_np) == 0:
        raise ValueError("perforation dropped every K block")
    kept = torch.as_tensor(kept_np, dtype=torch.int32, device=device)
    live = torch.ones((len(kept_np),), dtype=torch.int32, device=device)
    factor = torch.full((1,), nk / len(kept_np) if rescale else 1.0,
                        dtype=torch.float32, device=device)
    return kept, live, factor


def perforated_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                            kept: torch.Tensor, live: torch.Tensor,
                            factor: torch.Tensor, *, block_k: int,
                            out_dtype=torch.float32) -> torch.Tensor:
    """The plain version of the K4 kernel, on the kernel's own operands:
    acc = sum over enumerated K blocks e with live[e] of
    x[:, kept[e]] @ w[kept[e], :], in enumeration order, then acc * factor.
    A dead block adds nothing (not even 0 * inf). No value is read back to
    the host."""
    m, k = x.shape
    nk = k // block_k
    kept = kept.long()
    xk = x.float().reshape(m, nk, block_k).index_select(1, kept)
    wk = w.float().reshape(nk, block_k, w.shape[1]).index_select(0, kept)
    acc = torch.zeros((m, w.shape[1]), dtype=torch.float32, device=x.device)
    for e in range(kept.shape[0]):
        blk = xk[:, e] @ wk[e]
        acc = acc + torch.where(live[e] > 0, blk, torch.zeros_like(blk))
    return (acc * factor).to(out_dtype)


def perforated_matmul_ref(x: torch.Tensor, w: torch.Tensor, *, block_k: int,
                          perfo: Optional[PerforationParams],
                          fraction=None, rescale: bool = False,
                          out_dtype=torch.float32) -> torch.Tensor:
    """Oracle for kernels/perforated_matmul.py: drop the same K-blocks from
    the contraction for every output tile (structural mode, or masked mode
    when `fraction` is given)."""
    k = x.shape[1]
    if k % block_k:
        raise ValueError(f"block_k={block_k} does not divide K={k}")
    kept, live, factor = perforated_matmul_operands(
        k // block_k, perfo, fraction, rescale, device=x.device)
    return perforated_matmul_plain(x, w, kept, live, factor,
                                   block_k=block_k, out_dtype=out_dtype)


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


def attention_lanes_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, fraction, **kw) -> torch.Tensor:
    """`attention_ref` in masked mode over an (L,) fraction stack, lane by
    lane: q, k and v shared ((B, H, S, D)) or stacked per lane. Returns
    (L, B, Hq, Sq, D)."""
    fr = torch.as_tensor(fraction, dtype=torch.float32)
    return torch.stack([
        attention_ref(lane(q, i, 4), lane(k, i, 4), lane(v, i, 4),
                      fraction=fr[i].to(q.device), **kw)
        for i in range(fr.shape[0])])
