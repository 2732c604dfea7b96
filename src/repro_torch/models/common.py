"""Shared model components: init, norms, RoPE and the attention math (port
of `repro.models.common`).

Plain functions on tensors. Parameters are nested dicts of tensors with
the JAX package's names and layouts (`x @ W`, W stored (in, out)), so a
JAX parameter tree carries across leaf for leaf (`convert.lm_params`).
The JAX module's sharding hints have no meaning on one card and are gone;
its `scan_layers` is a Python loop in `models.lm`.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch


def dense_init(generator: torch.Generator, shape, scale: Optional[float] = None,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """Truncated-normal fan-in init: a standard normal cut at +-2, times
    1/sqrt(fan_in) (the JAX package's scales). Drawn on the generator's
    device, returned on `device` in `dtype`."""
    fan_in = shape[0] if len(shape) >= 1 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * scale).to(device=device, dtype=dtype)


def embed_init(generator: torch.Generator, shape, dtype=torch.float32,
               device=None) -> torch.Tensor:
    t = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (t * 0.02).to(device=device, dtype=dtype)


# ----------------------------------------------------------------------------
# norms
# ----------------------------------------------------------------------------

def rmsnorm_params(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p["scale"].float()
    return out.to(x.dtype)


def layernorm_params(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * p["scale"].float() + p["bias"].float()
    return out.to(x.dtype)


def norm_params(kind: str, d: int, dtype=torch.float32, device=None):
    return (rmsnorm_params(d, dtype, device) if kind == "rms"
            else layernorm_params(d, dtype, device))


def apply_norm(kind: str, p, x: torch.Tensor, eps: float = 1e-5):
    return rmsnorm(p, x, eps) if kind == "rms" else layernorm(p, x, eps)


# ----------------------------------------------------------------------------
# rotary position embeddings
# ----------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, D) with D even; positions: (S,). Rotates interleaved
    pairs (x[2i], x[2i+1]), as the JAX package does."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                       # (D/2,)
    angles = positions[..., :, None].float() * freqs              # (S, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., ::2], x[..., 1::2]
    xr1 = x1 * cos - x2 * sin
    xr2 = x2 * cos + x1 * sin
    out = torch.stack([xr1, xr2], dim=-1).reshape(x.shape)
    return out.to(x.dtype)


# ----------------------------------------------------------------------------
# attention math
# ----------------------------------------------------------------------------

def _dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with float32 products and sums (XLA's
    `preferred_element_type=float32` on narrower inputs)."""
    return torch.matmul(a.float(), b.float())


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, q_chunk: int = 512,
                      kv_chunk: int = 512, scale: Optional[float] = None,
                      kv_positions: Optional[np.ndarray] = None
                      ) -> torch.Tensor:
    """Flash-style online-softmax attention over chunks.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D), Hq % Hkv == 0. Queries sit at
    the END of the KV timeline. `kv_positions` (a static numpy array, herded
    KV-block perforation) gives each KV row's original timeline position;
    the causal mask compares against those instead of contiguous indices.
    """
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    dv = v.shape[-1]
    assert hq % hkv == 0
    rep = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    dev = q.device
    if kv_positions is None:
        kv_pos = torch.arange(skv, device=dev)
        offset = skv - sq
    else:
        kv_np = np.asarray(kv_positions)
        kv_pos = torch.as_tensor(kv_np, device=dev)
        offset = int(kv_np.max()) + 1 - sq

    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    nq = -(-sq // q_chunk)
    nkv = -(-skv // kv_chunk)
    sq_p, skv_p = nq * q_chunk, nkv * kv_chunk
    qp = torch.nn.functional.pad(q, (0, 0, 0, sq_p - sq))
    kp = torch.nn.functional.pad(k, (0, 0, 0, skv_p - skv))
    vp = torch.nn.functional.pad(v, (0, 0, 0, skv_p - skv))
    kvpos_p = torch.nn.functional.pad(kv_pos, (0, skv_p - skv),
                                      value=2 ** 30)  # padding: always masked
    if rep > 1:
        kp = kp.repeat_interleave(rep, dim=1)
        vp = vp.repeat_interleave(rep, dim=1)

    outs = []
    for iq in range(nq):
        qc = qp[:, :, iq * q_chunk:(iq + 1) * q_chunk]
        qi = iq * q_chunk + torch.arange(q_chunk, device=dev) + offset
        m = torch.full((b, hq, q_chunk), -1e30, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, hq, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, hq, q_chunk, dv), dtype=torch.float32,
                          device=dev)
        for ikv in range(nkv):
            sl = slice(ikv * kv_chunk, (ikv + 1) * kv_chunk)
            kc, vc = kp[:, :, sl], vp[:, :, sl]
            logits = _dot_f32(qc, kc.transpose(-1, -2)) * scale
            ki = kvpos_p[sl]
            mask = ki[None, :] < 2 ** 30
            if causal:
                mask = mask & (ki[None, :] <= qi[:, None])
            logits = torch.where(mask[None, None], logits, -1e30)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + _dot_f32(p.to(vc.dtype), vc)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        out = torch.where((l > 0.5)[..., None], out, 0.0)
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=2)[:, :, :sq]


def full_attention(q, k, v, *, causal: bool = True,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Quadratic reference attention (small sequences / tests)."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    rep = hq // hkv
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        ki = torch.arange(skv, device=q.device)[None, :]
        logits = torch.where((ki <= qi)[None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs, v.float()).to(q.dtype)


def decode_attention(q, k, v, *, valid_len: int,
                     scale: Optional[float] = None,
                     keep_mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Single-token decode attention against a (possibly oversized) cache.

    q: (B, Hq, 1, D); k/v: (B, Hkv, S_cache, D); positions >= valid_len are
    masked; `keep_mask` (S_cache,) additionally masks perforated KV blocks
    (herded: one mask for every batch/head). GQA is a grouped product: the
    cache is never head-repeated.
    """
    b, hq, _, d = q.shape
    _, hkv, skv, _ = k.shape
    dv = v.shape[-1]
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, hkv, group, d)
    logits = _dot_f32(qg, k.transpose(-1, -2)) * scale       # (B,Hkv,G,S)
    mask = torch.arange(skv, device=q.device) < valid_len
    if keep_mask is not None:
        mask = mask & keep_mask
    logits = torch.where(mask, logits, -1e30)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    ctx = _dot_f32(p.to(v.dtype), v) / torch.clamp(l, min=1e-30)
    return ctx.reshape(b, hq, 1, dv).to(q.dtype)
