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
import torch.utils.checkpoint


def dense_init(generator: torch.Generator, shape,
               scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal fan-in init: a standard normal cut at +-2, times
    1/sqrt(fan_in) (the JAX package's scales), float32 on the generator's
    device (a model's `hold` moves and casts it)."""
    fan_in = shape[0] if len(shape) >= 1 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(scale)


def embed_init(generator: torch.Generator, shape) -> torch.Tensor:
    t = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return t.mul_(0.02)


# ----------------------------------------------------------------------------
# norms
# ----------------------------------------------------------------------------

# the leaves of a norm's parameter dict: held in the param dtype and cast
# to float32 at use, as the JAX norms do
NORM_LEAVES = ("scale", "bias")


class DtypeRule:
    """The dtype rule of one model, in the two stages JAX applies it.

    `store(name, t)` puts a freshly drawn float32 leaf named `name` on
    `device` in the dtype JAX stores, differentiates and updates it in: a
    leaf of `float32_leaves` (each module's table of leaves JAX keeps and
    uses in float32) float32, every other leaf the param dtype. `use(name,
    t)` is the cast at use: every leaf but a norm leaf (cast to float32
    inside the norm) and a float32 leaf goes to the compute dtype (JAX's
    `.astype(x.dtype)`). `use` is a differentiable `Tensor.to`, so the
    stored (master) leaf receives the gradient, as the transpose of JAX's
    `astype` gives it. `hold = use . store` is the serving form: the cast
    done once at init instead of at every use."""

    def __init__(self, param_dtype: torch.dtype, compute_dtype: torch.dtype,
                 device, float32_leaves=()):
        self.param_dtype, self.compute_dtype = param_dtype, compute_dtype
        self.device, self.float32_leaves = device, tuple(float32_leaves)

    def _cast_at_use(self, name: str) -> bool:
        return name not in self.float32_leaves and name not in NORM_LEAVES

    def store(self, name: str, t: torch.Tensor) -> torch.Tensor:
        t = t.to(self.device)
        if name in self.float32_leaves:
            return t.to(torch.float32)
        return t.to(self.param_dtype)

    def use(self, name: str, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.compute_dtype) if self._cast_at_use(name) else t

    def hold(self, name: str, t: torch.Tensor) -> torch.Tensor:
        t = t.to(self.device)
        if self._cast_at_use(name) \
                and t.dtype == self.compute_dtype != self.param_dtype:
            # round in place: a full-width expert stack is gigabytes, and
            # the caller still holds `t`
            return t.copy_(t.to(self.param_dtype))
        return self.use(name, self.store(name, t))


def unshard(t: torch.Tensor, dim: int) -> torch.Tensor:
    """`t` with dim `dim` whole on every rank: a DTensor sharded (or
    partial) along it is redistributed to replicate there, for an op that
    has no DTensor rule over a split dim (a gather along it); a plain
    tensor is returned as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(t, DTensor):
        return t
    dim = dim % t.ndim
    places = [Replicate() if not isinstance(p, Shard) or p.dim == dim
              else p for p in t.placements]
    return t.redistribute(t.device_mesh, places)


def remat(enabled: bool, fn, *args):
    """`fn(*args)`, its activations recomputed in backward when `enabled`
    and autograd records (`jax.checkpoint` around a layer under
    `cfg.remat`); a plain call otherwise, so serving is unchanged."""
    if enabled and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


def rmsnorm_params(d: int, hold):
    return {"scale": hold("scale", torch.ones((d,)))}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p["scale"].float()
    return out.to(x.dtype)


def layernorm_params(d: int, hold):
    return {"scale": hold("scale", torch.ones((d,))),
            "bias": hold("bias", torch.zeros((d,)))}


def layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * p["scale"].float() + p["bias"].float()
    return out.to(x.dtype)


def norm_params(kind: str, d: int, hold):
    return (rmsnorm_params(d, hold) if kind == "rms"
            else layernorm_params(d, hold))


def apply_norm(kind: str, p, x: torch.Tensor, eps: float = 1e-5):
    return rmsnorm(p, x, eps) if kind == "rms" else layernorm(p, x, eps)


# ----------------------------------------------------------------------------
# activations, op by op as XLA evaluates the JAX definitions
# ----------------------------------------------------------------------------

def silu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.silu`: x * logistic(x), the logistic as 1 / (1 + exp(-x))
    with each op rounded in x's dtype (XLA's bfloat16 results bit for bit;
    `F.silu` rounds once and differs in the last bit of a third of them).
    The MoE experts, Mamba2 and RWKV6 use it: without it zamba2's bfloat16
    hidden states depart from JAX's by more than 0.02. The dense FFN keeps
    `F.silu`, whose bfloat16 streams the dense serving tests pin."""
    return x * (1 / (1 + torch.exp(-x)))


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


def sinusoidal_positions(seq_len: int, d: int, device=None) -> torch.Tensor:
    """(seq_len, d) float32 sinusoidal position table: sin in the even
    columns, cos in the odd ones (Whisper's encoder)."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / d))
    pe = torch.zeros((seq_len, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


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
