"""GQA attention with RoPE, optional qk-norm (qwen3), optional QKV bias
(qwen1.5), KV cache, and herded KV-block perforation as a first-class
option (port of `repro.models.attention`).

Two paths share one module, as in the JAX package:
  * prefill / forward: chunked online-softmax attention
    (`common.chunked_attention`), plain PyTorch as the JAX package computes
    it in plain `jnp`;
  * decode: single-token attention against the cache (linear in S).

The cache is written IN PLACE at the decoded position (the JAX functions
return an updated copy): a step writes only position `pos`, so a caller
that needs the pre-step state of positions < pos still has it.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.perforation import kept_indices
from ..core.types import ApproxSpec, PerforationParams, Technique
from . import common

KV_BLOCK = 128    # herded KV-perforation block (the JAX module's `block`)


def init_params(generator: torch.Generator, cfg: ModelConfig, hold) -> Dict:
    """The attention leaves drawn from `generator`, each through
    `hold(name, tensor)` (the model's dtype rule)."""
    d = cfg.d_model
    hd = cfg.resolved_head_dim

    def dense(name, shape):
        return hold(name, common.dense_init(generator, shape))

    p = {
        "wq": dense("wq", (d, cfg.n_heads * hd)),
        "wk": dense("wk", (d, cfg.n_kv_heads * hd)),
        "wv": dense("wv", (d, cfg.n_kv_heads * hd)),
        "wo": dense("wo", (cfg.n_heads * hd, d)),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                        ("bv", cfg.n_kv_heads)):
            p[name] = hold(name, torch.zeros((n * hd,)))
    if cfg.qk_norm:
        p["q_norm"] = common.rmsnorm_params(hd, hold)
        p["k_norm"] = common.rmsnorm_params(hd, hold)
    return p


def _project_qkv(p, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = common.split_heads(q, cfg.n_heads, hd).transpose(1, 2)
    k = common.split_heads(k, cfg.n_kv_heads, hd).transpose(1, 2)
    v = common.split_heads(v, cfg.n_kv_heads, hd).transpose(1, 2)
    if cfg.qk_norm:
        q = common.rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = common.rmsnorm(p["k_norm"], k, cfg.norm_eps)
    q = common.apply_rope(q, positions, cfg.rope_theta)
    k = common.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _maybe_perforate_kv(k, v, spec: Optional[ApproxSpec],
                        block: int = KV_BLOCK):
    """Herded KV-block perforation: the kept set is static, so K / V are
    structurally shortened. Returns (k, v, kv_positions | None): the
    original timeline positions of the kept rows, so the causal mask stays
    exact. With more than one block, a tail beyond the whole blocks is
    dropped, as in the JAX package."""
    if spec is None or spec.technique != Technique.PERFORATION:
        return k, v, None
    skv = k.shape[2]
    nblocks = max(skv // block, 1)
    kept = kept_indices(nblocks, spec.perforation)
    if len(kept) == nblocks:
        return k, v, None
    idx = np.concatenate([np.arange(b * block, (b + 1) * block)
                          for b in kept])
    idx = idx[idx < skv]
    t = torch.as_tensor(idx, device=k.device)
    return k.index_select(2, t), v.index_select(2, t), idx


@functools.lru_cache(maxsize=64)
def _decode_keep_mask(skv: int, params: PerforationParams,
                      device: torch.device) -> torch.Tensor:
    """The (S_cache,) mask of kept KV blocks at decode, built once per
    cache length and spec: dropped 128-blocks masked, the tail beyond whole
    blocks kept."""
    nblocks = max(skv // KV_BLOCK, 1)
    keep = np.zeros((skv,), bool)
    for kb in kept_indices(nblocks, params):
        keep[kb * KV_BLOCK:(kb + 1) * KV_BLOCK] = True
    keep[skv - skv % KV_BLOCK:] = True
    return torch.as_tensor(keep, device=device)


def _attend(p, q, k, v, b: int, s: int, causal: bool,
            approx: Optional[ApproxSpec]):
    kk, vv, kv_pos = _maybe_perforate_kv(k, v, approx)
    ctx = common.chunked_attention(q, kk, vv, causal=causal,
                                   kv_positions=kv_pos)
    ctx = ctx.transpose(1, 2).reshape(b, s, -1)
    return ctx @ p["wo"]


def forward(p, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
            causal: bool = True,
            approx: Optional[ApproxSpec] = None) -> torch.Tensor:
    """Self-attention over a full sequence (train / prefill)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, positions)
    return _attend(p, q, k, v, b, s, causal, approx)


def init_cache(cfg: ModelConfig, n_layers: int, batch: int, max_len: int,
               dtype, device=None) -> Dict:
    """The decode cache of `n_layers` layers, every leaf stacked on a
    leading layer axis (the JAX model's vmapped per-layer caches)."""
    hd = cfg.resolved_head_dim
    shape = (n_layers, batch, cfg.n_kv_heads, max_len, hd)
    if cfg.kv_cache_dtype == "int8":
        sshape = (n_layers, batch, cfg.n_kv_heads, max_len, 1)
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(sshape, dtype=torch.bfloat16,
                                   device=device),
            "v_scale": torch.zeros(sshape, dtype=torch.bfloat16,
                                   device=device),
        }
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _quantize_kv(x: torch.Tensor):
    """Symmetric per-(b, h, s) int8 quantization of K/V rows."""
    xf = x.float()
    m = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(m, min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def prefill(p, cfg: ModelConfig, x: torch.Tensor, cache: Dict,
            approx: Optional[ApproxSpec] = None
            ) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence forward that also fills cache[..., 0:S, :] in place."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(p, cfg, x, positions)
    out = _attend(p, q, k, v, b, s, True, approx)
    if cfg.kv_cache_dtype == "int8":
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        for name, val in (("k", kq), ("v", vq), ("k_scale", ks),
                          ("v_scale", vs)):
            cache[name][:, :, :s].copy_(val)
        return out, cache
    cache["k"][:, :, :s].copy_(k)
    cache["v"][:, :, :s].copy_(v)
    return out, cache


def _decode_step_int8(p, cfg: ModelConfig, q, k, v, x, cache: Dict,
                      pos: int) -> Tuple[torch.Tensor, Dict]:
    """int8-KV decode: the cache stores int8 rows and per-(b, h, s) scales;
    logits and context absorb the scales exactly:
      logits[.., s] = (q . k_int8[s]) * k_scale[s]
      ctx = sum_s (p[s] * v_scale[s]) * v_int8[s]
    """
    b = x.shape[0]
    kq, ks = _quantize_kv(k)
    vq, vs = _quantize_kv(v)
    for name, val in (("k", kq), ("v", vq), ("k_scale", ks),
                      ("v_scale", vs)):
        cache[name][:, :, pos:pos + 1].copy_(val)
    ck, cv, cks, cvs = (cache["k"], cache["v"], cache["k_scale"],
                        cache["v_scale"])
    hq, hkv, d = q.shape[1], ck.shape[1], q.shape[-1]
    group = hq // hkv
    skv = ck.shape[2]
    scale = 1.0 / (d ** 0.5)
    qg = q.reshape(b, hkv, group, d)
    logits = common._dot_f32(qg, ck.to(q.dtype).transpose(-1, -2))
    logits = logits * cks[:, :, None, :, 0].float() * scale
    mask = torch.arange(skv, device=x.device) <= pos
    logits = torch.where(mask, logits, -1e30)
    m = logits.amax(dim=-1, keepdim=True)
    pr = torch.exp(logits - m)
    pr = torch.where(mask, pr, 0.0)
    l = pr.sum(dim=-1, keepdim=True)
    pv = (pr * cvs[:, :, None, :, 0].float()).to(q.dtype)
    ctx = common._dot_f32(pv, cv.to(q.dtype)) / torch.clamp(l, min=1e-30)
    ctx = ctx.reshape(b, hq, 1, d).to(x.dtype)
    ctx = ctx.transpose(1, 2).reshape(b, 1, -1)
    return ctx @ p["wo"], cache


def decode_step(p, cfg: ModelConfig, x: torch.Tensor, cache: Dict, pos: int,
                approx: Optional[ApproxSpec] = None
                ) -> Tuple[torch.Tensor, Dict]:
    """One-token decode: x (B, 1, d); writes the cache at `pos` (a host
    int), attends to [0, pos]. Linear in cache length."""
    b = x.shape[0]
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, cfg, x, positions)
    if cfg.kv_cache_dtype == "int8":
        return _decode_step_int8(p, cfg, q, k, v, x, cache, pos)
    cache["k"][:, :, pos:pos + 1].copy_(k)
    cache["v"][:, :, pos:pos + 1].copy_(v)
    keep_mask = None
    if approx is not None and approx.technique == Technique.PERFORATION:
        keep_mask = _decode_keep_mask(cache["k"].shape[2],
                                      approx.perforation, x.device)
    ctx = common.decode_attention(q, cache["k"], cache["v"],
                                  valid_len=pos + 1, keep_mask=keep_mask)
    ctx = ctx.transpose(1, 2).reshape(b, 1, -1)
    return ctx @ p["wo"], cache
