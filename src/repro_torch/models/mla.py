"""Multi-head Latent Attention (DeepSeek-V2/V3) (port of `repro.models.mla`).

Queries and KV are low-rank compressed; the KV cache stores ONLY the
compressed latent (kv_lora_rank) plus the shared rope key
(qk_rope_head_dim) per position. Prefill expands the latent to per-head K
and V; decode is the ABSORBED form (W_uk folded into the query, W_uv
applied after the softmax), so K/V are never expanded at decode.

The cache is written IN PLACE at the decoded position, as the port's
attention cache is.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..configs.base import ModelConfig
from . import common


def init_params(generator: torch.Generator, cfg: ModelConfig, hold) -> Dict:
    m = cfg.mla
    d = cfg.d_model
    h = cfg.n_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim

    def dense(name, shape):
        return hold(name, common.dense_init(generator, shape))

    return {
        "w_dq": dense("w_dq", (d, m.q_lora_rank)),
        "q_norm": common.rmsnorm_params(m.q_lora_rank, hold),
        "w_uq": dense("w_uq", (m.q_lora_rank, h * qk_head)),
        "w_dkv": dense("w_dkv", (d, m.kv_lora_rank + m.qk_rope_head_dim)),
        "kv_norm": common.rmsnorm_params(m.kv_lora_rank, hold),
        "w_uk": dense("w_uk", (m.kv_lora_rank, h * m.qk_nope_head_dim)),
        "w_uv": dense("w_uv", (m.kv_lora_rank, h * m.v_head_dim)),
        "wo": dense("wo", (h * m.v_head_dim, d)),
    }


def _queries(p, cfg: ModelConfig, x, positions):
    m = cfg.mla
    # under FSDP the latent's two uses in its norm get gradients back in
    # layouts whose sum DTensor cannot redistribute: pinned
    cq = common.rmsnorm(p["q_norm"], x @ p["w_dq"], cfg.norm_eps, pin=True)
    # the latent made whole before the column-split up-projection (an
    # all-gather of (B, S, q_lora_rank), as GSPMD plans it; DTensor would
    # move the weight and all-reduce the heads' whole queries)
    q = common.split_heads(common.unshard(cq, -1) @ p["w_uq"], cfg.n_heads,
                           m.qk_nope_head_dim + m.qk_rope_head_dim)
    q = q.transpose(1, 2)
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = common.apply_rope(q[..., m.qk_nope_head_dim:], positions,
                               cfg.rope_theta)
    return torch.cat([q_nope, q_rope], dim=-1)


def _latent(p, cfg: ModelConfig, x, positions):
    """Compressed latent ckv (B,S,R) + shared rope key (B,1,S,rope_d)."""
    m = cfg.mla
    dkv = x @ p["w_dkv"]
    ckv = common.rmsnorm(p["kv_norm"], dkv[..., :m.kv_lora_rank],
                         cfg.norm_eps)
    k_rope = dkv[..., m.kv_lora_rank:][:, None]
    k_rope = common.apply_rope(k_rope, positions, cfg.rope_theta)
    return ckv, k_rope


def _expand_kv(p, cfg: ModelConfig, ckv, k_rope):
    """Expand the latent to per-head K (nope||rope) and V."""
    m = cfg.mla
    b, s, _ = ckv.shape
    h = cfg.n_heads
    # ckv feeds two products: each one's gradient comes back in ckv's
    # layout before they are added
    k_nope = common.split_heads(common.pin_grad(ckv) @ p["w_uk"], h,
                                m.qk_nope_head_dim)
    v = common.split_heads(common.pin_grad(ckv) @ p["w_uv"], h,
                           m.v_head_dim).transpose(1, 2)
    k_rope_b = k_rope.expand(b, h, s, m.qk_rope_head_dim)
    k = torch.cat([k_nope.transpose(1, 2), k_rope_b], dim=-1)
    return k, v


def _attend(p, cfg: ModelConfig, x, positions, causal: bool):
    # x feeds two products (with FSDP weights under training): each one's
    # gradient comes back in x's layout before they are added
    q = _queries(p, cfg, common.pin_grad(x), positions)
    ckv, k_rope = _latent(p, cfg, common.pin_grad(x), positions)
    k, v = _expand_kv(p, cfg, ckv, k_rope)
    ctx = common.chunked_attention(q, k, v, causal=causal)
    return common.merge_dims(ctx.transpose(1, 2), 2) @ p["wo"], ckv, k_rope


def forward(p, cfg: ModelConfig, x: torch.Tensor, positions,
            causal: bool = True, approx=None) -> torch.Tensor:
    return _attend(p, cfg, x, positions, causal)[0]


def init_cache(cfg: ModelConfig, n_layers: int, batch: int, max_len: int,
               dtype, device=None, new=None) -> Dict:
    """The latent cache of `n_layers` layers, stacked on a leading axis,
    each leaf made by `new(shape, dtype)` (zeros on `device` by
    default)."""
    new = new or common.leaf_maker(device)
    m = cfg.mla
    return {
        "ckv": new((n_layers, batch, max_len, m.kv_lora_rank), dtype),
        "k_rope": new((n_layers, batch, 1, max_len, m.qk_rope_head_dim),
                      dtype),
    }


def prefill(p, cfg: ModelConfig, x, cache,
            approx=None) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence forward that also fills the latent cache[0:S] in
    place."""
    s = x.shape[1]
    out, ckv, k_rope = _attend(p, cfg, x, torch.arange(s, device=x.device),
                               True)
    common.write_rows(cache["ckv"], ckv, 1)
    common.write_rows(cache["k_rope"], k_rope, 2)
    return out, cache


def decode_step(p, cfg: ModelConfig, x, cache, pos: int,
                approx=None) -> Tuple[torch.Tensor, Dict]:
    """ABSORBED MLA decode:

      logits[s] = (q_nope W_uk) . ckv[s] + q_rope . k_rope[s]
      ctx       = (softmax . ckv) W_uv

    The logit and context products run in float32 (the JAX module's
    `preferred_element_type`); positions after `pos` are masked with
    -1e30."""
    m = cfg.mla
    h = cfg.n_heads
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q = _queries(p, cfg, x, positions)                        # (B,H,1,qk)
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = q[..., m.qk_nope_head_dim:]
    ckv_t, k_rope_t = _latent(p, cfg, x, positions)
    common.write_rows(cache["ckv"], ckv_t, 1, pos)
    common.write_rows(cache["k_rope"], k_rope_t, 2, pos)
    ckv = cache["ckv"].to(x.dtype)                            # (B,S,R)
    k_rope = cache["k_rope"].to(x.dtype)[:, 0]                # (B,S,rd)
    skv = ckv.shape[1]
    # absorb W_uk into the query: (R, H*nope) -> (H, nope, R)
    w_uk = common.split_dim(p["w_uk"], 1, (h, m.qk_nope_head_dim))
    q_lat = common.shard_einsum("bhqd,rhd->bhqr", q_nope, w_uk)  # (B,H,1,R)
    logits = common.shard_einsum("bhqr,bsr->bhqs", q_lat.float(),
                                 ckv.float())
    logits = logits + common.shard_einsum("bhqd,bsd->bhqs", q_rope.float(),
                                          k_rope.float())
    logits = logits / ((m.qk_nope_head_dim + m.qk_rope_head_dim) ** 0.5)
    mask = torch.arange(skv, device=x.device) <= pos
    logits = torch.where(mask, logits, -1e30)
    mx = logits.amax(dim=-1, keepdim=True)
    pr = torch.exp(logits - mx)
    l = pr.sum(dim=-1, keepdim=True)
    ctx_lat = common.shard_einsum("bhqs,bsr->bhqr",
                                  pr.to(x.dtype).float(), ckv.float())
    ctx_lat = (ctx_lat / torch.clamp(l, min=1e-30)).to(x.dtype)
    # absorb W_uv on the way out: (R, H*dv) -> (H, R, dv)
    w_uv = common.split_dim(p["w_uv"], 1, (h, m.v_head_dim))
    ctx = common.shard_einsum("bhqr,rhd->bhqd", ctx_lat, w_uv)  # (B,H,1,dv)
    return common.merge_dims(ctx.transpose(1, 2), 2) @ p["wo"], cache
