"""The dense decoder block: pre-norm attention + FFN residual (port of the
dense part of `repro.models.blocks`).

The JAX module's MoE, MLA and zamba2-hybrid parts come with the model zoo
(ROADMAP Queue 1 item 6).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..configs.base import ModelConfig
from ..core.types import ApproxSpec
from . import attention, common, mlp


def init_block(generator: torch.Generator, cfg: ModelConfig, dtype,
               device=None, norm_dtype=torch.float32) -> Dict:
    return {
        "ln1": common.norm_params(cfg.norm, cfg.d_model, norm_dtype, device),
        "ln2": common.norm_params(cfg.norm, cfg.d_model, norm_dtype, device),
        "attn": attention.init_params(generator, cfg, dtype, device,
                                      norm_dtype),
        "ffn": mlp.init_params(generator, cfg.d_model, cfg.d_ff, cfg.mlp,
                               dtype, device),
    }


def block_forward(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor,
                  approx_attn: Optional[ApproxSpec] = None,
                  approx_ffn: Optional[ApproxSpec] = None,
                  causal: bool = True) -> torch.Tensor:
    h = common.apply_norm(cfg.norm, p["ln1"], x, cfg.norm_eps)
    x = x + attention.forward(p["attn"], cfg, h, positions, causal=causal,
                              approx=approx_attn)
    h = common.apply_norm(cfg.norm, p["ln2"], x, cfg.norm_eps)
    return x + mlp.forward(p["ffn"], cfg, h, cfg.mlp, approx=approx_ffn)


def block_prefill(p: Dict, cfg: ModelConfig, x, cache,
                  approx_attn=None, approx_ffn=None):
    h = common.apply_norm(cfg.norm, p["ln1"], x, cfg.norm_eps)
    out, cache = attention.prefill(p["attn"], cfg, h, cache,
                                   approx=approx_attn)
    x = x + out
    h = common.apply_norm(cfg.norm, p["ln2"], x, cfg.norm_eps)
    return x + mlp.forward(p["ffn"], cfg, h, cfg.mlp, approx=approx_ffn), cache


def block_decode(p: Dict, cfg: ModelConfig, x, cache, pos: int,
                 approx_attn=None, approx_ffn=None):
    h = common.apply_norm(cfg.norm, p["ln1"], x, cfg.norm_eps)
    out, cache = attention.decode_step(p["attn"], cfg, h, cache, pos,
                                       approx=approx_attn)
    x = x + out
    h = common.apply_norm(cfg.norm, p["ln2"], x, cfg.norm_eps)
    return x + mlp.forward(p["ffn"], cfg, h, cfg.mlp, approx=approx_ffn), cache


def init_block_cache(cfg: ModelConfig, n_layers: int, batch: int,
                     max_len: int, dtype, device=None) -> Dict:
    return attention.init_cache(cfg, n_layers, batch, max_len, dtype, device)
