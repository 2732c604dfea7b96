"""Decoder blocks: pre-norm attention (GQA or MLA) + FFN / MoE residual,
and the zamba2 hybrid grouping (port of `repro.models.blocks`).

A block's attention cache is a view of the model's stacked cache; the
attention modules write it in place.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..core.types import ApproxSpec
from . import attention, common, mamba2, mla, mlp, moe


def d_ff_dense(cfg: ModelConfig) -> int:
    """The FFN width of a dense block: the MoE config's `d_ff_dense` for
    the leading dense layers of an MoE model, else `d_ff`."""
    return cfg.moe.d_ff_dense if (cfg.moe and cfg.moe.d_ff_dense) \
        else cfg.d_ff


def init_block(generator: torch.Generator, cfg: ModelConfig, hold,
               use_moe: bool = False) -> Dict:
    p = {
        "ln1": common.norm_params(cfg.norm, cfg.d_model, hold),
        "ln2": common.norm_params(cfg.norm, cfg.d_model, hold),
        "attn": (mla if cfg.use_mla else attention).init_params(
            generator, cfg, hold),
    }
    if use_moe:
        p["moe"] = moe.init_params(generator, cfg, hold)
    else:
        p["ffn"] = mlp.init_params(generator, cfg.d_model, d_ff_dense(cfg),
                                   cfg.mlp, hold)
    return p


def _ffn(p: Dict, cfg: ModelConfig, h, approx_ffn):
    """The block's FFN output and its aux loss (0 for a dense FFN)."""
    if "moe" in p:
        return moe.forward(p["moe"], cfg, h, approx=approx_ffn)
    return mlp.forward(p["ffn"], cfg, h, cfg.mlp, approx=approx_ffn), None


def block_forward(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor,
                  approx_attn: Optional[ApproxSpec] = None,
                  approx_ffn: Optional[ApproxSpec] = None,
                  causal: bool = True) -> Tuple[torch.Tensor, object]:
    """Returns (x, aux_loss); aux_loss is None for a dense block. FSDP's
    weights are gathered for the block (`common.gather_fsdp`). A stream
    split along d_model (deepseek-v3's MTP block) stays split through the
    norms and the adds, and each sublayer gets its normed input whole
    (`common.whole_along`, `common.residual`)."""
    p = common.gather_fsdp(p, x)
    h = common.apply_norm(cfg.norm, p["ln1"], x, cfg.norm_eps)
    attn_mod = mla if cfg.use_mla else attention
    x = common.residual(x, attn_mod.forward(
        p["attn"], cfg, common.whole_along(h, -1), positions, causal=causal,
        approx=approx_attn))
    h = common.apply_norm(cfg.norm, p["ln2"], x, cfg.norm_eps)
    out, aux = _ffn(p, cfg, common.whole_along(h, -1), approx_ffn)
    return common.residual(x, out), aux


def block_prefill(p: Dict, cfg: ModelConfig, x, cache,
                  approx_attn=None, approx_ffn=None):
    h = common.apply_norm(cfg.norm, p["ln1"], x, cfg.norm_eps)
    attn_mod = mla if cfg.use_mla else attention
    out, cache = attn_mod.prefill(p["attn"], cfg, h, cache,
                                  approx=approx_attn)
    x = common.residual(x, out)
    h = common.apply_norm(cfg.norm, p["ln2"], x, cfg.norm_eps)
    return common.residual(x, _ffn(p, cfg, h, approx_ffn)[0]), cache


def block_decode(p: Dict, cfg: ModelConfig, x, cache, pos: int,
                 approx_attn=None, approx_ffn=None):
    h = common.apply_norm(cfg.norm, p["ln1"], x, cfg.norm_eps)
    attn_mod = mla if cfg.use_mla else attention
    out, cache = attn_mod.decode_step(p["attn"], cfg, h, cache, pos,
                                      approx=approx_attn)
    x = common.residual(x, out)
    h = common.apply_norm(cfg.norm, p["ln2"], x, cfg.norm_eps)
    return common.residual(x, _ffn(p, cfg, h, approx_ffn)[0]), cache


def init_block_cache(cfg: ModelConfig, n_layers: int, batch: int,
                     max_len: int, dtype, device=None, new=None) -> Dict:
    attn_mod = mla if cfg.use_mla else attention
    return attn_mod.init_cache(cfg, n_layers, batch, max_len, dtype, device,
                               new)


# ----------------------------------------------------------------------------
# zamba2 hybrid: groups of (attn_period-1) mamba layers + 1 SHARED attn block
# ----------------------------------------------------------------------------

def hybrid_layout(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(n_groups, mamba_per_group, n_tail_mamba): n_layers =
    n_groups*(mamba_per_group+1) + tail; shared attn applied once per
    group."""
    period = cfg.hybrid.attn_period
    n_groups = cfg.n_layers // period
    mamba_per_group = period - 1
    tail = cfg.n_layers - n_groups * period
    return n_groups, mamba_per_group, tail


def init_hybrid(generator: torch.Generator, cfg: ModelConfig, hold) -> Dict:
    """{"main": n_groups lists of mamba_per_group mixer layers, "tail": a
    list of the tail's layers (None without one), "shared_attn": ONE
    attention block applied once per group}."""
    n_groups, mpg, tail = hybrid_layout(cfg)

    def one_mamba():
        # Zamba2 mamba blocks are MIXER-ONLY (no per-layer MLP); the d_ff
        # MLP lives in the single SHARED attention block.
        return {"ln": common.norm_params(cfg.norm, cfg.d_model, hold),
                "mixer": mamba2.init_params(generator, cfg, hold)}

    main = [[one_mamba() for _ in range(mpg)] for _ in range(n_groups)]
    tail_p = [one_mamba() for _ in range(tail)] if tail else None
    return {"main": main, "tail": tail_p,
            "shared_attn": init_block(generator, cfg, hold)}


def mamba_sublayer(p, cfg: ModelConfig, x, approx_ffn=None):
    del approx_ffn  # mamba blocks have no FFN (zamba2 layout)
    h = common.apply_norm(cfg.norm, p["ln"], x, cfg.norm_eps)
    return common.residual(x, mamba2.forward(p["mixer"], cfg, h))


def mamba_sublayer_prefill(p, cfg: ModelConfig, x, approx_ffn=None):
    """Full-sequence sublayer that also emits the decode state (the
    prefill -> decode handoff)."""
    del approx_ffn
    h = common.apply_norm(cfg.norm, p["ln"], x, cfg.norm_eps)
    out, state = mamba2.forward(p["mixer"], cfg, h, return_state=True)
    return common.residual(x, out), state


def mamba_sublayer_decode(p, cfg: ModelConfig, x, cache, approx_ffn=None):
    del approx_ffn
    h = common.apply_norm(cfg.norm, p["ln"], x, cfg.norm_eps)
    out, new_cache = mamba2.decode_step(p["mixer"], cfg, h, cache)
    return common.residual(x, out), new_cache
