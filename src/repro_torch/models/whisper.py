"""Whisper-large-v3 backbone: encoder-decoder transformer (port of
`repro.models.whisper`).

The conv frontend is a STUB: the batch carries precomputed log-mel frame
embeddings `frames` (B, S_enc, d_model); the encoder runs bidirectional
attention over them, the decoder causal self-attention (with a KV cache at
decode) and cross-attention over the encoder memory. Prefill keeps the
memory in the cache, padded to `max_source_positions`; decode attends
over all of it and recomputes the cross K/V from it every step, as the
JAX model does.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..configs.base import ModelConfig
from . import attention, common, lm, mlp


def _init_enc_block(generator, cfg: ModelConfig, hold) -> Dict:
    return {
        "ln1": common.norm_params("ln", cfg.d_model, hold),
        "attn": attention.init_params(generator, cfg, hold),
        "ln2": common.norm_params("ln", cfg.d_model, hold),
        "ffn": mlp.init_params(generator, cfg.d_model, cfg.d_ff, "gelu",
                               hold),
    }


def _init_dec_block(generator, cfg: ModelConfig, hold) -> Dict:
    return {
        "ln1": common.norm_params("ln", cfg.d_model, hold),
        "self_attn": attention.init_params(generator, cfg, hold),
        "ln_x": common.norm_params("ln", cfg.d_model, hold),
        "cross_attn": attention.init_params(generator, cfg, hold),
        "ln2": common.norm_params("ln", cfg.d_model, hold),
        "ffn": mlp.init_params(generator, cfg.d_model, cfg.d_ff, "gelu",
                               hold),
    }


def _enc_block(p, cfg: ModelConfig, x, positions):
    h = common.layernorm(p["ln1"], x, cfg.norm_eps)
    x = common.residual(x, attention.forward(
        p["attn"], cfg, h, positions, causal=False,
        approx=cfg.approx_attention))
    h = common.layernorm(p["ln2"], x, cfg.norm_eps)
    return common.residual(x, mlp.forward(p["ffn"], cfg, h, "gelu",
                                          approx=cfg.approx_ffn))


def _memory_proj(memory, w):
    """`memory @ w`. A DTensor memory whose frames are split (the decode
    cache splits them where its model ranks divide them) multiplies shard
    by shard (`common.by_shard`), so that they stay split: DTensor's
    product flattens them into the batch, which torch 2.11 refuses for a
    split dim."""
    if any(p.is_shard() and p.dim % memory.ndim == 1
           for p in getattr(memory, "placements", ())):
        return common.by_shard(torch.matmul, "bsd,de->bse", memory, w,
                               free="bse")
    return memory @ w


def _cross_attention(p, cfg: ModelConfig, x, memory):
    """Queries from the decoder's x; K/V from the encoder memory (no mask,
    no rotary embedding)."""
    hd = cfg.resolved_head_dim
    q = common.split_heads(x @ p["wq"], cfg.n_heads, hd).transpose(1, 2)
    k = common.split_heads(_memory_proj(memory, p["wk"]), cfg.n_kv_heads,
                           hd).transpose(1, 2)
    v = common.split_heads(_memory_proj(memory, p["wv"]), cfg.n_kv_heads,
                           hd).transpose(1, 2)
    ctx = common.chunked_attention(q, k, v, causal=False)
    return common.merge_dims(ctx.transpose(1, 2), 2) @ p["wo"]


def _dec_tail(p, cfg: ModelConfig, x, memory, approx_ffn=None):
    """A decoder block after its self-attention: cross-attention and FFN."""
    h = common.layernorm(p["ln_x"], x, cfg.norm_eps)
    x = common.residual(x, _cross_attention(p["cross_attn"], cfg, h, memory))
    h = common.layernorm(p["ln2"], x, cfg.norm_eps)
    return common.residual(x, mlp.forward(p["ffn"], cfg, h, "gelu",
                                          approx=approx_ffn))


class Whisper(lm.Model):
    """The encoder-decoder on one device. Its batches carry `frames`."""

    STACKS = {("enc_blocks",): 1, ("dec_blocks",): 1}

    def _draw(self, generator: torch.Generator, hold) -> Dict:
        cfg = self.cfg
        return {
            "embed": self._embed_init(generator, hold),
            "enc_blocks": [_init_enc_block(generator, cfg, hold)
                           for _ in range(cfg.n_layers)],
            "dec_blocks": [_init_dec_block(generator, cfg, hold)
                           for _ in range(cfg.n_layers)],
            "enc_norm": common.norm_params("ln", cfg.d_model, hold),
            "dec_norm": common.norm_params("ln", cfg.d_model, hold),
            "head": self._head_init(generator, hold),
        }

    def encode(self, params, frames, remat: bool = False) -> torch.Tensor:
        """The encoder memory (B, S_enc, d) of `frames`; under `remat`
        each block is recomputed in backward."""
        cfg = self.cfg
        x = torch.as_tensor(frames, device=self.device).to(self.cdt)
        x = x + common.sinusoidal_positions(
            x.shape[1], cfg.d_model, self.device).to(self.cdt)[None]
        positions = torch.arange(x.shape[1], device=self.device)
        for lp in params["enc_blocks"]:
            x = common.remat(remat, _enc_block, lp, cfg, x, positions)
        return common.layernorm(params["enc_norm"], x, cfg.norm_eps)

    def _hidden(self, params, batch, remat: bool) -> torch.Tensor:
        cfg = self.cfg
        memory = self.encode(params, batch["frames"], remat)
        x = common.embed_rows(params["embed"], self._tokens(batch["tokens"]))
        positions = torch.arange(x.shape[1], device=self.device)

        def block(lp, h, mem):
            hh = common.layernorm(lp["ln1"], h, cfg.norm_eps)
            h = common.residual(h, attention.forward(
                lp["self_attn"], cfg, hh, positions, causal=True,
                approx=cfg.approx_attention))
            return _dec_tail(lp, cfg, h, mem, approx_ffn=cfg.approx_ffn)

        for lp in params["dec_blocks"]:
            x = common.remat(remat, block, lp, x, memory)
        return common.layernorm(params["dec_norm"], x, cfg.norm_eps)

    def _cache(self, batch_size: int, max_len: int, new) -> Dict:
        cfg = self.cfg
        return {
            "self": attention.init_cache(cfg, cfg.n_layers, batch_size,
                                         max_len, self.cdt, new=new),
            # the encoder memory, computed at prefill and kept
            "memory": new((batch_size, cfg.max_source_positions,
                           cfg.d_model), self.cdt),
        }

    def prefill(self, params, batch, mesh=None) -> Tuple[torch.Tensor, Dict]:
        cfg = self.cfg
        memory = self.encode(params, batch["frames"])
        x = common.embed_rows(params["embed"], self._tokens(batch["tokens"]))
        cache = self.init_cache(x.shape[0], batch["max_len"], mesh)
        common.write_rows(cache["memory"], memory, 1)
        for l, lp in enumerate(params["dec_blocks"]):
            h = common.layernorm(lp["ln1"], x, cfg.norm_eps)
            out, _ = attention.prefill(lp["self_attn"], cfg, h,
                                       lm.layer_view(cache["self"], l))
            x = _dec_tail(lp, cfg, common.residual(x, out), memory)
        x = common.layernorm(params["dec_norm"], x, cfg.norm_eps)
        return self._logits(params, x[:, -1]), cache

    def decode_step(self, params, cache: Dict, tokens: torch.Tensor,
                    pos: int) -> Tuple[torch.Tensor, Dict]:
        cfg = self.cfg
        x = common.embed_rows(params["embed"], tokens[:, None].long())
        # the memory made whole along d_model once for every layer, as
        # GSPMD gathers it ahead of the layer loop: a memory split there
        # makes DTensor move wk / wv to rows (a Shard-to-Shard move) and
        # all-reduce each layer's K / V of every head
        memory = common.unshard(cache["memory"], -1)
        for l, lp in enumerate(params["dec_blocks"]):
            h = common.layernorm(lp["ln1"], x, cfg.norm_eps)
            out, _ = attention.decode_step(
                lp["self_attn"], cfg, h, lm.layer_view(cache["self"], l),
                pos, approx=cfg.approx_decode)
            x = _dec_tail(lp, cfg, common.residual(x, out), memory)
        x = common.layernorm(params["dec_norm"], x, cfg.norm_eps)
        return self._logits(params, x[:, 0]), cache
