"""Causal LM assembly for the dense family, with decode-time TAF (port of
`repro.models.lm`).

`build(cfg, device=None)` returns a `Model` whose methods are the JAX
`Model`'s bound functions: `init`, `hidden`, `init_cache`, `prefill` and
`decode_step`. The layer loop is a Python loop over a list of per-layer
parameter dicts; the decode cache stacks every layer on a leading axis, as
the JAX model's vmapped caches do.

Weights are held in the dtype they are used in: every matrix and the
embedding in `compute_dtype` (the values JAX's per-use `.astype(cdt)`
gives, cast once here instead of at every use), norm scales in
`param_dtype`.

Decode-time TAF (paper section 3.1.3 as a serving feature): with
cfg.approx_decode = TAF, each layer carries a TAF state machine across
decode steps; while a layer's recent output deltas are RSD-stable the
layer is SKIPPED and its memoized delta and stale K/V are reused. JAX
branches on the device (`lax.cond`); here the branch is on the host: a
decode step reads the `(n_layers,)` `remaining` vector ONCE at its start
(one count in `obs.metrics.HOST_READS`) and then runs no computation of a
skipped layer at all -- its only kernel is the residual add of its
memoized delta. A computed layer adds three kernels (its delta memoized,
the delta's sum); every layer's detector, counters and stale K/V then
step together in a fixed handful of kernels at the end of the step. The RSD threshold
rides in the cache as data, so the QoS plane moves it between ticks with a
tensor write.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .. import device as device_mod
from ..configs.base import ModelConfig
from ..core.types import Technique
from ..obs import metrics as obs_metrics
from . import blocks, common

ZOO_ITEM = "ROADMAP Queue 1 item 6 (model zoo and training)"

# Each cache leaf's batch axis (None: the leaf has none). The serving
# engine's lane splice reads it instead of inferring the axis from shapes.
CACHE_BATCH_AXES = {
    ("dense", "k"): 1, ("dense", "v"): 1,
    ("dense", "k_scale"): 1, ("dense", "v_scale"): 1,
    ("taf", "threshold"): None, ("taf", "window"): None,
    ("taf", "filled"): None, ("taf", "remaining"): None,
    ("taf", "memo_delta"): 1, ("taf", "memo_k"): 1, ("taf", "memo_v"): 1,
}


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


class Model:
    """The dense causal LM of one config on one device."""

    def __init__(self, cfg: ModelConfig, device=None):
        self.cfg = cfg
        self.device = device_mod.resolve(device)
        self.pdt = _dtype(cfg.param_dtype)
        self.cdt = _dtype(cfg.compute_dtype)
        if self.taf_enabled and cfg.kv_cache_dtype == "int8":
            raise ValueError(
                "decode-time TAF memoizes K/V rows in the compute dtype; the "
                "int8 KV cache has no such rows (the JAX model cannot trace "
                "this combination either)")

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------

    @property
    def taf_enabled(self) -> bool:
        return self.cfg.approx_decode.technique == Technique.TAF

    def _as_used(self, t: torch.Tensor) -> torch.Tensor:
        """A weight as JAX uses it: stored in param_dtype, cast to
        compute_dtype."""
        return t.to(self.pdt).to(self.cdt)

    def init(self, generator: torch.Generator) -> Dict:
        """Parameters drawn from `generator` (on its device), with the JAX
        package's init scales, on the model's device."""
        cfg, dev = self.cfg, self.device

        def used(t):
            return self._as_used(t.to(dev))

        p: Dict = {
            "embed": used(common.embed_init(
                generator, (cfg.padded_vocab_size, cfg.d_model))),
            "final_norm": common.norm_params(cfg.norm, cfg.d_model, self.pdt,
                                             dev),
        }
        if not cfg.tie_embeddings:
            p["head"] = used(common.dense_init(
                generator, (cfg.d_model, cfg.padded_vocab_size)))
        layers = []
        for _ in range(cfg.n_layers):
            lp = blocks.init_block(generator, cfg, torch.float32, dev,
                                   self.pdt)
            for sub in ("attn", "ffn"):
                lp[sub] = {k: (used(v) if k.startswith(("w", "b")) else v)
                           for k, v in lp[sub].items()}
            layers.append(lp)
        p["dense_blocks"] = layers
        return p

    def _head_w(self, params) -> torch.Tensor:
        return (params["embed"].T if self.cfg.tie_embeddings
                else params["head"])

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    # ------------------------------------------------------------------
    # full-sequence paths
    # ------------------------------------------------------------------

    def hidden(self, params, batch) -> torch.Tensor:
        """(B, S, d) final hidden states of `batch["tokens"]`."""
        cfg = self.cfg
        x = params["embed"][self._tokens(batch["tokens"])]
        positions = torch.arange(x.shape[1], device=self.device)
        for lp in params["dense_blocks"]:
            x = blocks.block_forward(lp, cfg, x, positions,
                                     approx_attn=cfg.approx_attention,
                                     approx_ffn=cfg.approx_ffn)
        return common.apply_norm(cfg.norm, params["final_norm"], x,
                                 cfg.norm_eps)

    def init_cache(self, batch_size: int, max_len: int) -> Dict:
        cfg = self.cfg
        cache = {"dense": blocks.init_block_cache(
            cfg, cfg.n_layers, batch_size, max_len, self.cdt, self.device)}
        if self.taf_enabled:
            cache["taf"] = self._taf_init_cache(batch_size)
        return cache

    def prefill(self, params, batch) -> Tuple[torch.Tensor, Dict]:
        """(last-position logits (B, V) float32, a fresh cache of
        `batch["max_len"]` positions holding the prompt's K/V)."""
        cfg = self.cfg
        x = params["embed"][self._tokens(batch["tokens"])]
        cache = self.init_cache(x.shape[0], batch["max_len"])
        kv = cache["dense"]
        for l, lp in enumerate(params["dense_blocks"]):
            x, _ = blocks.block_prefill(
                lp, cfg, x, {k: t[l] for k, t in kv.items()},
                approx_attn=cfg.approx_attention, approx_ffn=cfg.approx_ffn)
        x = common.apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
        return (x[:, -1] @ self._head_w(params)).float(), cache

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------

    def _taf_init_cache(self, batch_size: int) -> Dict:
        cfg, dev = self.cfg, self.device
        t = cfg.approx_decode.taf
        n = cfg.n_layers
        hd = cfg.resolved_head_dim
        return {
            # the RSD threshold, one scalar per layer, as data the QoS plane
            # writes between ticks (never a rebuild)
            "threshold": torch.full((n,), t.rsd_threshold,
                                    dtype=torch.float32, device=dev),
            "window": torch.zeros((n, t.history_size), dtype=torch.float32,
                                  device=dev),
            "filled": torch.zeros((n,), dtype=torch.int32, device=dev),
            "remaining": torch.zeros((n,), dtype=torch.int32, device=dev),
            "memo_delta": torch.zeros((n, batch_size, cfg.d_model),
                                      dtype=torch.float32, device=dev),
            "memo_k": torch.zeros((n, batch_size, cfg.n_kv_heads, 1, hd),
                                  dtype=self.cdt, device=dev),
            "memo_v": torch.zeros((n, batch_size, cfg.n_kv_heads, 1, hd),
                                  dtype=self.cdt, device=dev),
        }

    def _decode_layer_taf(self, lp, l: int, kv: Dict, taf: Dict, sums, x,
                          pos: int):
        """The accurate branch of block-level TAF around one layer: compute
        the layer and memoize its output delta (rounded in the compute
        dtype, as JAX's `new_x - x`) and the delta's sum. The detector
        step that reads them runs for every computed layer at once at the
        end of the decode step (`_taf_step`): nothing reads it before the
        next step."""
        cfg = self.cfg
        new_x, _ = blocks.block_decode(
            lp, cfg, x, {k: c[l] for k, c in kv.items()}, pos,
            approx_attn=cfg.approx_attention, approx_ffn=cfg.approx_ffn)
        delta = taf["memo_delta"][l]
        delta.copy_((new_x - x)[:, 0, :])
        torch.sum(delta.view(-1), dim=0, out=sums[l])
        return new_x

    def _taf_step(self, kv: Dict, taf: Dict, sums, skip, pos: int):
        """Every layer's TAF detector after one decode step, in a fixed
        handful of kernels. A computed layer (`skip` False) pushes its
        batch-mean delta `s` (the sum times float32(1/n), XLA's form of
        `jnp.mean`) into its window, and enters the stable regime for
        prediction_size steps when the window's RSD (two-pass `jnp.std`
        over `jnp.mean`) is under its threshold with a full window; its
        memoized K/V become this step's. A skipped layer counts its
        `remaining` down by one and writes its stale K/V at `pos`."""
        t = self.cfg.approx_decode.taf
        h = t.history_size
        computed = ~skip
        s = sums * (1.0 / taf["memo_delta"][0].numel())
        win = torch.where(computed[:, None],
                          torch.cat([taf["window"][:, 1:], s[:, None]], 1),
                          taf["window"])
        filled = torch.where(computed, (taf["filled"] + 1).clamp_(max=h),
                             taf["filled"])
        mu = win.sum(dim=1) * (1.0 / h)
        centered = win - mu[:, None]
        sd = torch.sqrt((centered * centered).sum(dim=1) * (1.0 / h))
        stable = ((sd / torch.clamp(mu.abs(), min=1e-12) < taf["threshold"])
                  & (filled >= h))
        taf["remaining"].copy_(torch.where(
            computed, stable.to(torch.int32) * t.prediction_size,
            taf["remaining"] - 1))
        taf["window"].copy_(win)
        taf["filled"].copy_(filled)
        sel = computed.view(-1, 1, 1, 1, 1)
        for name in ("k", "v"):
            at_pos = kv[name][:, :, :, pos:pos + 1]
            memo = torch.where(sel, at_pos, taf["memo_" + name])
            at_pos.copy_(memo)
            taf["memo_" + name].copy_(memo)

    def decode_step(self, params, cache: Dict, tokens: torch.Tensor,
                    pos: int) -> Tuple[torch.Tensor, Dict]:
        """tokens (B,) at position `pos` (a host int) -> (logits (B, V)
        float32, the cache updated in place)."""
        cfg = self.cfg
        x = params["embed"][tokens[:, None].long()]
        kv = cache["dense"]
        taf = cache.get("taf") if self.taf_enabled else None
        if taf is None:
            for l, lp in enumerate(params["dense_blocks"]):
                x, _ = blocks.block_decode(
                    lp, cfg, x, {k: c[l] for k, c in kv.items()}, pos,
                    approx_attn=cfg.approx_attention,
                    approx_ffn=cfg.approx_ffn)
        else:
            skip = taf["remaining"] > 0               # device copy, pre-step
            rem = taf["remaining"].tolist()           # the step's host read
            obs_metrics.count_host_read()
            sums = torch.zeros((cfg.n_layers,), dtype=torch.float32,
                               device=self.device)
            for l, lp in enumerate(params["dense_blocks"]):
                if rem[l] > 0:
                    x.add_(taf["memo_delta"][l].unsqueeze(1))
                else:
                    x = self._decode_layer_taf(lp, l, kv, taf, sums, x, pos)
            self._taf_step(kv, taf, sums, skip, pos)
        x = common.apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
        return (x[:, 0] @ self._head_w(params)).float(), cache


def build(cfg: ModelConfig, device=None) -> Model:
    """The dense LM of `cfg` on `device` (None means cuda)."""
    if cfg.family != "dense" or cfg.use_mla or cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r}"
            + (" with MLA" if cfg.use_mla else "")
            + (" with MoE" if cfg.moe is not None else "")
            + f" is not ported yet ({ZOO_ITEM}); the port builds the dense "
            "family")
    return Model(cfg, device)

