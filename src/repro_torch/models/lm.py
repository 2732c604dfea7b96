"""Causal LM assembly for every decoder-only family, with decode-time TAF
(port of `repro.models.lm`):

  dense / vlm  -- GQA (or MLA) transformer, the vlm with a stubbed
                  patch-embedding prefix (pixtral)
  moe          -- transformer with MoE FFN (+ leading dense layers, MTP)
  hybrid       -- zamba2: Mamba2 backbone + a shared attention block
  ssm          -- rwkv6 (attention-free)
  audio        -- whisper (`models.whisper`)

`build(cfg, device=None)` returns a `Model` whose methods are the JAX
`Model`'s bound functions: `init`, `hidden`, `loss`, `init_cache`,
`prefill` and `decode_step`. The layer loop is a Python loop over lists of
per-layer parameter dicts (nested lists where JAX stacks two axes); the
decode cache stacks the layers on leading axes, as the JAX model's vmapped
caches do, and every step updates it in place.

The dtype rule (`common.DtypeRule`) has JAX's two stages. `masters(g)`
draws the weights in the dtype JAX stores and updates them in (float32
by default, `param_dtype`), and `use(masters)` casts them as the JAX
forward does at each use: matrices, embeddings and every leaf JAX casts
with `.astype(x.dtype)` to `compute_dtype`, norm scales kept in
`param_dtype`, and the leaves each module lists in its `FLOAT32_LEAVES`
(the MoE router, Mamba2's A_log / D / dt_bias, RWKV6's w0 / u) float32.
`init(g)` draws the same values already cast (`hold = use . store`, the
serving form); `loss(use(masters), batch)` differentiates into the
masters, as `jax.value_and_grad` over the JAX loss does. Under the loss
each layer runs through `common.remat` when `cfg.remat` (`jax.checkpoint`
in the JAX layer scans), and the head's cross-entropy goes by chunks of
the sequence (`chunked_xent`), so the (B, S, V) logits are never held.

Decode-time TAF (paper section 3.1.3 as a serving feature): with
cfg.approx_decode = TAF on a transformer without MLA or MoE (JAX's
`_taf_decode_enabled`), each layer carries a TAF state machine across
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

from typing import Callable, Dict, Optional, Tuple

import torch

from .. import device as device_mod
from ..configs.base import ModelConfig
from ..core.types import Technique
from ..obs import metrics as obs_metrics
from . import blocks, common, mamba2, moe, rwkv6


def _attn_axes(group: str, names, axis: int) -> Dict:
    return {(group, name): axis for name in names}


_GQA = ("k", "v", "k_scale", "v_scale")
_MLA = ("ckv", "k_rope")

# Each cache leaf's batch axis, keyed by the leaf's path in the cache
# (None: the leaf has none). The serving engine's lane splice and the
# sharding rules read it instead of inferring the axis from shapes.
CACHE_BATCH_AXES = {
    # transformer stacks (L, B, ...), GQA or MLA
    **_attn_axes("dense", _GQA + _MLA, 1),
    **_attn_axes("moe", _GQA + _MLA, 1),
    ("taf", "threshold"): None, ("taf", "window"): None,
    ("taf", "filled"): None, ("taf", "remaining"): None,
    ("taf", "memo_delta"): 1, ("taf", "memo_k"): 1, ("taf", "memo_v"): 1,
    # hybrid: mixers (G, M, B, ...) and (T, B, ...), shared attn (G, B, ...)
    ("mamba_main", "conv"): 2, ("mamba_main", "ssm"): 2,
    ("mamba_tail", "conv"): 1, ("mamba_tail", "ssm"): 1,
    **_attn_axes("attn", _GQA, 1),
    # ssm: every layer's state (L, B, ...)
    ("tm_x",): 1, ("cm_x",): 1, ("wkv",): 1,
    # audio: the decoder's self-attention (L, B, ...), the encoder memory
    **_attn_axes("self", _GQA, 1),
    ("memory",): 0,
}


def map_cache(fn: Callable, tree, *others, path: Tuple[str, ...] = ()):
    """`fn(path, leaf, *other leaves)` over a cache tree of nested dicts
    (a None subtree, such as a hybrid's absent `mamba_tail`, stays None);
    `others` are trees of the same structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_cache(fn, v, *(o[k] for o in others),
                             path=path + (k,))
                for k, v in tree.items()}
    return fn(path, tree, *others)


# The TAF detector-state leaves of `_taf_init_cache`: per-layer scalars or
# small vectors with NO batch dim. These are the leaves that become
# PER-SHARD under a sharded serving engine -- each logical shard runs its
# own stability detector (window/filled/remaining) and its own threshold
# knob, so a QoS controller can tighten one shard while another keeps
# approximating, without building a step. The memo_* leaves already carry
# the batch dim and shard along it like the KV cache.
TAF_SHARD_STATE = ("threshold", "window", "filled", "remaining")


def shard_taf_state(cache: Dict, n_shards: int) -> Dict:
    """Return `cache` with the TAF detector state copied per shard.

    Each `TAF_SHARD_STATE` leaf (n_layers, ...) gains a LEADING shard dim:
    (n_shards, n_layers, ...), one independent copy a shard (the rows
    evolve apart). `launch.steps.make_sharded_serve_step` runs each
    shard's decode over its own row, so the batch-mean stability
    statistic becomes a per-shard statistic over the shard's own lanes.
    A no-op for caches without a "taf" entry (precise models)."""
    if "taf" not in cache:
        return cache
    taf = dict(cache["taf"])
    for key in TAF_SHARD_STATE:
        leaf = taf[key]
        taf[key] = leaf.unsqueeze(0).repeat((n_shards,) + (1,) * leaf.dim())
    return dict(cache, taf=taf)


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


# every module's leaves that JAX keeps and multiplies in float32
FLOAT32_LEAVES = moe.FLOAT32_LEAVES + mamba2.FLOAT32_LEAVES \
    + rwkv6.FLOAT32_LEAVES


def _chunk_nll(h, w, labels, mask):
    """The masked negative log-likelihood summed over one chunk: float32
    logits of `h @ w` (rounded in h's dtype first, as JAX's einsum), kept
    in the head's vocab-split layout (`common.logsumexp_pick`). The
    product runs shard by shard (`common.by_shard`: the vocab split as the
    head's, the batch as h's, GSPMD's plan), so every chunk's (and MTP's)
    head gradient comes back alike, a sum pending over the batch's ranks
    that the chunks add to and that is summed once after the loss."""
    logits = common.by_shard(torch.matmul, "bcd,dv->bcv", h, w, free="bcv")
    logz, gold = common.logsumexp_pick(logits.float(), labels)
    return torch.sum((logz - gold) * mask)


def chunked_xent(h: torch.Tensor, head_w: torch.Tensor, labels,
                 mask: Optional[torch.Tensor] = None,
                 chunk: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy without holding the (B, S, V) logits: (sum of the
    masked nll, sum of the mask), both float32. The sequence goes in
    chunks of `chunk` positions, halved until it divides S, summed chunk by
    chunk in order (JAX's `lax.scan`), each chunk's partial sum over the
    batch's ranks summed before it is added (`common.settle`: one scalar
    all-reduce a chunk, where torch's versions would each plan the add);
    under autograd each chunk's logits are recomputed in backward, so one
    chunk's are held at a time."""
    b, s, _ = h.shape
    chunk = min(chunk, s)
    while s % chunk != 0:
        chunk //= 2
    labels = torch.as_tensor(labels, device=h.device).long()
    mask = (torch.ones((b, s), dtype=torch.float32, device=h.device)
            if mask is None else mask.float())
    w = common.gather_fsdp(head_w, h).to(h.dtype)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(s // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        args = (h[:, sl], w, labels[:, sl], mask[:, sl])
        total = total + common.settle(common.remat(True, _chunk_nll, *args))
        count = count + torch.sum(mask[:, sl])
    return total, count


def _mean_nll(h, head_w, labels) -> torch.Tensor:
    total, count = chunked_xent(h, head_w, labels)
    return total / torch.clamp(count, min=1.0)


def map_params(fn: Callable, tree, name: str = ""):
    """`fn(name, leaf)` over a parameter tree of dicts and (nested) layer
    lists, `name` the leaf's own key; a None subtree stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_params(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_params(fn, v, name) for v in tree]
    return fn(name, tree)


def layer_view(stack: Dict, index) -> Dict:
    """One layer's cache: views of a stacked cache group at `index` (an int
    or a tuple of ints for nested stacks)."""
    return {k: t[index] for k, t in stack.items()}


class Model:
    """One architecture's causal LM on one device: the pieces every family
    shares (dtype rule, embedding, head)."""

    # parameter subtrees JAX stacks on leading layer axes -> their number;
    # the port holds such a subtree as (nested) lists of per-layer dicts
    STACKS: Dict[Tuple[str, ...], int] = {}

    def __init__(self, cfg: ModelConfig, device=None):
        self.cfg = cfg
        self.device = device_mod.resolve(device)
        self.pdt = _dtype(cfg.param_dtype)
        self.cdt = _dtype(cfg.compute_dtype)
        self.rule = common.DtypeRule(self.pdt, self.cdt, self.device,
                                     FLOAT32_LEAVES)
        self.hold, self.store = self.rule.hold, self.rule.store

    def init(self, generator: torch.Generator) -> Dict:
        """Parameters drawn from `generator` (on its device), with the JAX
        package's init scales, on the model's device, held in the dtype
        the JAX forward multiplies each in (the serving form)."""
        return self._draw(generator, self.hold)

    def masters(self, generator: torch.Generator) -> Dict:
        """The same draw as `init`, in the same order, in the dtype JAX
        stores each leaf in (`DtypeRule.store`): the tree a train step
        differentiates and AdamW updates."""
        return self._draw(generator, self.store)

    def use(self, params) -> Dict:
        """`params` (masters) cast as the JAX forward casts each leaf at
        its use, differentiably: `use(masters(g))` equals `init(g)`."""
        return map_params(self.rule.use, params)

    def loss(self, params, batch) -> Tuple[torch.Tensor, Dict]:
        """(loss, metrics) of `batch` (tokens, labels and the frontend's
        inputs) on `params` in their use form: the mean next-token
        cross-entropy (`xent`), plus what the family adds."""
        x = self._hidden(params, batch, self.cfg.remat)
        out = _mean_nll(x, params["head"], batch["labels"])
        return out, {"xent": out}

    def hidden(self, params, batch) -> torch.Tensor:
        """(B, S, d) final hidden states of `batch["tokens"]`."""
        return self._hidden(params, batch, False)

    @property
    def taf_enabled(self) -> bool:
        """Decode-time TAF runs (JAX's `_taf_decode_enabled`): a TAF spec
        on a transformer without MLA or MoE."""
        return False

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def _embed_init(self, generator, hold) -> torch.Tensor:
        cfg = self.cfg
        return hold("embed", common.embed_init(
            generator, (cfg.padded_vocab_size, cfg.d_model)))

    def _head_init(self, generator, hold) -> torch.Tensor:
        cfg = self.cfg
        return hold("head", common.dense_init(
            generator, (cfg.d_model, cfg.padded_vocab_size)))

    def _head_w(self, params) -> torch.Tensor:
        return (params["embed"].T if self.cfg.tie_embeddings
                else params["head"])

    def _logits(self, params, x: torch.Tensor) -> torch.Tensor:
        """(B, V) float32 logits of the (B, d) hidden states `x`."""
        return (x @ self._head_w(params)).float()

    def init_cache(self, batch_size: int, max_len: int = 0,
                   mesh=None) -> Dict:
        """A cache of zeros (the TAF thresholds their value) for
        `batch_size` sequences of up to `max_len` positions, on the
        model's device. With `mesh`, each leaf is a DTensor laid out by
        the sharding rules (`runtime.sharding.cache_specs`, the JAX dry
        run's `out_shardings` of a prefill), only this device's shard
        allocated."""
        if mesh is None:
            return self._cache(batch_size, max_len,
                               common.leaf_maker(self.device))
        from ..runtime import sharding as shardlib
        shapes = self._cache(batch_size, max_len, common.LeafShape)
        specs = shardlib.cache_specs(mesh, shapes, batch_size)
        return map_cache(lambda _p, leaf, spec: common.placed_leaf(
            leaf, mesh, shardlib.placements(mesh, spec), self.device),
            shapes, specs)


# ============================================================================
# transformer families: dense / vlm / moe
# ============================================================================

class Transformer(Model):
    """dense / vlm / moe: `dense_blocks` (+ `moe_blocks` after them for
    moe), the vlm's patch embeddings prefixed to the text, the MTP head's
    parameters built as JAX builds them (only the loss reads them)."""

    STACKS = {("dense_blocks",): 1, ("moe_blocks",): 1}

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__(cfg, device)
        self.n_dense = cfg.moe.n_dense_layers if cfg.moe else cfg.n_layers
        self.n_moe = cfg.n_layers - self.n_dense
        if self.taf_enabled and cfg.kv_cache_dtype == "int8":
            raise ValueError(
                "decode-time TAF memoizes K/V rows in the compute dtype; the "
                "int8 KV cache has no such rows (the JAX model cannot trace "
                "this combination either)")

    @property
    def taf_enabled(self) -> bool:
        cfg = self.cfg
        return (cfg.approx_decode.technique == Technique.TAF
                and not cfg.use_mla and cfg.moe is None)

    def _stacks(self):
        """(params key, cache key) of each layer stack, in order."""
        return [(pk, ck) for pk, ck, n in (
            ("dense_blocks", "dense", self.n_dense),
            ("moe_blocks", "moe", self.n_moe)) if n]

    def _draw(self, generator: torch.Generator, hold) -> Dict:
        cfg = self.cfg
        p: Dict = {"embed": self._embed_init(generator, hold),
                   "final_norm": common.norm_params(cfg.norm, cfg.d_model,
                                                    hold)}
        if not cfg.tie_embeddings:
            p["head"] = self._head_init(generator, hold)
        if self.n_dense:
            p["dense_blocks"] = [blocks.init_block(generator, cfg, hold)
                                 for _ in range(self.n_dense)]
        if self.n_moe:
            p["moe_blocks"] = [blocks.init_block(generator, cfg, hold,
                                                 use_moe=True)
                               for _ in range(self.n_moe)]
        if cfg.mtp:
            p["mtp"] = {
                "proj": hold("proj", common.dense_init(
                    generator, (2 * cfg.d_model, cfg.d_model))),
                "block": blocks.init_block(generator, cfg, hold),
            }
        return p

    def _embed(self, params, batch) -> torch.Tensor:
        x = common.embed_rows(params["embed"], self._tokens(batch["tokens"]))
        if self.cfg.frontend == "vision_patches":   # the stubbed ViT's output
            patches = torch.as_tensor(batch["patch_embeds"],
                                      device=self.device).to(self.cdt)
            x = torch.cat([patches, x], dim=1)
        return x

    def _hidden_aux(self, params, batch, remat: bool):
        """(B, S, d) final hidden states of `batch["tokens"]` (after the
        vlm's patch prefix) and the MoE aux loss: the float32 sum over
        the layers, stack by stack (a dense layer adds 0)."""
        cfg = self.cfg
        x = self._embed(params, batch)
        positions = torch.arange(x.shape[1], device=self.device)
        aux = torch.zeros((), dtype=torch.float32, device=self.device)

        def layer(lp, h):
            return blocks.block_forward(lp, cfg, h, positions,
                                        approx_attn=cfg.approx_attention,
                                        approx_ffn=cfg.approx_ffn)

        for pk, _ in self._stacks():
            stack_aux = torch.zeros((), dtype=torch.float32,
                                    device=self.device)
            for lp in params[pk]:
                x, a = common.remat(remat, layer, lp, x)
                if a is not None:
                    stack_aux = stack_aux + a
            aux = aux + stack_aux
        x = common.apply_norm(cfg.norm, params["final_norm"], x,
                              cfg.norm_eps)
        return x, aux

    def _hidden(self, params, batch, remat: bool) -> torch.Tensor:
        return self._hidden_aux(params, batch, remat)[0]

    def loss(self, params, batch) -> Tuple[torch.Tensor, Dict]:
        """The next-token cross-entropy on the text positions (the vlm's
        patch prefix dropped) plus the MoE aux loss; with MTP, plus
        `mtp_loss_coef` times the loss of predicting token t+2 from
        block(proj([h_t ; emb(token_t+1)]))."""
        cfg = self.cfg
        x, aux = self._hidden_aux(params, batch, cfg.remat)
        if cfg.frontend == "vision_patches":
            x = x[:, batch["patch_embeds"].shape[1]:]
        labels = torch.as_tensor(batch["labels"], device=self.device).long()
        head = self._head_w(params)
        out = _mean_nll(x, head, labels)
        metrics = {"xent": out, "aux_loss": aux}
        if cfg.mtp:
            emb_next = common.embed_rows(params["embed"],
                                         self._tokens(batch["tokens"]))
            cat = torch.cat([x[:, :-1], emb_next[:, 1:]], dim=-1)
            hm = cat @ common.gather_fsdp(params["mtp"]["proj"], cat)
            positions = torch.arange(hm.shape[1], device=self.device)
            hm, _ = blocks.block_forward(params["mtp"]["block"], cfg, hm,
                                         positions)
            mtp_loss = _mean_nll(hm, head, labels[:, 1:])
            metrics["mtp_loss"] = mtp_loss
            out = out + cfg.mtp_loss_coef * mtp_loss
        return out + aux, metrics

    def _cache(self, batch_size: int, max_len: int, new) -> Dict:
        cache = {ck: blocks.init_block_cache(
            self.cfg, n, batch_size, max_len, self.cdt, new=new)
            for ck, n in (("dense", self.n_dense), ("moe", self.n_moe)) if n}
        if self.taf_enabled:
            cache["taf"] = self._taf_init_cache(batch_size, new)
        return cache

    def prefill(self, params, batch, mesh=None) -> Tuple[torch.Tensor, Dict]:
        """(last-position logits (B, V) float32, a fresh cache of
        `batch["max_len"]` positions holding the prompt's K/V, laid out on
        `mesh` when one is given (`init_cache`); the vlm's prompt starts
        with its patch embeddings)."""
        cfg = self.cfg
        x = self._embed(params, batch)
        cache = self.init_cache(x.shape[0], batch["max_len"], mesh)
        for pk, ck in self._stacks():
            for l, lp in enumerate(params[pk]):
                x, _ = blocks.block_prefill(
                    lp, cfg, x, layer_view(cache[ck], l),
                    approx_attn=cfg.approx_attention,
                    approx_ffn=cfg.approx_ffn)
        x = common.apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
        return self._logits(params, x[:, -1]), cache

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------

    def _taf_init_cache(self, batch_size: int, new) -> Dict:
        cfg = self.cfg
        t = cfg.approx_decode.taf
        n = cfg.n_layers
        hd = cfg.resolved_head_dim
        return {
            # the RSD threshold, one scalar per layer, as data the QoS plane
            # writes between ticks (never a rebuild)
            "threshold": new((n,), torch.float32, t.rsd_threshold),
            "window": new((n, t.history_size), torch.float32),
            "filled": new((n,), torch.int32),
            "remaining": new((n,), torch.int32),
            "memo_delta": new((n, batch_size, cfg.d_model), torch.float32),
            "memo_k": new((n, batch_size, cfg.n_kv_heads, 1, hd), self.cdt),
            "memo_v": new((n, batch_size, cfg.n_kv_heads, 1, hd), self.cdt),
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
                    pos: int, remaining=None) -> Tuple[torch.Tensor, Dict]:
        """tokens (B,) at position `pos` (a host int) -> (logits (B, V)
        float32, the cache updated in place). `remaining`: the TAF
        `remaining` vector as host ints when the caller has read it
        already (the sharded step reads every shard's at once); None reads
        it here."""
        cfg = self.cfg
        x = common.embed_rows(params["embed"], tokens[:, None].long())
        taf = cache.get("taf") if self.taf_enabled else None
        for pk, ck in self._stacks():
            kv = cache[ck]
            if taf is not None:
                x = self._decode_taf(params[pk], kv, taf, x, pos, remaining)
                continue
            for l, lp in enumerate(params[pk]):
                x, _ = blocks.block_decode(
                    lp, cfg, x, layer_view(kv, l), pos,
                    approx_attn=cfg.approx_attention,
                    approx_ffn=cfg.approx_ffn)
        x = common.apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
        return self._logits(params, x[:, 0]), cache

    def _decode_taf(self, layers, kv: Dict, taf: Dict, x, pos: int,
                    remaining):
        skip = taf["remaining"] > 0                   # device copy, pre-step
        rem = remaining
        if rem is None:
            rem = taf["remaining"].tolist()           # the step's host read
            obs_metrics.count_host_read()
        sums = torch.zeros((self.cfg.n_layers,), dtype=torch.float32,
                           device=self.device)
        for l, lp in enumerate(layers):
            if rem[l] > 0:
                x.add_(taf["memo_delta"][l].unsqueeze(1))
            else:
                x = self._decode_layer_taf(lp, l, kv, taf, sums, x, pos)
        self._taf_step(kv, taf, sums, skip, pos)
        return x


# ============================================================================
# hybrid (zamba2)
# ============================================================================

class Hybrid(Model):
    """zamba2: groups of Mamba2 mixers, each group closed by ONE shared
    attention block (weights shared, one KV cache per application), then
    a tail of mixers."""

    STACKS = {("layers", "main"): 2, ("layers", "tail"): 1}

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__(cfg, device)
        self.n_groups, self.mpg, self.tail = blocks.hybrid_layout(cfg)

    def _draw(self, generator: torch.Generator, hold) -> Dict:
        cfg = self.cfg
        return {"embed": self._embed_init(generator, hold),
                "layers": blocks.init_hybrid(generator, cfg, hold),
                "final_norm": common.norm_params(cfg.norm, cfg.d_model,
                                                 hold),
                "head": self._head_init(generator, hold)}

    def _hidden(self, params, batch, remat: bool) -> torch.Tensor:
        """Under `remat` each Mamba2 sublayer is recomputed in backward
        (the JAX model checkpoints the mixers, not the shared block)."""
        cfg = self.cfg
        x = common.embed_rows(params["embed"], self._tokens(batch["tokens"]))
        positions = torch.arange(x.shape[1], device=self.device)
        layers = params["layers"]

        def mixer(mp, h):
            return blocks.mamba_sublayer(mp, cfg, h,
                                         approx_ffn=cfg.approx_ffn)

        for group in layers["main"]:
            for mp in group:
                x = common.remat(remat, mixer, mp, x)
            x, _ = blocks.block_forward(layers["shared_attn"], cfg, x,
                                        positions,
                                        approx_attn=cfg.approx_attention,
                                        approx_ffn=cfg.approx_ffn)
        for mp in layers["tail"] or ():
            x = mixer(mp, x)
        return common.apply_norm(cfg.norm, params["final_norm"], x,
                                 cfg.norm_eps)

    def _cache(self, batch_size: int, max_len: int, new) -> Dict:
        cfg = self.cfg
        return {
            "mamba_main": mamba2.init_cache(cfg, (self.n_groups, self.mpg),
                                            batch_size, self.cdt, new=new),
            "mamba_tail": (mamba2.init_cache(cfg, (self.tail,), batch_size,
                                             self.cdt, new=new)
                           if self.tail else None),
            "attn": blocks.init_block_cache(cfg, self.n_groups, batch_size,
                                            max_len, self.cdt, new=new),
        }

    def _run(self, params, x, cache, mixer, shared):
        """x through every group's mixers and its shared-attention call,
        then the tail's mixers: `mixer(layer params, its cache view, x)`
        and `shared(x, the group's attention cache view)` each return the
        new x and write their cache in place."""
        layers = params["layers"]
        for g, group in enumerate(layers["main"]):
            for m, mp in enumerate(group):
                x = mixer(mp, layer_view(cache["mamba_main"], (g, m)), x)
            x = shared(x, layer_view(cache["attn"], g))
        for t, mp in enumerate(layers["tail"] or ()):
            x = mixer(mp, layer_view(cache["mamba_tail"], t), x)
        x = common.apply_norm(self.cfg.norm, params["final_norm"], x,
                              self.cfg.norm_eps)
        return x

    def prefill(self, params, batch, mesh=None) -> Tuple[torch.Tensor, Dict]:
        cfg = self.cfg
        x = common.embed_rows(params["embed"], self._tokens(batch["tokens"]))
        cache = self.init_cache(x.shape[0], batch["max_len"], mesh)

        def mixer(mp, mc, h):
            h, state = blocks.mamba_sublayer_prefill(mp, cfg, h)
            for k, t in state.items():        # cast to the cache's dtypes
                common.write_rows(mc[k], t, 0)
            return h

        def shared(h, ac):
            return blocks.block_prefill(params["layers"]["shared_attn"],
                                        cfg, h, ac)[0]

        x = self._run(params, x, cache, mixer, shared)
        return self._logits(params, x[:, -1]), cache

    def decode_step(self, params, cache: Dict, tokens: torch.Tensor,
                    pos: int) -> Tuple[torch.Tensor, Dict]:
        cfg = self.cfg
        x = common.embed_rows(params["embed"], tokens[:, None].long())

        def mixer(mp, mc, h):
            h, state = blocks.mamba_sublayer_decode(mp, cfg, h, mc)
            for k, t in state.items():
                common.write_rows(mc[k], t, 0)
            return h

        def shared(h, ac):
            return blocks.block_decode(params["layers"]["shared_attn"], cfg,
                                       h, ac, pos,
                                       approx_attn=cfg.approx_attention)[0]

        x = self._run(params, x, cache, mixer, shared)
        return self._logits(params, x[:, 0]), cache


# ============================================================================
# ssm (rwkv6)
# ============================================================================

class Rwkv(Model):
    """rwkv6: an input LayerNorm, RWKV layers carrying their state, a final
    LayerNorm. Decode ignores `pos`: the position is implicit in the
    state."""

    STACKS = {("layers",): 1}

    def _draw(self, generator: torch.Generator, hold) -> Dict:
        cfg = self.cfg
        return {"embed": self._embed_init(generator, hold),
                "ln_in": common.norm_params("ln", cfg.d_model, hold),
                "layers": [rwkv6.init_layer(generator, cfg, hold)
                           for _ in range(cfg.n_layers)],
                "final_norm": common.norm_params("ln", cfg.d_model, hold),
                "head": self._head_init(generator, hold)}

    def _cache(self, batch_size: int, max_len: int, new) -> Dict:
        return rwkv6.init_cache(self.cfg, self.cfg.n_layers, batch_size,
                                self.cdt, new=new)

    def _run(self, params, tokens, cache, remat: bool = False,
             write: bool = True) -> torch.Tensor:
        """The layers from the state in `cache`; with `write` each
        layer's new state is written into the cache in place (prefill,
        decode), else the cache is only read (the loss: autograd saved
        the state it read)."""
        cfg = self.cfg
        x = common.embed_rows(params["embed"], tokens)
        x = common.layernorm(params["ln_in"], x, cfg.norm_eps)
        for l, lp in enumerate(params["layers"]):
            view = layer_view(cache, l)
            x, state = common.remat(remat, rwkv6.layer_forward, lp, cfg, x,
                                    view)
            if write:
                rwkv6.write_state(view, state)
        return common.layernorm(params["final_norm"], x, cfg.norm_eps)

    def _hidden(self, params, batch, remat: bool) -> torch.Tensor:
        tokens = self._tokens(batch["tokens"])
        return self._run(params, tokens, self.init_cache(tokens.shape[0]),
                         remat=remat, write=False)

    def prefill(self, params, batch, mesh=None) -> Tuple[torch.Tensor, Dict]:
        tokens = self._tokens(batch["tokens"])
        cache = self.init_cache(tokens.shape[0], mesh=mesh)
        x = self._run(params, tokens, cache)
        return self._logits(params, x[:, -1]), cache

    def decode_step(self, params, cache: Dict, tokens: torch.Tensor,
                    pos: int) -> Tuple[torch.Tensor, Dict]:
        del pos  # state-space: the position is implicit in the state
        x = self._run(params, tokens[:, None].long(), cache)
        return self._logits(params, x[:, 0]), cache


# ============================================================================
# factory
# ============================================================================

def build(cfg: ModelConfig, device=None) -> Model:
    """The model of `cfg` on `device` (None means cuda)."""
    if cfg.family in ("dense", "vlm", "moe"):
        return Transformer(cfg, device)
    if cfg.family == "hybrid":
        return Hybrid(cfg, device)
    if cfg.family == "ssm":
        return Rwkv(cfg, device)
    if cfg.family == "audio":
        from . import whisper
        return whisper.Whisper(cfg, device)
    raise ValueError(f"unknown family {cfg.family}")
