"""RWKV-6 "Finch" (attention-free) -- data-dependent decay time-mix +
channel-mix (port of `repro.models.rwkv6`).

Per-channel data-dependent decay w_t = exp(-exp(w0 + lora(x))) clipped to
[-20, 3] inside, token-shift mixing, the per-head WKV state recurrence with
bonus `u` for the current token, squared-ReLU channel mix. The token-shift
mix coefficients are learned-static (the JAX module's recorded
simplification).

The WKV recurrence is a `lax.scan` over tokens in the JAX module; here it
is a per-token loop on the host, so a prefill launches a handful of
kernels per token and layer (host-bound; no kernel is written for it). A
decode step is the same layer on one token.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from . import common

# leaves JAX keeps and multiplies in float32 (the decay base and the bonus)
FLOAT32_LEAVES = ("w0", "u")


def _dims(cfg: ModelConfig):
    r = cfg.rwkv
    return r, cfg.d_model // r.head_dim


def init_time_mix(generator: torch.Generator, cfg: ModelConfig,
                  hold) -> Dict:
    r, nh = _dims(cfg)
    d = cfg.d_model

    def dense(name, shape, scale=None):
        return hold(name, common.dense_init(generator, shape, scale=scale))

    p = {name: hold(name, torch.full((d,), 0.5))
         for name in ("mix_r", "mix_k", "mix_v", "mix_w", "mix_g")}
    p.update({
        "w_r": dense("w_r", (d, d)), "w_k": dense("w_k", (d, d)),
        "w_v": dense("w_v", (d, d)), "w_g": dense("w_g", (d, d)),
        "w_o": dense("w_o", (d, d)),
        # data-dependent decay LoRA (Finch): w = exp(-exp(w0 + tanh(xA)B))
        "w0": hold("w0", torch.full((d,), -6.0)),
        "decay_A": dense("decay_A", (d, r.decay_lora_rank)),
        "decay_B": dense("decay_B", (r.decay_lora_rank, d), 0.01),
        "u": dense("u", (nh, r.head_dim), 0.5),
        "ln_x": common.norm_params("ln", d, hold),
    })
    return p


def init_channel_mix(generator: torch.Generator, cfg: ModelConfig,
                     hold) -> Dict:
    d = cfg.d_model
    return {
        "mix_k": hold("mix_k", torch.full((d,), 0.5)),
        "w_k": hold("w_k", common.dense_init(generator, (d, cfg.d_ff))),
        "w_v": hold("w_v", common.dense_init(generator, (cfg.d_ff, d))),
    }


def init_layer(generator: torch.Generator, cfg: ModelConfig, hold) -> Dict:
    return {
        "ln1": common.norm_params("ln", cfg.d_model, hold),
        "ln2": common.norm_params("ln", cfg.d_model, hold),
        "tm": init_time_mix(generator, cfg, hold),
        "cm": init_channel_mix(generator, cfg, hold),
    }


def init_cache(cfg: ModelConfig, n_layers: int, batch: int, dtype,
               device=None, new=None) -> Dict:
    """Every layer's state, stacked on a leading axis: the last token of
    the time mix and of the channel mix (`dtype`), the WKV state
    (float32), each leaf made by `new(shape, dtype)` (zeros on `device`
    by default)."""
    new = new or common.leaf_maker(device)
    r, nh = _dims(cfg)
    return {
        "tm_x": new((n_layers, batch, cfg.d_model), dtype),
        "cm_x": new((n_layers, batch, cfg.d_model), dtype),
        "wkv": new((n_layers, batch, nh, r.head_dim, r.head_dim),
                   torch.float32),
    }


def _token_shift(x, x_prev):
    """shifted[t] = x[t-1]; x_prev seeds t=0. x: (B,S,d), x_prev: (B,d).
    A DTensor x_prev (a cache's last token, split along d) is made whole
    along d first, as x is: DTensor's concatenation would split x along d
    instead, and the products after it would gather their weights."""
    return torch.cat([common.unshard(x_prev, -1)[:, None, :],
                      x[:, :-1, :]], dim=1)


def wkv_scan(r, k, v, w, u, state):
    """Recurrent WKV, token by token. r,k,v: (B,S,H,P); w: (B,S,H,P) decay
    in (0,1); u: (H,P) bonus; state: (B,H,P,P). S_t[h, i, j] accumulates
    k_i v_j; y_t = r_t . (S_{t-1} + u k v). Returns (y (B,S,H,P), the
    final state). DTensors scan shard by shard over batch and heads
    (`common.by_shard`): DTensor would run every token's ops one by one
    and refuses their einsum's flattened batch dims."""
    return common.by_shard(_wkv_loop, "bshp,bshp,bshp,bshp,hp,bhpq->"
                           "bshp,bhpq", r, k, v, w, u, state, free="bh")


def _wkv_loop(r, k, v, w, u, state):
    """The scan token by token. Each input is taken apart into its tokens
    once (`unbind`: its backward stacks the tokens' gradients, where a
    token's index would write a zero-filled gradient of the whole sequence
    for each token)."""
    ys = []
    ub = u[None, :, :, None]
    for rt, kt, vt, wt in zip(r.unbind(1), k[..., None].unbind(1),
                              v[..., None, :].unbind(1),
                              w[..., None].unbind(1)):
        kv = kt * vt                                          # (B,H,P,P)
        ys.append(torch.einsum("bhi,bhij->bhj", rt, state + ub * kv))
        state = state * wt + kv
    return torch.stack(ys, dim=1), state


def time_mix(p: Dict, cfg: ModelConfig, x: torch.Tensor,
             x_prev: torch.Tensor, state: torch.Tensor):
    """x: (B,S,d); x_prev: (B,d) the last token of the previous segment;
    state: (B,H,P,P). Returns (out, last_x, new_state)."""
    r_cfg, nh = _dims(cfg)
    hp = r_cfg.head_dim
    xs = _token_shift(x, x_prev)

    def mixed(name):
        m = p["mix_" + name]
        return x * m + xs * (1 - m)

    r = mixed("r") @ p["w_r"]
    k = mixed("k") @ p["w_k"]
    v = mixed("v") @ p["w_v"]
    g = mixed("g") @ p["w_g"]
    # Finch data-dependent decay. A DTensor's LoRA rank (split as decay_A's
    # columns) is made whole before decay_B, so that the decay comes out
    # split by heads as r, k and v are (DTensor would sum the product over
    # the rank's split, then scatter that sum along the batch)
    dlora = common.unshard(torch.tanh(mixed("w") @ p["decay_A"]), -1) \
        @ p["decay_B"]
    w = torch.exp(-torch.exp(torch.clamp(p["w0"] + dlora.float(),
                                         -20.0, 3.0)))
    def heads(t):
        return common.split_dim(t, 2, (nh, hp))

    y, new_state = wkv_scan(heads(r).float(), heads(k).float(),
                            heads(v).float(), heads(w), p["u"], state)
    y = common.merge_dims(y, 2).to(x.dtype)
    y = common.layernorm(p["ln_x"], y, cfg.norm_eps)
    return (y * common.silu(g)) @ p["w_o"], x[:, -1, :], new_state


def channel_mix(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                x_prev: torch.Tensor):
    xs = _token_shift(x, x_prev)
    m = p["mix_k"]
    h = torch.square(F.relu((x * m + xs * (1 - m)) @ p["w_k"]))
    return h @ p["w_v"], x[:, -1, :]


def layer_forward(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                  state: Dict) -> Tuple[torch.Tensor, Dict]:
    """One RWKV block over a sequence, carrying the segment state: reads
    this layer's `state` ({tm_x, cm_x, wkv}) and returns (x, the new
    state), writing nothing (autograd saves the state it read; the
    caller that keeps a cache writes it with `write_state`). A
    single-token step is the same math with S=1."""
    h = common.layernorm(p["ln1"], x, cfg.norm_eps)
    att, tm_x, wkv = time_mix(p["tm"], cfg, h, state["tm_x"].to(x.dtype),
                              state["wkv"])
    x = common.residual(x, att)
    h2 = common.layernorm(p["ln2"], x, cfg.norm_eps)
    ffn, cm_x = channel_mix(p["cm"], cfg, h2, state["cm_x"].to(x.dtype))
    return common.residual(x, ffn), {"tm_x": tm_x, "cm_x": cm_x, "wkv": wkv}


def write_state(cache: Dict, state: Dict) -> None:
    """Write a layer's new state into its cache views in place (cast to
    the cache's dtypes; a placed cache shard by shard)."""
    for k, t in state.items():
        common.write_rows(cache[k], t, 0)
