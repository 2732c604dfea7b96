"""Mamba2 (SSD) mixer -- the zamba2 backbone layer (port of
`repro.models.mamba2`).

Chunked State-Space-Duality form (Dao & Gu 2024): within a chunk the
recurrence is a masked attention-like quadratic; across chunks a loop
carries the (H, P, N) state. Decode is the O(1) recurrent step. Scalar
per-head decay A, depthwise causal conv on (x, B, C), gated output -- the
Mamba2 block structure with n_groups shared B/C. The scan runs in float32
with its decays clipped at -60, as in the JAX module.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from . import common

# leaves JAX keeps and multiplies in float32
FLOAT32_LEAVES = ("A_log", "D", "dt_bias")


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    n_heads = d_in // s.head_dim
    return s, d_in, n_heads


def init_params(generator: torch.Generator, cfg: ModelConfig, hold) -> Dict:
    s, d_in, nh = _dims(cfg)
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return {
        # in_proj -> [z (gate), x, B, C, dt]
        "w_in": hold("w_in", common.dense_init(
            generator, (cfg.d_model,
                        2 * d_in + 2 * s.n_groups * s.d_state + nh))),
        "conv_w": hold("conv_w", common.dense_init(
            generator, (s.conv_width, conv_dim), scale=0.5)),
        "conv_b": hold("conv_b", torch.zeros((conv_dim,))),
        "A_log": hold("A_log", torch.log(torch.linspace(1.0, 16.0, nh))),
        "D": hold("D", torch.ones((nh,))),
        "dt_bias": hold("dt_bias", torch.zeros((nh,))),
        "norm": common.rmsnorm_params(d_in, hold),
        "w_out": hold("w_out", common.dense_init(generator,
                                                 (d_in, cfg.d_model))),
    }


def _split_proj(cfg, proj):
    s, d_in, nh = _dims(cfg)
    gn = s.n_groups * s.d_state
    z = proj[..., :d_in]
    xbc = proj[..., d_in:d_in + d_in + 2 * gn]
    dt = proj[..., d_in + d_in + 2 * gn:]
    return z, xbc, dt


def _causal_conv(xbc, w, b, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv along S. xbc: (B,S,C); w: (W,C). `state`
    (B, W-1, C) holds the last inputs for decode. Returns (out,
    new_state)."""
    width = w.shape[0]
    if state is None:
        pad = xbc.new_zeros(xbc.shape[:1] + (width - 1,) + xbc.shape[2:])
    else:
        pad = state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)                        # (B, S+W-1, C)
    s = xbc.shape[1]
    out = xp[:, 0:s] * w[0]
    for i in range(1, width):
        out = out + xp[:, i:i + s] * w[i]
    out = out + b
    return common.silu(out), xp[:, -(width - 1):]


def _ssd_chunked(xh, dt, A, B, C, chunk: int):
    """SSD scan. xh: (b,S,H,P); dt: (b,S,H); A: (H,) (negative);
    B, C: (b,S,G,N). Returns (y (b,S,H,P), final_state (b,H,P,N))."""
    b, S, H, P = xh.shape
    G, N = B.shape[2], B.shape[3]
    assert S % chunk == 0
    nc = S // chunk
    rep = H // G

    xs = common.split_dim(xh, 1, (nc, chunk))
    dts = common.split_dim(dt, 1, (nc, chunk))
    Bs = common.split_dim(B, 1, (nc, chunk))
    Cs = common.split_dim(C, 1, (nc, chunk))

    dA = dts * A                                             # (b,nc,l,H) <= 0
    cum = common.along(lambda t: torch.cumsum(t, dim=2), dA, 2)  # a chunk
    # intra-chunk (attention-like) term: decay(i,j) = exp(cum_i - cum_j)
    li = torch.arange(chunk, device=xh.device)
    causal = li[:, None] >= li[None, :]
    dec = torch.exp(torch.clamp(cum[:, :, :, None, :] - cum[:, :, None, :, :],
                                -60.0, 0.0))                 # (b,nc,i,j,H)
    dec = torch.where(causal[None, None, :, :, None], dec, 0.0)
    CB = common.shard_einsum("bnigN,bnjgN->bnijg", Cs, Bs)   # (b,nc,i,j,G)
    CB = CB.repeat_interleave(rep, dim=4) if rep > 1 else CB
    scores = CB * dec * dts[:, :, None, :, :]                # dt_j factor
    y_intra = common.shard_einsum("bnijh,bnjhp->bnihp", scores, xs)

    # chunk state: sum_j exp(cum_last - cum_j) dt_j B_j x_j
    last = cum[:, :, -1:, :]                                 # (b,nc,1,H)
    decay_to_end = torch.exp(torch.clamp(last - cum, -60.0, 0.0))
    Bh = Bs.repeat_interleave(rep, dim=3) if rep > 1 else Bs
    state_c = common.shard_einsum("bnlh,bnlhN,bnlhp->bnhpN",
                                  decay_to_end * dts, Bh, xs)

    # inter-chunk loop: the state ENTERING each chunk (pre-decay)
    chunk_decay = torch.exp(torch.clamp(last[:, :, 0, :], -60.0, 0.0))
    h = xh.new_zeros((b, H, P, N))
    h_ins = []
    for n in range(nc):
        h_ins.append(h)
        h = h * chunk_decay[:, n, :, None, None] + state_c[:, n]
    h_ins = torch.stack(h_ins, dim=1)                        # (b,nc,H,P,N)

    # inter-chunk contribution: y_j += C_j exp(cum_j) h_in
    Ch = Cs.repeat_interleave(rep, dim=3) if rep > 1 else Cs
    in_decay = torch.exp(torch.clamp(cum, -60.0, 0.0))
    y_inter = common.shard_einsum("bnlhN,bnhpN,bnlh->bnlhp", Ch, h_ins,
                                  in_decay)
    return common.merge_dims(y_intra + y_inter, 1), h


def _ssd(xh, dt, A, B, C, chunk: int):
    """`_ssd_chunked`; DTensors scan shard by shard over batch and heads
    (`common.by_shard`: the scan mixes no two heads or batch rows), the
    heads split over the last mesh dim that splits nothing of `xh` and
    whose ranks divide them (a local slice), as GSPMD keeps the heads of
    the input projection's column split. With one group, each device then
    holds its heads' (chunk x chunk) decays, the scan's largest tensors,
    where the whole heads would be held on every device; B and C stay
    whole (their gradient a partial sum over the heads' ranks). More
    groups than one keep the heads as they come."""
    if hasattr(xh, "placements") and B.shape[2] == 1:
        from torch.distributed.tensor import Replicate, Shard
        mesh = xh.device_mesh
        free = [md for md, p in enumerate(xh.placements)
                if isinstance(p, Replicate) and xh.shape[2] % mesh.size(md) == 0]
        if free:
            places = list(xh.placements)
            places[free[-1]] = Shard(2)
            xh = xh.redistribute(mesh, places)
    return common.by_shard(lambda *ts: _ssd_chunked(*ts, chunk),
                           "bshp,bsh,h,bsgn,bsgn->bshp,bhpn", xh, dt, A, B, C,
                           free="bh")


def _sharded_conv(p: Dict, cfg: ModelConfig, proj, state=None):
    """(z, x, B, C, dt) of a DTensor projection split along its columns
    (`w_in`'s column split), the conv applied to x, B and C: the
    projection taken apart by `common.take_columns` (z, x and dt split
    evenly over the projection's ranks, whole heads each, as the scan
    splits them; B and C, which every head reads, whole), and the
    depthwise conv run on each of x, B and C with its own channels of
    `conv_w` / `conv_b` (exact: no channel mixes with another), device by
    device. `state` is the decode cache's conv state
    (laid out as the cache), taken apart alike. GSPMD moves the same
    columns (collective-permutes); DTensor's own slices would make the
    whole projection, and the scan's heads, whole on every device."""
    s, d_in, nh = _dims(cfg)
    gn = s.n_groups * s.d_state
    z, xs, B, C, dt = common.take_columns(proj, [
        (0, d_in), (d_in, 2 * d_in), (2 * d_in, 2 * d_in + gn),
        (2 * d_in + gn, 2 * d_in + 2 * gn),
        (2 * d_in + 2 * gn, proj.shape[-1])], whole=(2, 3))
    channels = [(0, d_in), (d_in, d_in + gn), (d_in + gn, d_in + 2 * gn)]
    states = (common.take_columns(state, channels, whole=(1, 2))
              if state is not None else [None] * 3)
    out = []
    for t, (a, b), st in zip((xs, B, C), channels, states):
        w, bias = p["conv_w"][:, a:b], p["conv_b"][a:b]
        if st is None:
            out.append(common.by_shard(
                lambda t, w, bias: _causal_conv(t, w, bias)[0],
                "bsc,wc,c->bsc", t, w, bias, free="bc"))
        else:
            out.append(common.by_shard(
                lambda t, w, bias, st: _causal_conv(t, w, bias, st)[0],
                "bsc,wc,c,bkc->bsc", t, w, bias, st, free="bc"))
    return (z, *out, dt)


def forward(p: Dict, cfg: ModelConfig, x: torch.Tensor, approx=None,
            return_state: bool = False):
    """Full-sequence Mamba2 mixer. x: (B, S, d_model). With
    return_state=True also returns the decode cache ({conv, ssm}) after
    the sequence -- the prefill -> decode state handoff. A DTensor
    projection is taken apart by `_sharded_conv`."""
    s, d_in, nh = _dims(cfg)
    bsz, S, _ = x.shape
    gn = s.n_groups * s.d_state
    w = s.conv_width
    proj = x @ p["w_in"]
    if hasattr(proj, "placements"):
        z, xs, B, C, dt = _sharded_conv(p, cfg, proj)
    else:
        z, xbc, dt = _split_proj(cfg, proj)
        xbc_raw = xbc  # pre-conv inputs: the conv decode state is their tail
        xbc, _ = _causal_conv(xbc, p["conv_w"], p["conv_b"])
        xs = xbc[..., :d_in]
        B, C = xbc[..., d_in:d_in + gn], xbc[..., d_in + gn:]
    B = common.split_dim(B, 2, (s.n_groups, s.d_state))
    C = common.split_dim(C, 2, (s.n_groups, s.d_state))
    dt_f = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])                               # (H,) negative
    xh = common.split_dim(xs, 2, (nh, s.head_dim))
    # pad S to a whole number of SSD chunks (dt=0 on padding => identity)
    chunk = min(s.chunk_size, S)
    pad = (-S) % chunk
    xh_p, B_p, C_p = xh, B, C
    if pad:
        # a DTensor pads its local shards (its sequence is whole): the
        # card's torch refuses DTensor's own pad of a head-split tensor
        xh_p = common.along(lambda t: F.pad(t, (0, 0, 0, 0, 0, pad)), xh, 1)
        dt_f = common.along(lambda t: F.pad(t, (0, 0, 0, pad)), dt_f, 1)
        B_p = common.along(lambda t: F.pad(t, (0, 0, 0, 0, 0, pad)), B, 1)
        C_p = common.along(lambda t: F.pad(t, (0, 0, 0, 0, 0, pad)), C, 1)
    y, h_final = _ssd(xh_p.float(), dt_f, A, B_p.float(), C_p.float(),
                      chunk)
    y = y[:, :S] + xh.float() * p["D"][None, None, :, None]
    y = common.merge_dims(y, 2).to(x.dtype)
    y = common.rmsnorm(p["norm"], y * common.silu(z), cfg.norm_eps)
    out = y @ p["w_out"]
    if not return_state:
        return out
    if hasattr(proj, "placements"):
        # the conv inputs' tail, taken from the projection's columns into
        # the cache's even split of them
        tail = (proj[:, S - (w - 1):S] if S >= w - 1 else common.along(
            lambda t: F.pad(t, (0, 0, w - 1 - S, 0)), proj, 1))
        conv_state = common.take_columns(tail, [(d_in, 2 * d_in + 2 * gn)])[0]
    elif S >= w - 1:
        conv_state = xbc_raw[:, S - (w - 1):S]
    else:
        conv_state = torch.cat(
            [xbc_raw.new_zeros((bsz, w - 1 - S) + xbc_raw.shape[2:]),
             xbc_raw], dim=1)
    return out, {"conv": conv_state, "ssm": h_final}


def init_cache(cfg: ModelConfig, lead: Tuple[int, ...], batch: int, dtype,
               device=None, new=None) -> Dict:
    """The decode cache of a stack of mixers with leading shape `lead`
    (the JAX model's vmapped caches): conv in `dtype`, ssm in float32,
    each leaf made by `new(shape, dtype)` (zeros on `device` by
    default)."""
    new = new or common.leaf_maker(device)
    s, d_in, nh = _dims(cfg)
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return {
        "conv": new(tuple(lead) + (batch, s.conv_width - 1, conv_dim),
                    dtype),
        "ssm": new(tuple(lead) + (batch, nh, s.head_dim, s.d_state),
                   torch.float32),
    }


def decode_step(p: Dict, cfg: ModelConfig, x: torch.Tensor, cache: Dict,
                approx=None) -> Tuple[torch.Tensor, Dict]:
    """O(1) recurrent step. x: (B, 1, d_model). Returns (out, the new
    {conv, ssm} state); the caller writes it into its cache."""
    s, d_in, nh = _dims(cfg)
    gn = s.n_groups * s.d_state
    proj = x @ p["w_in"]
    if hasattr(proj, "placements"):
        z, xs, B, C, dt = _sharded_conv(p, cfg, proj, state=cache["conv"])
        # the new conv state in the cache's layout: its last rows and the
        # step's conv inputs, split as the cache splits them
        row = common.take_columns(proj, [(d_in, 2 * d_in + 2 * gn)])[0]
        conv_state = torch.cat([cache["conv"].to(row.dtype), row],
                               dim=1)[:, 1 - s.conv_width:]
        B, C = B[:, 0], C[:, 0]
    else:
        z, xbc, dt = _split_proj(cfg, proj)
        xbc, conv_state = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                       state=cache["conv"])
        xs = xbc[..., :d_in]
        B, C = xbc[:, 0, d_in:d_in + gn], xbc[:, 0, d_in + gn:]
    B = common.split_dim(B, 1, (s.n_groups, s.d_state))
    C = common.split_dim(C, 1, (s.n_groups, s.d_state))
    rep = nh // s.n_groups
    Bh = B.repeat_interleave(rep, dim=1) if rep > 1 else B   # (b,H,N)
    Ch = C.repeat_interleave(rep, dim=1) if rep > 1 else C
    dt_f = F.softplus(dt[:, 0].float() + p["dt_bias"])       # (b,H)
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt_f * A[None, :])                     # (b,H)
    xh = common.split_dim(xs[:, 0], 1, (nh, s.head_dim)).float()
    h = cache["ssm"] * decay[:, :, None, None] + common.shard_einsum(
        "bh,bhN,bhp->bhpN", dt_f, Bh.float(), xh)
    y = common.shard_einsum("bhN,bhpN->bhp", Ch.float(), h)
    y = y + xh * p["D"][None, :, None]
    # a head dim the cache splits (batch 1: over the data ranks) is made
    # whole first, so the heads keep z's split
    y = common.merge_dims(common.unshard(y, 2), 1)[:, None].to(x.dtype)
    y = common.rmsnorm(p["norm"], y * common.silu(z), cfg.norm_eps)
    out = y @ p["w_out"]
    return out, {"conv": conv_state.to(cache["conv"].dtype), "ssm": h}
