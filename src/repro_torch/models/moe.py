"""Mixture-of-Experts layer: GShard-style top-k routing with capacity,
grouped dispatch and optional shared (always-on) experts -- the
DeepSeek-V3 / OLMoE shapes (port of `repro.models.moe`).

Beyond-paper AC composition: *expert perforation* -- herded dropping of
experts over the expert list (the paper's loop-perforation insight applied
to the expert loop). The drop set is herded (static and shared), so the
dropped experts' weights are never touched.

Routing follows the JAX module decision for decision: float32 router
logits on `x` cast to float32, softmax, the top k with ties broken toward
the lower expert index (`lax.top_k`'s order, a stable descending sort
here), and each (token, slot)'s capacity rank counted over the group's
flattened (token, slot) order, so the same tokens drop. The JAX module's
one-hot dispatch and combine products become an index scatter into the
(group, expert, capacity) buffer and a gather back: the expert products
run over the same (E, C) slots, and each kept slot's output is weighted as
the JAX combine weights it (its weight rounded to the compute dtype).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig, MoEConfig
from ..core.perforation import kept_indices
from ..core.types import ApproxSpec, Technique
from . import common, mlp

# leaves JAX keeps and multiplies in float32 (the router runs in float32)
FLOAT32_LEAVES = ("router",)


def init_params(generator: torch.Generator, cfg: ModelConfig, hold) -> Dict:
    m = cfg.moe
    d = cfg.d_model

    def dense(name, shape, scale=None):
        return hold(name, common.dense_init(generator, shape, scale=scale))

    p = {
        "router": dense("router", (d, m.n_experts)),
        # experts stacked on a leading E axis
        "w_gate": dense("w_gate", (m.n_experts, d, m.d_ff_expert),
                        1.0 / (d ** 0.5)),
        "w_up": dense("w_up", (m.n_experts, d, m.d_ff_expert),
                      1.0 / (d ** 0.5)),
        "w_down": dense("w_down", (m.n_experts, m.d_ff_expert, d),
                        1.0 / (m.d_ff_expert ** 0.5)),
    }
    if m.n_shared_experts:
        p["shared"] = mlp.init_params(
            generator, d, m.d_ff_expert * m.n_shared_experts, "gated_silu",
            hold)
    return p


def _capacity(m: MoEConfig, group: int) -> int:
    c = int(group * m.experts_per_token * m.capacity_factor / m.n_experts)
    return max(c, m.experts_per_token)


def kept_experts(n_experts: int, approx: Optional[ApproxSpec]):
    """The experts an expert-perforation spec keeps (None: all of them)."""
    if approx is None or approx.technique != Technique.PERFORATION:
        return None
    kept = kept_indices(n_experts, approx.perforation)
    return kept if len(kept) < n_experts else None


def route(logits: torch.Tensor, k: int, cap: int):
    """The routing decisions of float32 router logits (g, t, E): the top-k
    experts `top_i` (g, t, k), their renormalized weights `top_w`, each
    (token, slot)'s rank `pos` within its expert and whether it fits the
    capacity (`keep`), and the softmax `probs`."""
    g, t, n_e = logits.shape
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k's order: descending, ties toward the lower index
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[..., :k], top_i[..., :k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    # rank of each (token, slot) within its expert: the assignments before
    # it in the flattened (t, k) order
    # `one_hot` as a comparison: F.one_hot reads its input's range first
    # where it has data, which a count of shapes alone cannot see
    flat = top_i.reshape(g, t * k)
    onehot = (flat[..., None] == torch.arange(n_e, device=flat.device)).long()
    before = torch.cumsum(onehot, dim=1) - onehot
    pos = torch.gather(before, 2, top_i.reshape(g, t * k, 1)).reshape(g, t, k)
    return top_i, top_w, pos, pos < cap, probs


def _expert_counts(top_i: torch.Tensor, n_e: int) -> torch.Tensor:
    """(E,) float32: how many (token, slot) pairs chose each expert. A
    DTensor's devices count their own tokens' choices, summed over the
    ranks that split them (an all-reduce of E counts; DTensor cannot add
    into a plain tensor, nor index-add a split index)."""
    if not hasattr(top_i, "placements"):
        ce = torch.zeros((n_e,), dtype=torch.float32, device=top_i.device)
        ce.index_add_(0, top_i.reshape(-1),
                      torch.ones(top_i.numel(), device=top_i.device))
        return ce
    from torch.distributed.tensor import Partial, Replicate, Shard
    local = top_i.to_local()
    ce = torch.zeros((n_e,), dtype=torch.float32, device=local.device)
    ce.index_add_(0, local.reshape(-1),
                  torch.ones(local.numel(), device=local.device))
    return common.settle(common._from_local(ce, top_i.device_mesh, [
        Partial() if isinstance(p, Shard) else Replicate()
        for p in top_i.placements], (n_e,)))


def _dispatch_by_shard(xg, slot, keep, w_kept, w_experts, n_e: int,
                       cap: int):
    """The dispatch and combine of DTensors, each device on its own shard,
    as GSPMD lays them out under the JAX module's hints: the (g, E, C, d)
    buffer's groups split as the tokens `xg` (g, group, d) are (the data
    axes) and its experts where the expert stacks `w_experts` split theirs
    (`model`, each device its own experts' weights). `slot`, `keep` and
    `w_kept` are each (token, slot) pair's row e * C + pos, whether it
    fits and its weight, (g, group * k).

    Each device fills its shard of the buffer with a gather: each of its
    rows takes the token that chose it (zeros where none did), so neither
    the k copies of each token nor the whole buffer's spare row (which
    would make its expert dim uneven) are made. Returns (the buffer,
    `combine`): `combine(ye)` of the experts' outputs (g, E, C, d) is each
    token's kept slots on this device weighted by `w_kept` and summed in
    float32, as a product with the shard's (group, E_shard * C) combine
    weights (JAX's combine einsum, where gathering each slot's output
    would hold k float32 copies of the tokens), cast to the compute dtype,
    then summed over the devices that split the experts (an all-reduce of
    the (g, group, d) output). The routing decisions, capacities and drops
    are the plain version's; the sum over a token's slots runs in another
    order."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    g, group, d = xg.shape
    k = slot.shape[1] // group
    mesh = xg.device_mesh
    places, grads = [], []
    for p, pw in zip(xg.placements, w_experts.placements):
        if isinstance(p, Shard) and p.dim == 0:
            places.append(Shard(0))
            grads.append(Shard(0))
        elif isinstance(pw, Shard) and pw.dim == 0:
            places.append(Shard(1))      # experts: this device's only
            grads.append(Partial())
        else:
            places.append(Replicate())
            grads.append(Replicate())
    rows = [Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in places]
    shape = (g, n_e, cap, d)
    local_shape, offset = compute_local_shape_and_global_offset(
        shape, mesh, places)
    n_rows, lo = local_shape[1] * cap, offset[1] * cap   # this device's
    xg, slot, keep, w_kept = (
        v if list(v.placements) == rows else v.redistribute(mesh, rows)
        for v in (common.settle(xg), slot, keep, w_kept))
    x_l = xg.to_local(grad_placements=grads)
    g_l, dev = x_l.shape[0], x_l.device
    mine = slot.to_local() - lo
    col = torch.where(keep.to_local() & (mine >= 0) & (mine < n_rows), mine,
                      n_rows)                 # other slots: a spare column
    token = torch.arange(group * k, device=dev).expand(g_l, -1) // k
    # the token each of the shard's rows takes (`group`: none)
    who = torch.full((g_l, n_rows + 1), group, dtype=token.dtype, device=dev)
    who.scatter_(1, col, token)
    who = who[:, :n_rows].unsqueeze(-1)
    xe = torch.where(who < group, torch.gather(
        x_l, 1, who.clamp(max=group - 1).expand(-1, -1, d)), 0)
    xe = common._from_local(xe.reshape(g_l, -1, cap, d), mesh, places, shape)
    weights = torch.zeros((g_l, group * (n_rows + 1)), dtype=torch.float32,
                          device=dev)
    weights.scatter_add_(1, token * (n_rows + 1) + col,
                         w_kept.to_local(grad_placements=grads)[..., 0]
                         .float())
    weights = weights.view(g_l, group, n_rows + 1)[..., :n_rows]

    def combine(ye):
        if list(ye.placements) != places:
            ye = ye.redistribute(mesh, places)
        out = torch.bmm(weights, ye.to_local().reshape(g_l, n_rows, d)
                        .float()).to(x_l.dtype)
        return common.settle(common._from_local(out, mesh, [
            Partial() if isinstance(p, Shard) and p.dim == 1 else p
            for p in places], (g, group, d)))

    return xe, combine


def forward(p: Dict, cfg: ModelConfig, x: torch.Tensor,
            approx: Optional[ApproxSpec] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss). Dropped-token policy: capacity
    overflow falls through to the shared expert / residual (standard
    GShard)."""
    m = cfg.moe
    b, s, d = x.shape
    dt = x.dtype
    n_e = m.n_experts

    router_w = p["router"]
    w_gate, w_up, w_down = p["w_gate"], p["w_up"], p["w_down"]
    kept = kept_experts(n_e, approx)
    if kept is not None:
        idx = torch.as_tensor(kept, device=x.device)
        router_w = router_w.index_select(1, idx)
        w_gate = w_gate.index_select(0, idx)
        w_up = w_up.index_select(0, idx)
        w_down = w_down.index_select(0, idx)
        n_e = len(kept)

    group = min(m.router_group_size, b * s)
    n_tokens = b * s
    assert n_tokens % group == 0, (n_tokens, group)
    g = n_tokens // group
    # the tokens' partial sums summed, and each path's gradient brought
    # back to their layout before the paths' gradients are added
    x = common.settle(x)
    xg = common.split_dim(common.merge_dims(common.pin_grad(x), 0), 0,
                          (g, group))

    # xg feeds the router and the dispatch: each path's gradient comes back
    # in xg's layout before they are added
    logits = common.shard_einsum("gtd,de->gte", common.pin_grad(xg).float(),
                                 router_w.float())
    k = min(m.experts_per_token, n_e)
    cap = _capacity(m, group)
    # routing stays within each group: run it on the local groups
    top_i, top_w, pos, keep, probs = common.along(
        lambda lg: route(lg, k, cap), logits, (1, 2))

    # aux load-balance loss (Switch-style): E * sum_e f_e * P_e
    me = probs.mean(dim=(0, 1))
    ce = _expert_counts(top_i, n_e) / (g * group)
    aux = n_e * torch.sum(me * ce) * m.aux_loss_coef

    # dispatch: each kept (token, slot) to row e * cap + pos of its group
    slot = (top_i * cap + pos).reshape(g, group * k)
    keep_f = keep.reshape(g, group * k)
    w_kept = (top_w * keep).to(dt).reshape(g, group * k, 1)
    sharded = hasattr(xg, "placements")
    if sharded:
        xe, combine = _dispatch_by_shard(common.pin_grad(xg), slot, keep_f,
                                         w_kept, w_gate, n_e, cap)
    else:
        src = common.merge_dims(
            common.pin_grad(xg).unsqueeze(2).expand(g, group, k, d), 1)
        xe = torch.zeros((g, n_e * cap + 1, d), dtype=dt, device=x.device)
        # dropped slots land on the spare last row, which no expert reads
        dest = torch.where(keep_f, slot, n_e * cap)
        xe.scatter_(1, dest.unsqueeze(-1).expand(-1, -1, d), src)
        xe = common.split_dim(xe[:, :n_e * cap], 1, (n_e, cap))

    h = common.silu(common.shard_einsum("gecd,edf->gecf", xe, w_gate)) \
        * common.shard_einsum("gecd,edf->gecf", xe, w_up)
    ye = common.shard_einsum("gecf,efd->gecd", h, w_down)

    # combine: the kept slots' outputs, weighted in the compute dtype
    if sharded:
        out = combine(ye)
    else:
        ye = common.merge_dims(ye, 1)
        got = torch.gather(ye, 1, torch.where(keep_f, slot, 0)
                           .unsqueeze(-1).expand(-1, -1, d))
        out = (got.float() * w_kept.float()).reshape(g, group, k, d).sum(2)
    # (g, group) -> (b, s); the gradient comes back in this layout (DTensor
    # flattens a gradient split over both dims into one it cannot split)
    out = common.pin_grad(common.split_dim(common.merge_dims(out.to(dt), 0),
                                           0, (b, s)))
    if m.n_shared_experts:
        out = out + mlp.forward(p["shared"], cfg, common.pin_grad(x),
                                "gated_silu")
    return out, aux.float()
