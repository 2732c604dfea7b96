"""Shared model components: init, norms, RoPE and the attention math (port
of `repro.models.common`).

Plain functions on tensors. Parameters are nested dicts of tensors with
the JAX package's names and layouts (`x @ W`, W stored (in, out)), so a
JAX parameter tree carries across leaf for leaf (`convert.lm_params`).
The JAX module's sharding hints have no meaning on one card and are gone;
its `scan_layers` is a Python loop in `models.lm`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint


def dense_init(generator: torch.Generator, shape,
               scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal fan-in init: a standard normal cut at +-2, times
    1/sqrt(fan_in) (the JAX package's scales), float32 on the generator's
    device (a model's `hold` moves and casts it)."""
    if generator.device.type == "meta":  # a shape-only draw (specs.MetaDraw)
        return torch.empty(shape, dtype=torch.float32, device="meta")
    fan_in = shape[0] if len(shape) >= 1 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(scale)


def embed_init(generator: torch.Generator, shape) -> torch.Tensor:
    if generator.device.type == "meta":  # a shape-only draw (specs.MetaDraw)
        return torch.empty(shape, dtype=torch.float32, device="meta")
    t = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return t.mul_(0.02)


# ----------------------------------------------------------------------------
# norms
# ----------------------------------------------------------------------------

# the leaves of a norm's parameter dict: held in the param dtype and cast
# to float32 at use, as the JAX norms do
NORM_LEAVES = ("scale", "bias")


class DtypeRule:
    """The dtype rule of one model, in the two stages JAX applies it.

    `store(name, t)` puts a freshly drawn float32 leaf named `name` on
    `device` in the dtype JAX stores, differentiates and updates it in: a
    leaf of `float32_leaves` (each module's table of leaves JAX keeps and
    uses in float32) float32, every other leaf the param dtype. `use(name,
    t)` is the cast at use: every leaf but a norm leaf (cast to float32
    inside the norm) and a float32 leaf goes to the compute dtype (JAX's
    `.astype(x.dtype)`). `use` is a differentiable `Tensor.to`, so the
    stored (master) leaf receives the gradient, as the transpose of JAX's
    `astype` gives it. `hold = use . store` is the serving form: the cast
    done once at init instead of at every use."""

    def __init__(self, param_dtype: torch.dtype, compute_dtype: torch.dtype,
                 device, float32_leaves=()):
        self.param_dtype, self.compute_dtype = param_dtype, compute_dtype
        self.device, self.float32_leaves = device, tuple(float32_leaves)

    def _cast_at_use(self, name: str) -> bool:
        return name not in self.float32_leaves and name not in NORM_LEAVES

    def store(self, name: str, t: torch.Tensor) -> torch.Tensor:
        t = t.to(self.device)
        if name in self.float32_leaves:
            return t.to(torch.float32)
        return t.to(self.param_dtype)

    def use(self, name: str, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.compute_dtype) if self._cast_at_use(name) else t

    def hold(self, name: str, t: torch.Tensor) -> torch.Tensor:
        t = t.to(self.device)
        if self._cast_at_use(name) \
                and t.dtype == self.compute_dtype != self.param_dtype:
            # round in place: a full-width expert stack is gigabytes, and
            # the caller still holds `t`
            return t.copy_(t.to(self.param_dtype))
        return self.use(name, self.store(name, t))


# ----------------------------------------------------------------------------
# cache leaves
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LeafShape:
    """A cache leaf's shape, dtype and fill value, nothing allocated: the
    leaf maker a model's cache is built with to lay it out first (a leaf
    of a tree, not a sequence)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    fill: float = 0


def leaf_maker(device):
    """The plain leaf maker of a cache: `new(shape, dtype, fill=0)`, a
    tensor of `fill` on `device`."""
    def new(shape, dtype, fill=0):
        if fill:
            return torch.full(shape, fill, dtype=dtype, device=device)
        return torch.zeros(shape, dtype=dtype, device=device)
    return new


def placed_leaf(leaf: LeafShape, mesh, places, device) -> torch.Tensor:
    """The DTensor of `leaf`'s shape laid out by `places` on `mesh`, filled
    with `leaf.fill`: only this device's shard is allocated, on
    `device`."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    shape = tuple(leaf.shape)
    local_shape = compute_local_shape_and_global_offset(shape, mesh,
                                                        places)[0]
    local = leaf_maker(device)(tuple(local_shape), leaf.dtype, leaf.fill)
    return DTensor.from_local(local, mesh, places, run_check=False,
                              shape=shape, stride=contiguous_strides(shape))


def contiguous_strides(shape) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of `shape` (computed, not read
    off an allocation, which the dry run would count)."""
    out, step = [], 1
    for n in reversed(tuple(shape)):
        out.append(step)
        step *= max(n, 1)
    return tuple(reversed(out))


def write_rows(dst: torch.Tensor, src: torch.Tensor, dim: int,
               start: int = 0) -> torch.Tensor:
    """`dst`'s entries `start` .. `start + n` along `dim` set to `src` (n =
    `src.shape[dim]`), in place, cast to `dst`'s dtype: a cache filled by a
    prompt, or written at a decoded position. A DTensor `dst` is written
    shard by shard: `src` is laid out as `dst` (whole along `dim` unless it
    covers all of it there), so the write moves no more than that
    redistribution (none where the layouts agree, a local slice where
    `src` is whole, an all-to-all where `src` is split along another dim:
    `_swap_split`), and each device copies the rows its shard holds.
    DTensor's own copy into a slice of a split dim makes the slice whole:
    it writes a temporary, and `dst` is left as it was. Plain tensors are
    written as they are."""
    n = src.shape[dim]
    dim %= dst.ndim
    if not hasattr(dst, "placements"):
        dst[(slice(None),) * dim + (slice(start, start + n),)].copy_(src)
        return dst
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh = dst.device_mesh
    if not hasattr(src, "placements"):
        src = DTensor.from_local(src, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    part = start != 0 or n != dst.shape[dim]
    want = [Replicate() if part and isinstance(p, Shard)
            and p.dim % dst.ndim == dim else p for p in dst.placements]
    for md, (p, q) in enumerate(zip(src.placements, want)):
        if isinstance(p, Shard) and isinstance(q, Shard) \
                and p.dim % dst.ndim != q.dim % dst.ndim and not any(
                    o.is_shard() and o.dim % dst.ndim == q.dim % dst.ndim
                    for o in src.placements):
            src = _swap_split(src, md, q.dim % dst.ndim)
    if list(src.placements) != want:
        src = src.redistribute(mesh, want)
    d_loc, s_loc = dst.to_local(), src.to_local()
    if not part:
        d_loc.copy_(s_loc)
        return dst
    lo = compute_local_shape_and_global_offset(
        dst.shape, mesh, dst.placements)[1][dim]
    a, b = max(start, lo), min(start + n, lo + d_loc.shape[dim])
    if b > a:
        d_loc.narrow(dim, a - lo, b - a).copy_(s_loc.narrow(dim, a - start,
                                                              b - a))
    return dst


def unshard(t: torch.Tensor, dim: int) -> torch.Tensor:
    """`t` with dim `dim` whole on every rank: a DTensor sharded (or
    partial) along it is redistributed to replicate there, for an op that
    has no DTensor rule over a split dim (a gather along it); a plain
    tensor is returned as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(t, DTensor):
        return t
    dim = dim % t.ndim
    places = [Replicate() if not isinstance(p, Shard) or p.dim == dim
              else p for p in t.placements]
    return t.redistribute(t.device_mesh, places)


def gather_fsdp(tree, x: torch.Tensor):
    """`tree` (a layer's parameters: dicts and lists of tensors) with each
    DTensor leaf made whole over the mesh dims that split `x`'s batch (its
    dim 0): FSDP's gather of a layer's weights before it runs, as GSPMD
    gathers a weight split over the data axes where it meets activations
    split over them. DTensor's own product would instead move the
    activations to the weight's split (the batch made whole on every
    device, the product a partial sum over the data axes). A weight's
    gradient goes back to its split as a reduce-scatter. Weights split
    over no such dim, and plain trees, are returned as they are."""
    if not hasattr(x, "placements"):
        return tree
    from torch.distributed.tensor import Replicate, Shard
    batch = [isinstance(p, Shard) and p.dim == 0 for p in x.placements]

    def one(t):
        if isinstance(t, dict):
            return {k: one(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [one(v) for v in t]
        if not hasattr(t, "placements"):
            return t
        places = [Replicate() if b and isinstance(p, Shard) else p
                  for b, p in zip(batch, t.placements)]
        if places == list(t.placements):
            return t
        return t.redistribute(t.device_mesh, places)

    return one(tree)


def settle(t: torch.Tensor) -> torch.Tensor:
    """`t` with its partial sums summed: a DTensor partial over a mesh dim
    (the output of a product split along its contraction, and what is
    added to it) is replicated there, through one all-reduce of its local
    shard over that dim (`_sum_partials`); anything else is returned as it
    is. DTensor keeps a sum pending through linear ops, and a reshape of
    such a tensor, or its gradient, can take a layout DTensor cannot view
    back. The all-reduce is issued here and not by DTensor's
    redistribution, whose plan for a partial sum depends on torch's
    version (torch 2.13 sums some as a reduce-scatter and an all-gather).
    Its gradient passes as it comes along the summed dims, as
    `redistribute`'s does (a sum's gradient is whole)."""
    if not hasattr(t, "placements") or not any(
            p.is_partial() for p in t.placements):
        return t
    return _Settle.apply(t)


def residual(x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """`x + out`: the residual stream and a sublayer's output, each summed
    first where it is a partial sum (`settle`), so that the stream is whole
    after every add; where the stream is split along a dim over a mesh dim
    on which `out` is a partial sum (deepseek-v3's MTP block, whose input
    comes split along d_model), `out` is summed into that split instead,
    through one reduce-scatter, its gradient made whole through one
    all-gather (`_ScatterSum`). DTensor would plan the add of a partial sum
    itself, and torch's versions plan it apart: 2.11 sums the partial
    operand of a whole and a partial one, 2.13 leaves the sum pending, for
    the next norm to sum again in each layer's recompute. Plain tensors
    are added as they are."""
    x = settle(x)
    for md, p in enumerate(getattr(out, "placements", ())):
        q = x.placements[md] if hasattr(x, "placements") else None
        if p.is_partial() and q is not None and q.is_shard() \
                and out.shape[q.dim] % out.device_mesh.size(md) == 0:
            out = _ScatterSum.apply(out, md, q.dim % out.ndim)
    return x + settle(out)


def whole_along(t: torch.Tensor, dim: int) -> torch.Tensor:
    """`t` with dim `dim` whole: a DTensor split evenly along it over one
    mesh dim is gathered there through one all-gather of the local shards
    (`_Gather`), its gradient summed back into the split through one
    reduce-scatter; anything else is returned as it is. DTensor's own
    gradient of a gather plans that sum by torch's version (2.13 as a
    reduce-scatter along the batch and an all-to-all)."""
    md = _split_over(t, dim)
    if md is None or t.shape[dim] % t.device_mesh.size(md):
        return t
    return _Gather.apply(t, md, dim % t.ndim)


def _gather_local(local: torch.Tensor, dim: int, n: int,
                  group: str) -> torch.Tensor:
    """The shards `local` of `n` ranks joined along `dim` (one
    all-gather)."""
    moved = local.movedim(dim, 0).contiguous()
    out = _collective("all_gather_into_tensor", moved, n, group)
    return out.movedim(0, dim)


def _scatter_local(local: torch.Tensor, dim: int, n: int,
                   group: str) -> torch.Tensor:
    """This rank's part along `dim` of the sum of the `n` ranks' `local`
    (one reduce-scatter)."""
    moved = local.movedim(dim, 0).contiguous()
    out = _collective("reduce_scatter_tensor", moved, "sum", n, group)
    return out.movedim(0, dim)


class _ScatterSum(torch.autograd.Function):
    """A partial sum over mesh dim `md` summed into a split along `dim`
    there (one reduce-scatter); backward makes the gradient whole there
    (one all-gather), as a partial sum's gradient is."""

    @staticmethod
    def forward(ctx, t, md, dim):
        from torch.distributed.tensor import Shard
        mesh, places = t.device_mesh, list(t.placements)
        ctx.args = (mesh, md, dim, tuple(places))
        local = _scatter_local(t.to_local(), dim, mesh.size(md),
                               mesh.get_group(md).group_name)
        places[md] = Shard(dim)
        return _from_local(local, mesh, places, tuple(t.shape))

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import Replicate
        mesh, md, dim, places = ctx.args
        want = [Replicate() if p.is_partial() else p for p in places]
        if grad.placements[md].is_shard() \
                and grad.placements[md].dim % grad.ndim == dim:
            local = _gather_local(grad.to_local(), dim, mesh.size(md),
                                  mesh.get_group(md).group_name)
            now = list(grad.placements)
            now[md] = Replicate()
            grad = _from_local(local, mesh, now, tuple(grad.shape))
        return _relayout(grad, mesh, want), None, None


class _Gather(torch.autograd.Function):
    """A split along `dim` over mesh dim `md` made whole (one all-gather);
    backward sums a partial gradient back into the split (one
    reduce-scatter) and cuts a whole one."""

    @staticmethod
    def forward(ctx, t, md, dim):
        from torch.distributed.tensor import Replicate
        mesh, places = t.device_mesh, list(t.placements)
        ctx.args = (mesh, md, dim, tuple(places))
        local = _gather_local(t.to_local(), dim, mesh.size(md),
                              mesh.get_group(md).group_name)
        places[md] = Replicate()
        return _from_local(local, mesh, places, tuple(t.shape))

    @staticmethod
    def backward(ctx, grad):
        mesh, md, dim, places = ctx.args
        n = mesh.size(md)
        now = list(grad.placements)
        if now[md].is_partial():
            local = _scatter_local(grad.to_local(), dim, n,
                                   mesh.get_group(md).group_name)
        elif now[md].is_replicate():
            local = grad.to_local().chunk(n, dim)[mesh.get_local_rank(md)]
        else:
            return _relayout(grad, mesh, places), None, None
        now[md] = places[md]
        grad = _from_local(local, mesh, now, tuple(grad.shape))
        return _relayout(grad, mesh, places), None, None


def _sum_partials(t: torch.Tensor, dims) -> torch.Tensor:
    """DTensor `t` replicated over the mesh dims `dims` where it is a
    partial sum: its local shard all-reduced over each (the functional
    collective, outside autograd)."""
    from torch.distributed.tensor import Replicate
    mesh, places = t.device_mesh, list(t.placements)
    local = t.to_local()
    for md in dims:
        local = _collective("all_reduce", local, places[md].reduce_op,
                            mesh.get_group(md).group_name)
        places[md] = Replicate()
    return _from_local(local, mesh, places, tuple(t.shape))


def _relayout(t: torch.Tensor, mesh, places) -> torch.Tensor:
    """DTensor `t` laid out by `places` on `mesh`: its partial sums that
    `places` replicate summed by `_sum_partials`, the rest by DTensor's
    redistribution."""
    places = tuple(places)
    partial = [md for md, (p, q) in enumerate(zip(t.placements, places))
               if p.is_partial() and q.is_replicate()]
    if partial:
        t = _sum_partials(t, partial)
    if tuple(t.placements) != places:
        t = t.redistribute(mesh, places)
    return t


class _Settle(torch.autograd.Function):
    """`settle`'s sum; backward keeps the gradient's layout along the
    summed dims and lays out the others as the input's."""

    @staticmethod
    def forward(ctx, t):
        ctx.mesh, ctx.placements = t.device_mesh, tuple(t.placements)
        return _sum_partials(t, [md for md, p in enumerate(t.placements)
                                 if p.is_partial()])

    @staticmethod
    def backward(ctx, grad):
        places = tuple(g if p.is_partial() else p
                       for p, g in zip(ctx.placements, grad.placements))
        return _relayout(grad, ctx.mesh, places)


def pin_grad(t: torch.Tensor) -> torch.Tensor:
    """`t`, whose gradient is laid out as `t` is in backward before it
    reaches the op that made `t` (a DTensor's, its partial sums summed by
    `_relayout`; a plain tensor is returned as it is). A view that DTensor
    could take forward only in one layout (a split or merged dim made
    whole first) otherwise gets a gradient in the layout the ops after it
    chose, which DTensor may refuse to view back."""
    if not hasattr(t, "placements"):
        return t
    return _PinGrad.apply(t)


class _PinGrad(torch.autograd.Function):
    """Identity forward; backward lays out the gradient as the forward's
    placements (a partial sum's gradient is whole)."""

    @staticmethod
    def forward(ctx, t):
        from torch.distributed.tensor import Replicate
        ctx.mesh = t.device_mesh
        ctx.placements = tuple(Replicate() if p.is_partial() else p
                               for p in t.placements)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return _relayout(grad, ctx.mesh, ctx.placements)


def take_columns(t: torch.Tensor, bounds, whole=()) -> list:
    """The pieces `t[..., a:b]` for each (a, b) of `bounds` (they may
    overlap). A DTensor split along its last dim over one mesh dim (a
    column-parallel product's output) is taken apart without making that
    dim whole: a piece whose width its ranks divide, and whose index is not
    in `whole`, comes out split evenly over them, each rank receiving its
    columns from the ranks that hold them (one all-to-all for all such
    pieces); any other piece comes out whole on every rank, each rank
    adding its own columns into zeros (one all-reduce of those pieces'
    width). Both move only the pieces' columns, as GSPMD's
    collective-permutes move them, where DTensor's slice of a split dim
    would gather all of `t`. The other mesh dims keep `t`'s placements.
    Plain tensors, and DTensors not so split, are sliced."""
    pieces = [(int(a), int(b)) for a, b in bounds]
    md = _split_over(t, -1)
    if md is None:
        return [t[..., a:b] for a, b in pieces]
    from torch.distributed.tensor import Replicate, Shard
    t = settle(t)
    mesh = t.device_mesh
    n, me = mesh.size(md), mesh.get_local_rank(md)
    group = mesh.get_group(md).group_name
    held = _chunks(t.shape[-1], n)    # the columns each rank holds

    def owed(a, b, r):                # rank r's columns of an even piece
        w = (b - a) // n
        return a + r * w, a + (r + 1) * w

    local = t.to_local()
    lo = held[me][0]
    lead = tuple(t.shape[:-1])
    even = [i for i, (a, b) in enumerate(pieces)
            if (b - a) % n == 0 and i not in whole]
    summed = [i for i in range(len(pieces)) if i not in even]
    out = [None] * len(pieces)
    if even:
        cols = _route(local, -1, held, [[owed(*pieces[i], r) for i in even]
                                        for r in range(n)], me, group)
        places = list(t.placements)
        places[md] = Shard(t.ndim - 1)
        for c, i in zip(cols, even):
            a, b = pieces[i]
            out[i] = _from_local(c, mesh, places, lead + (b - a,))
    if summed:
        own, parts = held[me], []
        for i in summed:
            a, b = pieces[i]
            x, y = _meet(own, (a, b))
            parts += [local.new_zeros(local.shape[:-1] + (x - a,)),
                      local[..., x - lo:y - lo],
                      local.new_zeros(local.shape[:-1] + (b - y,))]
        sums = _SumOver.apply(torch.cat(parts, dim=-1), group).split(
            [pieces[i][1] - pieces[i][0] for i in summed], dim=-1)
        places = list(t.placements)
        places[md] = Replicate()
        for j, i in enumerate(summed):
            a, b = pieces[i]
            out[i] = _from_local(sums[j], mesh, places, lead + (b - a,))
    return out


def _split_over(t: torch.Tensor, dim: int):
    """The one mesh dim (of more than one rank) that splits DTensor `t`'s
    dim `dim`, or None (a plain tensor, that dim whole, or split over
    several mesh dims)."""
    dim %= t.ndim
    split = [md for md, p in enumerate(getattr(t, "placements", ()))
             if p.is_shard() and p.dim % t.ndim == dim]
    if len(split) != 1 or t.device_mesh.size(split[0]) == 1:
        return None
    return split[0]


def _chunks(extent: int, n: int) -> list:
    """The (start, stop) of each of `n` ranks' shards of a dim of `extent`
    split over them, as DTensor's `Shard` splits it: ceil(extent / n) to
    each rank, the last ones short or empty where the ranks do not divide
    `extent` (GSPMD's padding to a multiple of the ranks, held nowhere)."""
    c = -(-extent // n)
    return [(min(r * c, extent), min((r + 1) * c, extent)) for r in range(n)]


def _meet(have, want):
    """The overlap of two (start, stop) ranges, empty inside `want`."""
    x = min(max(have[0], want[0]), want[1])
    return x, max(min(have[1], want[1]), x)


def _route(local: torch.Tensor, dim: int, held, wants, me: int,
           group: str) -> list:
    """Each rank's ranges `wants[r]` (a list of (start, stop) along `dim`, in
    the dim's global indices; ranks may want the same rows) taken from the
    ranks that hold them, `held[r]` the range rank r's `local` holds
    (disjoint, in rank order), through one all-to-all of only those rows
    (`_AllToAll`; none where every rank holds what it wants): returns this
    rank's, one tensor a range of `wants[me]`. The backward sends each
    gradient back where its rows came from, summed where they went to
    several ranks."""
    dim %= local.ndim
    n, lo = len(held), held[me][0]

    def rows(x, y):
        return local.narrow(dim, x - lo if y > x else 0, y - x)

    def count(s, w):                  # the rows of `w` rank s holds
        x, y = _meet(held[s], w)
        return y - x

    if not any(count(s, w) for r in range(n) for w in wants[r]
               for s in range(n) if s != r):
        return [rows(*_meet(held[me], w)) for w in wants[me]]
    sends, in_sizes, out_sizes, got = [], [], [], []
    for r in range(n):
        parts = [_meet(held[me], w) for w in wants[r]]
        sends += [rows(x, y) for x, y in parts]
        in_sizes.append(sum(y - x for x, y in parts))
        got.append([count(r, w) for w in wants[me]])
        out_sizes.append(sum(got[-1]))
    send = torch.cat(sends, dim=dim).movedim(dim, 0).contiguous()
    recv = _AllToAll.apply(send, out_sizes, in_sizes, group)
    recv = recv.movedim(0, dim).split([k for ks in got for k in ks], dim=dim)
    m = len(wants[me])
    return [torch.cat([recv[r * m + j] for r in range(n)], dim=dim)
            for j in range(m)]


def _swap_split(t: torch.Tensor, md: int, dim: int) -> torch.Tensor:
    """DTensor `t`, split over mesh dim `md` along another dim (KV heads),
    split along `dim` there instead (a cache's sequence), as `Shard` splits
    it: each rank sends each other rank the part of its shard that falls in
    that rank's share of `dim`, through one all-to-all of only those
    (`_AllToAll`), where DTensor's redistribution gathers `t` whole over
    `md` on a cpu mesh. `dim` must be whole over the other mesh dims."""
    from torch.distributed.tensor import Shard
    mesh = t.device_mesh
    a = t.placements[md].dim % t.ndim
    n, me = mesh.size(md), mesh.get_local_rank(md)
    local = t.to_local()
    mine = _chunks(t.shape[dim], n)
    sends = [local.narrow(dim, x, y - x).reshape(-1) for x, y in mine]
    shapes = []
    for x, y in _chunks(t.shape[a], n):
        shape = list(local.shape)
        shape[a], shape[dim] = y - x, mine[me][1] - mine[me][0]
        shapes.append(shape)
    sizes = [math.prod(shape) for shape in shapes]
    recv = _AllToAll.apply(torch.cat(sends), sizes,
                           [p.numel() for p in sends],
                           mesh.get_group(md).group_name)
    local = torch.cat([p.reshape(shape) for p, shape in
                       zip(recv.split(sizes), shapes)], dim=a)
    places = list(t.placements)
    places[md] = Shard(dim)
    return _from_local(local, mesh, places, tuple(t.shape))


def _collective(op: str, t: torch.Tensor, *args) -> torch.Tensor:
    """The functional collective `op` of `t`, waited on (the op the dry
    run counts by kind)."""
    ops = torch.ops._c10d_functional
    return ops.wait_tensor(getattr(ops, op)(t, *args))


class _AllToAll(torch.autograd.Function):
    """An all-to-all of dim 0 (`in_sizes` rows to each rank, `out_sizes`
    from each); backward sends each gradient back where its rows came
    from."""

    @staticmethod
    def forward(ctx, t, out_sizes, in_sizes, group):
        ctx.args = (in_sizes, out_sizes, group)
        return _collective("all_to_all_single", t, out_sizes, in_sizes, group)

    @staticmethod
    def backward(ctx, grad):
        in_sizes, out_sizes, group = ctx.args
        return (_collective("all_to_all_single", grad.contiguous(), in_sizes,
                            out_sizes, group), None, None, None)


class _SumOver(torch.autograd.Function):
    """An all-reduce (sum) whose output is whole on every rank: its
    gradient, whole on every rank too (a DTensor made `Replicate`), is
    each rank's input gradient as it is."""

    @staticmethod
    def forward(ctx, t, group):
        return _collective("all_reduce", t, "sum", group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def embed_rows(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """`table[tokens]`, the embedding rows of `tokens`. A DTensor table
    keeps its vocab split over each mesh dim that does not split the
    tokens, and each device reads its own tokens' rows from its shard of
    the vocab: a token outside the shard reads a zero row, so the rows are
    a partial sum there, summed over the vocab's ranks (an all-reduce of
    the rows, not a gather of the table). The table's other splits (FSDP's)
    are gathered as a weight is. The table's gradient is each device's
    rows scattered into its shard, a partial sum over the ranks that split
    the tokens. DTensor's own indexing of a split vocab dim moves the
    table to a split of its other dim instead, some versions' backward
    scatter refuses the layout their rules give the rows' gradient, and
    its vocab-parallel embedding (`MaskPartial`) fails to reduce in
    others."""
    if not hasattr(table, "placements"):
        return table[tokens]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh = table.device_mesh
    if not hasattr(tokens, "placements"):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    vocab = [isinstance(p, Shard) and p.dim == 0 and not isinstance(q, Shard)
             for p, q in zip(table.placements, tokens.placements)]
    keep = [Shard(0) if v else Replicate() for v in vocab]
    if list(table.placements) != keep:
        table = table.redistribute(mesh, keep)
    local = table.to_local(grad_placements=[
        Partial() if isinstance(q, Shard) else p
        for p, q in zip(keep, tokens.placements)])
    ids = tokens.to_local()
    if any(vocab):
        lo = compute_local_shape_and_global_offset(
            table.shape, mesh, keep)[1][0]
        inside = (ids >= lo) & (ids < lo + local.shape[0])
        rows = local[(ids - lo).clamp(0, local.shape[0] - 1)] \
            * inside.unsqueeze(-1).to(local.dtype)
    else:
        rows = local[ids]
    shape = tuple(tokens.shape) + tuple(table.shape[1:])
    return settle(_from_local(rows, mesh, [
        Partial() if v else q for v, q in zip(vocab, tokens.placements)],
        shape))


def logsumexp_pick(logits: torch.Tensor, labels: torch.Tensor):
    """(logsumexp of `logits` over its last dim, `logits` at `labels`
    there), each shaped as `labels`: a loss's log-partition and gold
    logit. A DTensor split along the last dim (the head's vocab) keeps it
    split, as GSPMD keeps it, and each device works on its own shard: its
    largest logit, the all-reduced max of which is the shift; its sum of
    shifted exponents, all-reduced into the partition; its logit at each
    label its shard holds (zero at the others), all-reduced into the gold
    logit. The gradient is the plain one (the shift is a constant). The
    other dims keep their layout, `labels` laid out alike. DTensor's own
    gather along a split dim fails in some versions, and making the vocab
    whole holds a chunk's float32 logits whole on every device."""
    if not hasattr(logits, "placements"):
        return (torch.logsumexp(logits, dim=-1),
                torch.gather(logits, -1, labels[..., None])[..., 0])
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    logits = settle(logits)
    mesh, last = logits.device_mesh, logits.ndim - 1
    vocab = [isinstance(p, Shard) and p.dim % logits.ndim == last
             for p in logits.placements]
    rest = [Replicate() if v else p for v, p in zip(vocab, logits.placements)]
    if not hasattr(labels, "placements"):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    if list(labels.placements) != rest:
        labels = labels.redistribute(mesh, rest)
    shape = tuple(logits.shape[:-1])

    def summed(local, op="sum"):
        return _from_local(local, mesh, [
            Partial(op) if v else p for v, p in zip(vocab, rest)],
            shape).redistribute(mesh, rest)

    lg = logits.to_local()
    lo = compute_local_shape_and_global_offset(
        logits.shape, mesh, logits.placements)[1][last]
    m = summed(lg.detach().amax(dim=-1), "max").to_local()
    s = summed(torch.exp(lg - m[..., None]).sum(dim=-1))
    lb = labels.to_local() - lo
    inside = (lb >= 0) & (lb < lg.shape[-1])
    gold = torch.gather(lg, -1, lb.clamp(0, lg.shape[-1] - 1)[..., None])
    gold = summed(gold[..., 0] * inside.to(lg.dtype))
    return _from_local(m, mesh, rest, shape) + torch.log(s), gold


def along(fn, t: torch.Tensor, dims, *others):
    """`fn(t, *others)` for an op that works along the dims `dims` (an int
    or a tuple) and keeps `t`'s others, on which its results lead (a
    cumulative sum or a pad along a dim, a gather along it with an index
    shaped as `t` but there, MoE routing within each group): DTensors run
    it on their local shards, made whole along `dims` first and `others`
    laid out as `t`, and each result keeps `t`'s placements. DTensor has no
    rule for some such ops or their backward, its gather's backward
    allocates the whole gathered tensor on every device, and its sum of
    two gradients laid out differently needs a redistribution some
    versions lack. Plain tensors run `fn` as they are."""
    if not hasattr(t, "placements"):
        return fn(t, *others)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    for dim in (dims if isinstance(dims, tuple) else (dims,)):
        t = unshard(t, dim)
    mesh = t.device_mesh
    local = []
    for o in others:
        if not hasattr(o, "placements"):
            o = DTensor.from_local(o, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        if list(o.placements) != list(t.placements):
            o = o.redistribute(mesh, t.placements)
        local.append(o.to_local())
    split = {p.dim % t.ndim for p in t.placements if isinstance(p, Shard)}

    def wrap(out):
        return _from_local(out, mesh, t.placements, [
            t.shape[d] if d in split else n
            for d, n in enumerate(out.shape)])

    out = fn(t.to_local(), *local)
    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)


def _uneven(t: torch.Tensor, extent: int) -> bool:
    """Whether some dim of `t`'s mesh has ranks that do not divide
    `extent`: DTensor cannot view a dim of that extent split over them
    into or out of another (nor the gradient that comes back so split)."""
    return any(extent % n for n in t.device_mesh.shape)


def split_dim(t: torch.Tensor, dim: int, sizes) -> torch.Tensor:
    """`t` with dim `dim` split into `sizes` (row-major). A DTensor split
    along that dim over a mesh dim whose ranks do not divide `sizes[0]` is
    made whole along it first (DTensor splits no sharded dim unevenly);
    where some ranks do not divide `sizes[0]`, its gradient comes back in
    the layout it leaves (`pin_grad`). A plain tensor is only reshaped."""
    dim %= t.ndim
    shape = tuple(t.shape)
    out_shape = shape[:dim] + tuple(sizes) + shape[dim + 1:]
    if not hasattr(t, "placements"):
        return t.reshape(out_shape)
    from torch.distributed.tensor import Shard
    if any(isinstance(p, Shard) and p.dim % t.ndim == dim
           and sizes[0] % t.device_mesh.size(md)
           for md, p in enumerate(t.placements)):
        t = unshard(t, dim)
    out = t.reshape(out_shape)
    return pin_grad(out) if _uneven(t, sizes[0]) else out


def split_heads(t: torch.Tensor, n_heads: int, head_dim: int
                ) -> torch.Tensor:
    """(B, S, n_heads * head_dim) -> (B, S, n_heads, head_dim)
    (`split_dim` of the last dim). A DTensor split along its last dim over
    one mesh dim whose ranks do not divide `n_heads` (a column-parallel
    projection's output) comes out split by heads as `Shard` splits a dim
    its ranks do not divide (`_chunks`: GSPMD's heads padded to a multiple
    of the ranks), each rank receiving its heads' columns from the ranks
    that hold them through one all-to-all of only those columns
    (`_route`), where `split_dim` would make the projection whole."""
    md = _split_over(t, -1)
    if md is None or n_heads % t.device_mesh.size(md) == 0:
        return split_dim(t, -1, (n_heads, head_dim))
    from torch.distributed.tensor import Shard
    t = settle(t)
    mesh = t.device_mesh
    n = mesh.size(md)
    cols = _route(t.to_local(), -1, _chunks(t.shape[-1], n),
                  [[(a * head_dim, b * head_dim)] for a, b in
                   _chunks(n_heads, n)], mesh.get_local_rank(md),
                  mesh.get_group(md).group_name)[0]
    places = list(t.placements)
    places[md] = Shard(t.ndim - 1)
    local = cols.unflatten(-1, (cols.shape[-1] // head_dim, head_dim))
    return _from_local(local, mesh, places,
                       tuple(t.shape[:-1]) + (n_heads, head_dim))


def merge_dims(t: torch.Tensor, dim: int, n: int = 2) -> torch.Tensor:
    """`t` with dims `dim` .. `dim + n - 1` merged into one (row-major), the
    counterpart of `split_dim`. DTensor flattens a split dim only when it
    is the first of the merged dims and its ranks divide it: a DTensor split
    otherwise along a merged dim is made whole along it first, then split
    again along the merged dim where its ranks divide that dim's extent (a
    local slice). Where some ranks do not divide the first merged dim, its
    gradient comes back in the layout it leaves (`pin_grad`). Where only
    the first merged dim is split, over one mesh dim whose ranks divide the
    merged extent but not that dim's (heads split as `split_heads` splits
    them), each rank instead receives its even share of the merged dim from
    the ranks that hold it, through one all-to-all of only those rows
    (`_route`). A plain tensor is only reshaped."""
    dim %= t.ndim
    shape = tuple(t.shape)
    out_shape = shape[:dim] + (math.prod(shape[dim:dim + n]),) \
        + shape[dim + n:]
    if not hasattr(t, "placements"):
        return t.reshape(out_shape)
    from torch.distributed.tensor import Replicate, Shard
    mesh = t.device_mesh
    md = _split_over(t, dim)
    if md is not None and shape[dim] % mesh.size(md) \
            and out_shape[dim] % mesh.size(md) == 0 and not any(
                isinstance(p, Shard) and dim < p.dim % t.ndim < dim + n
                for p in t.placements):
        inner = out_shape[dim] // shape[dim]
        local = t.to_local().contiguous()
        local = local.reshape(local.shape[:dim] + (
            math.prod(local.shape[dim:dim + n]),) + local.shape[dim + n:])
        k = mesh.size(md)
        rows = _route(local, dim, [(a * inner, b * inner) for a, b in
                                   _chunks(shape[dim], k)],
                      [[w] for w in _chunks(out_shape[dim], k)],
                      mesh.get_local_rank(md),
                      mesh.get_group(md).group_name)[0]
        places = [Shard(p.dim % t.ndim - (n - 1)) if isinstance(p, Shard)
                  and p.dim % t.ndim >= dim + n else p for p in t.placements]
        places[md] = Shard(dim)
        return _from_local(rows, mesh, places, out_shape)
    places, resplit = list(t.placements), []
    for md, p in enumerate(places):
        if isinstance(p, Shard) and dim <= p.dim % t.ndim < dim + n and (
                p.dim % t.ndim != dim or shape[dim] % mesh.size(md)):
            places[md] = Replicate()
            if out_shape[dim] % mesh.size(md) == 0:
                resplit.append(md)
    if places != list(t.placements):
        t = t.redistribute(mesh, places)
    # a local shard that is a strided view (an expand, a slice) cannot be
    # viewed across its dims
    out = t.contiguous().reshape(out_shape)
    if resplit:
        places = list(out.placements)
        for md in resplit:
            places[md] = Shard(dim)
        out = out.redistribute(mesh, places)
    return pin_grad(out) if _uneven(t, shape[dim]) else out


def shard_einsum(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    """`torch.einsum(equation, *operands)`; DTensor operands multiply shard
    by shard (`by_shard`, each index the output keeps free to stay split).
    DTensor's own einsum flattens the batch indices into one dim first,
    which it refuses when they are split over different mesh dims or
    unevenly, and reshapes local shards that are strided views. Plain
    operands run `torch.einsum` as they are."""
    out_idx = equation.replace(" ", "").split("->")[1]
    return by_shard(lambda *ts: torch.einsum(equation, *ts), equation,
                    *operands, free=out_idx)


def by_shard(fn, spec: str, *operands, free: str):
    """`fn(*operands)` for a function that works within each slice of the
    indices in `free`: `spec` names each operand's and each result's dims
    as an einsum equation does ("bshp,hp->bshp,bhp"), and `fn` mixes no
    two slices of a `free` index. DTensor operands run shard by shard:
    for each mesh dim, the `free` index the first DTensor operand is split
    along there (else the first such index of another operand) splits
    every operand that carries it, as a local slice, and the operands split
    there along any other index are made whole (an all-gather, as FSDP's
    weights are); each device runs `fn` on its local shards, with no
    collective, and each result is split as its indices say. An operand
    whole where the others split an index it lacks gets, on each device,
    the part of its gradient that device's slice gives: a partial sum.
    Plain operands run `fn` as they are."""
    placed = [o for o in operands if hasattr(o, "placements")]
    if not placed:
        return fn(*operands)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    ins, outs = (part.split(",") for part in spec.replace(" ", "")
                 .split("->"))
    mesh = placed[0].device_mesh
    order = sorted(range(len(operands)),
                   key=lambda i: not hasattr(operands[i], "placements"))
    split = []                     # the index each mesh dim splits, or None
    for md in range(mesh.ndim):
        idx = None
        for i in order:
            o = operands[i]
            p = o.placements[md] if hasattr(o, "placements") else None
            if isinstance(p, Shard) and ins[i][p.dim % o.ndim] in free:
                idx = ins[i][p.dim % o.ndim]
                break
        split.append(idx)
    local = []
    for o, sub in zip(operands, ins):
        if not hasattr(o, "placements"):
            o = DTensor.from_local(o, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        want = [Shard(sub.index(ix)) if ix is not None and ix in sub
                else Replicate() for ix in split]
        if list(o.placements) != want:
            o = o.redistribute(mesh, want)
        local.append(o.to_local(grad_placements=[
            Partial() if ix is not None and ix not in sub else p
            for ix, p in zip(split, want)]))
    result = fn(*local)
    sizes = {ix: n for o, sub in zip(operands, ins)
             for ix, n in zip(sub, o.shape)}

    def wrap(out, sub):
        return _from_local(out, mesh, [
            Shard(sub.index(ix)) if ix is not None and ix in sub
            else Replicate() for ix in split], [
            sizes.get(ix, n) for ix, n in zip(sub, out.shape)])

    if isinstance(result, tuple):
        return tuple(wrap(r, sub) for r, sub in zip(result, outs))
    return wrap(result, outs[0])


def _from_local(local: torch.Tensor, mesh, places, shape) -> torch.Tensor:
    """The DTensor of global `shape` laid out by `places` whose local shard
    is `local` (made dense first when it is a strided view: DTensor takes
    its local shard to lie in memory as its global strides say)."""
    from torch.distributed.tensor import DTensor
    order = sorted(range(local.ndim), key=lambda d: local.stride(d))
    step = 1
    for d in order:
        if local.numel() == 0 or (local.shape[d] > 1
                                  and local.stride(d) != step):
            local = local.contiguous()
            order = range(local.ndim - 1, -1, -1)
            break
        step *= local.shape[d]
    strides, step = [0] * local.ndim, 1
    for d in order:
        strides[d] = step
        step *= max(shape[d], 1)
    return DTensor.from_local(local, mesh, places, run_check=False,
                              shape=tuple(shape), stride=tuple(strides))


def remat(enabled: bool, fn, *args):
    """`fn(*args)`, its activations recomputed in backward when `enabled`
    and autograd records (`jax.checkpoint` around a layer under
    `cfg.remat`); a plain call otherwise, so serving is unchanged."""
    if enabled and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


def rmsnorm_params(d: int, hold):
    return {"scale": hold("scale", torch.ones((d,)))}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm in float32. A DTensor input's partial sums are summed in its
    own dtype first, and the output's gradient is summed there too before
    it enters the norm's float32 backward (`pin_grad`): one all-reduce of
    the compute dtype each way, as GSPMD sums the residual stream, where
    DTensor would sum the float32 products inside the norm (several per
    norm, at twice the bytes). An input split along the normalized dim
    (Mamba2's gated output, split by heads; MLA's query latent, split by
    its columns) has its variance summed, and the variance's gradient too
    (a row each), so that the gradient spread back over the dim keeps the
    input's split and adds to the output's: DTensor would reduce-scatter
    it along the sequence instead (torch 2.11) or move it between splits
    (2.13), which the input's gradient then leaves split there."""
    xf = settle(x).float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    if any(p.is_shard() and p.dim % x.ndim == x.ndim - 1
           for p in getattr(x, "placements", ())):
        var = pin_grad(settle(var))
    out = xf * torch.rsqrt(var + eps) * p["scale"].float()
    return pin_grad(out.to(x.dtype))


def layernorm_params(d: int, hold):
    return {"scale": hold("scale", torch.ones((d,))),
            "bias": hold("bias", torch.zeros((d,)))}


def layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Layer norm in float32; a DTensor's partial sums, and its output's
    gradient's, are summed in its own dtype (as `rmsnorm`'s), and an input
    split along the normalized dim (RWKV6's WKV output, split by heads) has
    its mean and variance summed, and their gradients too, as `rmsnorm`
    sums its variance."""
    xf = settle(x).float()
    split = any(p.is_shard() and p.dim % x.ndim == x.ndim - 1
                for p in getattr(x, "placements", ()))
    mu = torch.mean(xf, dim=-1, keepdim=True)
    if split:
        mu = pin_grad(settle(mu))
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    if split:
        var = pin_grad(settle(var))
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * p["scale"].float() + p["bias"].float()
    return pin_grad(out.to(x.dtype))


def norm_params(kind: str, d: int, hold):
    return (rmsnorm_params(d, hold) if kind == "rms"
            else layernorm_params(d, hold))


def apply_norm(kind: str, p, x: torch.Tensor, eps: float = 1e-5):
    return rmsnorm(p, x, eps) if kind == "rms" else layernorm(p, x, eps)


# ----------------------------------------------------------------------------
# activations, op by op as XLA evaluates the JAX definitions
# ----------------------------------------------------------------------------

def silu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.silu`: x * logistic(x), the logistic as 1 / (1 + exp(-x))
    with each op rounded in x's dtype (XLA's bfloat16 results bit for bit;
    `F.silu` rounds once and differs in the last bit of a third of them).
    The MoE experts, Mamba2 and RWKV6 use it: without it zamba2's bfloat16
    hidden states depart from JAX's by more than 0.02. The dense FFN keeps
    `F.silu`, whose bfloat16 streams the dense serving tests pin."""
    return x * (1 / (1 + torch.exp(-x)))


# ----------------------------------------------------------------------------
# rotary position embeddings
# ----------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, D) with D even; positions: (S,). Rotates interleaved
    pairs (x[2i], x[2i+1]), as the JAX package does."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                       # (D/2,)
    angles = positions[..., :, None].float() * freqs              # (S, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., ::2], x[..., 1::2]
    xr1 = x1 * cos - x2 * sin
    xr2 = x2 * cos + x1 * sin
    out = torch.stack([xr1, xr2], dim=-1).reshape(x.shape)
    return out.to(x.dtype)


def sinusoidal_positions(seq_len: int, d: int, device=None) -> torch.Tensor:
    """(seq_len, d) float32 sinusoidal position table: sin in the even
    columns, cos in the odd ones (Whisper's encoder)."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / d))
    pe = torch.zeros((seq_len, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


# ----------------------------------------------------------------------------
# attention math
# ----------------------------------------------------------------------------

def _dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with float32 products and sums (XLA's
    `preferred_element_type=float32` on narrower inputs). Two DTensors
    split over their batch dims (and whole over the two product dims)
    multiply shard by shard: an operand whole along a batch dim the other
    splits takes the other's split (a local slice), then each device runs
    its own batched product, with no collective (DTensor's batched
    product would flatten the batch dims first, which it refuses when they
    are split over different mesh dims)."""
    places = _batch_split(a, b)
    if places is not None:
        from torch.distributed.tensor import DTensor
        mesh = a.device_mesh
        a, b = (t if tuple(t.placements) == places
                else t.redistribute(mesh, places) for t in (a, b))
        out = torch.matmul(a.to_local().float(), b.to_local().float())
        shape = tuple(a.shape[:-1]) + (b.shape[-1],)
        return DTensor.from_local(out, mesh, places, run_check=False,
                                  shape=shape,
                                  stride=contiguous_strides(shape))
    return torch.matmul(a.float(), b.float())


def _batch_split(a, b):
    """The placements two DTensors take for a shard-by-shard product, or
    None: on each mesh dim both whole, or one or both split alike over a
    batch dim (never over the two product dims)."""
    if not (hasattr(a, "placements") and hasattr(b, "placements")) or \
            a.ndim != b.ndim or a.ndim < 3 or \
            a.shape[:-2] != b.shape[:-2] or a.device_mesh != b.device_mesh:
        return None
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for pa, pb in zip(a.placements, b.placements):
        ps = [p for p in (pa, pb) if not isinstance(p, Replicate)]
        if any(not isinstance(p, Shard) or p.dim % a.ndim >= a.ndim - 2
               for p in ps) or len(set(ps)) > 1:
            return None
        out.append(ps[0] if ps else Replicate())
    if not any(isinstance(p, Shard) for p in out):
        return None
    return tuple(out)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, q_chunk: int = 512,
                      kv_chunk: int = 512, scale: Optional[float] = None,
                      kv_positions: Optional[np.ndarray] = None
                      ) -> torch.Tensor:
    """Flash-style online-softmax attention over chunks.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D), Hq % Hkv == 0. Queries sit at
    the END of the KV timeline. `kv_positions` (a static numpy array, herded
    KV-block perforation) gives each KV row's original timeline position;
    the causal mask compares against those instead of contiguous indices.
    DTensors run shard by shard (`_attention_by_shard`).
    """
    if hasattr(q, "placements"):
        return _attention_by_shard(q, k, v, causal=causal, q_chunk=q_chunk,
                                   kv_chunk=kv_chunk, scale=scale,
                                   kv_positions=kv_positions)
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    dv = v.shape[-1]
    assert hq % hkv == 0 if hkv else hq == 0   # a shard may hold no head
    rep = hq // max(hkv, 1)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    dev = q.device
    if kv_positions is None:
        kv_pos = torch.arange(skv, device=dev)
        offset = skv - sq
    else:
        kv_np = np.asarray(kv_positions)
        kv_pos = torch.as_tensor(kv_np, device=dev)
        offset = int(kv_np.max()) + 1 - sq

    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    nq = -(-sq // q_chunk)
    nkv = -(-skv // kv_chunk)
    sq_p, skv_p = nq * q_chunk, nkv * kv_chunk
    # pad to whole chunks (only when a chunk is ragged: DTensor's pad
    # redistributes even by 0)
    pad = torch.nn.functional.pad
    qp = pad(q, (0, 0, 0, sq_p - sq)) if sq_p > sq else q
    kp, vp = ((pad(k, (0, 0, 0, skv_p - skv)), pad(v, (0, 0, 0, skv_p - skv)))
              if skv_p > skv else (k, v))
    kvpos_p = pad(kv_pos, (0, skv_p - skv),
                  value=2 ** 30)  # padding: always masked
    if rep > 1:
        kp = kp.repeat_interleave(rep, dim=1)
        vp = vp.repeat_interleave(rep, dim=1)

    outs = []
    for iq in range(nq):
        qc = qp[:, :, iq * q_chunk:(iq + 1) * q_chunk]
        qi = iq * q_chunk + torch.arange(q_chunk, device=dev) + offset
        m = torch.full((b, hq, q_chunk), -1e30, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, hq, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, hq, q_chunk, dv), dtype=torch.float32,
                          device=dev)
        for ikv in range(nkv):
            sl = slice(ikv * kv_chunk, (ikv + 1) * kv_chunk)
            kc, vc = kp[:, :, sl], vp[:, :, sl]
            logits = _dot_f32(qc, kc.transpose(-1, -2)) * scale
            ki = kvpos_p[sl]
            mask = ki[None, :] < 2 ** 30
            if causal:
                mask = mask & (ki[None, :] <= qi[:, None])
            logits = torch.where(mask[None, None], logits, -1e30)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + _dot_f32(p.to(vc.dtype), vc)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        out = torch.where((l > 0.5)[..., None], out, 0.0)
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=2)[:, :, :sq]


def _attention_by_shard(q, k, v, **kw) -> torch.Tensor:
    """`chunked_attention` of DTensors q, k, v, each device on its own
    shards: attention mixes no batch row or head with another, so with q
    split over batch and heads (and whole over sequence and head dims), and
    k and v holding the KV heads of each device's query heads, each device
    runs the plain chunked attention on its local shards (GSPMD's plan). q
    is made whole along any other split (and its partial sums summed);
    heads whole on every rank of a mesh dim that splits neither them nor
    the batch are split there too (as `Shard` splits them: GSPMD's padding
    to a multiple of the ranks, held nowhere), so that no device holds
    every head's chunk probabilities. The output keeps q's layout. DTensor
    run op by op would plan every chunk pair's ops (millions at 32k) and
    refuses some of them: the pad of a ragged chunk, the flattened batch
    dims of a product split over two mesh dims."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    places = [p if isinstance(p, Shard) and p.dim % 4 < 2 else Replicate()
              for p in q.placements]
    by_heads = [md for md, p in enumerate(places)
                if isinstance(p, Shard) and p.dim % 4 == 1]
    whole = [md for md, p in enumerate(places) if isinstance(p, Replicate)]
    if whole and q.shape[1] > 1 and not by_heads:
        places[whole[-1]] = Shard(1)
        by_heads = [whole[-1]]
    if list(q.placements) != places:
        q = q.redistribute(mesh, places)
    shape = tuple(q.shape[:3]) + (v.shape[-1],)
    k, v = (_kv_heads(t, q, places, by_heads) for t in (k, v))
    return _from_local(chunked_attention(q.to_local(), k, v, **kw), mesh,
                       places, shape)


def _kv_heads(t, q, places, by_heads) -> torch.Tensor:
    """The local K or V (`t`, a DTensor (B, Hkv, S, D)) of this device's
    query heads in q (laid out by `places`, its heads split over the mesh
    dims `by_heads`), one KV head for each query head (query head h reads
    KV head h // (Hq / Hkv)), whole along the sequence. Where one mesh dim
    splits the query heads, each rank receives only the KV heads its query
    heads read, from the ranks that hold them (`_route`: one all-to-all,
    none where they are its own; a KV head that several ranks read goes to
    each, its gradients summed), and repeats them locally; t whole there is
    sliced (its gradient a partial sum). Otherwise t takes q's layout, its
    heads repeated to q's first where the ranks do not split both alike."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = q.device_mesh
    hq, hkv = q.shape[1], t.shape[1]
    group = hq // hkv
    if len(by_heads) != 1:
        if group > 1 and any(hkv % mesh.size(md) or hq % mesh.size(md)
                             for md in by_heads):
            t = t.repeat_interleave(group, dim=1)
        if list(t.placements) != places:
            t = t.redistribute(mesh, places)
        return t.to_local()
    md = by_heads[0]
    n, me = mesh.size(md), mesh.get_local_rank(md)
    want = list(places)
    own = t.placements[md]
    want[md] = own if isinstance(own, Shard) and own.dim % 4 == 1 \
        else Replicate()
    if list(t.placements) != want:
        t = t.redistribute(mesh, want)
    mine = _chunks(hq, n)
    need = [(a // group, -(-b // group)) if b > a else (0, 0)
            for a, b in mine]
    if isinstance(want[md], Shard):
        local = _route(t.to_local(), 1, _chunks(hkv, n),
                       [[w] for w in need], me,
                       mesh.get_group(md).group_name)[0]
    else:
        local = t.to_local(grad_placements=[
            Partial() if i == md else p for i, p in enumerate(want)])
        local = local[:, need[me][0]:need[me][1]]
    idx = [h // group - need[me][0] for h in range(*mine[me])]
    if idx != list(range(local.shape[1])):
        local = local.index_select(1, torch.tensor(idx, dtype=torch.long,
                                                   device=local.device))
    return local


def full_attention(q, k, v, *, causal: bool = True,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Quadratic reference attention (small sequences / tests)."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    rep = hq // hkv
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        ki = torch.arange(skv, device=q.device)[None, :]
        logits = torch.where((ki <= qi)[None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs, v.float()).to(q.dtype)


def decode_attention(q, k, v, *, valid_len: int,
                     scale: Optional[float] = None,
                     keep_mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Single-token decode attention against a (possibly oversized) cache.

    q: (B, Hq, 1, D); k/v: (B, Hkv, S_cache, D); positions >= valid_len are
    masked; `keep_mask` (S_cache,) additionally masks perforated KV blocks
    (herded: one mask for every batch/head). GQA is a grouped product: the
    cache is never head-repeated.
    """
    b, hq, _, d = q.shape
    _, hkv, skv, _ = k.shape
    dv = v.shape[-1]
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = split_dim(q, 1, (hkv, group)).reshape(b, hkv, group, d)
    logits = _dot_f32(qg, k.transpose(-1, -2)) * scale       # (B,Hkv,G,S)
    mask = torch.arange(skv, device=q.device) < valid_len
    if keep_mask is not None:
        mask = mask & keep_mask
    logits = torch.where(mask, logits, -1e30)
    # a cache split along its sequence leaves the max and the sum partial
    # (`settle`)
    m = settle(logits.amax(dim=-1, keepdim=True))
    p = torch.exp(logits - m)
    p = torch.where(mask, p, 0.0)
    l = settle(p.sum(dim=-1, keepdim=True))
    ctx = _dot_f32(p.to(v.dtype), v) / torch.clamp(l, min=1e-30)
    return ctx.reshape(b, hq, 1, dv).to(q.dtype)
