"""GPipe-style pipeline parallelism over one mesh dim (port of
`repro.runtime.pipeline`, on `torch.distributed` point-to-point sends in
place of `lax.ppermute`).

`pipeline_apply(fn, params_stacked, x, mesh, axis)` treats the `axis` mesh
dim as pipeline stages: stage s (this rank's coordinate along `axis`)
applies slice s of the stacked params and passes its activations to stage
s+1. Microbatching: the input batch is split into M microbatches; the
schedule runs S + M - 1 ticks (fill + steady state + drain), the classic
GPipe bubble fraction (S-1)/(S+M-1). Each tick every stage sends its
output to the next stage and receives the previous stage's (one ring
exchange, as the JAX package's cyclic ppermute); at the end the last stage
broadcasts the finished batch, so every stage returns it.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

PyTree = Any


def _slice(tree, s: int):
    if isinstance(tree, dict):
        return {k: _slice(v, s) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_slice(v, s) for v in tree)
    return tree[s]


def pipeline_apply(layer_fn: Callable, params_stacked: PyTree,
                   x: torch.Tensor, mesh, axis: str = "stage",
                   n_microbatches: int = 4) -> torch.Tensor:
    """Run x through S pipeline stages, each applying `layer_fn(params_s, .)`.

    layer_fn: (stage_params, activations (mb, ...)) -> activations.
    params_stacked: leaves with leading dim == S (one slice per stage).
    x: (batch, ...) with batch % n_microbatches == 0, the same on every
    rank. Returns the (batch, ...) output on every rank of the stage group.
    """
    import torch.distributed as dist
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    n_stages = len(ranks)
    stage = mesh.get_local_rank(axis)
    b = x.shape[0]
    if b % n_microbatches:
        raise ValueError(f"batch {b} does not split into {n_microbatches} "
                         f"microbatches")
    mb = b // n_microbatches
    params_s = _slice(params_stacked, stage)
    xm = x.reshape((n_microbatches, mb) + tuple(x.shape[1:]))
    nxt, prv = ranks[(stage + 1) % n_stages], ranks[(stage - 1) % n_stages]

    buf = torch.zeros_like(xm[0])                   # in-transit activations
    out = torch.zeros_like(xm)
    for t in range(n_stages + n_microbatches - 1):
        # stage 0 injects microbatch t (if available)
        x_in = xm[t if t < n_microbatches else 0] if stage == 0 else buf
        active = stage <= t and t - stage < n_microbatches
        y = layer_fn(params_s, x_in).to(x.dtype) if active else x_in
        done = t - (n_stages - 1)
        if stage == n_stages - 1 and done >= 0:     # last stage collects
            out[done].copy_(y)
        if n_stages == 1:
            buf = y
            continue
        y = y.contiguous()
        recv = torch.empty_like(y)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, y, nxt, group),
                dist.P2POp(dist.irecv, recv, prv, group)]):
            req.wait()
        buf = recv
    # only the last stage holds the output: it broadcasts it to the group
    dist.broadcast(out, src=ranks[-1], group=group)
    return out.reshape((b,) + tuple(x.shape[1:]))
