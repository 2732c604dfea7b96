"""Step functions: train_step (forward, backward and AdamW), prefill and
serve (one-token decode) (port of `repro.launch.steps`).

JAX jits these; eager PyTorch has nothing to compile, so the counterpart
of "a knob move recompiles nothing" is that no caller builds a new step
after construction: `builds()` counts every step built, and the serving
tests and `obs_overhead` pin its difference across knob moves and tracing
at 0.

A train step takes the masters (`Model.masters`, in the dtype JAX stores
them in), runs the model's loss on `Model.use(masters)` and differentiates
into the masters by `torch.autograd.grad`, as `jax.value_and_grad` over
the JAX loss does; AdamW then updates masters, moments and step counter in
place (the counterpart of the JAX step donating them) and returns them.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch

from ..models import common
from ..models.lm import Model, map_cache
from ..obs import metrics as obs_metrics
from ..optim import adamw
from ..optim import schedule as sched

_BUILDS = [0]


def builds() -> int:
    """Step functions built so far in this process."""
    return _BUILDS[0]


def _replicated_constants(params):
    """Inside a step over DTensor masters (placed by
    `runtime.sharding.place`), the plain tensors the model makes (position
    indices, masks, the online softmax's running max and sums, AdamW's
    scalars) take part as replicated DTensors; elsewhere nothing changes."""
    first = adamw.leaves(params)[0]
    if hasattr(first, "device_mesh"):
        from torch.distributed.tensor.experimental import (
            implicit_replication)
        return implicit_replication()
    return contextlib.nullcontext()


def loss_and_grads(model: Model, params, batch):
    """(loss, metrics, grads) of `batch` at the masters `params`: the
    loss and metrics detached, the grads a list in `adamw.leaves(params)`
    order, each in its master's dtype (zeros for a leaf the loss does not
    reach, as JAX's grad gives) and, for DTensor masters, its master's
    layout: DTensor leaves a gradient in whatever layout its last op
    chose, often sums pending over both mesh dims, and AdamW's in-place
    updates of the moments do not sum those first."""
    masters = adamw.leaves(params)
    for t in masters:
        if not t.requires_grad:
            t.requires_grad_(True)
    loss, metrics = model.loss(model.use(params), batch)
    grads = torch.autograd.grad(loss, masters, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else _laid_out_as(g, p)
             for g, p in zip(grads, masters)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def _laid_out_as(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """`g` redistributed to `p`'s placements where both are DTensors."""
    if hasattr(g, "placements") and tuple(g.placements) != tuple(
            p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(model: Model, opt_cfg: adamw.AdamWConfig,
                    schedule_fn: Optional[Callable] = None,
                    schedule_kwargs: Optional[Dict] = None) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics): one
    forward and backward over the whole batch and one AdamW step at the
    learning rate `opt_cfg.lr * schedule_fn(step)`. Metrics (0-d tensors on
    the device): `loss`, the family's `xent` / `aux_loss` / `mtp_loss`,
    and `grad_norm` (before clipping)."""
    schedule_fn = schedule_fn or sched.constant
    schedule_kwargs = schedule_kwargs or {}
    _BUILDS[0] += 1

    def train_step(params, opt_state, batch):
        with _replicated_constants(params):
            loss, metrics, grads = loss_and_grads(model, params, batch)
            lr_scale = schedule_fn(opt_state.step, **schedule_kwargs)
            params, opt_state, om = adamw.update(opt_cfg, grads, opt_state,
                                                 params, lr_scale)
        metrics = dict(metrics)
        metrics.update(om)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_train_step_accum(model: Model, opt_cfg: adamw.AdamWConfig,
                          accum_steps: int,
                          schedule_fn: Optional[Callable] = None,
                          schedule_kwargs: Optional[Dict] = None
                          ) -> Callable:
    """Gradient-accumulated train step: the global batch is split into
    `accum_steps` microbatches of contiguous rows run one after another,
    their float32 grads accumulated as g / accum_steps and their losses as
    loss / accum_steps, then one AdamW step; activation memory drops about
    accum_steps times. Metrics: `loss` and `grad_norm`."""
    schedule_fn = schedule_fn or sched.constant
    schedule_kwargs = schedule_kwargs or {}
    _BUILDS[0] += 1

    def train_step(params, opt_state, batch):
        rows = len(batch["tokens"])
        assert rows % accum_steps == 0, (rows, accum_steps)
        mb = rows // accum_steps
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in adamw.leaves(params)]
        total = torch.zeros((), dtype=torch.float32, device=acc[0].device)
        for i in range(accum_steps):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, _, grads = loss_and_grads(model, params, micro)
            with torch.no_grad():
                torch._foreach_add_(acc, torch._foreach_div(
                    [g.float() for g in grads], accum_steps))
            del grads
            total = total + loss / accum_steps
        lr_scale = schedule_fn(opt_state.step, **schedule_kwargs)
        params, opt_state, om = adamw.update(opt_cfg, acc, opt_state,
                                             params, lr_scale)
        om["loss"] = total
        return params, opt_state, om

    return train_step


def make_prefill_step(model: Model, max_len: int, mesh=None) -> Callable:
    """(params, batch) -> (last logits (B, V), a cache of max_len). With
    `mesh`, the cache is made inside the step already laid out by the
    sharding rules (`Model.init_cache`), as the JAX step's `out_shardings`
    place it."""
    _BUILDS[0] += 1

    def prefill_step(params, batch):
        return model.prefill(params, dict(batch, max_len=max_len), mesh=mesh)

    return prefill_step


def make_serve_step(model: Model) -> Callable:
    """One-token decode: (params, cache, tokens (B,), pos) ->
    (next_tokens (B,) int32, logits (B, V), the cache updated in place)."""
    _BUILDS[0] += 1

    def serve_step(params, cache, tokens, pos: int):
        logits, new_cache = model.decode_step(params, cache, tokens, pos)
        # DTensor has no argmax over a split vocab dim
        next_tokens = torch.argmax(common.unshard(logits, -1),
                                   dim=-1).to(torch.int32)
        return next_tokens, logits, new_cache

    return serve_step


def make_sharded_serve_step(model: Model, mesh, n_shards: int,
                            batch_size: int) -> Callable:
    """The serve step over this rank's share of `n_shards` logical shards
    of `batch_size // n_shards` contiguous lanes each, on a mesh whose data
    axes split the shards (`n_shards` any multiple of their extent).

    The cache it takes is this rank's: lane-bearing leaves hold the local
    shards' lanes, and the TAF detector state (`models.lm.shard_taf_state`)
    leads with the local shard dim. Each local shard runs the decode step
    over its own lanes and its own detector row, so:

      * outputs do not depend on how shards are packed onto ranks (no
        shard's compute sees another's lanes), and one shard equals the
        unsharded step bit for bit;
      * each shard's TAF threshold is an independent knob: the QoS plane
        moves one shard by writing one row of the (shards, n_layers)
        threshold leaf -- never a rebuild;
      * the TAF stability statistic (a batch mean) is computed over each
        shard's OWN lanes, so one shard's regime change cannot flip
        another shard's skip decisions.

    Skips are decided on the host: the step reads every local shard's
    `remaining` in ONE host read, a (local_shards, n_layers) tensor, and
    each shard then runs no computation of its skipped layers. The cost is
    local_shards decode steps' launches a call.

    Signature matches `make_serve_step`: (params, cache, tokens (local
    lanes,), pos) -> (next_tokens, logits, the cache updated in place).
    """
    from ..runtime import sharding as shardlib

    n_data = shardlib.data_extent(mesh)
    if n_shards < 1 or n_shards % n_data:
        raise ValueError(f"n_shards ({n_shards}) must be a positive multiple "
                         f"of the mesh's data extent ({n_data})")
    if batch_size % n_shards:
        raise ValueError(f"batch_size ({batch_size}) must divide evenly "
                         f"into {n_shards} shards")
    local_shards = n_shards // n_data
    lanes = batch_size // n_shards
    _BUILDS[0] += 1

    def view(path, t, s):
        kind = shardlib.decode_shard_axis(path)
        return (t if kind is None else t[s] if kind[0] == "state"
                else t.narrow(kind[1], s * lanes, lanes))

    def shard_view(cache, s: int):
        """Shard s's lanes and detector row, as views of the cache."""
        return map_cache(lambda path, t: view(path, t, s), cache)

    def sharded_step(params, cache, tokens, pos: int):
        rems = [None] * local_shards
        if model.taf_enabled and "taf" in cache:
            rems = cache["taf"]["remaining"].tolist()   # one host read
            obs_metrics.count_host_read()
        # only a decode-TAF step takes the `remaining` it was read into
        kw = [{"remaining": r} if model.taf_enabled else {} for r in rems]
        logits = [model.decode_step(params, shard_view(cache, s),
                                    tokens[s * lanes:(s + 1) * lanes], pos,
                                    **kw[s])[0]
                  for s in range(local_shards)]
        logits = logits[0] if local_shards == 1 else torch.cat(logits)
        next_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tokens, logits, cache

    return sharded_step
