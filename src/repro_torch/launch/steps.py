"""Step functions: prefill and serve (one-token decode) (port of the
serving half of `repro.launch.steps`).

JAX jits these; eager PyTorch has nothing to compile, so the counterpart
of "a knob move recompiles nothing" is that no caller builds a new step
after construction: `builds()` counts every step built, and the serving
tests and `obs_overhead` pin its difference across knob moves and tracing
at 0. The train steps come with the training half of the model zoo
(ROADMAP Queue 1 item 6b).
"""
from __future__ import annotations

from typing import Callable

import torch

from ..models.lm import Model, map_cache
from ..obs import metrics as obs_metrics

_BUILDS = [0]


def builds() -> int:
    """Step functions built so far in this process."""
    return _BUILDS[0]


def make_prefill_step(model: Model, max_len: int) -> Callable:
    """(params, batch) -> (last logits (B, V), a cache of max_len)."""
    _BUILDS[0] += 1

    def prefill_step(params, batch):
        return model.prefill(params, dict(batch, max_len=max_len))

    return prefill_step


def make_serve_step(model: Model) -> Callable:
    """One-token decode: (params, cache, tokens (B,), pos) ->
    (next_tokens (B,) int32, logits (B, V), the cache updated in place)."""
    _BUILDS[0] += 1

    def serve_step(params, cache, tokens, pos: int):
        logits, new_cache = model.decode_step(params, cache, tokens, pos)
        next_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
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
