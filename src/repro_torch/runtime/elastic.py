"""Elastic scaling: choose a mesh for the ranks that are actually alive
(port of `repro.runtime.elastic`, on `torch.distributed`).

Recovery flow after losing hosts (or gaining them back):
  1. `best_mesh_shape(n)` picks the largest supported (data, model) grid
     that fits n devices (model axis preserved when possible -- TP degree is
     a property of the weight layout; the data axis absorbs elasticity).
  2. rebuild the specs for the new mesh (runtime.sharding).
  3. restore the state onto it (`checkpoint.CheckpointManager.restore`
     with the new mesh and specs).
The global batch is kept constant by rescaling gradient-accumulation steps
(`accum_steps_for`), so training dynamics are unchanged across reshapes.

One rank per device: the backend follows the device, NCCL on ``cuda`` and
gloo on ``cpu``. A mesh of N devices needs the default process group to be
initialized already with world size N (`torchrun --nproc-per-node N`, or
`torch.distributed.init_process_group` with an explicit rank and world
size); nothing falls back to one process.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

from .. import device as device_mod


def backend_for(device) -> str:
    """The process-group backend of a device: nccl on cuda, gloo on cpu."""
    return "nccl" if device_mod.resolve(device).type == "cuda" else "gloo"


def require_world(n_devices: int, device=None) -> int:
    """Check that the default process group is up with world size
    `n_devices` and the backend of `device` (None means cuda); returns this
    rank. Raises, saying how to start one, otherwise."""
    import torch.distributed as dist
    backend = backend_for(device)
    how = (f"start the program with `torchrun --nproc-per-node "
           f"{n_devices} ...` (one rank per device), or call "
           f"torch.distributed.init_process_group({backend!r}, "
           f"init_method=..., rank=..., world_size={n_devices}) first")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"{n_devices} device(s) need an initialized default process "
            f"group of world size {n_devices} ({backend}); {how}")
    world = dist.get_world_size()
    if world != n_devices:
        raise RuntimeError(
            f"{n_devices} device(s) asked for but the process group has "
            f"world size {world}; {how}")
    # "fake" is the dry run's process group (`launch.dryrun.fake_world`)
    if dist.get_backend() not in (backend, "fake"):
        raise RuntimeError(
            f"the process group's backend is {dist.get_backend()}, but "
            f"{device_mod.resolve(device).type} tensors need {backend}")
    return dist.get_rank()


def init_from_env(device=None) -> None:
    """Start the default process group from the environment `torchrun`
    sets (RANK, WORLD_SIZE, MASTER_ADDR / MASTER_PORT, LOCAL_RANK), with
    the backend of `device` and, on cuda, this rank's card as the current
    device. Does nothing when the group is up or when the process was not
    started by a launcher (a later `require_world` then says how)."""
    import os

    import torch
    import torch.distributed as dist
    if dist.is_initialized() or "RANK" not in os.environ:
        return
    if device_mod.resolve(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend_for(device))


def init_single(device=None) -> bool:
    """Start a one-rank default process group with the backend of `device`
    (a `file://` rendezvous in a fresh temporary directory) unless one is
    up: the sharded engine on one card. Returns whether it started one."""
    import os
    import tempfile

    import torch.distributed as dist
    if dist.is_initialized():
        return False
    path = os.path.join(tempfile.mkdtemp(), "rendezvous")
    dist.init_process_group(backend_for(device), init_method=f"file://{path}",
                            rank=0, world_size=1)
    return True


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              device=None):
    """A `DeviceMesh` of `shape` over the whole world (which must hold
    exactly prod(shape) ranks)."""
    from torch.distributed.device_mesh import init_device_mesh
    n = math.prod(shape)
    require_world(n, device)
    return init_device_mesh(device_mod.resolve(device).type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def best_mesh_shape(n_devices: int, model_parallel: int = 16,
                    min_model: int = 1) -> Tuple[int, int]:
    """Largest (data, model) grid with data*model <= n_devices, preferring to
    keep the requested TP degree; degrade TP only when unavoidable."""
    mp = min(model_parallel, n_devices)
    while mp > min_model and n_devices % mp:
        mp //= 2
    data = n_devices // mp
    return data, mp


def make_mesh_for(n_devices: Optional[int] = None, model_parallel: int = 16,
                  axis_names: Sequence[str] = ("data", "model"), *,
                  device=None):
    """The `best_mesh_shape` mesh of `n_devices` ranks (the world size by
    default)."""
    import torch.distributed as dist
    if n_devices is None:
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("make_mesh_for() without n_devices needs an "
                               "initialized default process group")
        n_devices = dist.get_world_size()
    return make_mesh(best_mesh_shape(n_devices, model_parallel), axis_names,
                     device)


def data_mesh_for(n_devices: Optional[int] = None,
                  axis_names: Sequence[str] = ("data", "model"), *,
                  device=None):
    """Pure data-parallel mesh for the SERVING data plane: request lanes
    shard over `data`, TP degree pinned to 1 (decode-time TAF actuates
    per-shard thresholds, and a model axis would split heads the sharded
    serve step does not reduce over). Shape selection still flows through
    `best_mesh_shape`, so elasticity semantics match training: losing a
    device reshapes to (n-1, 1) and the engine re-plans its shards."""
    return make_mesh_for(n_devices, model_parallel=1, axis_names=axis_names,
                         device=device)


def accum_steps_for(global_batch: int, per_device_batch: int,
                    n_data_shards: int) -> int:
    """Keep the global batch constant across elastic reshapes by adjusting
    gradient accumulation."""
    per_step = per_device_batch * n_data_shards
    accum = max(1, global_batch // per_step)
    if accum * per_step != global_batch:
        raise ValueError(
            f"global_batch {global_batch} not reachable with "
            f"{n_data_shards} shards x {per_device_batch}/device")
    return accum
