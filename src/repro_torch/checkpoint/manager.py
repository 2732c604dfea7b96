"""Checkpointing with resharding restore, async writes, retention (port
of `repro.checkpoint.manager`).

Fault-tolerance substrate:
  * save(): flattens a tree of dicts, lists, tuples and NamedTuples (e.g.
    (params, AdamWState)) to path-keyed tensors and writes them with
    `torch.save` (numpy has no bfloat16) plus a manifest (keys, shapes,
    dtypes, step). Writes go to a tmp dir + atomic rename (`os.replace`),
    so a preempted save never corrupts the latest checkpoint.
  * The host snapshot is taken synchronously, before any writer starts:
    every leaf is copied to host memory (`detach().to("cpu",
    copy=True)`; a DTensor's full tensor). AdamW updates masters and
    moments in place, so a writer reading live storage would race the
    next step.
  * restore(): reads the tensors back into the structure of a template
    tree, refusing a shape mismatch, in each template leaf's dtype and on
    its device; with a target `mesh` and spec tree, each leaf is placed
    onto that layout (`runtime.sharding.place`) -- the target mesh may
    differ from the save-time one (elastic scaling): resharding happens
    on load.
  * async mode: serialization runs on a background thread; the train loop
    only blocks if a previous save is still in flight (one at a time).
  * retention: keep the newest `keep_n` checkpoints.

Under `torch.distributed` every rank calls save / wait / restore (a
DTensor's full tensor is a collective); rank 0 writes, and `wait` ends in
a barrier so no rank reads a checkpoint before it is published.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

PyTree = Any
_SEP = "||"
_FILE = "shard_0.pt"


def _children(node):
    """(key, child) pairs of an inner node, or None for a leaf."""
    if isinstance(node, dict):
        return list(node.items())
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _rebuild(like, values):
    if isinstance(like, dict):
        return dict(zip(like.keys(), values))
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*values)
    return type(like)(values)


def _map_paths(fn, tree, other=None, path=()):
    """`fn(key, leaf, other's entry)` over a tree's leaves (None stays
    None), the key the leaf's path joined by `_SEP`; `other` (or None) is
    walked along the same structure, its entries taken whole at `tree`'s
    leaves (a spec tuple is one entry)."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(_SEP.join(path), tree, other)
    if other is None:
        subs = [None] * len(kids)
    elif isinstance(other, dict):
        subs = [other[k] for k, _ in kids]
    else:
        subs = list(other)
    return _rebuild(tree, [_map_paths(fn, v, o, path + (k,))
                           for (k, v), o in zip(kids, subs)])


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    if hasattr(t, "full_tensor"):   # a DTensor: gather it
        t = t.full_tensor()
    return t.detach().to("cpu", copy=True)


def _flatten(tree: PyTree) -> Dict[str, torch.Tensor]:
    flat: Dict[str, torch.Tensor] = {}

    def take(key, leaf, _):
        flat[key] = _host_copy(leaf)

    _map_paths(take, tree)
    return flat


def _distributed() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def _writer() -> bool:
    import torch.distributed as dist
    return not _distributed() or dist.get_rank() == 0


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3,
                 async_save: bool = False):
        self.dir = directory
        self.keep_n = keep_n
        self.async_save = async_save
        self._inflight: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: PyTree) -> str:
        self.wait()
        # snapshot to host memory synchronously, before any writer starts
        flat = _flatten(tree)
        manifest = {
            "step": int(step),
            "keys": list(flat.keys()),
            "shapes": {k: list(v.shape) for k, v in flat.items()},
            "dtypes": {k: str(v.dtype) for k, v in flat.items()},
        }
        final = os.path.join(self.dir, f"step_{step:08d}")

        def write():
            tmp = final + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            torch.save(flat, os.path.join(tmp, _FILE))
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)          # atomic publish
            self._gc()

        if not _writer():
            return final
        if self.async_save:
            self._inflight = threading.Thread(target=write, daemon=True)
            self._inflight.start()
        else:
            write()
        return final

    def wait(self):
        if self._inflight is not None:
            self._inflight.join()
            self._inflight = None
        if _distributed():
            import torch.distributed as dist
            dist.barrier()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep_n]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like: PyTree, step: Optional[int] = None,
                mesh=None, specs: Optional[PyTree] = None
                ) -> Tuple[PyTree, int]:
        """Restore into the structure of `tree_like` (each leaf in the
        template leaf's dtype, on its device). With a `mesh` and a spec
        tree of the same structure (`runtime.sharding.param_specs` /
        `opt_state_specs`), each leaf is placed onto the TARGET layout as
        a DTensor -- the elastic reshard-on-restore path."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        data = torch.load(os.path.join(d, _FILE), weights_only=True)

        def one(key, like, spec):
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key}")
            t = data[key]
            if tuple(t.shape) != tuple(like.shape):
                raise ValueError(f"shape mismatch for {key}: ckpt "
                                 f"{tuple(t.shape)} vs model "
                                 f"{tuple(like.shape)}")
            if mesh is not None:
                from ..runtime import sharding
                return sharding.place(t.to(like.dtype), mesh,
                                      () if spec is None else spec)
            return t.to(device=like.device, dtype=like.dtype)

        return _map_paths(one, tree_like, specs if mesh is not None
                          else None), step
