"""Dry run: every (arch x shape x mesh) cell traced on shape-only tensors,
counted per device (port of `repro.launch.dryrun`).

For each cell:
  * build the model from its exact config, and its parameters, optimizer
    state, cache and batch as meta tensors (`launch.specs`): nothing is
    allocated and nothing is computed;
  * place them as DTensors on the production mesh (`launch.mesh`) by the
    port's sharding rules (`runtime.sharding`), on rank 0 of a fake
    process group of the mesh's world size
    (`torch.testing._internal.distributed.fake_pg`), so each local shard
    is what one device of the mesh would hold;
  * run the step once (`launch.steps`: train, prefill or serve) under
    `DeviceCount`, a `TorchDispatchMode` that lets DTensor desugar every
    op into local ops and collectives first and then counts what one
    device runs: FLOPs (`analysis.cost.op_cost`) split into bf16 / fp16
    products (tensor cores) and the rest, bytes moved at each dtype's size
    (views move none), each collective's output bytes by kind and mesh
    axis (and by the phase, dtype and shape of what it moves:
    `collectives.by_shape`), and the live bytes of device storages. A
    collective is counted as the one a card runs, on a "cuda" and a "cpu"
    mesh alike: the `_c10d_functional` ops by kind, and DTensor's
    Shard-to-Shard move as one all-to-all (`COLLECTIVES`); an op of a
    collective namespace that `COLLECTIVES` does not name raises.

Memory: `argument_bytes` are the local shards the step is given; the
step's own storages are tracked from allocation to release (a finalizer on
each storage), `temp_bytes` is their largest live total and
`per_device_bytes` the two summed; `temp_by_phase` is that largest total
in each phase of the step (`PHASES`: forward, backward, the gradients laid
out, the optimizer's update), each of which grows by a fixed amount a
layer where the step's own peak need not. A cell fits when that is under one
H100's 80 GB. Outputs are written into the arguments (the train step
updates masters and moments in place, the serve step its cache), so
`alias_bytes` counts those and `output_bytes` only the new ones.

Where the JAX dry run differs:
  * XLA counts a `while` body once, so the JAX roofline composes full depth
    from unrolled small-depth lowerings. The port's layers are a Python
    loop, traced trip by trip: the count is the full depth's, and `detail`
    holds one layer's FLOPs of each layer type from the same trace (each op
    is charged to the layer whose parameter it last read). The port's
    roofline composes as JAX's does (`roofline.composed_cost`, on this
    module's traces of the small-depth variants).
  * DTensor runs the step op by op, planning each op's layout from its
    operands' where GSPMD plans the program; the models write the
    redistributions a sharded step needs (`models.common`), and DTensor's
    own planning computes on host tensors that no device runs (not
    counted).
  * The stand-ins are meta tensors and not a `FakeTensorMode`'s fake
    tensors (which are meta tensors underneath): DTensor computes a strided
    shard's offsets on real index tensors, which a fake mode would make
    fake and then could not read back.
  * `launch/inspect_hlo.py` and `runtime/hlo.py` have no counterpart: there
    is no HLO text in the port. `DeviceCount`'s count of the collective
    ops by kind takes the place of `runtime.hlo.collective_stats` (one
    entry per collective, its result bytes; `wait_tensor`, the `-done`
    half, is not counted). DTensor moves a split from one dim to another
    over a mesh dim through `shard_dim_alltoall`: on a "cuda" mesh the
    `_dtensor.shard_dim_alltoall` op, on a "cpu" mesh (gloo has no
    all-to-all) an all-gather of the whole dim and a chunk of it.
    `DeviceCount` wraps that function and counts either as the
    all-to-all, of its output's bytes on the mesh dim's axis, so that the
    two meshes count the same collectives.

Results go to results/torch/dryrun/<cell>.json.

Usage:
  python -m repro_torch.launch.dryrun --arch olmoe-1b-7b --shape decode_32k
      --single-pod [--device cpu]
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--single-pod]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

from .. import device as device_mod
from ..analysis.cost import op_cost
from ..configs import SHAPES, get_config, list_archs, shape_applicable
from ..configs.base import ModelConfig, ShapeConfig
from ..models import build
from ..optim import adamw
from ..runtime import sharding as shardlib
from ..runtime.elastic import make_mesh
from . import specs as specs_mod
from . import steps as steps_mod
from .mesh import make_production_mesh

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "torch", "dryrun")

HBM_BYTES = 80e9          # one H100's device memory
NODE_CARDS = 8            # cards of one NVLink node (a DGX H100)
# a step's phases, for its memory: before its first backward, in a
# backward (recomputed activations included), after it until the
# optimizer's first foreach op (the gradients laid out as their masters),
# and from that op on
PHASES = ("forward", "backward", "gradients", "update")

# collective op ("namespace.name") -> the collective kind JAX's HLO count
# names
COLLECTIVES = {
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.all_reduce_coalesced_": "all-reduce",
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.all_gather_into_tensor_out": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_out": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_c10d_functional.broadcast": "broadcast",
    "_c10d_functional.broadcast_": "broadcast",
    # DTensor's Shard-to-Shard move over one mesh dim
    "_dtensor.shard_dim_alltoall": "all-to-all",
}
# the namespaces of collective ops: an op there that neither COLLECTIVES
# nor MOVE_NOTHING names makes `DeviceCount` raise, so that no collective
# is counted as a local op
COLLECTIVE_NAMESPACES = ("_c10d_functional", "_dtensor", "c10d")
# ops of those namespaces that move no bytes: a collective's `-done` half
# and the autograd wrapper of a collective's result
MOVE_NOTHING = {"_c10d_functional.wait_tensor",
                "_c10d_functional._wrap_tensor_autograd"}
_TENSOR_CORE = (torch.bfloat16, torch.float16)
_DOTS = {"mm", "bmm", "addmm", "baddbmm", "matmul", "mv", "dot", "addmv",
         "linear"}
# writes into part of their first argument: the bytes are the index and
# source operands read and the region written, not the whole destination
_SCATTERS = {"index_put", "index_put_", "_index_put_impl_", "index_copy",
             "index_copy_", "scatter", "scatter_", "scatter_add",
             "scatter_add_", "index_add", "index_add_", "masked_scatter_"}
# read only the rows their indices name: the bytes are the indices read
# and the output read and written once
_GATHERS = {"index", "index_select", "gather", "embedding", "take"}
_ALLOCS = {"empty", "empty_strided", "empty_like", "new_empty",
           "new_empty_strided"}


def _tensors(obj) -> List[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _tensors(o)]
    return []


def _read_bytes(t: torch.Tensor) -> int:
    """Bytes of one operand read once: its elements at its dtype's size,
    but no more than its storage holds (an expanded view)."""
    n = t.numel() * t.element_size()
    try:
        return min(n, t.untyped_storage().nbytes())
    except (RuntimeError, NotImplementedError):
        return n


class DeviceCount(TorchDispatchMode):
    """What one device runs in a step, op by op.

    Ops on DTensors are handed back to DTensor (`NotImplemented`), which
    runs them as local ops and collectives that reach this mode again.
    `axes` maps a process group's name to its mesh axis label; `owners`
    maps parameter tensors to (layer type, layer index) for `layers`."""

    def __init__(self, axes: Optional[Dict[str, str]] = None,
                 owners: Optional[WeakIdKeyDictionary] = None):
        super().__init__()
        self.axes = axes or {}
        self.owners = owners if owners is not None else WeakIdKeyDictionary()
        self.flops = {"tensor_core": 0.0, "float32": 0.0}
        self.dot_flops = 0.0
        self.bytes = 0.0
        self.counts: Dict[str, int] = {}
        self.coll_bytes: Dict[str, int] = {}
        self.axis_bytes: Dict[str, int] = {}
        # (phase, kind, mesh axis, dtype, shape) of each collective's
        # result -> how many
        self.coll_shapes: Dict[Tuple, int] = {}
        # DTensor's Shard-to-Shard moves (each counted as an all-to-all)
        self.moves = 0
        self.layers: Dict[Tuple[str, int], Dict[str, float]] = {}
        self.ops = 0
        self._owner: Optional[Tuple[str, int]] = None
        self._args: set = set()
        self._seen: Dict[int, Tuple] = {}
        # the live storages when the peak was reached
        self._at_peak: Dict[int, Tuple] = {}
        self.live = 0
        self.peak = 0
        # the peak of live bytes in each of `PHASES`
        self.phase_peak = dict.fromkeys(PHASES, 0)
        self._backward = self._update = False
        # filled by `count_step`: the argument, new-output and written-
        # argument bytes of the step
        self.arguments = self.out_bytes = self.alias_bytes = 0
        # > 0 while DTensor plans or moves a split (nothing is counted)
        self._quiet = 0
        self._unwrapped: List[List[Tuple[Any, str, Any]]] = []

    # -- DTensor's own planning and Shard-to-Shard moves ----------------------
    # The first time DTensor meets an op's placements it plans the op's
    # sharding, and the plan computes shard sizes and offsets on small host
    # tensors (a later call finds the plan cached): no device runs those ops,
    # so nothing is counted while DTensor plans.
    _PLANNERS = ("propagate", "propagate_op_sharding",
                 "propagate_op_sharding_non_cached")

    def __enter__(self):
        import sys
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor import _collective_utils
        prop = DTensor._op_dispatcher.sharding_propagator
        saved = []
        for name in self._PLANNERS:
            fn = getattr(prop, name, None)
            if fn is None:
                continue
            saved.append((prop, name, prop.__dict__.get(name)))
            setattr(prop, name, self._quiet_call(fn))
        # DTensor moves a split from one dim to another over a mesh dim
        # through `shard_dim_alltoall`, wherever its modules imported it
        move = _collective_utils.shard_dim_alltoall
        for mod_name, mod in list(sys.modules.items()):
            if (mod_name.startswith("torch.distributed")
                    and getattr(mod, "shard_dim_alltoall", None) is move):
                saved.append((mod, "shard_dim_alltoall", move))
                mod.shard_dim_alltoall = self._move_call(move)
        self._unwrapped.append(saved)
        return super().__enter__()

    def __exit__(self, *exc):
        for obj, name, own in reversed(self._unwrapped.pop()):
            if own is None:
                delattr(obj, name)
            else:
                setattr(obj, name, own)
        return super().__exit__(*exc)

    def _quiet_call(self, fn):
        def call(*args, **kwargs):
            self._quiet += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self._quiet -= 1
        return call

    def _move_call(self, move):
        """DTensor's Shard-to-Shard move counted as the one all-to-all a
        card runs (`_dtensor.shard_dim_alltoall`), of its output's bytes
        on the mesh dim's axis, on any mesh: on a cpu mesh DTensor falls
        back to an all-gather of the whole dim and a chunk of it, neither
        counted. The result is a tensor of its own, as the all-to-all's
        is (a chunk of the gathered tensor would hold all of it)."""
        moved = self._quiet_call(lambda *args: move(*args).clone())

        def call(input, gather_dim, shard_dim, mesh, mesh_dim):
            if self._quiet or isinstance(input, FakeTensor):
                return move(input, gather_dim, shard_dim, mesh, mesh_dim)
            out = moved(input, gather_dim, shard_dim, mesh, mesh_dim)
            self.ops += 1
            self._collective("all-to-all", mesh.get_group(mesh_dim).group_name,
                             [input], out, "shard_dim_alltoall")
            self._track(out, "shard_dim_alltoall")
            return out
        return call

    # -- memory ---------------------------------------------------------------
    def hold_arguments(self, tensors: Sequence[torch.Tensor]) -> int:
        """Mark the step's argument storages (not the step's own) and
        return their bytes."""
        total = 0
        for t in tensors:
            st = t.untyped_storage()
            if id(st) not in self._args:
                self._args.add(id(st))
                total += st.nbytes()
        return total

    def _phase(self, name: str) -> str:
        if torch._C._current_graph_task_id() != -1:
            self._backward = True
            return "backward"
        if not self._backward:
            return "forward"
        self._update = self._update or name.startswith("_foreach")
        return "update" if self._update else "gradients"

    def _free(self, key: int, nbytes: int) -> None:
        self._seen.pop(key, None)
        self.live -= nbytes

    def _track(self, out, name: str) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            if key in self._args or key in self._seen:
                continue
            nbytes = st.nbytes()
            phase = self._phase(name)
            self._seen[key] = (phase, name, str(t.dtype).replace("torch.", ""),
                               tuple(t.shape), nbytes)
            self.live += nbytes
            if self.live > self.peak:
                self.peak = self.live
                self._at_peak = dict(self._seen)
            self.phase_peak[phase] = max(self.phase_peak[phase], self.live)
            weakref.finalize(st, self._free, key, nbytes)

    # -- counting -------------------------------------------------------------
    def _charge(self, args) -> None:
        owners = {self.owners.get(t) for t in _tensors(args)} - {None}
        if len(owners) == 1:
            owner = owners.pop()
            self._owner = None if owner == OUTSIDE else owner
        elif owners:
            self._owner = None     # e.g. AdamW's foreach over every leaf

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            first = args[0] if args else None
            if (func._schema.is_mutable and isinstance(first, torch.Tensor)
                    and not isinstance(first, DTensor)):
                # an in-place op on a plain tensor the model made (under
                # implicit_replication, so alike on every rank) with
                # DTensor operands: each device gathers the operands whole
                # and runs the op on its own copy (DTensor's in-place path
                # refuses a plain destination)
                from torch.distributed.tensor import Replicate

                def whole(a):
                    if not isinstance(a, DTensor):
                        return a
                    return a.redistribute(
                        a.device_mesh,
                        [Replicate()] * a.device_mesh.ndim).to_local()
                with self:
                    func(first, *[whole(a) for a in args[1:]],
                         **{k: whole(v) for k, v in kwargs.items()})
                return first
            return NotImplemented
        name = func.overloadpacket.__name__
        op = f"{func.namespace}.{name}"
        kind = COLLECTIVES.get(op)
        if (func.namespace in COLLECTIVE_NAMESPACES and kind is None
                and op not in MOVE_NOTHING):
            raise NotImplementedError(
                f"DeviceCount: {op} is a collective op that COLLECTIVES "
                "does not name")
        out = func(*args, **kwargs)
        if self._quiet or func.namespace == "prim" or any(
                isinstance(t, FakeTensor)
                for t in _tensors(args) + _tensors(out)):
            # DTensor's sharding propagation runs the op once on fake
            # tensors of the global shape to learn its output's: no device
            # runs that
            return out
        self.ops += 1
        if func.namespace in COLLECTIVE_NAMESPACES:
            if kind is not None:
                # the group's name is the last string operand (the reduce
                # op, where there is one, comes before it)
                group = [a for a in args if isinstance(a, str)][-1:] or [""]
                self._collective(kind, group[0], _tensors(args), out, name)
            self._track(out, name)
            return out
        self._charge(args)
        ins = _tensors(args) + _tensors(list(kwargs.values()))
        if func.is_view or name in _ALLOCS:
            b = 0
        elif name in _GATHERS:
            outs = _tensors(out)
            b = sum(_read_bytes(t) for t in ins[1:]) + 2 * sum(
                t.numel() * t.element_size() for t in outs)
        elif name in _SCATTERS:
            rest = ins[1:]
            b = sum(_read_bytes(t) for t in rest) + max(
                (t.numel() * t.element_size() for t in rest), default=0)
        else:
            b = sum(_read_bytes(t) for t in ins) + sum(
                t.numel() * t.element_size() for t in _tensors(out))
        f = op_cost(func, args, kwargs, out).flops
        cls = ("tensor_core" if name in _DOTS and ins
               and ins[-1].dtype in _TENSOR_CORE else "float32")
        dot = f if name in _DOTS else 0.0
        self.flops[cls] += f
        self.dot_flops += dot
        self.bytes += b
        if self._owner is not None:
            row = self.layers.setdefault(
                self._owner, {"tensor_core": 0.0, "float32": 0.0, "dot": 0.0})
            row[cls] += f
            row["dot"] += dot
        if func.is_view or name == "_to_copy":
            owner = self.owners.get(ins[0]) if ins else None
            if owner is not None:
                for t in _tensors(out):
                    self.owners[t] = owner
        self._track(out, name)
        return out

    def _collective(self, kind: str, group: str, ins, out, name: str) -> None:
        """Count one collective of `kind` over the process group named
        `group`: its output's bytes, by kind, by mesh axis and by shape,
        and its operands read and output written in the memory term."""
        b = sum(t.numel() * t.element_size() for t in _tensors(out))
        self.moves += name == "shard_dim_alltoall"
        self.counts[kind] = self.counts.get(kind, 0) + 1
        self.coll_bytes[kind] = self.coll_bytes.get(kind, 0) + b
        axis = self.axes.get(group, group)
        self.axis_bytes[axis] = self.axis_bytes.get(axis, 0) + b
        for t in _tensors(out):
            key = (self._phase(name), kind, axis,
                   str(t.dtype).replace("torch.", ""), tuple(t.shape))
            self.coll_shapes[key] = self.coll_shapes.get(key, 0) + 1
        self.bytes += b + sum(_read_bytes(t) for t in ins)

    @property
    def total_flops(self) -> float:
        return self.flops["tensor_core"] + self.flops["float32"]

    def peak_by_op(self, top: int = 12) -> List[Dict[str, Any]]:
        """The storages live at the step's peak, by the phase and op that
        made them and their dtype and shape, most bytes first (the
        largest `top`; a storage a view of a larger one reads the view's
        shape)."""
        rows: Dict[Tuple, List[int]] = {}
        for ph, op, dt, shape, nbytes in self._at_peak.values():
            row = rows.setdefault((ph, op, dt, shape), [0, 0])
            row[0] += 1
            row[1] += nbytes
        out = [{"phase": ph, "op": op, "dtype": dt, "shape": list(shape),
                "count": n, "bytes": b}
               for (ph, op, dt, shape), (n, b) in rows.items()]
        return sorted(out, key=lambda r: -r["bytes"])[:top]

    def by_shape(self) -> List[Dict[str, Any]]:
        """The collectives by phase, kind, mesh axis and the dtype and
        local shape of their result (the tensors they move), most bytes
        first."""
        return shape_rows(self.coll_shapes)


def shape_rows(counts: Dict[Tuple, int]) -> List[Dict[str, Any]]:
    """`DeviceCount.coll_shapes` as the record's rows, most bytes first."""
    rows = [{"phase": ph, "kind": kind, "axis": axis, "dtype": dt,
             "shape": list(shape), "count": n,
             "bytes": n * math.prod(shape) * getattr(torch, dt).itemsize}
            for (ph, kind, axis, dt, shape), n in counts.items() if n]
    return sorted(rows, key=lambda r: -r["bytes"])


# ----------------------------------------------------------------------------
# placing the stand-ins
# ----------------------------------------------------------------------------

def _map(fn, tree, path=()):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _leaves(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    _map(lambda _p, t: out.append(t), tree)
    return out


def _local(t: torch.Tensor, mesh, spec):
    """`t` (meta) as the DTensor one device of `mesh` holds under `spec`:
    its local shard a meta tensor of rank 0's extent."""
    from torch.distributed.tensor import DTensor, Shard
    places = shardlib.placements(mesh, spec)
    shape = list(t.shape)
    for md, p in enumerate(places):
        if isinstance(p, Shard):
            shape[p.dim] = -(-shape[p.dim] // mesh.size(md))
    local = torch.empty(shape, dtype=t.dtype, device=t.device)
    return DTensor.from_local(local, mesh, places, run_check=False,
                              shape=t.shape, stride=t.stride())


def _place(tree, mesh, specs):
    if mesh is None or tree is None:   # an empty stack (a hybrid's tail)
        return tree
    if isinstance(tree, dict):
        return {k: _place(v, mesh, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_place(v, mesh, s) for v, s in zip(tree, specs)]
    return _local(tree, mesh, specs)


def _local_of(t):
    return t._local_tensor if hasattr(t, "_local_tensor") else t


# the owner of the parameters outside every layer (embedding, head, norm)
OUTSIDE = ("", -1)


def layer_owners(params) -> WeakIdKeyDictionary:
    """Each parameter tensor (local shard) -> (layer type, index): a leaf
    under a list of layers belongs to the list's key path and its index
    there, any other leaf to `OUTSIDE`."""
    owners = WeakIdKeyDictionary()

    def one(path, t):
        idx = [i for i, k in enumerate(path) if isinstance(k, int)]
        owners[_local_of(t)] = (OUTSIDE if not idx else (
            "/".join(str(k) for k in path[:idx[0]]), path[idx[0]]))

    _map(one, params)
    return owners


def _detail(count: DeviceCount) -> Dict[str, Any]:
    """One layer's FLOPs of each layer type (its first layer) and the
    number of such layers, as the JAX roofline's marginals report them."""
    out: Dict[str, Any] = {}
    kinds = sorted({label for label, _ in count.layers})
    for label in kinds:
        rows = {i: r for (lb, i), r in count.layers.items() if lb == label}
        first = rows[min(rows)]
        out[label] = {"n_layers": len(rows),
                      "layer_flops": first["tensor_core"] + first["float32"],
                      "layer_tensor_core_flops": first["tensor_core"],
                      "layer_dot_flops": first["dot"]}
    rows = count.layers.values()
    out["outside_layers_flops"] = count.total_flops - sum(
        r["tensor_core"] + r["float32"] for r in rows)
    out["outside_layers_dot_flops"] = count.dot_flops - sum(
        r["dot"] for r in rows)
    return out


# ----------------------------------------------------------------------------
# one cell
# ----------------------------------------------------------------------------

def mesh_label(mesh_shape: Dict[str, int]) -> str:
    return "x".join(str(n) for n in mesh_shape.values())


def production_mesh_shape(multi_pod: bool) -> Dict[str, int]:
    """The JAX package's production mesh: 16x16, or 2x16x16 multi-pod."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


@contextlib.contextmanager
def fake_world(world: int):
    """Rank 0 of a fake default process group of `world` ranks, for the
    duration of the block (collectives return at once and move nothing)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError(
            "the dry run starts its own fake process group; run it in a "
            "process with no default process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def link_of(group_ranks: Sequence[int]) -> str:
    """'nvlink' when every rank of the group sits in one node of
    `NODE_CARDS` cards, else 'infiniband'."""
    return ("nvlink" if len({r // NODE_CARDS for r in group_ranks}) <= 1
            else "infiniband")


def mesh_axes(mesh) -> Dict[str, Dict[str, Any]]:
    """{axis: {"group": its process group's name, "link": the links it
    crosses}} for rank 0's groups of `mesh`."""
    import torch.distributed as dist
    out = {}
    for name in mesh.mesh_dim_names:
        g = mesh.get_group(name)
        out[name] = {"group": g.group_name,
                     "link": link_of(dist.get_process_group_ranks(g))}
    return out


def _step_inputs(model, cfg: ModelConfig, shape: ShapeConfig, mesh):
    """(step, args, argument tensors, parameter tree) of one cell: the
    stand-ins placed on `mesh` (None: one device, unplaced)."""
    meta = specs_mod.meta_model(model)
    draw = specs_mod.MetaDraw()
    ms = shardlib.mesh_shape(mesh) if mesh is not None else None
    if shape.kind == "train":
        params = meta.masters(draw)
        opt = adamw.init(params)
        batch = specs_mod.train_batch_specs(cfg, shape)
        if mesh is not None:
            params = _place(params, mesh, shardlib.param_specs(
                ms, params, fsdp=cfg.fsdp))
            opt = adamw.AdamWState(*_place(list(opt), mesh, list(
                shardlib.opt_state_specs(ms, opt, fsdp=cfg.fsdp))))
            batch = _place(batch, mesh, specs_mod.batch_shardings(ms, batch))
        step = steps_mod.make_train_step(meta, adamw.AdamWConfig())
        return step, (params, opt, batch), _leaves([params, list(opt),
                                                    batch]), params
    # as the JAX dry run: serving weights are cast to the compute dtype
    # once, and stay TP-resident (no FSDP outside training)
    params = _map(lambda _p, t: t.to(meta.cdt) if t.is_floating_point()
                  else t, meta.init(draw))
    if mesh is not None:
        params = _place(params, mesh, shardlib.param_specs(ms, params))
    if shape.kind == "prefill":
        batch = specs_mod.prefill_batch_specs(cfg, shape)
        if mesh is not None:
            batch = _place(batch, mesh, specs_mod.batch_shardings(ms, batch))
        step = steps_mod.make_prefill_step(meta, shape.seq_len, mesh)
        return step, (params, batch), _leaves([params, batch]), params
    if shape.kind == "decode":
        cache, tokens = specs_mod.decode_specs(model, cfg, shape)
        if mesh is not None:
            cache = _place(cache, mesh, shardlib.cache_specs(
                ms, cache, shape.global_batch))
            tokens = _place({"tokens": tokens}, mesh,
                            specs_mod.batch_shardings(
                                ms, {"tokens": tokens}))["tokens"]
        step = steps_mod.make_serve_step(meta)
        return (step, (params, cache, tokens, shape.seq_len - 1),
                _leaves([params, cache, tokens]), params)
    raise ValueError(shape.kind)


def count_step(step, args, arguments, params, mesh=None) -> DeviceCount:
    """Run `step(*args)` once under a `DeviceCount` (DTensor args: on
    `mesh`, under `implicit_replication` for the plain tensors the model
    makes) and return the count."""
    axes = ({info["group"]: name for name, info in mesh_axes(mesh).items()}
            if mesh is not None else {})
    count = DeviceCount(axes, layer_owners(params))
    count.arguments = count.hold_arguments([_local_of(t) for t in arguments])
    ctx = contextlib.nullcontext()
    if mesh is not None:
        from torch.distributed.tensor.experimental import (
            implicit_replication)
        ctx = implicit_replication()
    with ctx, count:
        out = step(*args)
    for t in _leaves(out if isinstance(out, (list, tuple)) else [out]):
        if not isinstance(t, torch.Tensor):
            continue
        st = _local_of(t).untyped_storage()
        if id(st) in count._args:
            count.alias_bytes += st.nbytes()
        else:
            count.out_bytes += st.nbytes()
    return count


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               cfg_override: Optional[ModelConfig] = None, *,
               shape: Optional[ShapeConfig] = None,
               mesh_shape: Optional[Dict[str, int]] = None,
               device=None) -> Dict[str, Any]:
    """Trace one cell and count it per device; returns the record (the JAX
    record's keys, plus `flops_by_class`, `collectives.bytes_by_axis`,
    `collectives.links`, `fits` and `detail`).

    `shape` and `mesh_shape` replace the named shape and the production
    mesh (a one-device mesh runs with no process group). `device` is the
    mesh's device type (cuda unless "cpu" is asked for: NCCL's and gloo's
    collective choices differ)."""
    dev = device_mod.resolve(device)
    mshape = mesh_shape or production_mesh_shape(multi_pod)
    chips = math.prod(mshape.values())
    label = mesh_label(mshape)
    if mesh_shape is None and multi_pod:
        # DTensor splits no tensor dim over two mesh dims (the batch over
        # ('pod', 'data')), so the two data axes are one mesh dim of 32:
        # the same shards, and collectives over the same 32 ranks
        mshape = {"data": mshape["pod"] * mshape["data"],
                  "model": mshape["model"]}
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    shape = shape if shape is not None else SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": label, "chips": chips,
                           "kind": shape.kind}
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec
    model = build(cfg, device="cpu")
    t0 = time.time()
    world = fake_world(chips) if chips > 1 else contextlib.nullcontext()
    with world:
        mesh = None
        if chips > 1:
            mesh = (make_production_mesh(device=dev)
                    if mesh_shape is None and not multi_pod else
                    make_mesh(tuple(mshape.values()), tuple(mshape), dev))
        step, args, arguments, params = _step_inputs(model, cfg, shape,
                                                     mesh)
        t1 = time.time()
        count = count_step(step, args, arguments, params, mesh)
        links = ({k: v["link"] for k, v in mesh_axes(mesh).items()}
                 if mesh is not None else {})
    t2 = time.time()
    per_device = count.arguments + count.peak
    rec.update({
        "status": "ok",
        "lower_s": round(t1 - t0, 2),
        "compile_s": round(t2 - t1, 2),
        "memory": {"argument_bytes": count.arguments,
                   "output_bytes": count.out_bytes,
                   "temp_bytes": count.peak,
                   "temp_by_phase": dict(count.phase_peak),
                   "peak_by_op": count.peak_by_op(),
                   "alias_bytes": count.alias_bytes,
                   "code_bytes": 0},
        "per_device_bytes": per_device,
        "fits": per_device < HBM_BYTES,
        "hlo_flops_per_device": count.total_flops,
        "hlo_bytes_per_device": count.bytes,
        "flops_by_class": dict(count.flops),
        "dot_flops_per_device": count.dot_flops,
        "collectives": {"counts": count.counts,
                        "bytes_by_kind": count.coll_bytes,
                        "bytes_by_axis": count.axis_bytes,
                        "by_shape": count.by_shape(),
                        "shard_moves": count.moves,
                        "links": links,
                        "total_bytes_per_device": sum(
                            count.coll_bytes.values())},
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "ops": count.ops,
        "detail": _detail(count),
    })
    return rec


def short_cell(cfg: ModelConfig, shape: ShapeConfig
               ) -> Tuple[ModelConfig, ShapeConfig]:
    """A cell cut for a quick check that it traces: full width, depth cut
    to the JAX roofline's smallest variant (one layer; one dense and one
    MoE layer where there are leading dense layers; the hybrid's period,
    each layer type once), and short shapes: train 256 x 256 (the vlm's
    256 text tokens after its patches), prefill 32 x 512, decode 128 x
    512 (batch 1 for `long_500k`), on the same mesh."""
    if cfg.family == "moe" and cfg.moe.n_dense_layers > 0:
        cut = dataclasses.replace(cfg, n_layers=2, moe=dataclasses.replace(
            cfg.moe, n_dense_layers=1))
    elif cfg.family == "hybrid":
        cut = dataclasses.replace(cfg, n_layers=cfg.hybrid.attn_period)
    else:
        cut = dataclasses.replace(cfg, n_layers=1)
    if shape.kind == "train":
        short = ShapeConfig(shape.name, 256 + cfg.n_patch_tokens, 256,
                            "train")
    elif shape.kind == "prefill":
        short = ShapeConfig(shape.name, 512, 32, "prefill")
    else:
        short = ShapeConfig(shape.name, 512, min(shape.global_batch, 128),
                            "decode")
    return cut, short


def status_matrix(archs: Optional[Sequence[str]] = None,
                  shapes: Optional[Sequence[str]] = None
                  ) -> Dict[Tuple[str, str, str], str]:
    """{(arch, shape, mesh): "ok" | "skipped"}: the status each cell of the
    sweep takes before anything is traced (`shape_applicable`)."""
    out = {}
    for arch in archs or list_archs():
        cfg = get_config(arch)
        for s in shapes or list(SHAPES):
            for multi in (False, True):
                ok, _ = shape_applicable(cfg, SHAPES[s])
                out[(arch, s, mesh_label(production_mesh_shape(multi)))] = \
                    "ok" if ok else "skipped"
    return out


def run_all(multi_pod_only: bool = False, single_pod_only: bool = False,
            archs=None, shapes=None, results_dir: Optional[str] = None,
            device=None) -> Dict[str, int]:
    """Every cell of `archs` x `shapes` x the meshes, one after another,
    each record written to
    <results_dir>/<arch>__<shape>__<single|multi>.json."""
    results_dir = results_dir or RESULTS_DIR
    os.makedirs(results_dir, exist_ok=True)
    meshes = []
    if not multi_pod_only:
        meshes.append(False)
    if not single_pod_only:
        meshes.append(True)
    n = {"ok": 0, "skipped": 0, "FAILED": 0}
    for arch in (archs or list_archs()):
        for shape_name in (shapes or list(SHAPES)):
            for multi in meshes:
                tag = f"{arch}__{shape_name}__{'multi' if multi else 'single'}"
                try:
                    rec = lower_cell(arch, shape_name, multi, device=device)
                except Exception as e:  # a failure here is a port fault
                    rec = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_label(production_mesh_shape(multi)),
                           "status": "FAILED", "error": str(e)[-2000:],
                           "traceback": traceback.format_exc()[-4000:]}
                with open(os.path.join(results_dir, tag + ".json"), "w") as f:
                    json.dump(rec, f, indent=1)
                s = rec["status"]
                n[s] += 1
                extra = ""
                if s == "ok":
                    extra = (f"mem/dev={rec['per_device_bytes'] / 2**30:.2f}"
                             f"GiB flops/dev="
                             f"{rec['hlo_flops_per_device']:.3g} coll/dev="
                             f"{rec['collectives']['total_bytes_per_device']}"
                             f"B trace={rec['compile_s']}s")
                elif s == "FAILED":
                    extra = rec["error"].splitlines()[-1][:160] \
                        if rec["error"] else ""
                print(f"[{s:7s}] {tag} {extra}", flush=True)
    print(f"done: ok={n['ok']} skipped={n['skipped']} FAILED={n['FAILED']}")
    return n


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="only the 2x16x16 mesh")
    ap.add_argument("--single-pod", action="store_true",
                    help="only the 16x16 mesh")
    ap.add_argument("--device", default="cuda",
                    help="the mesh's device type: cuda (the default) or cpu")
    ap.add_argument("--results-dir", default=None)
    args = ap.parse_args(argv)
    device_mod.resolve(args.device)
    if args.all or not (args.arch and args.shape):
        run_all(multi_pod_only=args.multi_pod,
                single_pod_only=args.single_pod,
                archs=[args.arch] if args.arch else None,
                shapes=[args.shape] if args.shape else None,
                results_dir=args.results_dir, device=args.device)
        return
    for multi in ([True] if args.multi_pod else
                  [False] if args.single_pod else [False, True]):
        rec = lower_cell(args.arch, args.shape, multi, device=args.device)
        print(json.dumps(rec, indent=1))


if __name__ == "__main__":
    main()
