"""Sharding rules: map every parameter / optimizer / cache leaf to a
partition spec on a mesh (port of `repro.runtime.sharding`).

A spec is a tuple with one entry per tensor dim: None (replicated along
that dim), a mesh axis name, or a tuple of axis names (one dim split over
several mesh axes, row-major) -- the counterpart of a JAX `PartitionSpec`.
Every rule is a pure function of (the leaf's key path, its shape, the
mesh's shape), so the specs can be computed and tested without a process
group; `place` turns them into `torch.distributed.tensor` placements over a
`DeviceMesh`.

Policy (Megatron-style TP over `model`, DP over `data` (+`pod`), optional
FSDP/ZeRO-3 over the data axes):

  column-parallel weights (out-features sharded):  (..., d, f)  -> f: model
  row-parallel weights (in-features sharded):      (..., f, d)  -> f: model
  embeddings (V, d):                                V: model
  MoE expert stacks (E, d, f):                      E: model (EP)
  norms / biases / scalars:                         replicated
  FSDP: additionally shard the largest replicated dim over the data axes.

The layer axis: the JAX package stacks the layers of a group on leading
axes, which are never sharded; the port keeps one dict per layer in a list
(nested lists for two stack levels). A leaf under k lists is classified as
the JAX leaf it stands for -- shape (len of each list) + its own shape --
and its spec is that leaf's spec with the k stack entries dropped, so the
port's spec equals the JAX spec with its layer-stack entries removed.
Leaves are classified by the port's own key names.

Divisibility is checked against the mesh and a rule silently degrades to
replication for a dim that does not divide (e.g. tiny smoke configs).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

PyTree = Any
Spec = Tuple[Any, ...]

# parameter-name classes (last key of the path)
_COL = {"wq", "wk", "wv", "w_gate", "w_up", "w_in", "w_r", "w_k", "w_v",
        "w_g", "w_uq", "w_uk", "w_uv", "w_dq", "w_dkv", "head", "proj",
        "decay_A", "decay_B"}
_ROW = {"wo", "w_down", "w_out", "w_o"}
_EMBED = {"embed"}
# rwkv channel-mix: w_k is col (d->f), w_v is row (f->d) -- told apart by
# the "cm" key on the path; attention wv stays col.


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a `DeviceMesh` or of a mapping that already is
    one (the rules take either, so they run without a process group)."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return {str(n): int(s) for n, s in zip(mesh.mesh_dim_names, mesh.shape)}


def _axis_size(shape: Dict[str, int], axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(shape[a] for a in axis)
    return shape[axis]


def data_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axes: ('pod','data') on multi-pod, ('data',) else."""
    shape = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in shape)


def _data_axis(mesh):
    da = data_axes(mesh)
    return da if len(da) > 1 else da[0]


def batch_spec(mesh) -> Spec:
    return (_data_axis(mesh),)


def data_extent(mesh) -> int:
    """Number of data-parallel groups: the product of the data axes."""
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in data_axes(mesh))


def data_index(mesh) -> int:
    """This rank's position along the data axes of a `DeviceMesh`
    (row-major over ('pod', 'data'))."""
    index = 0
    for a in data_axes(mesh):
        index = index * mesh.size(mesh.mesh_dim_names.index(a)) \
            + mesh.get_local_rank(a)
    return index


def _param_spec(path: Sequence, shape, mesh, fsdp: bool,
                stack: Tuple[int, ...] = ()) -> Spec:
    """The spec of one parameter leaf at key path `path` (str dict keys,
    int list indices) under `len(stack)` layer lists of the given lengths:
    the JAX rule on the stacked shape, the stack entries dropped."""
    mshape = mesh_shape(mesh)
    keys = [k for k in path if isinstance(k, str)]
    name = keys[-1] if keys else ""
    full = tuple(stack) + tuple(shape)
    rank = len(full)
    spec = [None] * rank
    in_moe = any("moe" in k for k in keys)
    in_cm = "cm" in keys

    def set_if(dim, axis):
        if spec[dim] is None and full[dim] % _axis_size(mshape, axis) == 0:
            spec[dim] = axis
            return True
        return False

    if name in _EMBED and rank == 2:
        set_if(0, "model")
    elif in_moe and name in ("w_gate", "w_up", "w_down") and rank >= 3:
        set_if(rank - 3, "model")      # expert stacks (E, d, f): EP
    elif in_cm and name == "w_v" and rank >= 2:
        set_if(rank - 2, "model")      # rwkv channel-mix down-proj: row
    elif name in _ROW and rank >= 2:
        set_if(rank - 2, "model")
    elif name in _COL and rank >= 2:
        set_if(rank - 1, "model")
    # FSDP/ZeRO-3: shard one remaining dim over the data axes
    if fsdp and rank >= 2:
        axis = _data_axis(mesh)
        # prefer the largest unsharded trailing dim
        for d in sorted(range(max(rank - 2, 0), rank), key=lambda d: -full[d]):
            if spec[d] is None and set_if(d, axis):
                break
    return tuple(spec[len(stack):])


def _map(fn, tree, path=(), stack=()):
    """`fn(path, leaf, stack)` over a tree of dicts and lists; a list is a
    layer stack (its length joins `stack`); a None subtree stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (k,), stack) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v, path + (i,), stack + (len(tree),))
                for i, v in enumerate(tree)]
    return fn(path, tree, stack)


def param_specs(mesh, params: PyTree, fsdp: bool = False) -> PyTree:
    """Spec tree mirroring `params` (leaves need only a `.shape`)."""
    return _map(lambda path, leaf, stack: _param_spec(
        path, leaf.shape, mesh, fsdp, stack), params)


def opt_state_specs(mesh, opt_state: PyTree, fsdp: bool = False) -> PyTree:
    """Optimizer moments mirror the param layout; the step counter (and any
    other 0-d leaf) replicates. An `AdamWState` (a named tuple) is mapped
    field by field, as a dict would be: its fields are no layer stack."""
    if hasattr(opt_state, "_fields"):
        return type(opt_state)(*(opt_state_specs(mesh, f, fsdp)
                                 for f in opt_state))
    return _map(lambda path, leaf, stack: () if len(leaf.shape) == 0
                else _param_spec(path, leaf.shape, mesh, fsdp, stack),
                opt_state)


def _cache_key(path) -> Tuple[str, ...]:
    return tuple(k for k in path if isinstance(k, str))


def _batch_axes(batch_axes):
    if batch_axes is None:
        from ..models.lm import CACHE_BATCH_AXES
        return CACHE_BATCH_AXES
    return batch_axes


def cache_specs(mesh, cache: PyTree, batch_size: int,
                batch_axes: Optional[Mapping] = None) -> PyTree:
    """Decode/prefill cache layout (leading dims are the layer stack, as in
    the JAX package's caches). Rules per leaf:
      * the batch dim sharded over the data axes when divisible;
      * a heads-like dim (the first after the batch dim, or after the
        layer dim, that is > 1 and divides) sharded over `model`;
      * when the batch does not divide (long context at batch 1), the
        largest remaining dim shards over the data axes instead (context
        parallelism).
    Each leaf's batch dim comes from `batch_axes` (key path -> axis or
    None; `models.lm.CACHE_BATCH_AXES` by default), not from its shape, so
    a batch size equal to a layer, head or window extent cannot be taken
    for the batch dim. `batch_size` is checked against that dim.
    """
    table = _batch_axes(batch_axes)
    mshape = mesh_shape(mesh)
    daxis = _data_axis(mesh)
    d_sz = _axis_size(mshape, daxis)
    m_sz = mshape["model"]

    def one(path, leaf, _stack):
        shape = tuple(leaf.shape)
        rank = len(shape)
        spec = [None] * rank
        bdim = table[_cache_key(path)]
        if bdim is not None and shape[bdim] != batch_size:
            raise ValueError(f"cache leaf {_cache_key(path)} has batch dim "
                             f"{shape[bdim]}, expected {batch_size}")
        if bdim is not None and shape[bdim] % d_sz == 0:
            spec[bdim] = daxis
            seq_shardable = False
        else:
            seq_shardable = True  # batch unshardable: context parallelism
        start = (bdim + 1) if bdim is not None else 1
        for i in range(start, rank):
            if spec[i] is None and shape[i] > 1 and shape[i] % m_sz == 0:
                spec[i] = "model"
                break
        if seq_shardable:
            for d in sorted(range(rank), key=lambda d: -shape[d]):
                if spec[d] is None and shape[d] % d_sz == 0 and shape[d] > 1:
                    spec[d] = daxis
                    break
        return tuple(spec)

    return _map(one, cache)


# ----------------------------------------------------------------------------
# serving data plane: decode-cache layout for the sharded serve step
# ----------------------------------------------------------------------------

def decode_shard_axis(path, shape=None, batch_size: Optional[int] = None
                      ) -> Optional[Tuple[str, int]]:
    """Classify one decode-cache leaf for data-parallel serving.

    Returns ("state", 0) for TAF detector-state leaves (per-shard, leading
    shard dim added by `models.lm.shard_taf_state`), ("batch", axis) for
    leaves carrying the request-lane dim (KV cache, TAF memos), or None for
    replicated leaves. The lane dim is the leaf's entry in
    `models.lm.CACHE_BATCH_AXES`; with `shape` and `batch_size` given, the
    dim's extent is checked against the batch.
    """
    from ..models.lm import TAF_SHARD_STATE
    key = _cache_key(path)
    if "taf" in key and key[-1] in TAF_SHARD_STATE:
        return ("state", 0)
    axis = _batch_axes(None)[key]
    if axis is None:
        return None
    if shape is not None and batch_size is not None \
            and shape[axis] != batch_size:
        raise ValueError(f"cache leaf {key} has batch dim {shape[axis]}, "
                         f"expected {batch_size}")
    return ("batch", axis)


def decode_partition_specs(mesh, cache: PyTree,
                           batch_size: Optional[int] = None) -> PyTree:
    """Spec tree for the sharded serve step's cache: TAF detector state
    shards its leading (logical-shard) dim over the data axes, lane-bearing
    leaves their lane dim, everything else replicates."""
    daxis = _data_axis(mesh)

    def one(path, leaf, _stack):
        kind = decode_shard_axis(path, leaf.shape, batch_size)
        spec = [None] * len(leaf.shape)
        if kind is not None:
            spec[kind[1]] = daxis
        return tuple(spec)

    return _map(one, cache)


def placements(mesh, spec: Spec):
    """The `torch.distributed.tensor` placements of `spec` over `mesh`:
    for each mesh dim, Shard(d) of the tensor dim it splits, else
    Replicate()."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, entry in enumerate(spec)
                if entry == name or (isinstance(entry, tuple)
                                     and name in entry)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def place(tree: PyTree, mesh, specs: PyTree) -> PyTree:
    """`tree`'s tensors as DTensors over `mesh` laid out by `specs` (a spec
    tree of the same structure, e.g. from `param_specs`). Every rank passes
    the same full tensors; `full_tensor()` gives them back."""
    from torch.distributed.tensor import distribute_tensor

    def one(t, spec):
        return distribute_tensor(t, mesh, placements(mesh, spec))

    if isinstance(tree, dict):
        return {k: place(v, mesh, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [place(v, mesh, s) for v, s in zip(tree, specs)]
    return one(tree, specs)
