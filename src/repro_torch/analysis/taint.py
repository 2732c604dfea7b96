"""Taint analysis over eager PyTorch for A003 (unsafe approximation sink)
(port of `repro.analysis.taint`).

Sources are the *approximate value* leaves of a program's inputs (memoized
TAF outputs, perforated partial sums). The program runs once, op by op,
under `TaintMode`, a `TorchDispatchMode` that marks every output of an op
with a tainted input (the JAX walk's conservative "any in -> all out"),
per storage: a tainted value written into part of a buffer taints the
buffer. Sinks are positions where a tainted value steers the PROGRAM
rather than flowing through arithmetic:

  * a tainted scalar read by the host (`aten._local_scalar_dense`, which
    `bool()`, `float()`, `.item()` and `.tolist()` reach): Python control
    flow in eager PyTorch, the port's "branch predicate" (a "while
    predicate" when the reading line is a `while`, as a loop over a
    tainted carry's condition is);
  * the index operands of `index`, `index_select`, `gather`, `scatter*`,
    `index_put`, `index_add`, `index_copy`, `take` and `embedding`.

Arithmetic on approximate data is the point of approximate computing --
bounded error in, bounded error out. Indices and predicates are different:
a 1-ulp error flips a branch or reads a different row.

A call into a nested function or module is walked like any other op: the
ops it dispatches are the program's. A sink's `path` names the Python
functions between the analyzed function and the op ("/inner"), where the
JAX walk names its sub-jaxprs ("/pjit/cond[1]"). Detector STATE (TAF's
`remaining` counter) steering a branch is the approximation mechanism, not
a defect: callers choose which leaves they mark tainted.
"""
from __future__ import annotations

import dataclasses
import linecache
import os
import sys
import weakref
from typing import Dict, List, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# host reads: a tensor's value handed to Python
HOST_READS = ("_local_scalar_dense", "is_nonzero", "item")

# sink op -> positions of its index operands
_INDEX_SINKS = {
    "index": (1,), "index_put": (1,), "index_put_": (1,),
    "_index_put_impl_": (1,), "index_select": (2,), "gather": (2,),
    "scatter": (2,), "scatter_": (2,), "scatter_add": (2,),
    "scatter_add_": (2,), "scatter_reduce": (2,), "scatter_reduce_": (2,),
    "index_add": (2,), "index_add_": (2,), "index_copy": (2,),
    "index_copy_": (2,), "index_fill": (2,), "index_fill_": (2,),
    "take": (1,), "embedding": (1,),
}

_TORCH_DIR = os.path.dirname(torch.__file__)
_HERE = os.path.abspath(__file__)


def tensors(obj) -> List[torch.Tensor]:
    """The tensors of an op's operands (nested lists, tuples, dicts)."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in tensors(o)]
    if isinstance(obj, dict):
        return [t for o in obj.values() for t in tensors(o)]
    return []


def signature(obj) -> str:
    """An op operand as program text: a tensor by dtype and shape, any
    other value by its repr."""
    if isinstance(obj, torch.Tensor):
        return f"T[{str(obj.dtype).split('.')[-1]},{list(obj.shape)}]"
    if isinstance(obj, (list, tuple)):
        return "(" + ",".join(signature(o) for o in obj) + ")"
    if isinstance(obj, dict):
        return "{" + ",".join(f"{k}={signature(v)}"
                              for k, v in obj.items()) + "}"
    return repr(obj)


class TaintMode(TorchDispatchMode):
    """Propagates taint from `sources` through every op it sees; a
    subclass's `on_op` looks at each op with the tainted inputs it had."""

    def __init__(self, sources: Sequence[torch.Tensor] = ()):
        super().__init__()
        self._tainted: set = set()
        for t in sources:
            self.mark(t)

    def mark(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key not in self._tainted:
            self._tainted.add(key)
            weakref.finalize(st, self._tainted.discard, key)

    def tainted(self, t: torch.Tensor) -> bool:
        return id(t.untyped_storage()) in self._tainted

    def on_op(self, func, name: str, args, kwargs, out, hit) -> None:
        pass

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "prim":
            return out
        hit = [t for t in tensors(args) + tensors(kwargs)
               if self.tainted(t)]
        self.on_op(func, func.overloadpacket.__name__, args, kwargs, out,
                   hit)
        if hit:
            for t in tensors(out):
                self.mark(t)
        return out


def _caller_frames(entry):
    """The Python frames below `entry` (outermost first) that are neither
    torch's nor this module's."""
    frames = []
    f = sys._getframe(1)
    while f is not None and f is not entry:
        fn = os.path.abspath(f.f_code.co_filename)
        if not fn.startswith(_TORCH_DIR) and fn != _HERE:
            frames.append(f)
        f = f.f_back
    return frames[::-1]


@dataclasses.dataclass(frozen=True)
class TaintSink:
    primitive: str
    kind: str        # "branch predicate" | "while predicate" | "... indices"
    path: str        # Python functions below the analyzed one, "/inner"
    eqn_repr: str

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


class SinkMode(TaintMode):
    """`TaintMode` recording every sink the taint reaches."""

    def __init__(self, sources: Sequence[torch.Tensor], entry):
        super().__init__(sources)
        self.entry = entry
        self.sinks: List[TaintSink] = []

    def _sink(self, name, kind, args) -> None:
        frames = _caller_frames(self.entry)
        path = "".join("/" + f.f_code.co_name for f in frames[1:])
        if kind is None:
            line = ""
            if frames:
                f = frames[-1]
                line = linecache.getline(f.f_code.co_filename,
                                         f.f_lineno).strip()
            kind = ("while predicate" if line.startswith("while")
                    else "branch predicate")
        self.sinks.append(TaintSink(
            primitive=name, kind=kind, path=path,
            eqn_repr=f"{name}({signature(args)})"[:200]))

    def on_op(self, func, name, args, kwargs, out, hit) -> None:
        if not hit:
            return
        if name in HOST_READS:
            self._sink(name, None, args)
        elif name in _INDEX_SINKS:
            idx = [t for p in _INDEX_SINKS[name] if p < len(args)
                   for t in tensors(args[p])]
            if any(self.tainted(t) for t in idx):
                self._sink(name, f"{name} indices", args)


def leaf_paths(tree, prefix: str = "") -> List:
    """(path, leaf) pairs of a tree of dicts, lists, tuples and NamedTuples
    in flattening order; paths read like JAX's `keystr` ("[0]['memo']")."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in leaf_paths(v, f"{prefix}[{k!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [p for k, v in zip(tree._fields, tree)
                for p in leaf_paths(v, f"{prefix}.{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in leaf_paths(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def tainted_positions(example_args: tuple,
                      needles: Sequence[str]) -> List[int]:
    """Flattened input positions whose path contains any needle."""
    return [i for i, (path, _) in enumerate(leaf_paths(tuple(example_args)))
            if any(n in path for n in needles)]


def find_taint_sinks(fn, example_args: tuple,
                     tainted_inputs: Sequence[int]) -> List[TaintSink]:
    """Run `fn(*example_args)` once with the flattened input leaves at
    `tainted_inputs` tainted, and return every sink the taint reaches
    (de-duplicated)."""
    leaves = [leaf for _, leaf in leaf_paths(tuple(example_args))]
    sources = [leaves[i] for i in tainted_inputs
               if isinstance(leaves[i], torch.Tensor)]
    mode = SinkMode(sources, sys._getframe())
    with mode:
        fn(*example_args)
    seen, out = set(), []
    for s in mode.sinks:
        key = (s.primitive, s.kind, s.path, s.eqn_repr)
        if key not in seen:
            seen.add(key)
            out.append(s)
    return out
