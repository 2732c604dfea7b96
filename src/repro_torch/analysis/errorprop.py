"""Relative-error propagation over eager PyTorch (the QoI half of the
approxcost predictor, and the engine behind lint rule A007; port of
`repro.analysis.errorprop`).

Each tensor (by storage) carries ONE abstract value: a bound on its
*relative* error. Approximation sites inject an initial bound, and the
program runs once under `ErrorMode`, which pushes the bounds through every
aten op with the JAX package's transfer table (`_transfer`, keyed by the
JAX primitive each aten op stands for, `_PRIMITIVE`):

  * mul / div          : errors ADD (exact to first order);
  * add / sub / dot    : relative error can grow under cancellation --
                         bounded by ``CANCEL_AMP``;
  * transcendentals    : bounded condition number ``TRANS_AMP``;
  * select / where     : max over the data branches;
  * comparisons, argmax, integer ops: exact (relative error 0);
  * anything unknown   : ``DEFAULT_AMP`` x the worst input.

Loops: JAX finds `while` bodies in the jaxpr. An eager program names its
loops instead: `while_loop(cond_fn, body_fn, carry)` runs
`while cond_fn(carry): carry = body_fn(carry)`, and under `ErrorMode` first
iterates the body's transfer on the carry to a FIXPOINT (the body run on
copies of the carry, at most `_MAX_FIX_ITERS` times). A carry whose error
still grows has no static bound -- the loop runs until a data-dependent
condition -- so the loop is reported divergent (A007), the paper's MiniFE
pathology ("locally introduced errors propagate through subsequent
iterations") made checkable. A loop of a fixed trip count is a plain
Python loop and is propagated iteration by iteration.
"""
from __future__ import annotations

import dataclasses
import math
import sys
import weakref
from typing import Callable, Dict, List, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .taint import leaf_paths, tensors

# Headroom constants (model assumptions, the JAX package's).
CANCEL_AMP = 4.0    # additive cancellation headroom (add/sub/dot/reduce)
TRANS_AMP = 4.0     # transcendental condition-number headroom
DEFAULT_AMP = 4.0   # unknown-primitive fallback

_ERR_CAP = 1e30     # saturation value for divergent bounds
_MAX_FIX_ITERS = 40  # fixpoint iterations before declaring growth
_GROWTH_EPS = 1e-9   # relative growth below this counts as converged

# the JAX transfer table, by JAX primitive name
_MUL_LIKE = {"mul", "div", "atan2", "nextafter"}
_ADD_LIKE = {"add", "sub", "add_any", "complex"}
_DOT_LIKE = {"dot_general", "conv_general_dilated"}
_TRANS = {"exp", "exp2", "expm1", "log", "log1p", "tanh", "erf", "erfc",
          "erf_inv", "rsqrt", "sqrt", "cbrt", "sin", "cos", "tan", "asin",
          "acos", "atan", "sinh", "cosh", "asinh", "acosh", "atanh",
          "logistic", "pow", "integer_pow", "regularized_incomplete_beta",
          "lgamma", "digamma", "square"}
_PASS = {"neg", "abs", "real", "imag", "conj", "copy", "convert_element_type",
         "broadcast_in_dim", "reshape", "transpose", "squeeze", "rev",
         "slice", "dynamic_slice", "dynamic_update_slice", "concatenate",
         "pad", "gather", "scatter", "scatter-add", "scatter_add",
         "expand_dims", "tie_in", "stop_gradient", "reduce_sum",
         "reduce_max", "reduce_min", "cumsum", "cummax", "cummin",
         "reduce_precision", "max", "min", "clamp", "select_n", "select",
         "where", "sort", "top_k", "optimization_barrier", "copy_p",
         "device_put", "sharding_constraint", "reduce_mean", "mean",
         "transpose_p", "rem"}
_EXACT = {"eq", "ne", "lt", "le", "gt", "ge", "and", "or", "xor", "not",
          "sign", "floor", "ceil", "round", "is_finite", "iota", "argmax",
          "argmin", "reduce_and", "reduce_or", "shift_left",
          "shift_right_logical", "shift_right_arithmetic", "population_count",
          "clz", "rng_bit_generator", "random_seed", "random_bits",
          "random_wrap", "random_fold_in", "threefry2x32", "eq_to", "nan"}

# aten op packet -> the JAX primitive it stands for (the rest keep their
# name: exp, log, tanh, sin, ..., eq, lt, ..., sort are named alike)
_PRIMITIVE = {
    "add": "add", "sub": "sub", "rsub": "sub", "mul": "mul", "div": "div",
    "true_divide": "div", "reciprocal": "div", "mm": "dot_general",
    "bmm": "dot_general", "matmul": "dot_general", "addmm": "dot_general",
    "baddbmm": "dot_general", "mv": "dot_general", "dot": "dot_general",
    "linear": "dot_general", "einsum": "dot_general",
    "convolution": "conv_general_dilated", "sigmoid": "logistic",
    "erfinv": "erf_inv", "_to_copy": "convert_element_type",
    "clone": "copy", "copy": "copy", "copy_": "copy", "contiguous": "copy",
    "view": "reshape", "_unsafe_view": "reshape", "reshape": "reshape",
    "expand": "broadcast_in_dim", "unsqueeze": "expand_dims",
    "squeeze": "squeeze", "permute": "transpose", "transpose": "transpose",
    "t": "transpose", "flip": "rev", "slice": "slice", "select": "slice",
    "narrow": "slice", "index": "gather", "index_select": "gather",
    "gather": "gather", "scatter": "scatter", "scatter_add": "scatter_add",
    "index_put": "scatter", "index_copy": "scatter", "cat": "concatenate",
    "stack": "concatenate", "constant_pad_nd": "pad", "sum": "reduce_sum",
    "amax": "reduce_max", "amin": "reduce_min", "maximum": "max",
    "minimum": "min", "clamp": "clamp", "clamp_min": "clamp",
    "clamp_max": "clamp", "where": "select_n", "mean": "reduce_mean",
    "topk": "top_k", "detach": "stop_gradient", "alias": "copy",
    "fmod": "rem", "remainder": "rem", "bitwise_and": "and",
    "bitwise_or": "or", "bitwise_xor": "xor", "bitwise_not": "not",
    "logical_and": "and", "logical_or": "or", "logical_not": "not",
    "isfinite": "is_finite", "arange": "iota", "abs": "abs", "neg": "neg",
    "pow": "pow", "square": "square", "rsqrt": "rsqrt", "sqrt": "sqrt",
    "cumsum": "cumsum", "masked_fill": "select_n", "fill": "copy",
    "zero": "copy", "split": "slice", "split_with_sizes": "slice",
    "unbind": "slice", "chunk": "slice", "repeat_interleave":
    "broadcast_in_dim", "expand_as": "broadcast_in_dim",
}


def primitive(aten_name: str) -> str:
    """The JAX primitive an aten op packet stands for."""
    name = aten_name
    if name not in _PRIMITIVE and name.endswith("_"):
        name = name[:-1]   # an in-place op is its functional form
    return _PRIMITIVE.get(name, name)


def _transfer(name: str, rels: Sequence[float]) -> float:
    """Relative-error bound of an op's outputs from its inputs' bounds
    (`name` a JAX primitive; the JAX package's table)."""
    worst = max(rels, default=0.0)
    if worst == 0.0:
        return 0.0
    if name in _EXACT:
        return 0.0
    if name in _MUL_LIKE:
        return min(sum(rels), _ERR_CAP)
    if name in _ADD_LIKE:
        return min(worst * CANCEL_AMP, _ERR_CAP)
    if name in _DOT_LIKE:
        return min(sum(rels) * CANCEL_AMP, _ERR_CAP)
    if name in _TRANS:
        return min(worst * TRANS_AMP, _ERR_CAP)
    if name in _PASS:
        return worst
    return min(worst * DEFAULT_AMP, _ERR_CAP)


@dataclasses.dataclass(frozen=True)
class LoopReport:
    """One loop whose carry the injected error reaches."""

    kind: str        # "while"
    path: str        # the Python function that ran the loop
    gain: float      # per-iteration amplification of the carry error
    diverges: bool   # while-loop carry with gain > 1: statically unbounded
    eqn_repr: str

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ErrorReport:
    """Propagation result: per-output relative-error bounds + loop audit."""

    out_rel: List[float]
    loops: List[LoopReport]

    @property
    def bound(self) -> float:
        worst = max(self.out_rel, default=0.0)
        if any(lp.diverges for lp in self.loops):
            return math.inf
        return worst

    @property
    def divergent(self) -> List[LoopReport]:
        return [lp for lp in self.loops if lp.diverges]


class ErrorMode(TorchDispatchMode):
    """Pushes relative-error bounds (per storage) through every aten op."""

    def __init__(self):
        super().__init__()
        self._rel: Dict[int, float] = {}
        self.loops: List[LoopReport] = []

    def rel(self, t: torch.Tensor) -> float:
        return self._rel.get(id(t.untyped_storage()), 0.0)

    def set_rel(self, t: torch.Tensor, r: float, join: bool = False) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key not in self._rel:
            weakref.finalize(st, self._rel.pop, key, None)
        elif join:
            r = max(r, self._rel[key])
        self._rel[key] = min(r, _ERR_CAP)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = tensors(args) + tensors(kwargs)
        rels = [self.rel(t) for t in ins]
        out = func(*args, **kwargs)
        if func.namespace == "prim":
            return out
        r = _transfer(primitive(func.overloadpacket.__name__), rels)
        in_keys = {id(t.untyped_storage()) for t in ins}
        for t in tensors(out):
            # an op writing into (a view of) an operand joins that
            # storage's bound; a fresh output takes the op's
            join = id(t.untyped_storage()) in in_keys
            if r or join or id(t.untyped_storage()) in self._rel:
                self.set_rel(t, r, join=join)
        return out

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)


# the ErrorModes running now, innermost last (while_loop reads it)
_ACTIVE: List[ErrorMode] = []


def _clone_tree(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_clone_tree(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone_tree(v) for v in tree)
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree


def _carry_leaves(carry) -> List[torch.Tensor]:
    return [t for _, t in leaf_paths(carry) if isinstance(t, torch.Tensor)]


def _fixpoint(mode: ErrorMode, body_fn: Callable, carry):
    """Iterate the body's transfer on the carry's bounds. Returns (carry
    bounds, gain, converged)."""
    bounds = [mode.rel(t) for t in _carry_leaves(carry)]
    gain = 1.0
    for _ in range(_MAX_FIX_ITERS):
        trial = _clone_tree(carry)
        for t, b in zip(_carry_leaves(trial), bounds):
            mode.set_rel(t, b)
        outs = [mode.rel(t) for t in _carry_leaves(body_fn(trial))]
        new = [max(c, o) for c, o in zip(bounds, outs)]
        grew = [(n, c) for n, c in zip(new, bounds)
                if n > c * (1.0 + _GROWTH_EPS) + 1e-300]
        if not grew:
            return new, gain, True
        gain = max((n / c if c > 0 else math.inf) for n, c in grew)
        bounds = new
    return bounds, gain, False


def while_loop(cond_fn: Callable, body_fn: Callable, carry):
    """`while cond_fn(carry): carry = body_fn(carry)`, eagerly; `cond_fn`
    returns a 0-d bool tensor (read on the host) or a bool. Under an
    `ErrorMode` the body's error transfer is first taken to its fixpoint
    and the loop is recorded (`ErrorReport.loops`); a carry whose bound
    still grows is divergent and leaves the loop at `_ERR_CAP`."""
    mode = _ACTIVE[-1] if _ACTIVE else None
    report = None
    if mode is not None and (any(mode.rel(t) for t in _carry_leaves(carry))
                             or _touches_error(mode, body_fn, carry)):
        bounds, gain, converged = _fixpoint(mode, body_fn, carry)
        diverges = not converged and gain > 1.0 + _GROWTH_EPS
        caller = sys._getframe(1).f_code.co_name
        report = LoopReport(kind="while", path=f"/{caller}",
                            gain=float(gain if not converged else 1.0),
                            diverges=diverges,
                            eqn_repr=f"while_loop({cond_fn.__qualname__}, "
                                     f"{body_fn.__qualname__})"[:200])
        mode.loops.append(report)
    while cond_fn(carry):
        carry = body_fn(carry)
    if report is not None:
        for t, b in zip(_carry_leaves(carry), bounds):
            mode.set_rel(t, _ERR_CAP if report.diverges and b > 0 else b)
    return carry


def _touches_error(mode: ErrorMode, body_fn: Callable, carry) -> bool:
    """Whether one body pass on a copy of the carry gives it a bound (the
    error enters through the body's closure, e.g. a memoized value)."""
    trial = _clone_tree(carry)
    return any(mode.rel(t) for t in _carry_leaves(body_fn(trial)))


def propagate(fn: Callable, example_args: tuple,
              inject: Dict[int, float]) -> ErrorReport:
    """Run `fn(*example_args)` with relative-error bounds injected at
    flattened input POSITIONS (the approximation-site residuals); returns
    per-output bounds plus every loop the error flowed through."""
    leaves = [leaf for _, leaf in leaf_paths(tuple(example_args))]
    mode = ErrorMode()
    for pos, r in inject.items():
        if r and isinstance(leaves[pos], torch.Tensor):
            mode.set_rel(leaves[pos], float(r))
    with mode:
        out = fn(*example_args)
    outs = [mode.rel(t) if isinstance(t, torch.Tensor) else 0.0
            for _, t in leaf_paths(out)]
    seen, uniq = set(), []
    for lp in mode.loops:
        key = (lp.kind, lp.path, lp.eqn_repr, lp.diverges)
        if key not in seen:
            seen.add(key)
            uniq.append(lp)
    return ErrorReport(out_rel=outs, loops=uniq)


def amplification(fn: Callable, example_args: tuple,
                  inject_positions: Sequence[int],
                  rel: float = 1.0) -> ErrorReport:
    """`propagate` with `rel` injected at each of the given positions."""
    return propagate(fn, example_args, {p: rel for p in inject_positions})


def find_divergent_carries(fn: Callable, example_args: tuple,
                           inject_positions: Sequence[int]
                           ) -> List[LoopReport]:
    """A007 helper: while-loop carries that amplify an error injected at
    the given input positions without a static bound."""
    return propagate(fn, example_args,
                     {p: 1.0 for p in inject_positions}).divergent
