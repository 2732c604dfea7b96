"""approxcost for the port: FLOP / byte counting and the app cost model
(port of `repro.analysis.cost`).

Two parts:

* `kernel_cost` -- the FLOPs and bytes of one precise-path call of a
  kernel, written from its shapes (the block-shape autotuner's count).
  The JAX package traces `tuning.build_call(kernel, config)` to a jaxpr
  and counts a `pallas_call` as the FLOPs of its body times the grid
  product, plus the call's input and output bytes: every element a body
  reads, writes or computes counts one FLOP, a dot 2 * M * N * K, a
  transcendental 8. The port writes the same count per grid step (the
  block products, the operand blocks read, the tile-sized elementwise work
  and the state updates) times the grid, and per call each operand and
  output once. Terms that do not scale with a block are left out (under 1%
  at the tuner's shapes). The counts describe the Pallas grid the tuner
  shares with the JAX package, not the CUDA launch layout.
* `trace_cost` and `AppCostModel` -- the static speedup / error predictor
  that prunes sweeps before anything runs. `trace_cost(fn, *args)` runs
  `fn` once on fake tensors under a dispatch mode that counts each aten
  op as the JAX package counts each jaxpr equation: a dot 2 * out *
  contraction, a transcendental `TRANS_FLOPS` an output element, a
  reduction its input size, a view or layout op bytes only, anything
  else one FLOP an output element; bytes are inputs + outputs, 4 an
  element. Nothing is computed: fake tensors carry shapes only. A Python
  loop in `fn` is counted once per trip, as a `scan` of the same length.
  `AppCostModel.predict` maps a spec to a `CostPrediction` through a
  machine profile (`analysis.machine`): the roofline time of the precise
  workload against the workload less the skipped region work plus the
  technique's bookkeeping, and a conservative error bound.

The skip-fraction models (what fraction of decision invocations the
technique approximates, before any input is seen):

  TAF    f = p_act * duty * warmup
           p_act  = thresh / (thresh + rsd_scale)
           duty   = pSize / (pSize + 1)
           warmup = max(0, 1 - hSize / invocations)
  iACT   f = thresh / (thresh + dist_scale)
  perfo  f = drop_fraction(n_iters, params)

and the per-decision overheads that make sub-1x predictions real:

  TAF    ~ (3*hSize + 8) FLOPs   -- RSD window update + stability test
  iACT   ~ tSize * 3 * in_dim    -- distance probe against every entry
  perfo    0                     -- bounds change at trace time

The model is first-order on purpose: it ranks candidate specs and bounds
their error so measurement is spent where it can matter.
"""
from __future__ import annotations

import dataclasses
import functools
import logging
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from ..core.types import ApproxSpec, Technique
from .machine import MachineProfile, get_machine

log = logging.getLogger("repro_torch.analysis.cost")

# the tuner's precise calls run the kernels' defaults
_IACT_TABLE = 4       # iact_rowfn table_size
_TRANS_FLOPS = 8      # a transcendental (tanh, exp, integer_pow)
_ELEM_BYTES = 4       # float32 / int32 everywhere

# Transcendentals lower to polynomial/rational kernels; weight them as a
# handful of fused multiply-adds rather than one flop.
TRANS_FLOPS = 8.0
# Multiplicative headroom on every error bound: the skip-fraction and
# residual models are first-order, the bound must not be.
SITE_HEADROOM = 4.0


@dataclasses.dataclass(frozen=True)
class CostVector:
    """FLOPs and bytes moved -- the two roofline numerators."""

    flops: float = 0.0
    bytes: float = 0.0

    def __add__(self, other: "CostVector") -> "CostVector":
        return CostVector(self.flops + other.flops, self.bytes + other.bytes)

    def __mul__(self, k: float) -> "CostVector":
        return CostVector(self.flops * k, self.bytes * k)

    __rmul__ = __mul__

    def to_json(self) -> Dict:
        return {"flops": self.flops, "bytes": self.bytes}


def kernel_cost(kernel: str, shapes: Sequence[Sequence[int]],
                config: Dict[str, int]) -> CostVector:
    """FLOPs and bytes of one precise-path call of `kernel` (thresholds 0,
    no perforation: `tuning.build_call`) on operands of `shapes` at the
    block `config`."""
    if kernel == "perforated_matmul":
        (m, k), (_, n) = shapes[0], shapes[1]
        bm, bn, bk = config["block_m"], config["block_n"], config["block_k"]
        nk = k // bk
        grid = (m // bm) * (n // bn) * nk
        # block product, x and w blocks read, accumulator read / add /
        # write, its zeroing and the final scale
        step = 2 * bm * bk * bn + bm * bk + bk * bn + 7 * bm * bn
        # operands, output, kept / liveness lists and the factor
        io = m * k + k * n + m * n + 3 * nk + 4
        return CostVector(float(grid * step), float(io * _ELEM_BYTES))
    if kernel == "taf_matmul":
        (m, k), (_, n) = shapes[0], shapes[1]
        bm, bn = config["block_m"], config["block_n"]
        grid = (m // bm) * (n // bn)
        # tile product, x and w blocks read, y / memo writes, the memo copy
        # of the approximate path and the tile mean
        step = 2 * bm * k * bn + bm * k + k * bn + 5 * bm * bn
        io = m * k + k * n + m * n + 3 * grid + 5  # + mask and threshold
        return CostVector(float(grid * step), float(io * _ELEM_BYTES))
    if kernel == "iact_rowfn":
        (rows, d_in), (_, d_h), (_, d_out) = shapes[0], shapes[1], shapes[2]
        br, t = config["block_rows"], _IACT_TABLE
        grid = rows // br
        step = (2 * br * d_in * d_h + 2 * br * d_h * d_out   # the FFN
                + (6 + 2 * _TRANS_FLOPS) * br * d_h           # tanh GELU
                + d_in * d_h + d_h * d_out                    # weights read
                + 3 * br * t * d_in + 4 * br * t              # the probe
                + 2 * br * t * d_out                          # the gather
                + 2 * br * d_in + 3 * br * d_out + 6 * br     # rows, insert
                + 2 * t * (d_in + d_out) + d_in + d_out)      # the table
        io = (rows * d_in + d_in * d_h + d_h * d_out + rows * d_out
              + 3 * grid + 5)
        return CostVector(float(grid * step), float(io * _ELEM_BYTES))
    if kernel == "perforated_attention":
        b, hq, sq, d = shapes[0]
        skv = shapes[1][2]
        bq, bkv = config["block_q"], config["block_kv"]
        nkv = skv // bkv
        grid = b * hq * (sq // bq) * nkv
        # q.k and p.v products; 16 element ops a score (scale, causal
        # mask, max, shift, exp, sum); the q / acc / k / v tiles and the
        # row statistics
        step = (4 * bq * bkv * d + 16 * bq * bkv + 9 * bq * d
                + 2 * bkv * d + 21 * bq)
        io = 2 * math.prod(shapes[0]) + 2 * math.prod(shapes[1]) + \
            3 * nkv + 1
        return CostVector(float(grid * step), float(io * _ELEM_BYTES))
    raise ValueError(f"unknown kernel {kernel!r}")


# --------------------------------------------------------------------------
# FLOP / byte counting over aten ops
# --------------------------------------------------------------------------

# aten op packets counted like the JAX package's `_TRANS` primitives
_TRANS = {
    "exp", "exp2", "log", "log1p", "log2", "log10", "expm1", "sin", "cos",
    "tan", "asin", "acos", "atan", "atan2", "sinh", "cosh", "tanh", "asinh",
    "acosh", "atanh", "erf", "erfc", "erfinv", "sigmoid", "rsqrt", "sqrt",
    "pow", "lgamma", "digamma", "gelu",
}

# aten op packets that are products: 2 * output * contraction
_DOTS = {"mm", "bmm", "addmm", "baddbmm", "matmul", "mv", "dot", "einsum",
         "linear", "addmv"}

# layout / data-movement / creation ops: bytes but no arithmetic (the JAX
# package's `_MOVE`: broadcast_in_dim, reshape, slice, select_n, iota ...)
_MOVE = {
    "view", "_unsafe_view", "reshape", "expand", "expand_as", "permute",
    "transpose", "t", "slice", "select", "unsqueeze", "squeeze", "flatten",
    "unflatten", "as_strided", "alias", "detach", "clone", "contiguous",
    "_to_copy", "to", "copy", "copy_", "cat", "stack", "constant_pad_nd",
    "pad", "index", "index_select", "gather", "scatter", "where", "full",
    "full_like", "zeros", "zeros_like", "ones", "ones_like", "empty",
    "empty_like", "empty_strided", "arange", "lift_fresh", "lift_fresh_copy",
    "split", "split_with_sizes", "unbind", "flip", "roll", "repeat",
    "new_zeros", "new_ones", "new_full", "new_empty", "scalar_tensor",
    "_local_scalar_dense", "masked_fill", "fill", "fill_", "zero_",
    "tensor_split", "chunk", "narrow", "movedim", "broadcast_to",
    "repeat_interleave", "diagonal", "tril", "triu",
}

# reductions and scans: their input size
_REDUCE = {
    "sum", "mean", "prod", "amax", "amin", "max", "min", "argmax", "argmin",
    "cumsum", "cumprod", "cummax", "cummin", "logsumexp", "sort", "std",
    "var", "norm", "linalg_vector_norm", "any", "all", "topk", "median",
    "aminmax", "count_nonzero",
}


def _numel(a) -> float:
    """Elements of one op argument: a tensor's numel, 1 for a Python
    number (as a JAX literal counts), 0 otherwise; lists are summed."""
    if isinstance(a, torch.Tensor):
        return float(a.numel())
    if isinstance(a, (bool, int, float)):
        return 1.0
    if isinstance(a, (list, tuple)):
        return sum(_numel(x) for x in a if isinstance(x, torch.Tensor))
    return 0.0


def _out_numel(out) -> float:
    if isinstance(out, torch.Tensor):
        return float(out.numel())
    if isinstance(out, (list, tuple)):
        return sum(_out_numel(o) for o in out)
    return 0.0


def _dot_flops(name: str, args, out: float) -> float:
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if name in ("addmm", "baddbmm", "addmv"):
        tensors = tensors[1:]  # the added term is not a factor
    if not tensors or tensors[0].dim() == 0:
        return 2.0 * out
    return 2.0 * out * float(tensors[0].shape[-1])


def op_cost(func, args, kwargs, out) -> CostVector:
    """FLOP / byte cost of one aten op call, as `eqn_cost` counts a jaxpr
    equation."""
    if func.namespace == "prim":
        return CostVector()  # a metadata query (device, layout), no work
    name = func.overloadpacket.__name__
    if name.endswith("_") and name not in _MOVE:
        name = name[:-1]  # an in-place op counts as its functional form
    n_in = sum(_numel(a) for a in args) + sum(
        _numel(v) for v in kwargs.values() if isinstance(v, torch.Tensor))
    n_out = _out_numel(out)
    bytes_ = (n_in + n_out) * _ELEM_BYTES
    if name in _DOTS:
        return CostVector(_dot_flops(name, args, n_out), bytes_)
    if name in _MOVE:
        return CostVector(0.0, bytes_)
    if name in _TRANS:
        return CostVector(n_out * TRANS_FLOPS, bytes_)
    if name in _REDUCE and (n_out < n_in or name.startswith("cum")
                            or name == "sort"):
        inp = sum(_numel(a) for a in args if isinstance(a, torch.Tensor))
        return CostVector(inp, bytes_)
    # one flop per output element (elementwise arithmetic, comparisons,
    # selects, maximum / minimum, integer ops, ...)
    return CostVector(n_out, bytes_)


# the counts of the `trace_cost` calls running now (innermost last); an op
# is added to the innermost one unless it is paused
_COUNTS: List[List] = []


def _add(c: CostVector) -> None:
    top = _COUNTS[-1]
    if not top[1]:
        top[0] = top[0] + c


def reduction(fn: Callable) -> Callable:
    """Mark `fn(t, ...)` as one reduction of the tensor `t` for
    `trace_cost`: however `fn` is written (a loop that fixes the order of
    its adds, say), it counts as a reduction primitive does -- its input
    size in FLOPs, its input and output in bytes. Outside `trace_cost` it
    runs as written."""
    @functools.wraps(fn)
    def wrapped(t, *args, **kwargs):
        if not _COUNTS:
            return fn(t, *args, **kwargs)
        top = _COUNTS[-1]
        paused, top[1] = top[1], True
        try:
            out = fn(t, *args, **kwargs)
        finally:
            top[1] = paused
        _add(CostVector(float(t.numel()),
                        (t.numel() + _out_numel(out)) * _ELEM_BYTES))
        return out
    return wrapped


def trace_cost(fn: Callable, *example_args) -> CostVector:
    """Run `fn` at `example_args` on fake tensors (shapes only, nothing is
    computed) and count the cost of every aten op it dispatches."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            _add(op_cost(func, args, kwargs, out))
            return out

    _COUNTS.append([CostVector(), False])
    try:
        with FakeTensorMode(allow_non_fake_inputs=True) as fake:
            fake_args = [fake.from_tensor(a) if isinstance(a, torch.Tensor)
                         else a for a in example_args]
            with _Count():
                fn(*fake_args)
        return _COUNTS[-1][0]
    finally:
        _COUNTS.pop()


# --------------------------------------------------------------------------
# Per-site skip-fraction + overhead + residual models
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Site:
    """One approximation site of an app, as the cost model sees it.

    region:        cost of the approximable work *per decision invocation*
                   (for perforation: the whole perforable loop per run).
    invocations:   decision invocations over the whole workload.
    in_dim:        input width per invocation (iACT probe cost scales
                   with it).
    rsd_scale:     the site's typical signal RSD -- calibrates how often a
                   TAF threshold fires (p_act = t / (t + rsd_scale)).
    dist_scale:    the site's typical input spread -- calibrates the iACT
                   table-hit rate the same way.
    n_iters:       perforable-loop length (drop_fraction needs it).
    amplification: relative-error gain from this site to the QoI (1.0 when
                   the region IS the QoI).
    qoi_condition: additive residual floor for ill-conditioned QoIs --
                   when the QoI crosses zero (option prices, logits),
                   MAPE is heavy-tailed and even a vanishing absolute
                   perturbation costs this much relative error.
    """

    region: CostVector = dataclasses.field(default_factory=CostVector)
    invocations: float = 1.0
    in_dim: int = 8
    rsd_scale: float = 0.5
    dist_scale: float = 0.5
    n_iters: int = 8
    amplification: float = 1.0
    qoi_condition: float = 0.0


def _taf_fraction(spec: ApproxSpec, site: Site) -> float:
    t = spec.taf
    p_act = t.rsd_threshold / (t.rsd_threshold + site.rsd_scale + 1e-30)
    duty = t.prediction_size / (t.prediction_size + 1.0)
    warmup = max(0.0, 1.0 - t.history_size / max(site.invocations, 1.0))
    return p_act * duty * warmup


def _iact_fraction(spec: ApproxSpec, site: Site) -> float:
    t = spec.iact
    return t.threshold / (t.threshold + site.dist_scale + 1e-30)


def _skip_fraction(spec: ApproxSpec, site: Site) -> float:
    if spec.technique == Technique.TAF:
        return min(1.0, _taf_fraction(spec, site))
    if spec.technique == Technique.IACT:
        return min(1.0, _iact_fraction(spec, site))
    if spec.technique == Technique.PERFORATION:
        from ..core.perforation import drop_fraction
        return drop_fraction(site.n_iters, spec.perforation)
    return 0.0


def _skip_fraction_upper(spec: ApproxSpec, site: Site) -> float:
    """Upper bound on the skip fraction, for the ERROR side of the
    prediction: on highly redundant data the detector fires at every
    opportunity, capped only by the technique's structure (TAF's duty
    cycle and warmup; nothing for iACT). Perforation is structural, so
    expected == upper."""
    if spec.technique == Technique.TAF:
        t = spec.taf
        duty = t.prediction_size / (t.prediction_size + 1.0)
        warmup = max(0.0, 1.0 - t.history_size / max(site.invocations, 1.0))
        return duty * warmup
    if spec.technique == Technique.IACT:
        return 1.0
    return _skip_fraction(spec, site)


def _overhead(spec: ApproxSpec, site: Site) -> CostVector:
    """Per-decision bookkeeping the technique adds (never skipped)."""
    if spec.technique == Technique.TAF:
        return CostVector(3.0 * spec.taf.history_size + 8.0,
                          _ELEM_BYTES * spec.taf.history_size)
    if spec.technique == Technique.IACT:
        probe = spec.iact.table_size * 3.0 * site.in_dim
        return CostVector(probe, _ELEM_BYTES * spec.iact.table_size
                          * site.in_dim)
    return CostVector()


def _site_residual(spec: ApproxSpec, site: Site) -> float:
    """Relative error introduced per approximated invocation."""
    if spec.technique == Technique.TAF:
        # the RSD threshold bounds the window's spread; each of the pSize
        # predicted invocations can drift by up to that much again
        return (site.qoi_condition
                + spec.taf.rsd_threshold * (1.0 + spec.taf.prediction_size))
    if spec.technique == Technique.IACT:
        # an input within `threshold` of a table entry reuses its output;
        # against the site's spread that is the relative perturbation
        return (site.qoi_condition
                + spec.iact.threshold / max(site.dist_scale, 1e-30))
    if spec.technique == Technique.PERFORATION:
        return 1.0  # a dropped iteration's contribution is fully lost
    return 0.0


# --------------------------------------------------------------------------
# The predictor
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CostPrediction:
    """What the model claims about one spec, before any execution."""

    speedup: float            # t_precise / t_approx on the target machine
    error_bound: float        # conservative relative QoI error
    skip_fraction: float      # predicted fraction of work approximated
    flop_fraction: float      # approx FLOPs / precise FLOPs
    t_precise_s: float
    t_approx_s: float
    modeled: bool = True      # False: no site for this technique -> neutral

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


_NEUTRAL = CostPrediction(speedup=1.0, error_bound=0.0, skip_fraction=0.0,
                          flop_fraction=1.0, t_precise_s=0.0,
                          t_approx_s=0.0, modeled=False)


@dataclasses.dataclass(frozen=True)
class AppCostModel:
    """Static speedup/error predictor for one app on one machine.

    total:       whole-workload precise cost (must contain every site's
                 ``region * invocations``).
    sites:       per-technique approximation sites.
    dispatches:  kernel dispatch count (identical on both sides; floors
                 the runtime of tiny regions via ``dispatch_s``).
    """

    name: str
    total: CostVector
    sites: Dict[Technique, Site]
    machine: MachineProfile = dataclasses.field(
        default_factory=lambda: get_machine())
    dispatches: float = 1.0

    def predict(self, spec: ApproxSpec) -> CostPrediction:
        if not spec.enabled:
            t = self.machine.time_s(self.total.flops, self.total.bytes,
                                    invocations=self.dispatches)
            return CostPrediction(1.0, 0.0, 0.0, 1.0, t, t)
        site = self.sites.get(spec.technique)
        if site is None:
            return _NEUTRAL
        f = _skip_fraction(spec, site)
        over = _overhead(spec, site) * site.invocations
        saved = site.region * (f * site.invocations)
        apx_flops = max(self.total.flops - saved.flops + over.flops, 0.0)
        apx_bytes = max(self.total.bytes - saved.bytes + over.bytes, 0.0)
        t_pre = self.machine.time_s(self.total.flops, self.total.bytes,
                                    invocations=self.dispatches)
        t_apx = self.machine.time_s(apx_flops, apx_bytes,
                                    invocations=self.dispatches)
        err = (SITE_HEADROOM * site.amplification
               * _skip_fraction_upper(spec, site)
               * _site_residual(spec, site))
        return CostPrediction(
            speedup=t_pre / max(t_apx, 1e-30),
            error_bound=err,
            skip_fraction=f,
            flop_fraction=apx_flops / max(self.total.flops, 1e-30),
            t_precise_s=t_pre,
            t_approx_s=t_apx)

    # -- pruning / seeding -------------------------------------------------

    def select(self, specs: Sequence[ApproxSpec], *,
               min_speedup: float = 1.0,
               max_error: Optional[float] = None
               ) -> Tuple[List[ApproxSpec], List[ApproxSpec]]:
        """(kept, dropped): drop specs predicted sub-``min_speedup`` or
        above ``max_error``. NONE and unmodeled specs are always kept."""
        kept, dropped = [], []
        for spec in specs:
            p = self.predict(spec)
            if not spec.enabled or not p.modeled:
                kept.append(spec)
            elif p.speedup < min_speedup:
                dropped.append(spec)
            elif max_error is not None and p.error_bound > max_error:
                dropped.append(spec)
            else:
                kept.append(spec)
        return kept, dropped

    def select_band(self, specs: Sequence[ApproxSpec], *,
                    budget: Optional[int] = None,
                    band: float = 0.10) -> List[ApproxSpec]:
        """Specs inside the predicted-front band, best (lowest regret)
        first.

        A spec's regret is its relative speedup deficit against the
        predicted-(error_bound, speedup) Pareto front: 0 on the front,
        else the largest gap to a dominating prediction. Specs within
        ``band`` relative regret survive; ``budget`` truncates the
        ranking; ties go by `harness.spec_key`. NONE / unmodeled specs
        rank first.
        """
        from ..core.harness import spec_key

        scored = []
        preds = [(spec, self.predict(spec)) for spec in specs]
        modeled = [(s, p) for s, p in preds if s.enabled and p.modeled]
        for spec, p in preds:
            if not spec.enabled or not p.modeled:
                scored.append((-1.0, spec_key(spec), spec))
                continue
            regret = 0.0
            for _, q in modeled:
                if (q.error_bound <= p.error_bound
                        and q.speedup > p.speedup):
                    gap = (q.speedup - p.speedup) / max(q.speedup, 1e-30)
                    regret = max(regret, gap)
            scored.append((regret, spec_key(spec), spec))
        scored.sort(key=lambda t: (t[0], t[1]))
        picked = [s for r, _, s in scored if r <= band]
        if budget is not None:
            picked = picked[:max(budget, 0)]
        return picked


def filter_specs(model: Union[AppCostModel,
                              Callable[[ApproxSpec], CostPrediction]],
                 specs: Sequence[ApproxSpec], *,
                 min_speedup: float = 1.0,
                 max_error: Optional[float] = None,
                 context: str = "sweep"
                 ) -> Tuple[List[ApproxSpec], List[ApproxSpec]]:
    """Shared pruning entry point for sweep / autotune / refine.

    Accepts an ``AppCostModel`` or any ``spec -> CostPrediction``
    callable; logs the kept/dropped count so pruned sweeps are auditable.
    """
    specs = list(specs)
    if isinstance(model, AppCostModel):
        kept, dropped = model.select(specs, min_speedup=min_speedup,
                                     max_error=max_error)
    else:
        kept, dropped = [], []
        for spec in specs:
            p = model(spec)
            if not spec.enabled or not getattr(p, "modeled", True):
                kept.append(spec)
            elif p.speedup < min_speedup:
                dropped.append(spec)
            elif max_error is not None and p.error_bound > max_error:
                dropped.append(spec)
            else:
                kept.append(spec)
    log.info("predict[%s]: kept %d / dropped %d of %d specs "
             "(min_speedup=%.3g%s)", context, len(kept), len(dropped),
             len(specs), min_speedup,
             "" if max_error is None else f", max_error={max_error:.3g}")
    return kept, dropped


def ladder_model(machine=None, *, region_flops: float = 4096.0,
                 invocations: float = 256.0, in_dim: int = 16,
                 n_iters: int = 8, name: str = "ladder") -> AppCostModel:
    """A generic single-site-per-technique model for screening ladders
    whose app is not in hand: ~4k FLOPs per decision invocation over a
    16-wide input, where the technique overheads dominate the screen (an
    oversized iACT table or a TAF window that costs more than it skips
    predicts sub-1x whatever the threshold)."""
    prof = get_machine(machine)
    region = CostVector(region_flops, region_flops * _ELEM_BYTES / 2.0)
    site = Site(region=region, invocations=invocations, in_dim=in_dim,
                n_iters=n_iters)
    return AppCostModel(
        name=name,
        total=region * invocations,
        sites={Technique.TAF: site, Technique.IACT: site,
               Technique.PERFORATION: site},
        machine=prof,
        # one fused launch for the whole ladder region
        dispatches=1.0)
