"""Block-shape autotuning for the port's kernels (port of
`repro.kernels.tuning`).

  1. **search space** -- per kernel, the JAX package's power-of-two block
     candidates that divide the operand geometry, kept where the kernel's
     own `launchable` rule accepts them (shared memory per CTA within the
     232448 bytes a Hopper block may use, and each kernel's thread-layout
     rules). The JAX package bounds the space by a TPU VMEM budget instead;
     that quantity has no meaning here. So every candidate launches, and a
     candidate that fails to launch raises;
  2. **cost-model pre-prune** -- every candidate is ranked on the roofline
     of `analysis.machine` from `analysis.cost.kernel_cost` (the FLOPs and
     bytes the JAX package's `trace_cost` counts for the Pallas grid), with
     the kernel launches of one call as the invocation term: on the GPU a
     launch is the dispatch, a CTA is not. K1, K2 and K4 launch once a
     call, K3 four times whatever block_rows is (`launches`);
  3. **measured time** -- warm-up calls, then the median of `repeats`
     timed calls (`obs.timing.measure`: CUDA events on the card). The
     precise path runs (knobs that never approximate), so candidates are
     compared on block geometry alone. The baseline config (the caller's
     default, else `FALLBACK_BLOCKS`) is timed beside the cost model's top
     `max_measure`, so a stored winner never loses to it in the same
     measurement; the JAX tuner times only the top candidates.
     `measure=False` crowns the cost-model winner;
  4. **persistent cache** -- winners land in a JSON `TuningCache` (the JAX
     package's schema) keyed by (kernel, operand shapes, dtype, machine,
     substrate). A hit skips all measurement. The ambient cache comes from
     `$REPRO_TORCH_TUNING_CACHE`, else the committed
     `src/repro_torch/kernels/tuning_cache.json` (H100 entries); `ops`
     resolves None block arguments from it.

Tuned blocks are semantic for the approximation masks (a TAF mask is
(M/block_m, N/block_n), iACT votes per block_rows, perforation liveness is
per block_kv / block_k), so apps that pin geometry keep passing explicit
blocks; `approx_ffn.make_app(blocks="tuned")` records the resolved blocks in
its workload dict.

The machine and substrate of a cache key follow the device: "cuda" and the
H100 profile for a CUDA tensor, "host" and "host-sim" for a CPU tensor.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .. import device as device_mod
from .. import obs
from ..analysis.cost import kernel_cost
from ..analysis.machine import SUBSTRATE_MACHINES, get_machine
from ..obs import trace
from ..obs.timing import measure

KERNELS = ("taf_matmul", "iact_rowfn", "perforated_matmul",
           "perforated_attention")

# Power-of-two block candidates, the JAX package's.
_POW2 = (8, 16, 32, 64, 128, 256, 512)

# Fallbacks: the pre-tuning defaults of kernels/ops.py, used when no cache
# entry matches the operand shapes.
FALLBACK_BLOCKS: Dict[str, Dict[str, int]] = {
    "taf_matmul": {"block_m": 128, "block_n": 128},
    "iact_rowfn": {"block_rows": 128},
    "perforated_matmul": {"block_m": 128, "block_n": 128, "block_k": 128},
    "perforated_attention": {"block_q": 128, "block_kv": 128},
}

# config key -> (operand index, axis index) the block must divide
_BLOCK_AXES: Dict[str, Dict[str, Tuple[int, int]]] = {
    "taf_matmul": {"block_m": (0, 0), "block_n": (1, 1)},
    "iact_rowfn": {"block_rows": (0, 0)},
    "perforated_matmul": {"block_m": (0, 0), "block_n": (1, 1),
                          "block_k": (0, 1)},
    "perforated_attention": {"block_q": (0, 2), "block_kv": (1, 2)},
}

# how many leading operand shapes identify the workload in a cache key:
# attention's v mirrors k, so (q, k) is the canonical pair -- this must
# agree with what `ops.resolve_blocks` passes on lookup
_KEY_OPERANDS = {"taf_matmul": 2, "iact_rowfn": 3,
                 "perforated_matmul": 2, "perforated_attention": 2}


def key_shapes(kernel: str,
               shapes: Sequence[Sequence[int]]) -> Tuple[Tuple[int, ...],
                                                         ...]:
    """The canonical cache-key shape tuple: the leading operands that
    identify the workload (normalized to int tuples)."""
    nops = _KEY_OPERANDS.get(kernel, len(shapes))
    return tuple(tuple(int(d) for d in s) for s in shapes[:nops])


# --------------------------------------------------------------------------
# search space + validation
# --------------------------------------------------------------------------

def _pow2_divisors(n: int) -> List[int]:
    out = [b for b in _POW2 if b <= n and n % b == 0]
    return out or [int(n)]  # no pow2 divisor: the full axis is the one tile


def validate_config(kernel: str, shapes: Sequence[Sequence[int]],
                    config: Dict[str, int]) -> Optional[str]:
    """None if `config` is divisor-valid for `shapes`, else the reason."""
    axes = _BLOCK_AXES.get(kernel)
    if axes is None:
        return f"unknown kernel {kernel!r} (expected one of {KERNELS})"
    for key, (op, ax) in axes.items():
        if key not in config:
            return f"config is missing {key!r}"
        block = config[key]
        if not isinstance(block, int) or block <= 0:
            return f"{key}={block!r} is not a positive int"
        if op >= len(shapes) or ax >= len(shapes[op]):
            return (f"shapes {list(map(tuple, shapes))} have no operand "
                    f"{op} axis {ax} for {key}")
        dim = int(shapes[op][ax])
        if dim % block:
            return (f"{key}={block} does not divide operand axis "
                    f"{dim} (operand {op}, axis {ax})")
    extra = set(config) - set(axes)
    if extra:
        return f"config has keys {sorted(extra)} unknown to {kernel}"
    return None


def launchable(kernel: str, shapes: Sequence[Sequence[int]],
               config: Dict[str, int]) -> Optional[str]:
    """None if the kernel launches at `config` on `shapes`, else why not
    (the kernel module's own rule)."""
    from . import ops
    return ops.KERNELS[kernel].launchable(shapes, config)


def search_space(kernel: str, shapes: Sequence[Sequence[int]]
                 ) -> List[Dict[str, int]]:
    """All divisor-valid block configs for `kernel` on `shapes` that the
    kernel launches. Deterministic order (sorted by block values)."""
    axes = _BLOCK_AXES.get(kernel)
    if axes is None:
        raise ValueError(f"unknown kernel {kernel!r} "
                         f"(expected one of {KERNELS})")
    keys = sorted(axes)
    choices = []
    for key in keys:
        op, ax = axes[key]
        choices.append(_pow2_divisors(int(shapes[op][ax])))
    configs: List[Dict[str, int]] = []

    def rec(i, cur):
        if i == len(keys):
            cfg = dict(cur)
            if launchable(kernel, shapes, cfg) is None:
                configs.append(cfg)
            return
        for b in choices[i]:
            cur[keys[i]] = b
            rec(i + 1, cur)

    rec(0, {})
    for cfg in configs:  # the generator's own contract, cheap to enforce
        err = validate_config(kernel, shapes, cfg)
        if err:
            raise AssertionError(f"search_space emitted invalid {cfg}: {err}")
    return configs


def grid_steps(kernel: str, shapes: Sequence[Sequence[int]],
               config: Dict[str, int]) -> int:
    """Grid size of the Pallas kernel at `config` (the JAX package's
    invocation term; the port charges `launches` instead)."""
    if kernel == "taf_matmul":
        (m, _), (_, n) = shapes[0], shapes[1]
        return (m // config["block_m"]) * (n // config["block_n"])
    if kernel == "iact_rowfn":
        return shapes[0][0] // config["block_rows"]
    if kernel == "perforated_matmul":
        (m, k), (_, n) = shapes[0], shapes[1]
        return ((m // config["block_m"]) * (n // config["block_n"])
                * (k // config["block_k"]))
    if kernel == "perforated_attention":
        b, hq, sq, _ = shapes[0]
        skv = shapes[1][2]
        return (b * hq * (sq // config["block_q"])
                * (skv // config["block_kv"]))
    raise ValueError(f"unknown kernel {kernel!r}")


def launches(kernel: str, shapes: Sequence[Sequence[int]],
             config: Dict[str, int]) -> int:
    """CUDA kernel launches of one call at `config`: the invocation term of
    `predict_time_s`. K3 launches four kernels a call (schedule, first
    product, second product, fill); K1, K2 (one persistent launch) and K4
    one. Neither count depends on the block shape."""
    if kernel == "iact_rowfn":
        return 4
    if kernel in ("taf_matmul", "perforated_matmul", "perforated_attention"):
        return 1
    raise ValueError(f"unknown kernel {kernel!r}")


# --------------------------------------------------------------------------
# cost-model pre-prune
# --------------------------------------------------------------------------

def build_call(kernel: str, config: Dict[str, int],
               pipeline: bool = True) -> Callable:
    """The precise-path callable tuned/measured at `config`: knobs are set
    so no block ever approximates (TAF/iACT thresholds 0, no perforation),
    making candidates comparable on block geometry alone. `pipeline` is
    inert (every port kernel has one launch path)."""
    from . import ops
    if kernel == "taf_matmul":
        return lambda x, w: ops.taf_matmul(
            x, w, rsd_threshold=0.0, pipeline=pipeline, **config)[0]
    if kernel == "iact_rowfn":
        return lambda x, w1, w2: ops.iact_rowfn(
            x, w1, w2, threshold=0.0, **config)[0]
    if kernel == "perforated_matmul":
        return lambda x, w: ops.perforated_matmul(
            x, w, perfo=None, pipeline=pipeline, **config)
    if kernel == "perforated_attention":
        return lambda q, k, v: ops.flash_attention(
            q, k, v, pipeline=pipeline, **config)
    raise ValueError(f"unknown kernel {kernel!r}")


def predict_time_s(kernel: str, arrays: Sequence, config: Dict[str, int],
                   machine=None, pipeline: bool = True) -> float:
    """Roofline-predicted seconds at `config`: `kernel_cost`'s FLOPs and
    bytes on the machine profile, plus one dispatch per kernel launch.
    `pipeline` is inert."""
    del pipeline
    mp = get_machine(machine if machine is not None
                     else current_machine_name(_device(arrays)))
    shapes = operand_shapes(arrays)
    cv = kernel_cost(kernel, shapes, config)
    return mp.time_s(cv.flops, cv.bytes,
                     invocations=float(launches(kernel, shapes, config)))


# --------------------------------------------------------------------------
# measurement
# --------------------------------------------------------------------------

def measure_s(fn: Callable, *args, warmup: int = 2, repeats: int = 5
              ) -> float:
    """Median-of-k seconds of `fn(*args)` on the device of its first
    tensor argument (`obs.timing.measure`: warm-up calls first; CUDA events
    on the card)."""
    return measure(fn, *args, device=_device(args), warmup=max(1, warmup),
                   repeats=max(1, repeats), stat="median",
                   span="tuning.measure").seconds


# --------------------------------------------------------------------------
# the persistent cache
# --------------------------------------------------------------------------

def _device(arrays: Sequence) -> torch.device:
    for a in arrays:
        if isinstance(a, torch.Tensor):
            return a.device
    raise ValueError("no tensor among the operands to take a device from")


def current_substrate(device=None) -> str:
    """"cuda" for a CUDA device, "host" for the CPU (`device` as the port's
    entry points take it: cuda unless the caller passes "cpu")."""
    return "cuda" if device_mod.resolve(device).type == "cuda" else "host"


def current_machine_name(device=None) -> str:
    """The registered roofline profile of the device's substrate: the H100
    profile for cuda, "host-sim" for the CPU. Caches key on registered
    names, never on the process-local "measured" profile."""
    return SUBSTRATE_MACHINES[current_substrate(device)]


def dtype_name(dtype) -> str:
    """The dtype as the cache schema writes it ("float32")."""
    return str(dtype).replace("torch.", "")


def operand_shapes(arrays: Sequence) -> Tuple[Tuple[int, ...], ...]:
    return tuple(tuple(int(d) for d in a.shape) for a in arrays)


def cache_key(kernel: str, shapes: Sequence[Sequence[int]], dtype: str,
              machine: str, substrate: str) -> str:
    s = "x".join(".".join(str(int(d)) for d in shp) for shp in shapes)
    return f"{kernel}|{s}|{dtype}|{machine}|{substrate}"


def validate_entry(key: str, entry: Dict) -> Optional[str]:
    """None if a cache entry is internally consistent, else the reason:
    known kernel, divisor-valid config for the recorded shapes, and entry
    fields that re-derive its cache key."""
    kernel = entry.get("kernel")
    if kernel not in KERNELS:
        return f"unknown kernel {kernel!r}"
    shapes = entry.get("shapes")
    config = entry.get("config")
    if not shapes or not isinstance(config, dict):
        return "entry is missing shapes/config"
    err = validate_config(kernel, shapes, config)
    if err:
        return err
    rekey = cache_key(kernel, shapes, entry.get("dtype", ""),
                      entry.get("machine", ""), entry.get("substrate", ""))
    if rekey != key:
        return (f"entry fields re-derive key {rekey!r} but it is stored "
                f"under {key!r} (stale or hand-edited)")
    return None


class TuningCache:
    """A {cache_key: entry} JSON store. Entries record everything needed to
    re-validate them (kernel, shapes, dtype, machine, substrate, config)
    plus the winning measurement."""

    def __init__(self, path: Optional[str] = None,
                 entries: Optional[Dict[str, Dict]] = None):
        self.path = path
        self.entries: Dict[str, Dict] = dict(entries or {})

    @classmethod
    def load(cls, path: str) -> "TuningCache":
        with open(path) as f:
            doc = json.load(f)
        return cls(path=path, entries=doc.get("entries", {}))

    def save(self, path: Optional[str] = None) -> str:
        path = path or self.path
        if not path:
            raise ValueError("TuningCache has no path to save to")
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump({"version": 1,
                       "entries": {k: self.entries[k]
                                   for k in sorted(self.entries)}},
                      f, indent=1, sort_keys=True)
        self.path = path
        return path

    def get(self, key: str) -> Optional[Dict]:
        return self.entries.get(key)

    def put(self, key: str, entry: Dict) -> None:
        self.entries[key] = entry

    def __len__(self) -> int:
        return len(self.entries)


COMMITTED_CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "tuning_cache.json")


def default_cache_path() -> Optional[str]:
    """$REPRO_TORCH_TUNING_CACHE, else the committed H100 cache (if any)."""
    env = os.environ.get("REPRO_TORCH_TUNING_CACHE")
    if env:
        return env
    return COMMITTED_CACHE if os.path.exists(COMMITTED_CACHE) else None


_DEFAULT_CACHE: Optional[TuningCache] = None


def default_cache(reload: bool = False) -> TuningCache:
    """The process-ambient cache `kernels/ops.py` consults for None block
    defaults. Loaded lazily from `default_cache_path()`; empty when none."""
    global _DEFAULT_CACHE
    if _DEFAULT_CACHE is None or reload:
        p = default_cache_path()
        _DEFAULT_CACHE = (TuningCache.load(p) if p and os.path.exists(p)
                          else TuningCache())
    return _DEFAULT_CACHE


def set_default_cache(cache: Optional[TuningCache]) -> None:
    """Install (or, with None, drop back to lazy-loading) the ambient
    cache. Tests use this to pin tuned defaults without touching disk."""
    global _DEFAULT_CACHE
    _DEFAULT_CACHE = cache


def tuned_config(kernel: str, shapes: Sequence[Sequence[int]],
                 dtype: str = "float32", machine: Optional[str] = None,
                 substrate: Optional[str] = None,
                 cache: Optional[TuningCache] = None, device=None
                 ) -> Optional[Dict[str, int]]:
    """Pure cache lookup (never measures): the tuned block config for this
    exact (kernel, shapes, dtype, machine, substrate), or None on a miss.
    Machine and substrate default to those of `device`."""
    cache = cache if cache is not None else default_cache()
    if not cache.entries:
        return None
    key = cache_key(kernel, key_shapes(kernel, shapes), str(dtype),
                    machine or current_machine_name(device),
                    substrate or current_substrate(device))
    entry = cache.get(key)
    return dict(entry["config"]) if entry else None


# --------------------------------------------------------------------------
# the autotuner
# --------------------------------------------------------------------------

def autotune(kernel: str, *arrays, cache: Optional[TuningCache] = None,
             machine=None, substrate: Optional[str] = None,
             max_measure: int = 6, warmup: int = 2, repeats: int = 5,
             pipeline: bool = True, measure: bool = True,
             measure_fn: Optional[Callable] = None,
             baseline: Optional[Dict[str, int]] = None,
             log: Optional[Callable[[str], None]] = None) -> Dict[str, int]:
    """Tune `kernel`'s block shapes for these operands; returns the config.

    Cache hit -> return at once (no measurement). Miss -> enumerate the
    launchable divisor-valid search space, rank every candidate on the
    roofline cost model, time the top `max_measure` and the baseline on
    the operands' device and keep the fastest (or, with `measure=False`,
    crown the cost-model winner), and store the result. The baseline is
    `baseline` (it must be divisor-valid and launchable, and may lie
    outside the power-of-two space), else `FALLBACK_BLOCKS[kernel]` where
    it launches. `measure_fn(fn, args) -> seconds` overrides the timer
    (tests inject deterministic ones). A candidate that fails to launch
    raises.
    """
    dev = _device(arrays)
    mp = get_machine(machine if machine is not None
                     else current_machine_name(dev))
    sub = substrate or current_substrate(dev)
    shapes = key_shapes(kernel, operand_shapes(arrays))
    dtype = dtype_name(arrays[0].dtype)
    cache = cache if cache is not None else default_cache()
    key = cache_key(kernel, shapes, dtype, mp.name, sub)
    hit = cache.get(key)
    if hit is not None:
        obs.count("tuning.cache_hits")
        return dict(hit["config"])
    obs.count("tuning.cache_misses")

    space = search_space(kernel, shapes)
    if not space:
        raise ValueError(f"empty search space for {kernel} on "
                         f"{list(map(tuple, shapes))}")
    ranked = sorted(
        ((predict_time_s(kernel, arrays, cfg, machine=mp), i, cfg)
         for i, cfg in enumerate(space)),
        key=lambda t: (t[0], t[1]))
    candidates = [cfg for _, _, cfg in ranked[:max(1, max_measure)]]
    predicted_us = {json.dumps(cfg, sort_keys=True): t * 1e6
                    for t, _, cfg in ranked}
    base = dict(baseline if baseline is not None
                else FALLBACK_BLOCKS[kernel])
    why = (validate_config(kernel, shapes, base)
           or launchable(kernel, shapes, base))
    if why and baseline is not None:
        raise ValueError(f"baseline {base} of {kernel} does not launch on "
                         f"{list(map(tuple, shapes))}: {why}")
    if why:
        base = None
    elif base not in space:  # a default outside the power-of-two space
        predicted_us[json.dumps(base, sort_keys=True)] = predict_time_s(
            kernel, arrays, base, machine=mp) * 1e6

    if measure:
        timer = measure_fn or (
            lambda fn, args: measure_s(fn, *args, warmup=warmup,
                                       repeats=repeats))
        if base is not None and base not in candidates:
            candidates.append(base)
        timed = []
        for cfg in candidates:
            with trace.span("tuning.measure_config", kernel=kernel,
                            config=dict(cfg)):
                s = float(timer(build_call(kernel, cfg, pipeline=pipeline),
                                arrays))
            timed.append((s, cfg))
            if log:
                log(f"{kernel} {cfg}: {s * 1e6:.1f}us")
        best_s, best = min(timed, key=lambda t: t[0])
        measured = len(timed)
        base_us = (None if base is None else
                   round(next(t for t, c in timed if c == base) * 1e6, 3))
    else:  # cost-model ranking: no timing at all
        best_s, best = ranked[0][0], candidates[0]
        measured = 0
        base_us = None

    entry = {
        "kernel": kernel,
        "shapes": [list(s) for s in shapes],
        "dtype": dtype,
        "machine": mp.name,
        "substrate": sub,
        "config": dict(best),
        "us": round(best_s * 1e6, 3),
        "predicted_us": round(
            predicted_us[json.dumps(best, sort_keys=True)], 3),
        "pipeline": bool(pipeline),
        "candidates": len(space),
        "measured": measured,
        "baseline": base,
        "baseline_us": base_us,
    }
    cache.put(key, entry)
    if cache.path:
        cache.save()
    return dict(best)
