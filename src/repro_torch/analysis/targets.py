"""The built-in lint targets: what approxlint analyzes out of the box (port
of `repro.analysis.targets`).

Each target is the smallest configuration that exercises a lintable
surface -- tiny shapes, the smoke decode config -- grouped into the same
"apps" as the JAX package's for the CLI's ``--apps`` flag:

  kernels  -- the quality knobs of K1-K4 (A001) and their launch
              configuration (A002). On the card a knob target is a
              wrapper call on CUDA tensors, probed by CUDA-graph replay
              (`trace.probe_graph`). On the CPU no kernel exists (a wrapper
              given CPU tensors takes its plain version, an oracle that
              reads the knob on the host by design), so a knob target is
              what the wrapper does with the knob before the launch: the
              operands it hands the kernel (`_build.knob_operand`,
              `perforated_attention.launch_operands`,
              `perforated_matmul._operands`), probed by `trace.probe_knob`.
  regions  -- ApproxRegion step hooks + perforated_loop's fraction (A001)
              and the region step with its memoized values tainted (A003,
              A007).
  ffn      -- the approx_ffn app's block geometry (A002) and the default
              sweep grids' batching keys (A001).
  decode   -- the serving decode step: knob (A001), taint (A003, A007,
              A008) and the engine's placement on a one-rank mesh (A005).

Every target runs real (tiny) computation: the port's analyses follow the
ops an eager program dispatches.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

APP_NAMES = ("kernels", "regions", "ffn", "decode")


@dataclasses.dataclass(frozen=True)
class KnobTarget:
    """One quality knob on one target: `build()` returns a function of a
    single 0-d knob tensor. On the card, a kernel target with `graph` set
    is probed by CUDA-graph replay at `card_values` (which must move its
    output), comparing float outputs within `atol`."""

    subject: str
    build: Callable[[], Callable]
    values: Tuple[float, ...] = (0.25, 0.75)
    graph: bool = False
    card_values: Tuple[float, ...] = (0.25, 0.75)
    atol: float = 0.0


@dataclasses.dataclass(frozen=True)
class TraceTarget:
    """A program for the structural rules: `build()` returns (fn,
    example_args); `tainted` names the approximate-value leaves by path
    substring."""

    subject: str
    build: Callable[[], Tuple[Callable, tuple]]
    tainted: Tuple[str, ...] = ()


# --------------------------------------------------------------------------
# kernels
# --------------------------------------------------------------------------

# each kernel's registered lint config: (tuning name, operand shapes,
# config), launchable on the card (A002 checks it)
KERNEL_CONFIGS = {
    "taf_matmul": ("taf_matmul", ((128, 64), (64, 64)),
                   dict(block_m=16, block_n=16)),
    "iact_memo": ("iact_rowfn", ((128, 32), (32, 64), (64, 32)),
                  dict(block_rows=16)),
    "perforated_attention": ("perforated_attention",
                             ((1, 2, 64, 32), (1, 2, 128, 32)),
                             dict(block_q=16, block_kv=32)),
    "perforated_matmul": ("perforated_matmul", ((64, 256), (256, 64)),
                          dict(block_m=32, block_n=32, block_k=32)),
}
# phase 3's tolerances (the JAX tests'), for replay against eager calls
_ATOL = {"taf_matmul": 1e-3, "iact_memo": 1e-3,
         "perforated_attention": 1e-4, "perforated_matmul": 1e-3}


def _kernel_data(device):
    """Inputs on which each knob moves its kernel's output: near-constant
    positive tiles for K2 (stable tile means), row blocks that repeat the
    block before them for K3 (memo hits at any threshold above 0), random
    attention and GEMM operands for K1 / K4."""
    rng = np.random.RandomState(0)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=device)
    x2 = 1.0 + 0.01 * rng.randn(128, 64)
    w2 = np.abs(rng.randn(64, 64)) + 0.1
    x3 = np.repeat(rng.randn(4, 32), 32, axis=0)  # each block twice
    w31, w32 = rng.randn(32, 64), rng.randn(64, 32)
    q = rng.randn(1, 2, 64, 32)
    kv = rng.randn(1, 2, 128, 32)
    x4, w4 = rng.randn(64, 256), rng.randn(256, 64)
    return dict(taf=(t(x2), t(w2)), iact=(t(x3), t(w31), t(w32)),
                attn=(t(q), t(kv)), pmm=(t(x4), t(w4)))


def kernel_knob_targets(device="cpu") -> List[KnobTarget]:
    from ..core.types import PerforationKind, PerforationParams
    from ..kernels import (_build, iact_memo, perforated_attention,
                           perforated_matmul, taf_matmul)

    dev = torch.device(device)
    card = dev.type == "cuda"
    masked = PerforationParams(kind=PerforationKind.INI, fraction=0.0)
    nkv = KERNEL_CONFIGS["perforated_attention"][1][1][2] // 32
    nk = KERNEL_CONFIGS["perforated_matmul"][1][0][1] // 32

    def taf():
        if not card:
            return lambda th: _build.knob_operand(th, 0, dev)
        x, w = _kernel_data(dev)["taf"]
        return lambda th: taf_matmul.taf_matmul(
            x, w, block_m=16, block_n=16, history_size=2, prediction_size=2,
            rsd_threshold=th)

    def iact():
        if not card:
            return lambda th: _build.knob_operand(th, 0, dev)
        x, w1, w2 = _kernel_data(dev)["iact"]
        return lambda th: iact_memo.iact_rowfn(
            x, w1, w2, block_rows=16, table_size=2, threshold=th)

    def attn():
        if not card:
            return lambda f: perforated_attention.launch_operands(
                nkv, masked, f, 0, dev)
        q, kv = _kernel_data(dev)["attn"]
        return lambda f: perforated_attention.perforated_attention(
            q, kv, kv, block_q=16, block_kv=32, perfo=masked, fraction=f)

    def pmm():
        if not card:
            return lambda f: perforated_matmul._operands(nk, masked, f, True,
                                                         dev)
        x, w = _kernel_data(dev)["pmm"]
        return lambda f: perforated_matmul.perforated_matmul(
            x, w, block_m=32, block_n=32, block_k=32, perfo=masked,
            fraction=f, rescale=True)

    def pmm_structural():
        # the kept set is made from the knob as a Python number: the
        # operands of a structural call (static by construction)
        return lambda f: perforated_matmul._operands(
            nk, PerforationParams(kind=PerforationKind.INI,
                                  fraction=float(f)), None, False, dev)

    def attn_structural():
        return lambda f: perforated_attention.launch_operands(
            nkv, PerforationParams(kind=PerforationKind.INI,
                                   fraction=float(f)), None, 0, dev)

    return [
        KnobTarget("kernels.taf_matmul.rsd_threshold", taf, graph=True,
                   card_values=(0.0, 0.5), atol=_ATOL["taf_matmul"]),
        KnobTarget("kernels.iact_memo.threshold", iact, graph=True,
                   card_values=(0.0, 1.0), atol=_ATOL["iact_memo"]),
        KnobTarget("kernels.perforated_attention.fraction", attn, graph=True,
                   atol=_ATOL["perforated_attention"]),
        KnobTarget("kernels.perforated_matmul.fraction", pmm, graph=True,
                   atol=_ATOL["perforated_matmul"]),
        # Structural perforation mode: the kept set SHAPES the launch -- the
        # herded payoff (dropped blocks are never visited). A001 flags it
        # as static by construction; the repo allowlist records it as
        # intentional, pointing sweeps at the masked fraction= mode.
        KnobTarget("kernels.perforated_matmul.perfo", pmm_structural),
        KnobTarget("kernels.perforated_attention.perfo", attn_structural),
    ]


def kernel_config_targets() -> List[Tuple[str, str, tuple, Dict]]:
    """(subject, tuning kernel name, shapes, config) of each kernel knob
    target's registered launch config (A002), as the JAX package's
    `kernel_trace_targets` name them."""
    out = []
    for t in kernel_knob_targets("cpu"):
        mod = t.subject.split(".")[1]
        name, shapes, config = KERNEL_CONFIGS[mod]
        out.append((t.subject.rsplit(".", 1)[0] + ".config", name, shapes,
                    config))
    return out


# --------------------------------------------------------------------------
# regions
# --------------------------------------------------------------------------

def region_knob_targets(device="cpu") -> List[KnobTarget]:
    from ..core.approx import ApproxRegion, perforated_loop
    from ..core.types import (ApproxSpec, IACTParams, PerforationKind,
                              PerforationParams, TAFParams, Technique)

    def taf():
        spec = ApproxSpec(Technique.TAF, taf=TAFParams(2, 4, 0.5))
        region = ApproxRegion(spec, lambda x: x * 2.0, n_elements=8,
                              substrate="host", device=device)
        state = region.init_state()
        x = torch.ones((8,), dtype=torch.float32, device=device)
        return lambda th: region.step(state, x, rsd_threshold=th)

    def iact():
        # the port's iACT regions take (N, in_dim) inputs
        spec = ApproxSpec(Technique.IACT, iact=IACTParams())
        region = ApproxRegion(spec, lambda x: x[:, 0] * 2.0, n_elements=8,
                              in_dim=1, substrate="host", device=device)
        state = region.init_state()
        x = torch.ones((8, 1), dtype=torch.float32, device=device)
        return lambda th: region.step(state, x, threshold=th)

    def body(i, c):
        return c + float(i)

    def perfo():
        spec = ApproxSpec(
            Technique.PERFORATION,
            perforation=PerforationParams(kind=PerforationKind.INI,
                                          fraction=0.0))
        zero = torch.zeros((), dtype=torch.float32, device=device)
        return lambda f: perforated_loop(spec, 8, body, zero,
                                         fraction=f)[0]

    def perfo_skip():
        zero = torch.zeros((), dtype=torch.float32, device=device)

        def run(s):
            spec = ApproxSpec(
                Technique.PERFORATION,
                perforation=PerforationParams(kind=PerforationKind.SMALL,
                                              skip=int(s)))
            return perforated_loop(spec, 8, body, zero)[0]

        return run

    return [
        KnobTarget("regions.taf.rsd_threshold", taf),
        KnobTarget("regions.iact.threshold", iact),
        KnobTarget("regions.perforated_loop.fraction", perfo),
        # skip-driven perforation's knob is the loop structure itself;
        # allowlisted as intentional (see .approxlint.json)
        KnobTarget("regions.perforated_loop.skip", perfo_skip,
                   values=(2.0, 4.0)),
    ]


def region_taint_targets(device="cpu") -> List[TraceTarget]:
    """Region steps with their MEMOIZED-VALUE state leaves tainted: the
    approximate outputs must not steer control flow or indexing (A003).
    Detector state (windows, counters) is deliberately NOT a source."""
    from ..core.approx import ApproxRegion
    from ..core.types import ApproxSpec, TAFParams, Technique

    def taf():
        spec = ApproxSpec(Technique.TAF, taf=TAFParams(2, 4, 0.5))
        region = ApproxRegion(spec, lambda x: x * 2.0, n_elements=8,
                              substrate="host", device=device)
        state = region.init_state()
        x = torch.ones((8,), dtype=torch.float32, device=device)
        th = torch.tensor(0.5, dtype=torch.float32, device=device)
        fn = lambda st, xx: region.step(st, xx, rsd_threshold=th)
        return fn, (state, x)

    return [TraceTarget("regions.taf.step", taf, tainted=("memo",))]


# --------------------------------------------------------------------------
# ffn app geometry + sweep grids
# --------------------------------------------------------------------------

def default_grids():
    """The union Table-2 grid the sweep benchmarks run -- the spec
    population whose batched grouping A001 checks host-side."""
    from ..core import harness
    return (list(harness.taf_grid()) + list(harness.iact_grid())
            + list(harness.perfo_grid()))


def ffn_geometry() -> Dict[str, int]:
    """The approx_ffn app's block geometry vs its array shapes -- the
    divisibility preconditions its kernel path checks at run time, lifted
    to lint time (A002)."""
    from ..apps import approx_ffn
    return {
        "seq": 128, "d": 32, "d_h": 64,
        "block_m": approx_ffn._BLOCK_M,
        "block_rows": approx_ffn._BLOCK_ROWS,
        "block_attn": approx_ffn._BLOCK_ATTN,
    }


# --------------------------------------------------------------------------
# decode / serving fixtures (lazy, cached: one tiny model per device)
# --------------------------------------------------------------------------

def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


@functools.lru_cache(maxsize=2)
def decode_fixture(device: str = "cpu"):
    """The smoke decode model with TAF enabled: the program the serving
    path runs, prefilled once. Targets take clones of its cache (the
    decode step updates a cache in place)."""
    from ..launch import steps as steps_mod
    from ..models import build
    from ..qos import calibrate

    cfg = calibrate.default_decode_cfg()
    model = build(cfg, device=device)
    params = model.init(torch.Generator().manual_seed(0))
    prompt_len, batch = 4, 2
    prompts = torch.zeros((batch, prompt_len), dtype=torch.int32,
                          device=device)
    logits, cache = steps_mod.make_prefill_step(model, 16)(
        params, {"tokens": prompts})
    tokens = torch.argmax(logits, dim=-1).to(torch.int32)
    return {"model": model, "params": params, "cache": cache,
            "tokens": tokens, "pos": prompt_len,
            "serve": steps_mod.make_serve_step(model)}


def serve_knob_target(device="cpu") -> KnobTarget:
    """The decode TAF threshold through the real serve step: writing the
    knob into the cache and stepping must not change the program (A001)."""

    def build():
        fx = decode_fixture(device)

        def run(th):
            cache = _clone(fx["cache"])
            thr = cache["taf"]["threshold"]
            thr.copy_(th.to(thr.dtype).expand_as(thr))
            return fx["serve"](fx["params"], cache, fx["tokens"], fx["pos"])

        return run

    return KnobTarget("decode.serve_step.rsd_threshold", build)


def serve_taint_target(device="cpu") -> TraceTarget:
    def build():
        fx = decode_fixture(device)
        return fx["serve"], (fx["params"], _clone(fx["cache"]),
                             fx["tokens"], fx["pos"])

    return TraceTarget("decode.serve_step", build,
                       tainted=("memo_k", "memo_v", "memo_delta"))


def engine_fixture(device: str = "cpu"):
    """A one-rank sharded ServingEngine over the decode fixture's model,
    prefilled once -- the placement surface A005 audits. It needs a
    one-rank default process group (`runtime.elastic.init_single`)."""
    from ..serving.scheduler import ServingEngine

    fx = decode_fixture(device)
    eng = ServingEngine(fx["model"], fx["params"], slots=2, max_len=16,
                        prompt_len=4, devices=1)
    prompts = np.zeros((eng.n_slots, eng.prompt_len), np.int32)
    logits, eng.cache = eng._prefill_local(prompts)
    eng.tokens = torch.argmax(logits, dim=-1).to(torch.int32)
    return eng


def tree_paths(tree, path=()) -> List[Tuple[tuple, object]]:
    """(key path tuple, leaf) pairs of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in tree_paths(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in tree_paths(v, path + (i,))]
    return [(path, tree)]
