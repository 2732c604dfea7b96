"""Memory, race and barrier checks of the port's nine CUDA kernels.

    python -m repro_torch.kernels.sanitize --tool memcheck
    python -m repro_torch.kernels.sanitize --tool racecheck|synccheck|initcheck
    python -m repro_torch.kernels.sanitize --tool memcheck --device cpu

One tool a process: racecheck and synccheck load the checked build, which
cannot share a process with the release one.

One run launches every `__global__` function of `csrc/` (`KERNELS`: K1's
`attn_kernel`; K2's `taf_persistent` and `taf_lanes`; K3's `iact_schedule`,
`iact_ffn1`, `iact_ffn2`, `iact_union` and `iact_fill`; K4's `perf_matmul`)
through the normal wrappers, `ops.*` and their lane forms, on a fixed list
of small cases (`CASES`) made from a seed with numpy. The cases come from
each kernel's launch rule (`launchable`) and reach its branches: K1 at
D 16-128 in float32 and bf16, GQA, Sq < Skv, causal and not, every
perforation kind structural and masked, fully masked rows, lanes shared and
stacked; K2 with several column slices a CTA, more units than teams,
ragged tiles, W staged and resident, thresholds under which tiles are
stable and none is, lanes shared and stacked; K3 with thresholds under
which every block computes, some approximate, or only block 0 computes,
ragged rows and widths, lanes shared and stacked; K4 at every tile side,
block_k of one to three chunks, every kind structural and masked, rescale
on and off, every block dropped.

Every result is held against its plain version (the wrapper on CPU copies
of the same inputs): masks bit for bit, values within `ATOL`, the
tolerances `chip_smoke.py` holds the kernels to. The four tools are named
after the compute-sanitizer tool whose class of fault each one looks for,
and each runs on the card with nothing but this package:

  memcheck   every input, output and scratch buffer lies between guard
             zones (`Poison`); each case runs twice, the guards
             holding 0xFF in one run and 0x7F in the other, the buffers
             zero in both. A write out of bounds lands in a guard; a read
             out of bounds that reaches a result reads the guard, so the
             two runs' outputs differ.
  initcheck  every output and scratch buffer is filled before the launch,
             with 0xFF in one run and 0x7F in the other (guards zero): an
             element read before any thread wrote it, or never written,
             makes the two runs' outputs differ.
  synccheck  the checked build (`_build.use_checked_build`): every CTA
             barrier checks that all threads of the CTA reached the same
             barrier; a barrier in a divergent branch records a fault and
             its line.
  racecheck  the checked build with jitter: every thread sleeps a random
             moment at each barrier and `cp.async` wait, so warps reach
             shared memory out of their usual order. Each case runs with
             jitter off and then with three seeds, and every run's outputs
             must be bit-identical: a missing barrier lets a warp read a
             stage before it lands or after it is overwritten.

The kernels promise bit-identical outputs on identical inputs (no float
atomics, fixed orders), which is what lets a difference stand for a fault.
What these checks cannot see: a read out of bounds whose value never
reaches an output, one farther than a guard (4 KiB or the buffer's own
size), and K2's barrier between CTAs, which lives in global memory (its
repeated-call and rounds tests keep it).

Each tool prints a line per case and, last, one JSON object: the tool, the
cases, the findings, the launches of each of the nine kernels counted by
`torch.profiler` over the first pass, the wrapper calls, the seconds. It
exits 1 on any finding or disagreement, or if a kernel was not launched.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import json
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.types import PerforationKind, PerforationParams
from . import _build, iact_memo, ops

TOOLS = ("memcheck", "racecheck", "synccheck", "initcheck")
# the __global__ functions of csrc/ (taf_lanes and the K3 FFN launches are
# templates: each instantiation counts under its name)
KERNELS = ("attn_kernel", "taf_persistent", "taf_lanes", "iact_schedule",
           "iact_ffn1", "iact_ffn2", "iact_union", "iact_fill",
           "perf_matmul")
# chip_smoke.py's tolerances: the JAX package's test tolerances
ATOL = {"taf_matmul": 1e-3, "iact_rowfn": 1e-3,
        "perforated_attention": 1e-4, "perforated_attention_bf16": 0.05,
        "perforated_matmul": 1e-3}
# (fill, guard) bytes of a tool's two runs
PATTERNS = {"memcheck": ((0x00, 0xFF), (0x00, 0x7F)),
            "initcheck": ((0xFF, 0x00), (0x7F, 0x00))}
JITTER_NS = 2000   # racecheck: the most a thread sleeps at a site
JITTER_SEEDS = (1, 2, 3)
STABLE, NEVER = 1e6, 0.0  # TAF thresholds: every full window / none stable

P, K = PerforationParams, PerforationKind


@dataclasses.dataclass(frozen=True)
class Case:
    """One wrapper call: the kernel (an `ops.KERNELS` key), its operands
    ((name, shape) in the wrapper's order), how they are drawn, the
    wrapper's keyword arguments and its quality knob (None, a number, or a
    tuple: a lane stack)."""
    name: str
    kernel: str
    operands: Tuple[Tuple[str, Tuple[int, ...]], ...]
    kw: Tuple[Tuple[str, object], ...]
    knob: object = None
    data: str = "randn"  # "randn", "stable" (TAF), "pairs", "alike" (K3)
    dtype: str = "float32"
    seed: int = 0

    @property
    def lanes(self) -> int:
        return len(self.knob) if isinstance(self.knob, tuple) else 0

    @property
    def kwargs(self) -> Dict[str, object]:
        return dict(self.kw)

    def shapes(self) -> List[Tuple[int, ...]]:
        """One lane's operand shapes (a stacked operand loses its L)."""
        nd = 4 if self.kernel == "perforated_attention" else 2
        return [s[1:] if len(s) > nd else s for _, s in self.operands]


def _attn(name, b, hq, hkv, sq, skv, d, bq, bkv, *, dtype="float32",
          causal=True, perfo=None, knob=None, stacked=0, seed=0):
    lead = (stacked,) if stacked else ()
    return Case(name, "perforated_attention",
                (("q", lead + (b, hq, sq, d)), ("k", lead + (b, hkv, skv, d)),
                 ("v", lead + (b, hkv, skv, d))),
                (("block_q", bq), ("block_kv", bkv), ("causal", causal),
                 ("perfo", perfo)), knob, dtype=dtype, seed=seed)


def _taf(name, m, k, n, bm, bn, knob, *, h=2, p=4, x_lanes=0, w_lanes=0,
         seed=0):
    return Case(name, "taf_matmul",
                (("x", ((x_lanes,) if x_lanes else ()) + (m, k)),
                 ("w", ((w_lanes,) if w_lanes else ()) + (k, n))),
                (("block_m", bm), ("block_n", bn), ("history_size", h),
                 ("prediction_size", p)), knob, data="stable", seed=seed)


def _iact(name, n, d_in, d_h, d_out, r, t, knob, *, data="pairs",
          x_lanes=0, w_lanes=0, seed=0):
    lx = (x_lanes,) if x_lanes else ()
    lw = (w_lanes,) if w_lanes else ()
    return Case(name, "iact_rowfn",
                (("x", lx + (n, d_in)), ("w1", lw + (d_in, d_h)),
                 ("w2", lw + (d_h, d_out))),
                (("block_rows", r), ("table_size", t)), knob, data=data,
                seed=seed)


def _pmm(name, m, k, n, bm, bn, bk, *, perfo=None, knob=None, rescale=False,
         seed=0):
    return Case(name, "perforated_matmul", (("x", (m, k)), ("w", (k, n))),
                (("block_m", bm), ("block_n", bn), ("block_k", bk),
                 ("perfo", perfo), ("rescale", rescale)), knob, seed=seed)


CASES: Tuple[Case, ...] = (
    # K1: every head dim in float32 (3xTF32) and bf16, GQA / MQA, Sq < Skv
    _attn("attn_d16_gqa", 1, 4, 2, 64, 128, 16, 16, 32),
    _attn("attn_d32_mqa", 2, 4, 1, 64, 96, 32, 32, 32),
    _attn("attn_d64", 1, 2, 2, 128, 128, 64, 64, 64),
    _attn("attn_d128_gqa", 1, 4, 2, 128, 256, 128, 128, 128),
    _attn("attn_d16_gqa_bf16", 1, 4, 2, 64, 128, 16, 16, 32,
          dtype="bfloat16"),
    _attn("attn_d32_mqa_bf16", 2, 4, 1, 64, 96, 32, 32, 32, dtype="bfloat16"),
    _attn("attn_d64_bf16", 1, 2, 2, 128, 128, 64, 64, 64, dtype="bfloat16"),
    _attn("attn_d128_gqa_bf16", 1, 4, 2, 128, 256, 128, 128, 128,
          dtype="bfloat16"),
    _attn("attn_not_causal", 1, 4, 1, 32, 128, 64, 32, 32, causal=False),
    # every perforation kind, structural
    _attn("attn_small2", 1, 4, 2, 64, 256, 32, 32, 32,
          perfo=P(kind=K.SMALL, skip=2)),
    _attn("attn_large2", 1, 4, 2, 64, 256, 32, 32, 32,
          perfo=P(kind=K.LARGE, skip=2)),
    _attn("attn_ini", 1, 4, 2, 64, 256, 32, 32, 64,
          perfo=P(kind=K.INI, fraction=0.25)),
    _attn("attn_fini", 1, 4, 2, 64, 256, 32, 32, 32,
          perfo=P(kind=K.FINI, fraction=0.25)),
    _attn("attn_random", 1, 4, 2, 64, 256, 32, 32, 32,
          perfo=P(kind=K.RANDOM, fraction=0.25)),
    # masked, the fraction a device tensor
    _attn("attn_ini_masked", 1, 4, 2, 64, 256, 32, 32, 32,
          perfo=P(kind=K.INI), knob=0.5),
    _attn("attn_fini_masked_bf16", 1, 4, 2, 64, 256, 64, 64, 32,
          dtype="bfloat16", perfo=P(kind=K.FINI), knob=0.5),
    _attn("attn_random_masked", 1, 4, 4, 64, 256, 128, 32, 64,
          perfo=P(kind=K.RANDOM), knob=0.3),
    # the first half of the KV blocks dropped: rows 0-63 see no key (0)
    _attn("attn_rows_fully_masked", 1, 2, 1, 128, 128, 16, 16, 32,
          perfo=P(kind=K.INI), knob=0.5),
    # every block dropped: every row 0
    _attn("attn_all_dropped", 1, 2, 2, 64, 128, 32, 32, 32,
          perfo=P(kind=K.FINI), knob=1.0),
    # lanes: one call for a stack of fractions, shared and stacked q / k / v
    _attn("attn_lanes_shared", 1, 4, 4, 128, 128, 64, 32, 32,
          perfo=P(kind=K.FINI), knob=(0.5, 0.25, 0.75, 0.0)),
    _attn("attn_lanes_stacked", 1, 4, 2, 64, 128, 32, 32, 32,
          perfo=P(kind=K.RANDOM), knob=(0.25, 0.5), stacked=2),

    # K2: a threshold under which every full window is stable, and none
    _taf("taf_stable", 128, 64, 64, 16, 64, STABLE),
    _taf("taf_none_stable", 128, 64, 64, 16, 64, NEVER),
    # 256 column slices of 16: more than one slice a CTA
    _taf("taf_slices_per_cta", 32, 64, 4096, 16, 4096, STABLE, h=1, p=1),
    # 16 column blocks of 32 CTAs: more units than teams, several rounds
    _taf("taf_rounds", 128, 64, 8192, 32, 512, STABLE, h=2, p=2),
    # block_m 24 (a 16-row pass, then 8), K off the 256 chunk, 8-column
    # slices of block_n 24
    _taf("taf_ragged", 96, 100, 48, 24, 24, STABLE, h=2, p=3),
    # K 3072: W slices do not fit shared memory and are staged with x
    _taf("taf_staged_w", 32, 3072, 64, 16, 32, NEVER),
    # lanes sharing x and w (one lane set), stacked x, stacked w in rounds
    _taf("taf_lanes_shared", 128, 64, 128, 16, 64,
         (NEVER, STABLE, NEVER, STABLE)),
    _taf("taf_lanes_stacked_x", 64, 32, 64, 16, 32, (NEVER, STABLE, STABLE),
         x_lanes=3),
    _taf("taf_lanes_stacked_w_rounds", 128, 64, 2048, 32, 512,
         (STABLE, NEVER, STABLE, NEVER), w_lanes=4),

    # K3: every block computes, some approximate, only block 0 computes
    _iact("iact_all_compute", 256, 32, 64, 16, 16, 4, 0.0),
    _iact("iact_some_approximate", 256, 32, 64, 16, 16, 4, 0.5),
    _iact("iact_only_block_0", 256, 32, 64, 16, 16, 2, 0.5, data="alike"),
    # 160 rows (a ragged GEMM row tile), d_in 20 (the 8th CTA's slice of
    # d_in empty), d_h 72 and d_out 36 (ragged columns), one slot
    _iact("iact_ragged", 160, 20, 72, 36, 32, 1, 0.5),
    _iact("iact_table_8", 512, 64, 128, 64, 64, 8, 0.5),
    # lanes: shared operands (iact_union), stacked rows, stacked weights
    _iact("iact_lanes_shared", 256, 32, 64, 16, 16, 4, (0.0, 0.5, 1e3)),
    _iact("iact_lanes_stacked_rows", 128, 16, 32, 8, 16, 4, (0.5, 0.0),
          x_lanes=2),
    _iact("iact_lanes_stacked_weights", 128, 16, 32, 8, 32, 2, (0.5, 1e3),
          w_lanes=2),

    # K4: every tile side, block_k of one to three 32-deep chunks
    _pmm("pmm_32x32", 64, 128, 64, 32, 32, 32),
    _pmm("pmm_64x128_small2", 128, 256, 256, 64, 128, 64,
         perfo=P(kind=K.SMALL, skip=2), rescale=True),
    _pmm("pmm_128x64_large2", 256, 256, 128, 128, 64, 32,
         perfo=P(kind=K.LARGE, skip=2)),
    _pmm("pmm_128x128_ini", 256, 384, 256, 128, 128, 96,
         perfo=P(kind=K.INI, fraction=0.25), rescale=True),
    _pmm("pmm_fini", 64, 256, 64, 32, 32, 64,
         perfo=P(kind=K.FINI, fraction=0.5)),
    _pmm("pmm_random", 64, 256, 128, 64, 32, 32,
         perfo=P(kind=K.RANDOM, fraction=0.25), rescale=True),
    _pmm("pmm_ini_masked", 128, 256, 128, 64, 64, 32, perfo=P(kind=K.INI),
         knob=0.5, rescale=True),
    _pmm("pmm_fini_masked", 64, 256, 64, 32, 64, 64, perfo=P(kind=K.FINI),
         knob=0.25),
    _pmm("pmm_random_masked", 128, 256, 64, 128, 32, 32,
         perfo=P(kind=K.RANDOM), knob=0.5, rescale=True),
    # every block dropped: y is 0 whatever the rescale
    _pmm("pmm_all_dropped", 64, 128, 64, 32, 32, 32, perfo=P(kind=K.FINI),
         knob=1.0, rescale=True),
)


def cuda_kernels(case: Case) -> Tuple[str, ...]:
    """The `KERNELS` one wrapper call of `case` launches (the wrapper
    module's own list; K3's lanes add `iact_union` only when they share
    every operand)."""
    mod = ops.KERNELS[case.kernel]
    stacked = any(len(s) != len(one)
                  for (_, s), one in zip(case.operands, case.shapes()))
    if not case.lanes or (case.kernel == "iact_rowfn" and stacked):
        return mod.CUDA_KERNELS
    return mod.LANE_CUDA_KERNELS


def launch_rule(case: Case) -> Optional[str]:
    """None if the kernel's launch rule takes `case`, else the reason."""
    kw, shapes = case.kwargs, case.shapes()
    if case.kernel == "perforated_attention":
        return ops.KERNELS[case.kernel].launchable(
            shapes, dict(block_q=kw["block_q"], block_kv=kw["block_kv"]))
    if case.kernel == "iact_rowfn":
        return iact_memo.launchable(shapes, dict(block_rows=kw["block_rows"]),
                                    kw["table_size"])
    keys = ("block_m", "block_n") + (
        ("block_k",) if case.kernel == "perforated_matmul" else ())
    return ops.KERNELS[case.kernel].launchable(shapes,
                                               {k: kw[k] for k in keys})


def arrays(case: Case) -> Dict[str, np.ndarray]:
    """The case's operands as float32 numpy arrays, from its seed. Weights
    are scaled by 1 / sqrt(fan-in), so values stay of order 1."""
    rng = np.random.RandomState(1000 + case.seed)
    out = {}
    for name, shape in case.operands:
        if case.data == "stable" and name == "x":
            # rows repeat one pattern with 2% noise: TAF tiles stabilise
            base = rng.randn(*shape[:-2], 1, shape[-1])
            a = base + 0.02 * rng.randn(*shape)
        elif case.data in ("pairs", "alike") and name == "x":
            n, d_in = shape[-2:]
            r = case.kwargs["block_rows"]
            lead = shape[:-2]
            if case.data == "alike":  # every row near one point
                a = (rng.randn(*lead, 1, d_in)
                     + 1e-4 * rng.randn(*shape))
            else:  # a new point for every two blocks: the second can hit
                pts = rng.randn(*lead, -(-n // (2 * r)), d_in)
                a = (np.repeat(pts, 2 * r, axis=-2)[..., :n, :]
                     + 1e-3 * rng.randn(*shape))
        elif name in ("w", "w1", "w2"):
            a = rng.randn(*shape) / np.sqrt(shape[-2])
        else:
            a = rng.randn(*shape)
        out[name] = a.astype(np.float32)
    return out


def checked_state(jitter_ns: int = 0, seed: int = 0
                  ) -> Dict[str, Tuple[int, int]]:
    """Read and clear each translation unit's barrier faults in the checked
    build, and set the jitter of its barriers and `cp.async` waits: each
    thread then sleeps up to `jitter_ns` ns there (0: none), drawn from
    `seed`. Returns {unit: (faults, line of the first faulty barrier)}, a
    unit being a `.cu` source, which ends in REPRO_SANITIZE_ENTRY(unit)."""
    if not _build._checked:
        raise RuntimeError("checked_state needs _build.use_checked_build()")
    out = {}
    for unit in (src.stem for src in _build.sources()):
        fn = _build.function(f"repro_sanitize_{unit}", [
            _build.I, ctypes.c_uint, ctypes.POINTER(ctypes.c_ulonglong),
            ctypes.POINTER(ctypes.c_uint)])
        faults, line = ctypes.c_ulonglong(0), ctypes.c_uint(0)
        _build.check(f"repro_sanitize_{unit}",
                     fn(jitter_ns, seed & 0xffffffff, ctypes.byref(faults),
                        ctypes.byref(line)))
        out[unit] = (faults.value, line.value)
    return out


class Poison:
    """Buffers filled with one byte and fenced by guard zones of another.

    `alloc` returns a view into the middle of a larger buffer: the view
    holds `fill`, and everything around it (at least `guard` bytes on each
    side, and the bytes rounding it up to 16) holds `guard_fill`. A kernel
    that writes out of bounds into a guard shows in `breaches`. One that
    reads an element of an output or scratch buffer before writing it reads
    `fill`, and one that reads out of bounds reads `guard_fill`: two runs
    that differ in that byte give outputs that differ."""

    GUARD = 4096  # bytes on each side, at least (or the buffer's size)

    def __init__(self, fill: int, guard_fill: int):
        self.fill, self.guard_fill = int(fill) & 0xff, int(guard_fill) & 0xff
        self.fences: List[Tuple[torch.Tensor, int, int, str]] = []

    def alloc(self, shape, dtype, device, label: str = "") -> torch.Tensor:
        item = torch.empty((), dtype=dtype).element_size()
        n = item * int(torch.Size(shape).numel())
        body = (n + 15) // 16 * 16
        g = max(self.GUARD, body)
        raw = torch.full((2 * g + body,), self.guard_fill, dtype=torch.uint8,
                         device=device)
        raw[g:g + n] = self.fill
        self.fences.append((raw, g, n, label or f"{dtype} {tuple(shape)}"))
        return raw[g:g + n].view(dtype).view(shape)

    def guarded(self, t: torch.Tensor, label: str = "") -> torch.Tensor:
        """A copy of `t` inside a fenced buffer (an input's guards)."""
        out = self.alloc(t.shape, t.dtype, t.device, label)
        out.copy_(t)
        return out

    def breaches(self) -> List[str]:
        """The buffers whose guards no longer hold `guard_fill`, each with
        the offsets (bytes from the buffer's start) written outside it."""
        found = []
        for raw, g, n, label in self.fences:
            outside = torch.cat([raw[:g], raw[g + n:]])
            bad = (outside != self.guard_fill).nonzero().flatten()
            if bad.numel():
                offs = torch.where(bad < g, bad - g, bad - g + n)
                found.append(f"{label}: {bad.numel()} guard bytes written, "
                             f"at offsets {offs[:4].tolist()}")
        return found


@contextlib.contextmanager
def poisoned(fill: int, guard_fill: int):
    """Within the block, `_build.empty` fills with `fill` and fences with
    `guard_fill`; yields the `Poison` that holds the fences."""
    poison, prev = Poison(fill, guard_fill), _build.allocator
    _build.allocator = poison.alloc
    try:
        yield poison
    finally:
        _build.allocator = prev


def tensors(case: Case, device, poison: Optional[Poison] = None
            ) -> List[torch.Tensor]:
    """The operands on `device` in the case's dtype, each inside guard
    zones when `poison` is given."""
    dt = getattr(torch, case.dtype)
    out = []
    for name, a in arrays(case).items():
        t = torch.from_numpy(a).to(device=device, dtype=dt)
        out.append(poison.guarded(t, f"{case.name} {name}") if poison else t)
    return out


def knob_tensor(case: Case, device, poison: Optional[Poison] = None):
    """The knob as a float32 tensor on `device` (0-d, or (L,) for lanes),
    inside guard zones when `poison` is given; None stays None."""
    if case.knob is None:
        return None
    t = torch.tensor(case.knob, dtype=torch.float32, device=device)
    return poison.guarded(t, f"{case.name} knob") if poison else t


def call(case: Case, ops_in: Sequence[torch.Tensor], knob
         ) -> Tuple[torch.Tensor, ...]:
    """The wrapper call: (values,) or (values, mask)."""
    kw = case.kwargs
    if case.kernel == "taf_matmul":
        return tuple(ops.taf_matmul(*ops_in, rsd_threshold=knob, **kw))
    if case.kernel == "iact_rowfn":
        return tuple(ops.iact_rowfn(*ops_in, threshold=knob, **kw))
    if case.kernel == "perforated_matmul":
        return (ops.perforated_matmul(*ops_in, fraction=knob, **kw),)
    return (ops.perforated_attention(*ops_in, fraction=knob, **kw),)


def plain(case: Case) -> Tuple[torch.Tensor, ...]:
    """The plain version's outputs: the wrapper on CPU tensors."""
    return call(case, tensors(case, "cpu"), knob_tensor(case, "cpu"))


def tolerance(case: Case) -> float:
    if case.kernel == "perforated_attention" and case.dtype == "bfloat16":
        return ATOL["perforated_attention_bf16"]
    return ATOL[case.kernel]


def disagreement(case: Case, got: Sequence[torch.Tensor],
                 want: Sequence[torch.Tensor]) -> Optional[str]:
    """Why `got` (the kernel's outputs) departs from `want` (the plain
    version's), or None: masks equal, values within the tolerance."""
    err = float((got[0].float().cpu() - want[0].float()).abs().max())
    if not err <= tolerance(case):
        return f"max_abs_err {err:.3g} > atol {tolerance(case)}"
    if len(got) > 1 and not torch.equal(got[1].cpu(), want[1]):
        return "mask differs from the plain version's"
    return None


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().reshape(-1).view(torch.uint8).cpu()


def same_bits(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor]) -> bool:
    return all(torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b))


def _run_poisoned(case, device, fill, guard_fill, guard_inputs):
    with poisoned(fill, guard_fill) as poison:
        ins = tensors(case, device, poison if guard_inputs else None)
        knob = knob_tensor(case, device, poison if guard_inputs else None)
        out = call(case, ins, knob)
        torch.cuda.synchronize(device)
        out = tuple(o.clone() for o in out)
        return out, poison.breaches()


def check_case(tool: str, case: Case, device, want) -> Tuple[List[str], int]:
    """Run `case` as `tool` runs it; returns (findings, wrapper calls)."""
    findings = []
    if tool in PATTERNS:
        runs = [_run_poisoned(case, device, f, g, tool == "memcheck")
                for f, g in PATTERNS[tool]]
        for (out, breaches), (fill, guard_fill) in zip(runs, PATTERNS[tool]):
            findings += [f"out-of-bounds write: {b}" for b in breaches]
            why = disagreement(case, out, want)
            if why:
                findings.append(f"fill 0x{fill:02X} guards 0x{guard_fill:02X}:"
                                f" {why}")
        if not same_bits(runs[0][0], runs[1][0]):
            what = ("a read out of bounds reaches the result"
                    if tool == "memcheck" else
                    "an element is read before it is written, or never "
                    "written") + " (or a race made the runs differ)"
            findings.append(f"outputs differ between the two patterns: "
                            f"{what}")
        return findings, len(runs)
    seeds = (0,) + (JITTER_SEEDS if tool == "racecheck" else ())
    first = None
    for seed in seeds:
        checked_state(JITTER_NS if seed else 0, seed)
        out = call(case, tensors(case, device), knob_tensor(case, device))
        torch.cuda.synchronize(device)
        for unit, (faults, line) in checked_state().items():
            if faults:
                findings.append(f"seed {seed}: {faults} barrier passes in "
                                f"csrc/{unit}.cu (or a header it includes) "
                                f"where the CTA's threads were at different "
                                f"barriers, the first at line {line}")
        why = disagreement(case, out, want)
        if why:
            findings.append(f"seed {seed}: {why}")
        if first is None:
            first = out
        elif not same_bits(first, out):
            findings.append(f"seed {seed}: outputs differ from the run "
                            "without jitter: a shared-memory race")
    return findings, len(seeds)


def _profiled(fn: Callable[[], object]) -> Dict[str, int]:
    """Launches of each of `KERNELS` while `fn` runs (torch.profiler, the
    card's activity alone)."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
    counts = {k: 0 for k in KERNELS}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for k in KERNELS:
            if k in e.key:
                counts[k] += e.count
    return counts


def run_tool(tool: str, device: str = "cuda",
             cases: Sequence[Case] = CASES,
             log: Callable[[str], None] = print) -> Dict:
    """Run `tool` over `cases`; returns its summary (see the module
    docstring). On the CPU the wrappers take their plain versions, and only
    the control flow and the parity run."""
    t0 = time.perf_counter()
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card and tool in ("racecheck", "synccheck"):
        _build.use_checked_build()
    findings: Dict[str, List[str]] = {}
    expected = {k: 0 for k in KERNELS}
    calls_before = ops.launch_counts()

    def first_pass():
        for case in cases:
            why = launch_rule(case)
            if why:
                findings[case.name] = [f"not launchable: {why}"]
                continue
            want = plain(case)
            if on_card:
                got, n_runs = check_case(tool, case, dev, want)
                for k in cuda_kernels(case):
                    expected[k] += n_runs
            else:
                got = []
                out = call(case, tensors(case, dev), knob_tensor(case, dev))
                if not same_bits(out, want):
                    got.append("the plain version is not reproducible")
            findings[case.name] = got
            log(f"  {tool} {case.name}: "
                + ("ok" if not got else "; ".join(got)))

    if on_card:
        launches = _profiled(first_pass)
    else:
        first_pass()
        launches = {k: 0 for k in KERNELS}
    calls_after = ops.launch_counts()
    bad = {k: v for k, v in findings.items() if v}
    missing = [k for k in KERNELS
               if on_card and any(k in cuda_kernels(c) for c in cases)
               and launches[k] < expected[k]]
    return dict(
        tool=tool, device=(torch.cuda.get_device_name(dev) if on_card
                           else "cpu"),
        cases=len(cases), errors=sum(len(v) for v in bad.values()),
        findings=bad, launches=launches, expected_launches=expected,
        not_launched=missing,
        wrapper_calls={k: calls_after[k] - calls_before[k]
                       for k in calls_after},
        seconds=time.perf_counter() - t0)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tool", required=True, choices=TOOLS)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), or cpu: the case list and the "
                         "plain versions only")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("sanitize: no CUDA device", file=sys.stderr)
        return 2
    summary = run_tool(args.tool, args.device,
                       log=lambda m: print(m, flush=True))
    print(json.dumps(summary), flush=True)
    return 1 if summary["errors"] or summary["not_launched"] else 0


if __name__ == "__main__":
    sys.exit(main())
