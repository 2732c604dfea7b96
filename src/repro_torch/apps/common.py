"""What the memoization apps share: one timed evaluation, the technique
dispatch over an invocation sequence, and the lane loop of their batched
runners. The JAX apps repeat this code in each module; here it is written
once.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..core import batching
from ..core import iact as iact_mod
from ..core import taf as taf_mod
from ..core.types import ApproxSpec, Technique
from ..obs import metrics, timing


def timed(fn: Callable, *args, device) -> Tuple[object, float, int]:
    """`fn(*args)` once to warm up, then once timed (between CUDA events on
    the card, by `perf_counter` on the CPU). Returns (value, seconds, host
    reads of the timed call), the reads tallied in
    `obs.metrics.HOST_READS`."""
    fn(*args)
    before = metrics.host_reads()
    m = timing.measure(fn, *args, device=device, warmup=0, repeats=1)
    return m.value, m.seconds, metrics.host_reads() - before


def run_memo(spec: ApproxSpec, xs: torch.Tensor, fn: Callable,
             exact: Callable[[torch.Tensor], torch.Tensor]):
    """(ys, approx_fraction) of the region `fn` over the invocation sequence
    `xs` (T, N, ...) under `spec`: TAF / iACT through their run_sequence,
    anything else `exact(xs)` with fraction 0 (a 0-d device tensor)."""
    if spec.technique == Technique.TAF:
        ys, _, frac = taf_mod.run_sequence(spec.taf, xs, fn, spec.level)
    elif spec.technique == Technique.IACT:
        ys, _, frac = iact_mod.run_sequence(spec.iact, xs, fn, spec.level)
    else:
        ys = exact(xs)
        frac = torch.zeros((), dtype=torch.float32, device=xs.device)
    return ys, frac


def memo_group(key, xs: torch.Tensor, fn: Callable,
               post: Optional[Callable] = None):
    """The group function of a memoization app's batched runner: the key's
    run_sequence once per lane, each lane with its own 0-d knob tensor;
    `post(ys)` turns a lane's outputs into its QoI. None for keys with no
    run_sequence shape."""
    seq = batching.sequence_runner(key, xs, fn)
    if seq is None:
        return None

    def lane(th):
        ys, frac = seq(th)
        return (ys if post is None else post(ys)), frac

    return batching.lanes(lane)
