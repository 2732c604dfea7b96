"""FLOP and byte counts of the kernels' precise-path calls (the part of
`repro.analysis.cost` that the block-shape autotuner needs).

The JAX package traces `tuning.build_call(kernel, config)` to a jaxpr and
counts a `pallas_call` as the FLOPs of its body times the grid product,
plus the call's input and output bytes (`analysis/cost.py:183-191` there):
every element a body reads, writes or computes counts one FLOP, a dot
2 * M * N * K, a transcendental 8. The port has no jaxpr, so `kernel_cost`
writes the same count from the kernels' shapes: per grid step, the
block products, the operand blocks read, the tile-sized elementwise work
and the state updates, times the grid; per call, each operand and output
once (4 bytes an element). Terms that do not scale with a block (a few
scalar ops a step) are left out; they are under 1% at the tuner's shapes.

The counts describe the Pallas grid the port's tuner shares with the JAX
package (`tuning.grid_steps`), not the CUDA launch layout: they rank block
configs by the work the block geometry adds, and the launch count enters
the tuner's prediction separately (`tuning.launches`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence

# the tuner's precise calls run the kernels' defaults
_IACT_TABLE = 4       # iact_rowfn table_size
_TRANS_FLOPS = 8      # a transcendental (tanh, exp, integer_pow)
_ELEM_BYTES = 4       # float32 / int32 everywhere


@dataclasses.dataclass(frozen=True)
class CostVector:
    """FLOPs and bytes moved -- the two roofline numerators."""

    flops: float = 0.0
    bytes: float = 0.0


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
