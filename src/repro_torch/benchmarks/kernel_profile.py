"""Where each kernel's time goes on the card, at the app's full width.

For each of the port's kernels on the approx_ffn path, called as the app
calls it at Qwen3-1.7B widths (seq 4096, d 2048, 16 heads, d_h 6144):

  * `wall_ms`   -- one wrapper call between CUDA events (median of 5);
  * `host_ms`   -- the same call on the host clock up to its return,
                   before any synchronize: the time to enqueue its launches;
  * `device_ms` -- the sum of the device times of the call's own CUDA
                   kernels, from one `torch.profiler` (CUPTI) session
                   around one call of each, one row per kernel name with
                   its count and mean;
  * `idle`      -- 1 - device_ms / wall_ms: the share of the call in which
                   the card ran none of its kernels (the call's small
                   copies and memsets count as idle).

    PYTHONPATH=src python -m repro_torch.benchmarks.kernel_profile \\
        [--out chiprun_out/kernel_profile.json]

Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Dict, List

import torch

from .. import device as device_mod
from ..apps import approx_ffn
from ..core.types import PerforationKind, PerforationParams
from ..kernels import ops
from ..obs import timing

FULL_GEOM = dict(seq=4096, d=2048, d_h=6144, heads=16)  # Qwen3-1.7B widths


def kernel_calls(s: Dict[str, torch.Tensor], d: int
                 ) -> Dict[str, Callable[[], object]]:
    """One call per kernel with the main path's specs: TAF (2, 4, 0.2),
    IACT (2, 0.05) and masked fini 0.5 perforation."""
    fini = PerforationParams(kind=PerforationKind.FINI, fraction=0.0)
    return {
        "taf_matmul": lambda: ops.taf_matmul(
            s["x"], s["wp"], block_m=16, block_n=d, history_size=2,
            prediction_size=4, rsd_threshold=0.2),
        "iact_rowfn": lambda: ops.iact_rowfn(
            s["a"], s["w1"], s["w2"], block_rows=16, table_size=2,
            threshold=0.05),
        "perforated_attention": lambda: ops.perforated_attention(
            s["q"], s["q"], s["q"], block_q=32, block_kv=32, perfo=fini,
            fraction=0.5),
    }


# names of the CUDA kernels each wrapper launches (csrc/*.cu)
KERNEL_NAMES = {"taf_matmul": ("taf_step",),
                "iact_rowfn": ("iact_probe", "iact_ffn1", "iact_ffn2",
                               "iact_insert"),
                "perforated_attention": ("attn_kernel",)}


def _device_us(evt) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def device_kernels(calls: Dict[str, Callable[[], object]],
                   dev: torch.device) -> List[Dict]:
    """Every CUDA kernel the calls ran, one row per kernel name, from one
    `torch.profiler` session around one call of each."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for fn in calls.values():
            fn()
            torch.cuda.synchronize(dev)
    rows = []
    for e in prof.key_averages():
        us = _device_us(e)
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append(dict(name=e.key, count=e.count, total_ms=us / 1e3,
                             mean_us=us / max(e.count, 1)))
    return sorted(rows, key=lambda k: -k["total_ms"])


def time_call(fn: Callable[[], object], dev: torch.device) -> Dict:
    wall = timing.measure(fn, device=dev, warmup=1, repeats=5).seconds
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize(dev)
    return dict(wall_ms=wall * 1e3, host_ms=host * 1e3)


def main(out: str = None, geom: Dict[str, int] = None) -> Dict:
    geom = geom or FULL_GEOM
    dev = device_mod.resolve("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    s = approx_ffn.kernel_operands(**geom, device=dev)
    report = {"geometry": geom, "card": device_mod.name(dev), "calls": {}}
    calls = kernel_calls(s, geom["d"])
    rows = device_kernels(calls, dev)
    for name, fn in calls.items():
        r = time_call(fn, dev)
        r["kernels"] = [k for k in rows
                        if any(n in k["name"] for n in KERNEL_NAMES[name])]
        r["device_ms"] = sum(k["total_ms"] for k in r["kernels"])
        r["idle"] = 1.0 - r["device_ms"] / r["wall_ms"]
        report["calls"][name] = r
        print(f"{name}: wall_ms={r['wall_ms']:.4f} host_ms={r['host_ms']:.4f}"
              f" device_ms={r['device_ms']:.4f} idle={r['idle']:.4f}")
        for k in r["kernels"]:
            print(f"    {k['count']:6d} x {k['mean_us']:10.3f} us = "
                  f"{k['total_ms']:.4f} ms  {k['name'][:90]}")
    # the same TAF call with threshold 0: no tile approximates, so every
    # step computes its product (the cost of a computed step)
    r = time_call(lambda: ops.taf_matmul(
        s["x"], s["wp"], block_m=16, block_n=geom["d"], history_size=2,
        prediction_size=4, rsd_threshold=0.0), dev)
    report["calls"]["taf_matmul_all_computed"] = r
    print(f"taf_matmul, threshold 0 (all computed): "
          f"wall_ms={r['wall_ms']:.4f} host_ms={r['host_ms']:.4f}")
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    main(out=ap.parse_args().out)
