"""Kernel microbenchmarks (port of `benchmarks/kernel_micro.py`): oracle
parity and skip profile of the memoizing kernels, the block-skip savings of
the perforated kernels, the `pipeline=` parity check, the threshold sweep's
rebuild count, and the block-shape autotuner against the default blocks.

    PYTHONPATH=src python -m repro_torch.benchmarks.kernel_micro \\
        [--geometry ref|full] [--device cuda|cpu] [--out chiprun_out/...]

Geometries:

  ref   the JAX module's own shapes: 256^3 operands for the structural
        rows, and the approx_ffn reference geometry (seq 128, d 32, d_h 64,
        heads 2) with the app's blocks as the tuning defaults;
  full  the main path's full width (Qwen3-1.7B: seq 4096, d 2048, d_h
        6144, 16 heads of 128, 8 KV heads for the attention rows), and K4
        at the FFN down-projection x (4096, 6144) @ w (6144, 2048) with
        block_k 128 (the JAX herded FFN perforation's hidden-block
        granularity, `src/repro/models/mlp.py`).

Every time is a median of timed calls after warm-up (`obs.timing.measure`:
CUDA events on the card, the host clock on the CPU, where the wrappers run
their plain versions). The structural numbers (executed grid fraction,
FLOPs) do not depend on the device.

With `artifacts_dir` three files are written there (never under
`benchmarks/`):

  kernel_micro.json  one row per measurement;
  BENCH_kernel.json  oracle parity, pipeline parity, the sweep's rebuild
                     count and the tuned-vs-default times, under the keys
                     the JAX package's `benchmarks/run.py` gates;
  tuning_cache.json  the autotuner's winners for this device.

The tuner runs on a fresh in-memory cache (the committed cache must not
pre-answer its own benchmark), with `max_measure` 4, warm-up 1 and 3
repeats, and times the default blocks beside its top 4: `default_us` and
`tuned_us` come from that one pass, and the tuned config is the default
where nothing beat it (speedup 1).
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .. import device as device_mod
from ..apps import approx_ffn
from ..core.perforation import drop_fraction
from ..core.types import PerforationKind, PerforationParams
from ..kernels import _build, ops, ref, tuning
from ..obs import metrics as obs_metrics

FULL_GEOM = dict(seq=4096, d=2048, d_h=6144, heads=16)  # Qwen3-1.7B widths
REF_GEOM = dict(seq=128, d=32, d_h=64, heads=2)         # the JAX app's

# per geometry: the structural rows' shapes and blocks, and the tuning
# defaults (the blocks the app pins at that geometry; K4 is not in the app)
GEOMETRIES = {
    "ref": dict(
        app=REF_GEOM, mkn=(256, 256, 256), taf_blocks=(64, 64),
        iact=dict(rows=256, d_in=64, d_h=128, d_out=32, block_rows=32),
        pmm=dict(m=256, k=256, n=256, blocks=(64, 64, 64)),
        attn=dict(hq=4, hkv=2, sq=128, skv=256, d=64, block=64),
        defaults={
            "taf_matmul": {"block_m": 16, "block_n": 32},
            "iact_rowfn": {"block_rows": 16},
            "perforated_attention": {"block_q": 32, "block_kv": 32},
            "perforated_matmul": {"block_m": 64, "block_n": 64,
                                  "block_k": 64},
        }),
    "full": dict(
        app=FULL_GEOM, mkn=(4096, 2048, 2048), taf_blocks=(64, 64),
        iact=dict(rows=4096, d_in=2048, d_h=6144, d_out=2048,
                  block_rows=32),
        pmm=dict(m=4096, k=6144, n=2048, blocks=(128, 128, 128)),
        attn=dict(hq=16, hkv=8, sq=4096, skv=4096, d=128, block=64),
        defaults={
            "taf_matmul": {"block_m": 16, "block_n": 2048},
            "iact_rowfn": {"block_rows": 16},
            "perforated_attention": {"block_q": 32, "block_kv": 32},
            "perforated_matmul": {"block_m": 64, "block_n": 64,
                                  "block_k": 128},
        }),
}


def _tensor(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)


def tuning_arrays(geometry: str, dev: torch.device) -> Dict[str, tuple]:
    """kernel -> operands at the geometry its tuning defaults come from:
    the app's operands (`approx_ffn.kernel_operands`) for K1-K3, and K4's
    own shape (random from seed 7)."""
    g = GEOMETRIES[geometry]
    s = approx_ffn.kernel_operands(**g["app"], seed=7, device=dev)
    p = g["pmm"]
    rng = np.random.RandomState(7)
    xm = _tensor(rng.randn(p["m"], p["k"]), dev)
    wm = _tensor(rng.randn(p["k"], p["n"]), dev)
    return {
        "taf_matmul": (s["x"], s["wp"]),
        "iact_rowfn": (s["a"], s["w1"], s["w2"]),
        "perforated_attention": (s["q"], s["q"], s["q"]),
        "perforated_matmul": (xm, wm),
    }


def main(report: Callable[[str, str, str], None],
         artifacts_dir: Optional[str] = None, *, geometry: str = "ref",
         device=None) -> Dict:
    """Run every row on `device` (cuda unless the caller passes "cpu");
    returns the BENCH_kernel document."""
    dev = device_mod.resolve(device)
    g = GEOMETRIES[geometry]
    rows = []
    bench = {"metric": "kernel_micro",
             "substrate": tuning.current_substrate(dev),
             "machine": tuning.current_machine_name(dev),
             "device": device_mod.name(dev), "geometry": geometry}

    def _time(f, *args, warmup: int = 1, repeats: int = 3) -> float:
        """Median-of-k microseconds."""
        return tuning.measure_s(f, *args, warmup=warmup,
                                repeats=repeats) * 1e6

    def emit(name, us, derived, **structural):
        report(name, f"{us:.0f}", derived)
        rows.append(dict(name=name, us_per_call=round(us, 1), **structural))

    rng = np.random.RandomState(0)
    m, k, n = g["mkn"]
    x = _tensor(np.tile(rng.randn(1, k), (m, 1)), dev)
    w = _tensor(rng.randn(k, n), dev)
    bm, bn = g["taf_blocks"]

    matmul_flops = 2.0 * m * k * n
    us = _time(lambda a, b: ops.taf_matmul(a, b, block_m=bm, block_n=bn)[0],
               x, w)
    y, mask = ops.taf_matmul(x, w, block_m=bm, block_n=bn)
    yr, mr = ref.taf_matmul_ref(x, w, block_m=bm, block_n=bn,
                                history_size=3, prediction_size=8,
                                rsd_threshold=0.5)
    ok_taf = bool(torch.allclose(y, yr, rtol=1e-5, atol=1e-3)
                  and torch.equal(mask, mr))
    skipped = float(mask.float().mean())
    emit("kernel_taf_matmul", us,
         f"oracle_match={ok_taf},blocks_skipped={skipped:.0%}",
         oracle_match=ok_taf, executed_grid_fraction=1.0 - skipped,
         flops_total=matmul_flops,
         flops_executed=matmul_flops * (1.0 - skipped))

    # 4 distinct row-values, each spanning rows / 4 consecutive rows: the
    # later blocks of each run hit the table written by its first block
    c = g["iact"]
    x2 = _tensor(np.repeat(rng.randn(4, c["d_in"]), c["rows"] // 4, 0), dev)
    w1 = _tensor(rng.randn(c["d_in"], c["d_h"]).astype(np.float32) * 0.1,
                 dev)
    w2 = _tensor(rng.randn(c["d_h"], c["d_out"]).astype(np.float32) * 0.1,
                 dev)
    br = c["block_rows"]
    ffn_flops = 2.0 * c["rows"] * c["d_h"] * (c["d_in"] + c["d_out"])
    us = _time(lambda a: ops.iact_rowfn(a, w1, w2, block_rows=br)[0], x2)
    y2, m2 = ops.iact_rowfn(x2, w1, w2, block_rows=br)
    y2r, m2r = ref.iact_rowfn_ref(x2, w1, w2, block_rows=br, table_size=4,
                                  threshold=0.5)
    ok_iact = bool(torch.allclose(y2, y2r, rtol=1e-5, atol=1e-3)
                   and torch.equal(m2, m2r))
    hit = float(m2.float().mean())
    emit("kernel_iact_rowfn", us,
         f"oracle_match={ok_iact},blocks_hit={hit:.0%}",
         oracle_match=ok_iact, executed_grid_fraction=1.0 - hit,
         flops_total=ffn_flops, flops_executed=ffn_flops * (1.0 - hit))
    bench["oracle_match"] = {"taf": ok_taf, "iact": ok_iact}
    bench["executed_grid_fraction"] = {"taf": 1.0 - skipped,
                                       "iact": 1.0 - hit}

    p = g["pmm"]
    pbm, pbn, pbk = p["blocks"]
    if (p["m"], p["k"], p["n"]) == (m, k, n):
        xm, wm = x, w
    else:
        xm = _tensor(rng.randn(p["m"], p["k"]), dev)
        wm = _tensor(rng.randn(p["k"], p["n"]), dev)
    pmm_flops = 2.0 * p["m"] * p["k"] * p["n"]
    for skip in (2, 4, 8):
        pp = PerforationParams(kind=PerforationKind.SMALL, skip=skip)
        us = _time(lambda a, b: ops.perforated_matmul(
            a, b, block_m=pbm, block_n=pbn, block_k=pbk, perfo=pp), xm, wm)
        saved = drop_fraction(p["k"] // pbk, pp)
        emit("kernel_perforated_matmul", us,
             f"skip={skip},flops_saved={saved:.0%}",
             skip=skip, executed_grid_fraction=1.0 - saved,
             flops_total=pmm_flops,
             flops_executed=pmm_flops * (1.0 - saved))

    a = g["attn"]
    q = _tensor(rng.randn(1, a["hq"], a["sq"], a["d"]), dev)
    kk = _tensor(rng.randn(1, a["hkv"], a["skv"], a["d"]), dev)
    v = _tensor(rng.randn(1, a["hkv"], a["skv"], a["d"]), dev)
    ab = a["block"]
    attn_flops = 4.0 * a["hq"] * a["sq"] * a["skv"] * a["d"]
    for fr in (0.0, 0.5):
        pp = (None if fr == 0.0 else
              PerforationParams(kind=PerforationKind.INI, fraction=fr))
        us = _time(lambda q_, k_, v_: ops.perforated_attention(
            q_, k_, v_, block_q=ab, block_kv=ab, perfo=pp), q, kk, v)
        emit("kernel_perforated_attention", us, f"ini_drop={fr:.0%}",
             ini_drop=fr, executed_grid_fraction=1.0 - fr,
             flops_total=attn_flops, flops_executed=attn_flops * (1.0 - fr))

    # pipeline parity: both values of `pipeline=` must give bit-equal
    # outputs and masks (here they run the same launch path)
    def _eq(u, w_):
        if isinstance(u, tuple):
            return all(_eq(a_, b_) for a_, b_ in zip(u, w_))
        return bool(torch.equal(u, w_))

    pperfo = PerforationParams(kind=PerforationKind.SMALL, skip=2)
    parity = {
        "taf_matmul": _eq(
            ops.taf_matmul(x, w, block_m=bm, block_n=bn, pipeline=True),
            ops.taf_matmul(x, w, block_m=bm, block_n=bn, pipeline=False)),
        "perforated_matmul": _eq(
            ops.perforated_matmul(xm, wm, block_m=pbm, block_n=pbn,
                                  block_k=pbk, perfo=pperfo, pipeline=True),
            ops.perforated_matmul(xm, wm, block_m=pbm, block_n=pbn,
                                  block_k=pbk, perfo=pperfo,
                                  pipeline=False)),
        "perforated_attention": _eq(
            ops.perforated_attention(q, kk, v, block_q=ab, block_kv=ab,
                                     perfo=None, pipeline=True),
            ops.perforated_attention(q, kk, v, block_q=ab, block_kv=ab,
                                     perfo=None, pipeline=False)),
    }
    bench["pipeline_parity"] = parity
    report("kernel_pipeline_parity", "0",
           ",".join(f"{k2}={v2}" for k2, v2 in sorted(parity.items())))

    # knob sweep: the threshold is a device tensor, so 16 thresholds run on
    # the library already built -- zero kernel-library builds
    ops.taf_matmul(x, w, block_m=bm, block_n=bn, rsd_threshold=0.1)
    before = _build.builds
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    n_sweep = 16
    for th in np.linspace(0.05, 2.0, n_sweep):
        ops.taf_matmul(x, w, block_m=bm, block_n=bn,
                       rsd_threshold=float(th))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    us = (time.perf_counter() - t0) * 1e6 / n_sweep
    recompiles = _build.builds - before
    emit("kernel_taf_threshold_sweep", us,
         f"n={n_sweep},recompiles={recompiles}",
         n_sweep=n_sweep, recompiles=int(recompiles))
    bench["sweep"] = {"n": n_sweep, "recompiles": int(recompiles)}

    # block-shape autotuning vs the default blocks, on the geometry the
    # defaults were written for (a fresh in-memory cache per run). The
    # tuner times the default beside its top 4 in one pass and keeps the
    # fastest, so the speedup is >= 1 and is 1 where the default wins.
    cache = tuning.TuningCache()
    tune = {}
    for kernel, arrays in tuning_arrays(geometry, dev).items():
        default = g["defaults"][kernel]
        tuned = tuning.autotune(kernel, *arrays, cache=cache,
                                max_measure=4, warmup=1, repeats=3,
                                baseline=default)
        entry = cache.get(tuning.cache_key(
            kernel,
            tuning.key_shapes(kernel, tuning.operand_shapes(arrays)),
            tuning.dtype_name(arrays[0].dtype),
            tuning.current_machine_name(dev), tuning.current_substrate(dev)))
        tuned_us = float(entry["us"])
        default_us = float(entry["baseline_us"])
        counter = ops.KERNELS[kernel].COUNTER
        before = counter.launches
        tuning.build_call(kernel, tuned)(*arrays)
        speedup = default_us / max(tuned_us, 1e-9)
        tune[kernel] = {
            "default": default, "tuned": tuned,
            "default_us": round(default_us, 1),
            "tuned_us": round(tuned_us, 1),
            "speedup": round(speedup, 3),
            "candidates": entry["candidates"],
            "measured": entry["measured"],
            "predicted_us": entry["predicted_us"],
            "tuned_launches": counter.launches - before,
            "shapes": entry["shapes"],
        }
        emit(f"kernel_tuned_{kernel}", tuned_us,
             f"default_us={default_us:.0f},speedup={speedup:.2f}x,"
             f"blocks={'/'.join(str(v2) for _, v2 in sorted(tuned.items()))}",
             tuned=tuned, default=default, speedup=round(speedup, 3))
    tune["all_beat_default"] = bool(all(
        v2["speedup"] > 1.0 for v2 in tune.values() if isinstance(v2, dict)))
    bench["tuning"] = tune
    report("kernel_tuning_all_beat_default", "0",
           str(tune["all_beat_default"]))

    if artifacts_dir:
        os.makedirs(artifacts_dir, exist_ok=True)
        path = os.path.join(artifacts_dir, "kernel_micro.json")
        with open(path, "w") as f:
            json.dump(rows, f, indent=1)
        report("kernel_micro_json", "0", path)
        bpath = os.path.join(artifacts_dir, "BENCH_kernel.json")
        with open(bpath, "w") as f:
            json.dump(obs_metrics.stamp(bench), f, indent=1)
        report("BENCH_kernel_json", "0", bpath)
        cpath = cache.save(os.path.join(artifacts_dir, "tuning_cache.json"))
        report("tuning_cache_json", "0", cpath)
    return bench


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--geometry", choices=sorted(GEOMETRIES), default="ref")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--out", default="chiprun_out/kernel_micro",
                    help="artifacts directory")
    args = ap.parse_args()
    main(lambda name, v, d: print(f"{name},{v},{d}", flush=True),
         args.out, geometry=args.geometry, device=args.device)
