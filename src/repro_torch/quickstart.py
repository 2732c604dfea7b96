"""Quickstart: the HPAC-Offload programming model in five minutes (port of
`examples/quickstart.py`).

    PYTHONPATH=src python -m repro_torch.quickstart [--device cuda|cpu]

Shows (1) pragma-style region annotation (TAF), (2) herded loop
perforation, (3) the design-space sweep harness, and (4) a CUDA kernel:
K2 `taf_matmul` held against its plain version (on the CPU the wrapper runs
that plain version). Sections 1-3 print the same values as the JAX script;
everything runs on `device`, ``cuda`` unless the caller passes ``"cpu"``.
"""
from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

from . import convert, device as device_mod
from .core import (ApproxRegion, ApproxSpec, Level, PerforationKind,
                   PerforationParams, Technique, parse_pragma,
                   perforated_loop)
from .core.harness import ApproxApp, AppResult, mape, sweep, taf_grid
from .kernels import ops, ref
from .obs import timing


def foo(x: torch.Tensor) -> torch.Tensor:
    """An "expensive device function": (N, 4) -> (N,)."""
    return torch.sum(torch.sin(x) * torch.cos(x) ** 2, dim=-1)


def main(device=None) -> Dict:
    """Run the four sections on `device`, print what the JAX script prints
    (plus K2's mask check), and return the values."""
    dev = device_mod.resolve(device)
    out = {}

    # ------------------------------------------------------------------ (1)
    # A C++ HPAC-Offload pragma...
    #   #pragma approx memo(out:3:8:0.5) level(thread)
    # ...is this spec:
    spec = parse_pragma("memo(out:3:8:0.5) level(thread)")
    print("parsed spec:", spec.technique.value, spec.taf)
    # the state machines run on `dev` (the "host" substrate: no kernel)
    region = ApproxRegion(spec, foo, n_elements=64, in_dim=4,
                          substrate="host", device=dev)
    xs = convert.to_tensor(np.random.RandomState(0).standard_normal(
        (100, 64, 4)) * 0.01, dev) + 1.0  # slowly varying => TAF-friendly
    ys, frac = region.run(xs)
    exact = torch.stack([foo(x) for x in xs])
    out["taf_fraction"] = float(frac)
    out["taf_mape"] = mape(exact.cpu().numpy(), ys.cpu().numpy())
    print(f"TAF: approximated {out['taf_fraction']:.0%} of invocations, "
          f"MAPE {out['taf_mape']:.4%}")

    # ------------------------------------------------------------------ (2)
    # herded loop perforation: structurally shorter loop, uniform control
    pspec = ApproxSpec(Technique.PERFORATION,
                       perforation=PerforationParams(
                           kind=PerforationKind.SMALL, skip=4))
    total, kept = perforated_loop(
        pspec, 32, lambda i, acc: acc + float(i),
        torch.zeros((), device=dev))
    out["perforated_sum"], out["perforated_kept"] = float(total), kept
    print(f"perforated sum over 32 iters (skip 1-of-4): {float(total)} "
          f"(executed {kept:.0%})")

    # ------------------------------------------------------------------ (3)
    # the DSE harness: sweep TAF parameters over an app, Figure-6 style
    def run(s: ApproxSpec) -> AppResult:
        r = ApproxRegion(s, foo, n_elements=64, in_dim=4, substrate="host",
                         device=dev)
        m = timing.measure(r.run, xs, device=dev, warmup=0, repeats=1)
        ys_, frac_ = m.value
        return AppResult(qoi=ys_.cpu().numpy(), wall_time_s=m.seconds,
                         approx_fraction=float(frac_),
                         flop_fraction=max(1 - float(frac_), 1e-3))

    app = ApproxApp("quickstart", run)
    records = sweep(app, taf_grid(h_sizes=(2, 3), p_sizes=(8, 64),
                                  thresholds=(0.1, 1.0),
                                  levels=(Level.ELEMENT,)), repeats=1)
    best = max((r for r in records if r.error < 0.1),
               key=lambda r: r.modeled_speedup)
    out["best"] = dict(spec=best.spec, modeled_speedup=best.modeled_speedup,
                       error=best.error)
    print(f"best config under 10% error: {best.spec} -> "
          f"modeled {best.modeled_speedup:.2f}x at {best.error:.2%} error")

    # ------------------------------------------------------------------ (4)
    # K2, the TAF matmul kernel, against its plain version
    x = convert.to_tensor(np.random.RandomState(1).standard_normal(
        (256, 128)).astype(np.float32) * 0.01 + 1.0, dev)
    w = convert.to_tensor(np.random.RandomState(2).standard_normal(
        (128, 128)).astype(np.float32), dev)
    y, mask = ops.taf_matmul(x, w, block_m=64, block_n=64,
                             rsd_threshold=1.0)
    y_ref, mask_ref = ref.taf_matmul_ref(x, w, block_m=64, block_n=64,
                                         history_size=3, prediction_size=8,
                                         rsd_threshold=1.0)
    out["k2_matches"] = bool(torch.allclose(y, y_ref, rtol=0.0, atol=1e-4)
                             and torch.equal(mask, mask_ref))
    out["k2_approx_blocks"] = float(mask.float().mean())
    print(f"taf_matmul kernel == oracle: {out['k2_matches']}; "
          f"blocks approximated: {out['k2_approx_blocks']:.0%} "
          f"({device_mod.name(dev)})")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
