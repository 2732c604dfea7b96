"""repro_torch -- the PyTorch/CUDA port of the HPAC-Offload reproduction.

A second package beside the JAX one (`repro`), which stays the reference.
It imports torch, numpy and the standard library, never JAX and nothing of
`repro`. Module names mirror the JAX package's, so each part has an obvious
counterpart:

  core/       types, perforation, rsd, hierarchy, the TAF / iACT state
              machines, approx (ApproxRegion, perforated_loop), substrate
              ("host" state machines and oracles | "cuda" kernels),
              harness, batching, pareto, autotune
  kernels/    hand-written Hopper kernels (csrc/*.cu) behind `ops`, each
              with its plain PyTorch version in `ref`; the block-shape
              autotuner (`tuning`)
  analysis/   roofline machine profiles and the kernels' cost counts
  obs/        tracing, metrics and the CUDA-event timer
  apps/       approx_ffn, the kernel-backed app, and the five HPC apps
              (blackscholes, binomial_options, kmeans, lavamd, minife_cg)
  benchmarks/ the approx_ffn sweep, fig6 / fig7, the per-kernel device
              profile and the kernel microbenchmarks (kernel_micro)
  convert     carries the JAX app's arrays and technique states into the
              port's tensors
  device      the device rule: cuda unless the caller asks for "cpu"
"""
from . import device  # noqa: F401
from .core.types import (ApproxSpec, IACTParams, Level,  # noqa: F401
                         PerforationKind, PerforationParams, TAFParams,
                         Technique, parse_pragma)
