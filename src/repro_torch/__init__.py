"""repro_torch -- the PyTorch/CUDA port of the HPAC-Offload reproduction.

A second package beside the JAX one (`repro`), which stays the reference.
It imports torch, numpy and the standard library, never JAX and nothing of
`repro`. Module names mirror the JAX package's, so each part has an obvious
counterpart:

  core/       types, perforation, substrate ("host" oracles | "cuda"
              kernels), harness, batching, pareto
  kernels/    hand-written Hopper kernels (csrc/*.cu) behind `ops`, each
              with its plain PyTorch version in `ref`
  obs/        tracing, metrics and the CUDA-event timer
  apps/       approx_ffn, the kernel-backed app
  benchmarks/ the approx_ffn sweep and the per-kernel device profile
  convert     carries the JAX app's arrays into the port's tensors
  device      the device rule: cuda unless the caller asks for "cpu"
"""
from . import device  # noqa: F401
from .core.types import (ApproxSpec, IACTParams, Level,  # noqa: F401
                         PerforationKind, PerforationParams, TAFParams,
                         Technique, parse_pragma)
