"""repro_torch.core -- the programming model and the sweep harness (port of
`repro.core`).

  types        -- ApproxSpec / TAFParams / IACTParams / PerforationParams /
                  Level
  approx       -- ApproxRegion (the "pragma"), parse_pragma, perforated_loop
  taf / iact   -- technique state machines (NamedTuple states of tensors)
  perforation  -- skip patterns (host numpy and device-tensor masks)
  hierarchy    -- element/tile/block majority-rules voting
  rsd          -- TAF's activation statistic
  substrate    -- "host" state machines and oracles vs "cuda" kernels, and
                  the kernel-backed region evaluators
  harness      -- the DSE harness + error metrics (MAPE, MCR)
  batching     -- group specs by static structure, one lane loop per group
  pareto       -- error/speedup Pareto front + front-guided refinement
  autotune     -- successive halving and random search over specs
"""
from . import types, perforation  # noqa: F401  (first: kernels import them)
from . import (approx, autotune, batching, harness,  # noqa: F401
               hierarchy, iact, pareto, rsd, substrate, taf)
from .approx import ApproxRegion, perforated_loop  # noqa: F401
from .types import (ApproxSpec, IACTParams, Level,  # noqa: F401
                    PerforationKind, PerforationParams, TAFParams,
                    Technique, parse_pragma)

__all__ = [
    "approx", "autotune", "batching", "harness", "hierarchy", "iact",
    "pareto", "perforation", "rsd", "substrate", "taf",
    "types", "ApproxRegion", "perforated_loop", "ApproxSpec", "IACTParams",
    "Level", "PerforationKind", "PerforationParams", "TAFParams", "Technique",
    "parse_pragma",
]
