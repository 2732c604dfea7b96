"""repro_torch.core -- the programming model and the sweep harness.

  types        -- ApproxSpec / TAFParams / IACTParams / PerforationParams
  perforation  -- skip patterns (host numpy and device-tensor masks)
  substrate    -- "host" oracles vs "cuda" kernels + region evaluators
  harness      -- the DSE harness + error metrics (MAPE, MCR)
  batching     -- group specs by static structure, one lane loop per group
  pareto       -- error/speedup Pareto front and hypervolume
"""
from . import types, perforation  # noqa: F401  (first: kernels import them)
from . import batching, harness, pareto, substrate  # noqa: F401
