"""repro_torch.analysis -- the roofline machine profiles and the kernel
cost counts the block-shape autotuner ranks candidates with.

  machine  -- named roofline profiles (the H100 and the host simulator),
              `measure_machine` to calibrate the running device
  cost     -- `CostVector` and `kernel_cost`, the FLOPs and bytes of one
              precise-path call of each kernel at a block config
"""
from . import cost, machine  # noqa: F401
