"""Named machine profiles (port of `repro.analysis.machine`).

The autotuner's cost-model prune composes a time estimate from roofline
terms over one profile:

  compute_s    = FLOPs / peak_flops
  memory_s     = bytes / hbm_bw
  collective_s = collective_bytes / ici_bw

plus `dispatch_s` per kernel launch: the fixed cost that floors the runtime
of a call made of many small launches.

Profiles:

  h100      -- one NVIDIA H100 SXM (NVIDIA's data sheet): 67 TFLOP/s
               float32 outside the tensor cores (the rate K2 and K3 compute
               at; K1 and K4 take three TF32 products per float32
               operation on the tensor cores, which the profile does not
               model), 3.35 TB/s HBM3, NVLink 450 GB/s each way.
               `dispatch_s` is the median of three `measure_machine`
               readings on an H100 80GB HBM3 at a 700 W power limit
               (`chip_smoke.py` phase 7), each the median of 100 calls of
               one eager PyTorch op between CUDA events, host dispatch
               included.
  host-sim  -- the JAX package's host profile, copied: the CPU the plain
               versions run on.

`SUBSTRATE_MACHINES` maps the port's substrates ("cuda", "host") to them.
`get_machine("measured")` calibrates the running device on first use; that
profile is process-local, and tuning caches never key on it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Union


@dataclasses.dataclass(frozen=True)
class MachineProfile:
    """Roofline parameters of one execution substrate."""

    name: str
    peak_flops: float        # FLOP/s per device
    hbm_bw: float            # bytes/s per device
    ici_bw: float            # bytes/s per link
    dispatch_s: float = 0.0  # fixed per-launch dispatch overhead

    def time_s(self, flops: float, bytes_: float = 0.0,
               coll_bytes: float = 0.0, invocations: float = 1.0) -> float:
        """Roofline time: max of the three terms, plus dispatch."""
        t = max(flops / self.peak_flops,
                bytes_ / self.hbm_bw,
                coll_bytes / self.ici_bw)
        return t + invocations * self.dispatch_s


H100 = "h100"
HOST_SIM = "host-sim"

MACHINES: Dict[str, MachineProfile] = {
    H100: MachineProfile(name=H100, peak_flops=67e12, hbm_bw=3.35e12,
                         ici_bw=450e9, dispatch_s=1.3408e-05),
    HOST_SIM: MachineProfile(name=HOST_SIM, peak_flops=100e9, hbm_bw=40e9,
                             ici_bw=10e9, dispatch_s=20e-6),
}

DEFAULT_MACHINE = H100

# substrate name (repro_torch.core.substrate) -> machine profile name
SUBSTRATE_MACHINES: Dict[str, str] = {
    "cuda": H100,
    "host": HOST_SIM,
}

# timed calls behind one dispatch_s reading
DISPATCH_REPEATS = 100

# the calibrated profile's reserved name: get_machine("measured") measures
# the running device on first use (see measure_machine)
MEASURED_MACHINE = "measured"


def measure_machine(name: str = MEASURED_MACHINE, *, device=None,
                    size: int = 384, copy_mb: int = 8, repeats: int = 3,
                    register: bool = True) -> MachineProfile:
    """Calibrate a roofline profile on `device` (cuda unless the caller
    passes "cpu").

    Three median-of-k measurements through `obs.timing.measure` (CUDA
    events on the card, each after a warm-up call):

      peak_flops -- a (size, size) float32 matmul: 2 * size^3 FLOPs;
      hbm_bw     -- one elementwise scale over copy_mb MiB (read + write);
      dispatch_s -- one scalar add, median of `DISPATCH_REPEATS` calls:
                    the launch floor (a single call varies by a few
                    times).

    `ici_bw` is the static profile's (one device cannot observe it). The
    result is registered in `MACHINES` under `name`; it is never a tuning
    cache key.
    """
    import numpy as np
    import torch

    from .. import device as device_mod
    from ..obs.timing import measure

    dev = device_mod.resolve(device)

    def _med(fn, *args, k=repeats):
        return measure(fn, *args, device=dev, warmup=1,
                       repeats=max(1, k), stat="median",
                       span="machine.calibrate").seconds

    rng = np.random.RandomState(0)
    a = torch.from_numpy(rng.randn(size, size).astype(np.float32)).to(dev)
    t_mm = _med(torch.matmul, a, a)
    peak_flops = max(2.0 * size ** 3 / max(t_mm, 1e-9), 1e9)

    buf = torch.from_numpy(rng.randn(copy_mb * (1 << 20) // 4)
                           .astype(np.float32)).to(dev)
    t_cp = _med(torch.mul, buf, 1.0000001)
    hbm_bw = max(2.0 * buf.numel() * 4 / max(t_cp, 1e-9), 1e8)

    one = torch.zeros((), dtype=torch.float32, device=dev)
    dispatch_s = max(_med(torch.add, one, 1.0, k=DISPATCH_REPEATS), 1e-7)

    base = SUBSTRATE_MACHINES["cuda" if dev.type == "cuda" else "host"]
    profile = MachineProfile(name=name, peak_flops=peak_flops,
                             hbm_bw=hbm_bw, ici_bw=MACHINES[base].ici_bw,
                             dispatch_s=dispatch_s)
    if register:
        MACHINES[name] = profile
    return profile


def get_machine(machine: Union[str, MachineProfile, None] = None
                ) -> MachineProfile:
    """Resolve a profile by name (or pass one through). None gives the
    default profile; substrate names ("cuda" / "host") map through
    `SUBSTRATE_MACHINES`; "measured" calibrates the running device on first
    use and stays in `MACHINES` for the rest of the process."""
    if machine is None:
        machine = DEFAULT_MACHINE
    if isinstance(machine, MachineProfile):
        return machine
    name = SUBSTRATE_MACHINES.get(machine, machine)
    if name == MEASURED_MACHINE and name not in MACHINES:
        return measure_machine()
    if name not in MACHINES:
        raise KeyError(
            f"unknown machine profile {machine!r} "
            f"(choose from: {', '.join(sorted(MACHINES))} "
            f"or '{MEASURED_MACHINE}')")
    return MACHINES[name]
