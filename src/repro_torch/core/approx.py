"""The HPAC-Offload "pragma" as a PyTorch region API (port of
`repro.core.approx`).

A C++ HPAC-Offload region:

    #pragma approx memo(in:2:0.5f:4) level(warp)
    output[i] = foo(&input[5*i], 5, N);

becomes:

    spec = parse_pragma("memo(in:2:0.5:4) level(warp)")   # or ApproxSpec(..)
    region = ApproxRegion(spec, foo_batched, n_elements=N, in_dim=5,
                          substrate="host")
    out, st, mask = region.step(region.init_state(), x)   # one invocation
    ys, frac = region.run(xs)                             # a sequence

`ApproxRegion` owns the technique state (TAF window / iACT tables) the way
the HPAC runtime owns the per-thread AC state, as an explicit NamedTuple of
tensors. Perforation is loop-shaped rather than region-shaped;
`perforated_loop` and `perforation.kept_indices` cover it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .. import device as device_mod
from . import hierarchy
from . import iact as iact_mod
from . import perforation as perfo_mod
from . import substrate as substrate_mod
from . import taf as taf_mod
from .types import ApproxSpec, Level, Technique, parse_pragma  # re-export

__all__ = [
    "ApproxSpec", "ApproxRegion", "Level", "parse_pragma", "perforated_loop",
]


@dataclasses.dataclass
class ApproxRegion:
    """An approximated code region (the dynamic extent of one pragma).

    fn: the accurate path, batched over elements: (N, in_dim) -> (N, *out)
    for IACT, or a thunk () -> (N, *out) for TAF when no input is given (TAF
    memoizes on *outputs*).

    `substrate`: None resolves the ambient default at call time (see
    `core.substrate`; "cuda" unless `$REPRO_SUBSTRATE` or `use(...)` says
    otherwise), "host" / "cuda" pin one. "host" runs the technique state
    machines of `core.taf` / `core.iact` on the region's `device`. "cuda"
    needs a kernel implementation of THIS region's fn,
    `cuda_impl(x, *, rsd_threshold=None, threshold=None) -> (out,
    approx_mask)`, typically a partial over `substrate.taf_matmul_region`
    (K2) or `substrate.iact_ffn_region` (K3): the counterpart of the JAX
    package's `pallas_impl`. `device`: where `init_state` puts the state,
    ``cuda`` unless the caller passes ``"cpu"``.
    """

    spec: ApproxSpec
    fn: Callable
    n_elements: int
    in_dim: int = 1
    out_shape: Tuple[int, ...] = ()
    out_dtype: torch.dtype = torch.float32
    tile_size: Optional[int] = None
    substrate: Optional[str] = None
    cuda_impl: Optional[Callable] = None
    device: Optional[str] = None

    def _on_kernels(self) -> bool:
        if self.spec.technique not in (Technique.TAF, Technique.IACT):
            return False
        sub = substrate_mod.resolve(self.substrate)
        if sub == substrate_mod.CUDA and self.cuda_impl is None:
            raise ValueError(
                "substrate='cuda' needs a cuda_impl: a kernel-backed "
                "implementation of this region (see repro_torch.core."
                "substrate)")
        return sub == substrate_mod.CUDA

    def init_state(self):
        dev = device_mod.resolve(self.device)
        t = self.spec.technique
        if t == Technique.TAF:
            return taf_mod.init(self.spec.taf, self.n_elements,
                                self.out_shape, self.out_dtype, dev)
        if t == Technique.IACT:
            n_tab = iact_mod.n_tables_for(self.spec.iact, self.n_elements)
            return iact_mod.init(self.spec.iact, n_tab, self.in_dim,
                                 self.out_shape, self.out_dtype, dev)
        return ()

    def _check_hooks(self, rsd_threshold, threshold):
        """Knob hooks are technique-specific: passing one the technique
        cannot honour is a spec bug, not a silent no-op."""
        t = self.spec.technique
        if rsd_threshold is not None and t != Technique.TAF:
            raise ValueError(
                f"rsd_threshold is a TAF hook; region technique is {t}")
        if threshold is not None and t != Technique.IACT:
            raise ValueError(
                f"threshold is an iACT hook; region technique is {t}")

    def step(self, state, x: Optional[torch.Tensor] = None, *,
             rsd_threshold=None, threshold=None):
        """Single invocation -> (out, new_state, approx_mask).

        `rsd_threshold` (TAF) / `threshold` (iACT) override the spec's
        value (a float or a 0-d tensor). On the "cuda" substrate the kernel
        implementation is called (one kernel call = one invocation); the
        kernel owns its AC state, so `state` passes through unchanged.
        """
        self._check_hooks(rsd_threshold, threshold)
        t = self.spec.technique
        # only the memoization techniques dispatch to a kernel: NONE runs
        # its fn on any substrate, and PERFORATION keeps its "use
        # perforated_loop" contract on both
        if self._on_kernels():
            out, mask = self.cuda_impl(x, rsd_threshold=rsd_threshold,
                                       threshold=threshold)
            return out, state, mask
        if t == Technique.TAF:
            thunk = (lambda: self.fn(x)) if x is not None else self.fn
            return taf_mod.step(state, thunk, self.spec.taf, self.spec.level,
                                tile_size=self.tile_size,
                                rsd_threshold=rsd_threshold)
        if t == Technique.IACT:
            return iact_mod.step(state, x, self.fn, self.spec.iact,
                                 self.spec.level, tile_size=self.tile_size,
                                 threshold=threshold)
        if t == Technique.NONE:
            y = self.fn(x) if x is not None else self.fn()
            return y, state, torch.zeros((self.n_elements,),
                                         dtype=torch.bool, device=y.device)
        raise ValueError(f"ApproxRegion.step does not handle {t}; use "
                         "perforated_loop for perforation")

    def run(self, xs: torch.Tensor, *, rsd_threshold=None, threshold=None):
        """Run a whole invocation sequence (T, N, ...).

        Accepts the same hooks as `step`. Returns (outputs,
        approx_fraction), the fraction a 0-d tensor on the outputs' device.
        On the "cuda" substrate one kernel call IS the invocation sequence
        (the kernel's sequential row-block axis is the paper's temporal
        loop): `xs` is passed whole and the kernel's mask gives the
        fraction.
        """
        self._check_hooks(rsd_threshold, threshold)
        t = self.spec.technique
        if self._on_kernels():
            ys, mask = self.cuda_impl(xs, rsd_threshold=rsd_threshold,
                                      threshold=threshold)
            return ys, hierarchy.fraction(mask)
        if t == Technique.TAF:
            ys, _, frac = taf_mod.run_sequence(self.spec.taf, xs, self.fn,
                                               self.spec.level,
                                               tile_size=self.tile_size,
                                               rsd_threshold=rsd_threshold)
            return ys, frac
        if t == Technique.IACT:
            ys, _, frac = iact_mod.run_sequence(self.spec.iact, xs, self.fn,
                                                self.spec.level,
                                                tile_size=self.tile_size,
                                                threshold=threshold)
            return ys, frac
        if t == Technique.NONE:
            ys = torch.stack([self.fn(x) for x in xs])
            return ys, torch.zeros((), dtype=torch.float32, device=ys.device)
        raise ValueError(f"ApproxRegion.run does not handle {t}")


def perforated_loop(spec: ApproxSpec, n_iters: int,
                    body: Callable[[int, object], object], carry,
                    herded_structural: bool = True, fraction=None):
    """`for i in range(n): carry = body(i, carry)` with loop perforation.

    With herded perforation the kept-iteration set is static, so the loop
    runs over the kept subset only: skipped iterations are genuinely not
    executed. Returns (carry, executed_fraction).

    `fraction` (ini/fini/random kinds; a float or a 0-d tensor) overrides
    spec.perforation.fraction. Then the loop is the MASKED variant: every
    index is visited and the execute mask, built on the fraction's device
    (`perforation.traced_execute_mask`), gates the body with a select on
    the carry, so no value is read back to the host; the executed fraction
    is a 0-d tensor. The body then runs for every index and must return a
    carry of the same structure (a tensor or a tuple of tensors).
    """
    if spec.technique != Technique.PERFORATION:
        if fraction is not None:
            raise ValueError(
                f"fraction is a perforation hook; spec technique is "
                f"{spec.technique} (a hook the technique cannot honor is a "
                "spec bug, not a silent no-op)")
        for i in range(n_iters):
            carry = body(i, carry)
        return carry, 1.0
    p = spec.perforation
    if fraction is not None:
        mask = perfo_mod.traced_execute_mask(n_iters, p, fraction,
                                             device=_device_of(carry))
        for i in range(n_iters):
            carry = _select(mask[i], body(i, carry), carry)
        return carry, hierarchy.fraction(mask)
    if herded_structural and p.herded:
        keep = perfo_mod.kept_indices(n_iters, p)
        for i in keep:
            carry = body(int(i), carry)
        return carry, len(keep) / max(n_iters, 1)
    # non-herded / masked: every index is visited, but `body` is never
    # invoked for a skipped iteration (the mask is a host array here)
    mask = perfo_mod.execute_mask(n_iters, p)
    for i in range(n_iters):
        if mask[i]:
            carry = body(i, carry)
    return carry, float(np.mean(mask))


def _device_of(carry) -> Optional[torch.device]:
    """The device of the carry's first tensor leaf (None: the CPU)."""
    if isinstance(carry, (tuple, list)):
        for c in carry:
            dev = _device_of(c)
            if dev is not None:
                return dev
        return None
    return carry.device if isinstance(carry, torch.Tensor) else None


def _select(keep: torch.Tensor, new, old):
    """`new` where the 0-d bool `keep` holds, else `old`, leaf by leaf."""
    if isinstance(new, (tuple, list)):
        return type(new)(_select(keep, n, o) for n, o in zip(new, old))
    return torch.where(keep, new, old)
