"""Parameter types for the HPAC-Offload programming model.

These dataclasses mirror the paper's pragma clauses one-to-one:

    #pragma approx memo(out:hSize:pSize:rsdThresh) level(thread)
        -> TAFParams(history_size=hSize, prediction_size=pSize,
                     rsd_threshold=rsdThresh), level=Level.ELEMENT

    #pragma approx memo(in:tsize:thresh:tperwarp) level(warp)
        -> IACTParams(table_size=tsize, threshold=thresh,
                      tables_per_block=tperwarp), level=Level.TILE

    #pragma approx perfo(small:M) / perfo(large:M) / perfo(ini:f) / perfo(fini:f)
        -> PerforationParams(kind=..., skip=M or fraction=f)

A copy of `repro.core.types` (the JAX package): enum values, defaults and
`parse_pragma` are identical, so specs and DB rows round-trip between the
two packages. On the GPU the hierarchy is the paper's own: thread /
32-thread warp / CUDA block (team).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class Technique(enum.Enum):
    """Which approximate-computing technique a region uses."""

    NONE = "none"
    TAF = "taf"          # output memoization (temporal approximate function)
    IACT = "iact"        # input memoization
    PERFORATION = "perfo"


class Level(enum.Enum):
    """Hierarchical decision level (paper: thread / warp / team).

    ELEMENT -- per element (GPU thread). Quality knob only: masked
               elements still execute, so no FLOPs are saved.
    TILE    -- per tile (GPU warp): the unit of uniform control.
    BLOCK   -- per kernel block (CUDA block): decisions at this level
               skip whole tile products in the port's kernels.
    """

    ELEMENT = "element"  # paper: thread
    TILE = "tile"        # paper: warp
    BLOCK = "block"      # paper: team


class PerforationKind(enum.Enum):
    SMALL = "small"  # skip one of every M iterations
    LARGE = "large"  # execute one of every M iterations
    INI = "ini"      # skip the first `fraction` of iterations
    FINI = "fini"    # skip the last `fraction` of iterations
    RANDOM = "random"  # paper's HPAC also supports rand; kept for parity


@dataclasses.dataclass(frozen=True)
class TAFParams:
    """Temporal Approximate Function memoization (output memoization).

    history_size:    paper hSize -- sliding window length used for RSD.
    prediction_size: paper pSize -- number of approximated invocations once
                     the stable regime is entered.
    rsd_threshold:   enter the stable regime when RSD(window) < threshold.
    """

    history_size: int = 3
    prediction_size: int = 8
    rsd_threshold: float = 0.5

    def __post_init__(self):
        if self.history_size < 1:
            raise ValueError("history_size must be >= 1")
        if self.prediction_size < 1:
            raise ValueError("prediction_size must be >= 1")
        if self.rsd_threshold < 0:
            raise ValueError("rsd_threshold must be >= 0")


@dataclasses.dataclass(frozen=True)
class IACTParams:
    """Approximate input memoization (iACT).

    table_size:       paper tsize -- entries per memo table.
    threshold:        Euclidean-distance activation threshold.
    tables_per_block: paper tperwarp: how many independent tables serve one
                      decision tile. 0 means "one table per element"
                      (paper default: one per thread).
    """

    table_size: int = 4
    threshold: float = 0.5
    tables_per_block: int = 1

    def __post_init__(self):
        if self.table_size < 1:
            raise ValueError("table_size must be >= 1")
        if self.threshold < 0:
            raise ValueError("threshold must be >= 0")
        if self.tables_per_block < 0:
            raise ValueError("tables_per_block must be >= 0")


@dataclasses.dataclass(frozen=True)
class PerforationParams:
    """Loop perforation.

    kind:     small / large / ini / fini / random.
    skip:     M for small ("skip 1 of every M") and large ("run 1 of every M").
    fraction: for ini/fini/random -- fraction of iterations dropped.
    herded:   paper section 3.1.5 -- when True every element drops the SAME
              iterations, keeping control flow uniform (no divergence: this
              is what makes the skipped tiles actually free).
    """

    kind: PerforationKind = PerforationKind.SMALL
    skip: int = 4
    fraction: float = 0.25
    herded: bool = True
    seed: int = 0  # for kind=RANDOM

    def __post_init__(self):
        if self.skip < 2 and self.kind in (PerforationKind.SMALL, PerforationKind.LARGE):
            raise ValueError("skip must be >= 2 for small/large perforation")
        if not (0.0 <= self.fraction < 1.0):
            raise ValueError("fraction must be in [0, 1)")


@dataclasses.dataclass(frozen=True)
class ApproxSpec:
    """Everything a `#pragma approx` line carries, as one object.

    This is the unit stored in architecture configs (`approx:` block) and
    consumed by the substrate's region evaluators.
    """

    technique: Technique = Technique.NONE
    level: Level = Level.ELEMENT
    taf: Optional[TAFParams] = None
    iact: Optional[IACTParams] = None
    perforation: Optional[PerforationParams] = None

    def __post_init__(self):
        if self.technique == Technique.TAF and self.taf is None:
            object.__setattr__(self, "taf", TAFParams())
        if self.technique == Technique.IACT and self.iact is None:
            object.__setattr__(self, "iact", IACTParams())
        if self.technique == Technique.PERFORATION and self.perforation is None:
            object.__setattr__(self, "perforation", PerforationParams())

    @property
    def enabled(self) -> bool:
        return self.technique != Technique.NONE


def parse_pragma(text: str) -> ApproxSpec:
    """Parse a paper-style pragma string into an ApproxSpec.

    Accepted grammar (whitespace-insensitive), mirroring Figure 5 of the paper:

        "memo(out:H:P:T) level(thread|warp|team)"
        "memo(in:S:T:W) level(...)"
        "perfo(small:M)" | "perfo(large:M)" | "perfo(ini:F)" | "perfo(fini:F)"

    This keeps the familiar idiom available to users porting HPAC pragmas.
    """
    text = text.strip()
    level = Level.ELEMENT
    lowered = text.replace(" ", "")
    if "level(" in lowered:
        inside = lowered.split("level(", 1)[1].split(")", 1)[0]
        level = {"thread": Level.ELEMENT, "warp": Level.TILE, "team": Level.BLOCK,
                 "element": Level.ELEMENT, "tile": Level.TILE, "block": Level.BLOCK}[inside]
    if "memo(out:" in lowered:
        args = lowered.split("memo(out:", 1)[1].split(")", 1)[0].split(":")
        h, p = int(args[0]), int(args[1])
        t = float(args[2]) if len(args) > 2 else 0.5
        return ApproxSpec(Technique.TAF, level,
                          taf=TAFParams(history_size=h, prediction_size=p, rsd_threshold=t))
    if "memo(in:" in lowered:
        args = lowered.split("memo(in:", 1)[1].split(")", 1)[0].split(":")
        s = int(args[0])
        t = float(args[1]) if len(args) > 1 else 0.5
        w = int(args[2]) if len(args) > 2 else 1
        return ApproxSpec(Technique.IACT, level,
                          iact=IACTParams(table_size=s, threshold=t, tables_per_block=w))
    if "perfo(" in lowered:
        args = lowered.split("perfo(", 1)[1].split(")", 1)[0].split(":")
        kind = PerforationKind(args[0])
        if kind in (PerforationKind.SMALL, PerforationKind.LARGE):
            return ApproxSpec(Technique.PERFORATION, level,
                              perforation=PerforationParams(kind=kind, skip=int(args[1])))
        return ApproxSpec(Technique.PERFORATION, level,
                          perforation=PerforationParams(kind=kind, fraction=float(args[1])))
    if lowered in ("", "none"):
        return ApproxSpec()
    raise ValueError(f"unrecognized pragma: {text!r}")
