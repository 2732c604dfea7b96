"""Offline Pareto DB -> online approximation policy (port of
`repro.qos.policy`, host logic line for line).

The harness establishes the paper's quality bound OFFLINE: `harness.sweep`
measures error after the fact and `pareto.pareto_front` extracts the
error/speedup trade-off curve. This module turns that curve into something
the serving path can act on: a **policy ladder** -- the front ordered from
precise to aggressive -- plus the `best_speedup_under_error`-style selection
that maps a quality target (max error under a metric, per request class) to
a concrete `ApproxSpec` and substrate choice.

Ladder invariants (what the controller relies on):

  * rung 0 is ALWAYS the precise spec (`ApproxSpec()`), error 0, speedup 1 --
    the hard-fallback anchor;
  * rungs ascend in offline error and (being a Pareto front) ascend in
    speedup, so "one rung toward 0" is strictly quality-improving and "one
    rung away" is strictly performance-improving;
  * every rung is serializable (the spec dict schema of `harness.Record`),
    so a chosen policy can be shipped, diffed, and reloaded.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence, Union

from ..core import pareto as pareto_mod
from ..core.harness import (ERROR_METRICS, load_db, spec_from_dict,
                            spec_hash, workload_hash)
from ..core.types import ApproxSpec, Technique

_PRECISE_SPEC = {"technique": "none", "level": "element"}


def _get(r, field, default=None):
    if isinstance(r, dict):
        return r.get(field, default)
    return getattr(r, field, default)


@dataclasses.dataclass(frozen=True)
class QosTarget:
    """A per-request-class quality contract: keep `metric` error below
    `max_error` (strict, matching `best_speedup_under_error`)."""

    max_error: float
    metric: str = "mape"
    request_class: str = "default"

    def __post_init__(self):
        if self.max_error <= 0:
            raise ValueError(
                "max_error must be > 0: the violation test is est >= "
                "max_error, so a 0 bound flags even bit-exact precise "
                "canaries (error 0.0) as violations -- serve without a "
                "QoS engine to run always-precise")
        if self.metric not in ERROR_METRICS:
            raise ValueError(
                f"unknown metric {self.metric!r}; expected one of "
                f"{sorted(ERROR_METRICS)}")

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class PolicyEntry:
    """One ladder rung: a spec and its offline-measured coordinates."""

    spec: Dict                   # harness spec-dict schema
    error: float                 # offline error under the policy's metric
    speedup: float               # measured wall-time speedup
    modeled_speedup: float       # structural (FLOP-bound) speedup
    spec_hash: str = ""

    def __post_init__(self):
        if not self.spec_hash:
            object.__setattr__(self, "spec_hash", spec_hash(self.spec))

    @property
    def precise(self) -> bool:
        return self.spec.get("technique", "none") == "none"

    def to_spec(self) -> ApproxSpec:
        return spec_from_dict(self.spec)

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class PolicyChoice:
    """A serialized selection: what `choose` picked for a target. This is
    the artifact a deployment ships (the spec the serving path will run,
    where it runs, and the contract it was picked under)."""

    entry: PolicyEntry
    index: int                   # ladder rung
    substrate: Optional[str]
    target: QosTarget

    def to_json(self) -> Dict:
        return {"entry": self.entry.to_json(), "index": self.index,
                "substrate": self.substrate, "target": self.target.to_json()}


class QosPolicy:
    """The ladder + selection logic. Build from records (`from_records`) or
    a harness DB (`from_db`); serialize with `save`/`load`."""

    def __init__(self, entries: Sequence[PolicyEntry], *, metric: str = "mape",
                 app: str = "", substrate: Optional[str] = None,
                 use_modeled: bool = False):
        if metric not in ERROR_METRICS:
            raise ValueError(f"unknown metric {metric!r}")
        self.metric = metric
        self.app = app
        self.substrate = substrate
        self.use_modeled = use_modeled
        self.entries: List[PolicyEntry] = self._ladder(entries)
        # rung index -> ApproxSpec, parsed once: spec_at sits in the
        # serving tick's hot path (every lane, every tick)
        self._specs: List[ApproxSpec] = [e.to_spec() for e in self.entries]

    def _ladder(self, entries: Sequence[PolicyEntry]) -> List[PolicyEntry]:
        """Normalize to the ladder invariants: rung 0 precise, the rest the
        non-dominated subset ascending in error, no duplicate spec hashes,
        nothing the precise rung dominates (paying error for < 1x speedup
        is never a rung). Applied on EVERY construction path -- including
        direct `QosPolicy(entries)` and `load` of a hand-edited file -- so
        the controller's "one rung away is strictly better on one axis"
        assumption cannot be violated by a merged or stale policy file."""
        precise = PolicyEntry(spec=dict(_PRECISE_SPEC), error=0.0,
                              speedup=1.0, modeled_speedup=1.0)
        cands = [e for e in entries
                 if not e.precise and self._perf(e) > 1.0]
        front = pareto_mod.pareto_front(cands, use_modeled=self.use_modeled)
        rest = sorted(front, key=lambda e: (e.error, self._perf(e)))
        out, seen = [precise], {precise.spec_hash}
        for e in rest:
            if e.spec_hash not in seen:
                seen.add(e.spec_hash)
                out.append(e)
        return out

    def __len__(self) -> int:
        return len(self.entries)

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    @classmethod
    def from_records(cls, records: Sequence, *, metric: str = "mape",
                     app: str = "", substrate: Optional[str] = None,
                     use_modeled: bool = False) -> "QosPolicy":
        """Ladder = the Pareto front of `records` (Record objects or DB
        rows) -- extracted by the `_ladder` normalization every
        construction path runs, so the front is computed exactly once.
        Dominated configurations never become rungs: the controller only
        ever trades error for speedup along the front."""
        entries = [PolicyEntry(
            spec=dict(_get(r, "spec")),
            error=float(_get(r, "error")),
            speedup=float(_get(r, "speedup", 1.0)),
            modeled_speedup=float(_get(r, "modeled_speedup", 1.0)),
        ) for r in records]
        if substrate is None:
            subs = {(_get(r, "workload") or {}).get("substrate")
                    for r in records}
            subs.discard(None)
            substrate = subs.pop() if len(subs) == 1 else None
        if not app:
            apps = {_get(r, "app", "") for r in records}
            app = apps.pop() if len(apps) == 1 else ""
        return cls(entries, metric=metric, app=app, substrate=substrate,
                   use_modeled=use_modeled)

    @classmethod
    def from_db(cls, db_path: str, *, app: Optional[str] = None,
                workload: Optional[Dict] = None, metric: str = "mape",
                substrate: Optional[str] = None,
                use_modeled: bool = False) -> "QosPolicy":
        """Build from a `harness.sweep` database, optionally scoped to one
        app name and one workload fingerprint (so a shared DB holding many
        apps / problem sizes yields the right ladder)."""
        rows = load_db(db_path)
        if app is not None:
            rows = [r for r in rows if r.get("app") == app]
        if workload is not None:
            wkey = workload_hash(workload)
            rows = [r for r in rows
                    if workload_hash(r.get("workload", {})) == wkey]
        if not rows:
            raise ValueError(
                f"no rows in {db_path!r} match app={app!r} "
                f"workload={workload!r}")
        return cls.from_records(rows, metric=metric, app=app or "",
                                substrate=substrate, use_modeled=use_modeled)

    # ------------------------------------------------------------------
    # selection
    # ------------------------------------------------------------------

    def _perf(self, e: PolicyEntry) -> float:
        return e.modeled_speedup if self.use_modeled else e.speedup

    def select(self, target: Union[QosTarget, float]) -> int:
        """Rung index of the fastest entry whose offline error is strictly
        under the target (`best_speedup_under_error` semantics). Rung 0
        (precise) always qualifies, so selection never fails."""
        if not isinstance(target, QosTarget):
            target = QosTarget(max_error=float(target), metric=self.metric)
        if target.metric != self.metric:
            raise ValueError(
                f"target metric {target.metric!r} does not match the "
                f"policy's offline metric {self.metric!r}")
        ok = [i for i, e in enumerate(self.entries)
              if e.error < target.max_error or i == 0]
        return max(ok, key=lambda i: (self._perf(self.entries[i]), i))

    def choose(self, target: Union[QosTarget, float]) -> PolicyChoice:
        """`select`, packaged with the substrate and contract -- the
        serializable deployment artifact."""
        if not isinstance(target, QosTarget):
            target = QosTarget(max_error=float(target), metric=self.metric)
        i = self.select(target)
        return PolicyChoice(entry=self.entries[i], index=i,
                            substrate=self.substrate, target=target)

    def spec_at(self, index: int) -> ApproxSpec:
        return self._specs[index]

    # ------------------------------------------------------------------
    # serialization
    # ------------------------------------------------------------------

    def to_json(self) -> Dict:
        return {
            "version": 1,
            "app": self.app,
            "metric": self.metric,
            "substrate": self.substrate,
            "use_modeled": self.use_modeled,
            "entries": [e.to_json() for e in self.entries],
        }

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_json(), f, indent=1)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "QosPolicy":
        with open(path) as f:
            d = json.load(f)
        entries = [PolicyEntry(**e) for e in d["entries"]]
        return cls(entries, metric=d["metric"], app=d.get("app", ""),
                   substrate=d.get("substrate"),
                   use_modeled=d.get("use_modeled", False))


def precise_entry() -> PolicyEntry:
    """The rung-0 spec as a standalone entry (used by tests/benchmarks)."""
    return PolicyEntry(spec=dict(_PRECISE_SPEC), error=0.0, speedup=1.0,
                       modeled_speedup=1.0)


def spec_knob(spec: Optional[ApproxSpec]):
    """The spec's online actuator value -- the traced scalar a controller
    moves without recompiling -- or None for the precise spec. Raises for
    specs with no traced knob (skip-driven perforation): those cannot be
    walked online and should not appear on a serving ladder."""
    from ..core import batching
    if spec is None or not spec.enabled:
        return None
    return batching.traced_param(spec)


def validate_ladder_knobs(policy: QosPolicy) -> None:
    """Every rung must be actuable online (precise or traced-knob-backed);
    called by QosEngine at construction so a bad ladder fails fast."""
    for i, e in enumerate(policy.entries):
        try:
            spec_knob(e.to_spec())
        except ValueError as err:
            raise ValueError(
                f"policy rung {i} ({e.spec}) has no traced quality knob "
                f"and cannot be actuated online: {err}") from err


def validate_ladder_taf(policy: QosPolicy, taf_params) -> None:
    """Every non-precise rung must be decode-TAF matching `taf_params`'s
    structural fields (history/prediction size). The serving engine's only
    online actuator is the TAF threshold scalar: a rung calibrated under
    different structural params describes a DIFFERENT stability detector,
    so its offline error -- which `select` and the `trust_offline` prior
    gate knob moves on -- misdescribes the running decode step. Called by
    `ServingEngine` at construction; the offline analogue is the check in
    `calibrate.make_decode_app`."""
    for i in range(len(policy)):
        spec = policy.spec_at(i)
        if not spec.enabled:
            continue
        if spec.technique != Technique.TAF or spec.taf is None:
            raise ValueError(
                f"policy rung {i} ({spec.technique.value}) is not "
                "decode-TAF: the serving engine's only online actuator "
                "is the TAF threshold")
        if (spec.taf.history_size, spec.taf.prediction_size) != \
                (taf_params.history_size, taf_params.prediction_size):
            raise ValueError(
                f"policy rung {i} was calibrated with structural TAF "
                f"params ({spec.taf.history_size}, "
                f"{spec.taf.prediction_size}) but the model runs "
                f"({taf_params.history_size}, "
                f"{taf_params.prediction_size}): its offline error does "
                "not describe this decode step")
