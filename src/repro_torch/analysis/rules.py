"""The approxlint rules: A001-A008 (port of `repro.analysis.rules`).

Every rule is a function `(apps, device) -> List[Finding]` over the target
registry (`targets.py`). The rule IDs, severities, subjects and messages
are the JAX package's, so the two packages' reports compare finding by
finding.

  A001 recompile-leak            quality knob shapes the program
  A002 substrate misconfiguration  kernel launch config / tuning cache /
                                 ffn geometry / benchmark wiring
  A003 unsafe approximation sink   approximate values steering control flow
  A004 QoS ladder validity         saved policy files break the ladder
                                 invariants the controller relies on
  A005 sharding placement          leaves entering the sharded serve step
                                 not laid out for the engine's mesh
  A006 sub-1x ladder rung          a rung's predicted speedup <= 1
  A007 divergent loop carry        error amplifying through a while carry
  A008 instrumentation safety      obs hooks that read device values or
                                   keep device tensors in their payloads
"""
from __future__ import annotations

import glob as glob_mod
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import taint as taint_mod
from . import targets as targets_mod
from . import trace as trace_mod
from .findings import Finding, Severity

_KNOB_FIELDS = ("thresh", "fraction")  # quality-knob keys in the spec dict


def _err(e: Exception, n: int = 500) -> str:
    return f"{type(e).__name__}: {e}"[:n]


# --------------------------------------------------------------------------
# A001 -- recompile leak
# --------------------------------------------------------------------------

def probe_target(t: targets_mod.KnobTarget, device="cpu"
                 ) -> trace_mod.KnobTraceResult:
    """The verdict of one knob target: CUDA-graph replay for a kernel
    target on the card, the knob probe otherwise."""
    fn = t.build()
    if t.graph and torch.device(device).type == "cuda":
        return trace_mod.probe_graph(fn, t.card_values, t.atol, device)
    return trace_mod.probe_knob(fn, t.values, device=device)


def _probe_targets(knob_targets, device="cpu") -> List[Finding]:
    out = []
    for t in knob_targets:
        try:
            res = probe_target(t, device)
        except Exception as e:  # noqa: BLE001
            out.append(Finding(
                "A001", Severity.WARNING, t.subject,
                "knob target failed to build (cannot verify tracing)",
                {"error": _err(e)}))
            continue
        if res.verdict == "static":
            out.append(Finding(
                "A001", Severity.ERROR, t.subject,
                "quality knob is a STATIC argument: every knob value is a "
                "fresh compile (or an outright trace failure)",
                {"trace_error": res.error}))
        elif res.verdict == "baked":
            out.append(Finding(
                "A001", Severity.ERROR, t.subject,
                "quality knob is BAKED into the program as a constant: "
                "sweeping it recompiles",
                {"jaxpr_diff": res.diff_excerpt}))
        elif res.verdict == "error":
            out.append(Finding(
                "A001", Severity.WARNING, t.subject,
                "knob trace crashed (neither clean nor a known leak shape)",
                {"error": res.error}))
    return out


def check_spec_grouping(specs, subject_prefix: str = "grids"
                        ) -> List[Finding]:
    """Host-side A001 over a spec population: specs that differ ONLY in
    their quality knob must share a batching static_key (one compiled
    evaluation per structural group). The `harness.run_specs` lint hook
    runs this over the caller's actual specs."""
    from ..core import batching, harness
    from ..core.perforation import FRACTION_KINDS
    from ..core.types import Technique

    findings = []
    groups: Dict[str, set] = {}
    for spec in specs:
        d = harness.spec_to_dict(spec)
        key = batching.static_key(spec)
        tech = spec.technique
        fraction_perfo = (tech == Technique.PERFORATION
                          and spec.perforation.kind in FRACTION_KINDS)
        if tech in (Technique.TAF, Technique.IACT) or fraction_perfo:
            if key is None:
                findings.append(Finding(
                    "A001", Severity.ERROR,
                    f"{subject_prefix}.{tech.value}",
                    "spec has a traced quality knob but no batching "
                    "static_key: it falls out of the grouped runner and "
                    "compiles per grid point", {"spec": d}))
                continue
            stripped = json.dumps(
                {k: v for k, v in d.items() if k not in _KNOB_FIELDS},
                sort_keys=True)
            groups.setdefault(stripped, set()).add(key)
    for stripped, keys in groups.items():
        if len(keys) > 1:
            findings.append(Finding(
                "A001", Severity.ERROR, f"{subject_prefix}.static_key",
                "specs differing only in their quality knob map to "
                "DIFFERENT static keys: the knob leaks into the compiled "
                "structure", {"structural_group": stripped,
                              "keys": sorted(map(str, keys))}))
    return findings


def rule_a001(apps: Sequence[str], device="cpu") -> List[Finding]:
    findings: List[Finding] = []
    if "kernels" in apps:
        findings += _probe_targets(targets_mod.kernel_knob_targets(device),
                                   device)
    if "regions" in apps:
        findings += _probe_targets(targets_mod.region_knob_targets(device),
                                   device)
    if "ffn" in apps:
        findings += check_spec_grouping(targets_mod.default_grids())
    if "decode" in apps:
        findings += _probe_targets([targets_mod.serve_knob_target(device)],
                                   device)
    return findings


# --------------------------------------------------------------------------
# A002 -- substrate / kernel misconfiguration
# --------------------------------------------------------------------------

def _check_kernel_configs() -> List[Finding]:
    """Each kernel target's registered config must be valid and launchable
    by its kernel's launch rule (`kernels.tuning`): the port's counterpart
    of tracing a `pallas_call` at it."""
    from ..kernels import tuning

    findings = []
    for subject, kernel, shapes, config in \
            targets_mod.kernel_config_targets():
        try:
            why = (tuning.validate_config(kernel, shapes, config)
                   or tuning.launchable(kernel, shapes, config))
        except Exception as e:  # noqa: BLE001
            why = _err(e)
        if why:
            findings.append(Finding(
                "A002", Severity.ERROR, subject,
                "kernel fails to trace at its registered config "
                "(scalar-prefetch arity / BlockSpec / divisibility)",
                {"error": str(why)[:500]}))
    return findings


def _check_ffn_geometry() -> List[Finding]:
    findings = []
    try:
        geo = targets_mod.ffn_geometry()
    except Exception as e:  # noqa: BLE001
        return [Finding("A002", Severity.WARNING, "ffn.geometry",
                        "approx_ffn app unimportable; geometry unchecked",
                        {"error": _err(e, 300)})]
    seq = geo["seq"]
    for name in ("block_m", "block_rows", "block_attn"):
        if seq % geo[name]:
            findings.append(Finding(
                "A002", Severity.ERROR, f"ffn.geometry.{name}",
                f"app sequence length {seq} is not divisible by "
                f"{name}={geo[name]}: the Pallas path asserts at run time",
                {"seq": seq, name: geo[name]}))
    return findings


def _check_benchmarks_wiring() -> List[Finding]:
    """The port driver's MODULES / substrate_support / baselines."""
    import inspect

    from ..benchmarks import run as bench_run
    from ..core import substrate as substrate_mod

    findings = []
    support = bench_run.substrate_support()
    both = set(substrate_mod.SUBSTRATES)
    for key, mod in bench_run.MODULES.items():
        if key not in support:
            findings.append(Finding(
                "A002", Severity.ERROR, f"benchmarks.{key}",
                "module registered in MODULES but missing from the "
                "substrate_support table", {}))
            continue
        declares = "substrate" in inspect.signature(mod.main).parameters
        if key == "kernel":
            if support[key] != {substrate_mod.CUDA}:
                findings.append(Finding(
                    "A002", Severity.ERROR, "benchmarks.kernel",
                    "kernel_micro is pallas-native; its support entry "
                    "must be exactly {'pallas'}",
                    {"entry": sorted(support[key])}))
        elif declares and support[key] != both:
            findings.append(Finding(
                "A002", Severity.ERROR, f"benchmarks.{key}",
                "module's main() accepts substrate= but the support "
                "table does not offer both substrates",
                {"entry": sorted(support[key])}))
        elif not declares and support[key] != {substrate_mod.HOST}:
            findings.append(Finding(
                "A002", Severity.ERROR, f"benchmarks.{key}",
                "module's main() has no substrate parameter but the "
                "support table claims substrate choice",
                {"entry": sorted(support[key])}))
    base_dir = bench_run.BASELINES
    for bf in sorted(glob_mod.glob(os.path.join(base_dir, "BENCH_*.json"))):
        name = os.path.basename(bf)
        if name not in bench_run._BASELINE_CHECKS:
            findings.append(Finding(
                "A002", Severity.ERROR, f"benchmarks.baselines.{name}",
                "committed baseline has no check rules in "
                "_BASELINE_CHECKS: --check-regression would fail on it",
                {"path": bf}))
    for name in bench_run._BASELINE_CHECKS:
        if not os.path.exists(os.path.join(base_dir, name)):
            findings.append(Finding(
                "A002", Severity.WARNING, f"benchmarks.baselines.{name}",
                "check rules registered but no committed baseline file",
                {"expected": os.path.join(base_dir, name)}))
    return findings


def _check_tuning_cache() -> List[Finding]:
    """Audit the committed block-shape tuning cache (`kernels/tuning.py`):
    every entry valid for its kernel's search space and launch rule, and
    keyed on a machine some substrate maps to."""
    from ..kernels import tuning
    from .machine import MACHINES, MEASURED_MACHINE, SUBSTRATE_MACHINES

    path = tuning.default_cache_path()
    if path is None or not os.path.exists(path):
        return []
    sub = f"tuning_cache:{path}"
    try:
        cache = tuning.TuningCache.load(path)
    except Exception as e:  # noqa: BLE001
        return [Finding("A002", Severity.ERROR, sub,
                        "tuning cache unreadable", {"error": _err(e, 300)})]
    known = (set(SUBSTRATE_MACHINES.values())
             | (set(MACHINES) - {MEASURED_MACHINE}))
    findings = []
    for key, entry in sorted(cache.entries.items()):
        esub = f"{sub}#{key}"
        err = tuning.validate_entry(key, entry)
        if err:
            findings.append(Finding(
                "A002", Severity.ERROR, esub,
                "tuning-cache entry is invalid (stale or hand-edited): "
                + err, {"entry": entry}))
            continue
        machine = entry.get("machine", "")
        if machine not in known:
            findings.append(Finding(
                "A002", Severity.ERROR, esub,
                f"tuning-cache entry keyed on machine {machine!r}, which "
                "no substrate maps to (stale vs SUBSTRATE_MACHINES): the "
                "entry can never be consulted",
                {"machine": machine, "known": sorted(known)}))
    return findings


def rule_a002(apps: Sequence[str], device="cpu") -> List[Finding]:
    findings: List[Finding] = []
    if "kernels" in apps:
        findings += _check_kernel_configs()
        findings += _check_tuning_cache()
    if "ffn" in apps:
        findings += _check_ffn_geometry()
        findings += _check_benchmarks_wiring()
    return findings


# --------------------------------------------------------------------------
# A003 -- unsafe approximation sink
# --------------------------------------------------------------------------

def _taint_one(t: targets_mod.TraceTarget) -> List[Finding]:
    try:
        fn, args = t.build()
        positions = taint_mod.tainted_positions(args, t.tainted)
        sinks = taint_mod.find_taint_sinks(fn, args, positions)
    except Exception as e:  # noqa: BLE001
        return [Finding("A003", Severity.WARNING, t.subject,
                        "taint target failed to trace", {"error": _err(e)})]
    if not positions:
        return [Finding("A003", Severity.WARNING, t.subject,
                        "no tainted source leaves matched "
                        f"{t.tainted}: the walk checked nothing", {})]
    return [Finding(
        "A003", Severity.ERROR, f"{t.subject}{s.path}",
        f"approximate value reaches a {s.kind} (`{s.primitive}`) with no "
        "precise fallback: a 1-ulp error becomes a discontinuous "
        "program change",
        {"eqn": s.eqn_repr, "sources": list(t.tainted)}) for s in sinks]


def rule_a003(apps: Sequence[str], device="cpu") -> List[Finding]:
    findings: List[Finding] = []
    if "regions" in apps:
        for t in targets_mod.region_taint_targets(device):
            findings += _taint_one(t)
    if "decode" in apps:
        findings += _taint_one(targets_mod.serve_taint_target(device))
    return findings


# --------------------------------------------------------------------------
# A004 -- QoS ladder validity (raw saved-policy files)
# --------------------------------------------------------------------------

def check_policy_file(path: str,
                      model_taf: Optional[Tuple[int, int]] = None
                      ) -> List[Finding]:
    """Lint ONE saved QosPolicy file on its RAW entries: `QosPolicy.load`
    re-normalizes the ladder, so a broken file would self-heal at load
    time."""
    sub = f"policy:{path}"
    try:
        with open(path) as f:
            doc = json.load(f)
    except Exception as e:  # noqa: BLE001
        return [Finding("A004", Severity.ERROR, sub,
                        "policy file unreadable", {"error": _err(e, 300)})]
    return check_policy_document(doc, subject=sub, model_taf=model_taf)


def check_policy_document(doc: Dict, *, subject: str = "policy",
                          model_taf: Optional[Tuple[int, int]] = None
                          ) -> List[Finding]:
    """The A004 ladder checks over a policy JSON document (the
    `QosPolicy.to_json` schema). Shared by the file pass and the
    `ServingEngine(lint=True)` hook."""
    from ..core.harness import spec_from_dict, spec_hash
    from ..qos.policy import spec_knob

    sub = subject
    entries = doc.get("entries", [])
    if not entries:
        return [Finding("A004", Severity.ERROR, sub,
                        "policy has no entries (not even the precise rung)",
                        {})]
    use_modeled = bool(doc.get("use_modeled", False))
    perf_key = "modeled_speedup" if use_modeled else "speedup"
    findings: List[Finding] = []

    e0 = entries[0]
    if e0.get("spec", {}).get("technique", "none") != "none" or \
            e0.get("error", 1.0) != 0.0 or e0.get(perf_key, 0.0) != 1.0:
        findings.append(Finding(
            "A004", Severity.ERROR, f"{sub}#rung0",
            "rung 0 must be the precise anchor (technique none, error 0, "
            "speedup 1): the controller's hard fallback lands here",
            {"rung0": e0}))

    seen_hash: Dict[str, int] = {}
    structural: Dict[Tuple[int, int], List[int]] = {}
    for i, e in enumerate(entries):
        rsub = f"{sub}#rung{i}"
        spec_d = e.get("spec", {})
        err, perf = e.get("error"), e.get(perf_key)
        precise = spec_d.get("technique", "none") == "none"
        if i > 0 and precise:
            findings.append(Finding(
                "A004", Severity.ERROR, rsub,
                "precise spec on a non-zero rung (duplicate anchor)", {}))
        if i > 0 and isinstance(perf, (int, float)) and perf <= 1.0:
            findings.append(Finding(
                "A004", Severity.ERROR, rsub,
                "rung pays quality for <= 1x speedup: dominated by the "
                "precise rung", {"error": err, perf_key: perf}))
        stored = e.get("spec_hash", "")
        actual = spec_hash(spec_d)
        if stored and stored != actual:
            findings.append(Finding(
                "A004", Severity.ERROR, rsub,
                "stored spec_hash does not match the spec (stale or "
                "hand-edited entry)",
                {"stored": stored, "recomputed": actual}))
        if actual in seen_hash:
            findings.append(Finding(
                "A004", Severity.ERROR, rsub,
                f"duplicate spec (same spec_hash as rung "
                f"{seen_hash[actual]})", {"spec_hash": actual}))
        else:
            seen_hash[actual] = i
        try:
            spec_knob(spec_from_dict(spec_d))
        except Exception as ex:  # noqa: BLE001
            findings.append(Finding(
                "A004", Severity.ERROR, rsub,
                "spec is unparseable or has no online-actuable knob",
                {"error": _err(ex, 300), "spec": spec_d}))
            continue
        if spec_d.get("technique") == "taf":
            structural.setdefault(
                (int(spec_d.get("hSize", -1)), int(spec_d.get("pSize", -1))),
                []).append(i)

    for i in range(1, len(entries)):
        for j in range(i + 1, len(entries)):
            ei, ej = entries[i], entries[j]
            erri, errj = ei.get("error"), ej.get("error")
            pi, pj = ei.get(perf_key), ej.get(perf_key)
            if None in (erri, errj, pi, pj):
                continue
            if errj >= erri and pj <= pi:
                findings.append(Finding(
                    "A004", Severity.ERROR, f"{sub}#rung{j}",
                    f"rung dominated by rung {i} (more error, no more "
                    "speedup): 'one rung away is strictly faster' breaks",
                    {"rung": {"error": errj, perf_key: pj},
                     "dominator": {"error": erri, perf_key: pi}}))
            elif errj <= erri:
                findings.append(Finding(
                    "A004", Severity.ERROR, f"{sub}#rung{j}",
                    f"ladder not ascending in error after rung {i}: "
                    "'one rung toward 0 is strictly quality-improving' "
                    "breaks",
                    {"errors": [erri, errj]}))

    if len(structural) > 1:
        findings.append(Finding(
            "A004", Severity.ERROR, f"{sub}#ladder",
            "TAF rungs disagree on structural (history, prediction) "
            "params: they describe different stability detectors",
            {"groups": {str(k): v for k, v in structural.items()}}))
    if model_taf is not None and structural:
        mism = {k: v for k, v in structural.items() if k != tuple(model_taf)}
        if mism:
            findings.append(Finding(
                "A004", Severity.ERROR, f"{sub}#ladder",
                f"TAF rungs calibrated under structural params "
                f"{sorted(mism)} but the target model runs "
                f"{tuple(model_taf)}: offline error misdescribes the "
                "running decode step",
                {"rungs": sorted(v2 for v in mism.values() for v2 in v)}))
    return findings


def rule_a004(policy_paths: Sequence[str],
              model_taf: Optional[Tuple[int, int]] = None) -> List[Finding]:
    findings: List[Finding] = []
    for path in policy_paths:
        findings += check_policy_file(path, model_taf=model_taf)
    return findings


# --------------------------------------------------------------------------
# A005 -- sharding placement
# --------------------------------------------------------------------------

def _unplaced(engine, surface: str, path: tuple, leaf) -> Optional[str]:
    """Why one leaf entering the sharded serve step is not laid out for
    the engine (None when it is): not a tensor, a DTensor on another mesh,
    a plain tensor off the engine's device, or a lane / shard extent that
    is not this rank's."""
    from ..runtime import sharding as shardlib

    if not isinstance(leaf, torch.Tensor):
        return type(leaf).__name__
    mesh = getattr(leaf, "device_mesh", None)
    if mesh is not None:
        if (tuple(mesh.shape) != tuple(engine.mesh.shape)
                or mesh.mesh_dim_names != engine.mesh.mesh_dim_names):
            return f"DTensor on mesh {tuple(mesh.shape)}"
        return None
    want = engine.model.device
    if leaf.device.type != want.type or (
            want.index is not None and leaf.device.index != want.index):
        return f"tensor on {leaf.device}"
    lanes = engine._hi - engine._lo
    if surface == "tokens" and leaf.shape[0] != lanes:
        return f"{leaf.shape[0]} lanes, this rank serves {lanes}"
    if surface == "cache":
        kind = shardlib.decode_shard_axis(path)
        want = (engine.local_shards if kind == ("state", 0) else lanes)
        if kind is not None and leaf.shape[kind[1]] != want:
            return f"extent {leaf.shape[kind[1]]} on dim {kind[1]}, " \
                   f"this rank holds {want}"
    return None


def check_engine_placement(engine) -> List[Finding]:
    """Audit every leaf entering the engine's sharded serve step. The
    port's sharded engine is SPMD: each rank holds its own lanes (and its
    shards' detector rows) as tensors on its device, or DTensors on the
    engine's mesh. A leaf laid out otherwise is re-placed (or fails) every
    tick."""
    if engine.mesh is None:
        return []
    findings = []
    surfaces = {"params": engine.params, "cache": engine.cache,
                "tokens": engine.tokens}
    for name, tree in surfaces.items():
        if tree is None:
            continue
        bad = []
        for path, leaf in targets_mod.tree_paths(tree):
            why = _unplaced(engine, name, path, leaf)
            if why:
                bad.append(("/".join(map(str, path)), why))
        if bad:
            findings.append(Finding(
                "A005", Severity.ERROR, f"serving.engine.{name}",
                f"{len(bad)} leaf/leaves enter the shard_map'd serve step "
                "without mesh commitment: pjit re-shards them every tick",
                {"leaves": bad[:8],
                 "mesh": dict(zip(engine.mesh.mesh_dim_names,
                                  map(int, engine.mesh.shape)))}))
    return findings


def rule_a005(apps: Sequence[str], device="cpu") -> List[Finding]:
    """The engine fixture on a one-rank mesh; a process group this rule
    starts for it (none was up) is gone again when it returns."""
    if "decode" not in apps:
        return []
    import torch.distributed as dist

    from ..runtime import elastic
    started = elastic.init_single(device)
    try:
        engine = targets_mod.engine_fixture(device)
        return check_engine_placement(engine)
    except Exception as e:  # noqa: BLE001
        return [Finding("A005", Severity.WARNING, "serving.engine",
                        "engine fixture failed to build; placement "
                        "unchecked", {"error": _err(e)})]
    finally:
        if started:
            dist.destroy_process_group()


# --------------------------------------------------------------------------
# A006 -- ladder rung with predicted sub-1x speedup
# --------------------------------------------------------------------------

def check_policy_cost(doc: Dict, *, subject: str = "policy",
                      machine=None) -> List[Finding]:
    """Every rung's spec through the analytical cost model
    (`analysis.cost.ladder_model`) on the target machine: flag rungs whose
    PREDICTED speedup is sub-1x."""
    from ..core.harness import spec_from_dict
    from . import cost as cost_mod

    model = cost_mod.ladder_model(machine or doc.get("substrate"))
    findings: List[Finding] = []
    for i, e in enumerate(doc.get("entries", [])):
        spec_d = e.get("spec", {})
        if spec_d.get("technique", "none") == "none":
            continue
        try:
            spec = spec_from_dict(spec_d)
        except Exception:  # noqa: BLE001 -- unparseable spec is A004's job
            continue
        pred = model.predict(spec)
        if pred.modeled and pred.speedup <= 1.0:
            findings.append(Finding(
                "A006", Severity.ERROR, f"{subject}#rung{i}",
                f"rung's predicted speedup on {model.machine.name} is "
                f"{pred.speedup:.3f}x (<= 1x): the technique's overhead "
                "exceeds the work it can skip -- the rung trades quality "
                "for a slowdown",
                {"spec": spec_d, "predicted_speedup": pred.speedup,
                 "skip_fraction": pred.skip_fraction,
                 "machine": model.machine.name}))
    return findings


def rule_a006(policy_paths: Sequence[str], machine=None) -> List[Finding]:
    findings: List[Finding] = []
    for path in policy_paths:
        sub = f"policy:{path}"
        try:
            with open(path) as f:
                doc = json.load(f)
        except Exception:  # noqa: BLE001 -- A004 reports unreadable files
            continue
        findings += check_policy_cost(doc, subject=sub, machine=machine)
    return findings


# --------------------------------------------------------------------------
# A007 -- error amplifies unboundedly through a loop carry
# --------------------------------------------------------------------------

def check_divergence(fn, example_args, tainted: Sequence[str],
                     subject: str) -> List[Finding]:
    """Inject unit relative error at the approximate-value leaves and
    propagate it through the program (`analysis.errorprop`). A
    `while_loop` carry whose per-iteration error gain stays > 1 at the
    fixpoint is divergent: the loop runs until a data-dependent
    condition, so no finite bound exists."""
    from . import errorprop

    positions = taint_mod.tainted_positions(example_args, tainted)
    if not positions:
        return [Finding("A007", Severity.WARNING, subject,
                        "no tainted input leaves matched; divergence "
                        "unchecked", {"needles": list(tainted)})]
    findings = []
    for rep in errorprop.find_divergent_carries(fn, example_args, positions):
        findings.append(Finding(
            "A007", Severity.ERROR, subject,
            f"approximation error amplifies unboundedly through a "
            f"{rep.kind} carry (per-iteration gain {rep.gain:.3g} > 1, "
            "no static trip bound): locally small residuals diverge "
            "through subsequent iterations",
            {"loop": rep.to_json()}))
    return findings


def rule_a007(apps: Sequence[str], device="cpu") -> List[Finding]:
    findings: List[Finding] = []
    tt = []
    if "regions" in apps:
        tt += targets_mod.region_taint_targets(device)
    if "decode" in apps:
        tt.append(targets_mod.serve_taint_target(device))
    for t in tt:
        fn, example_args = t.build()
        findings += check_divergence(fn, example_args, t.tainted, t.subject)
    return findings


# --------------------------------------------------------------------------
# A008 -- instrumentation safety (obs hooks on the hot path)
# --------------------------------------------------------------------------

def check_instrumentation_safety(fn, example_args, subject: str,
                                 build=None) -> List[Finding]:
    """Audit `fn`'s obs instrumentation by running it with the tracer off
    and with an ACTIVE tracer (scoped; the caller's tracer is restored).

    Two failure modes, both of which break the serving plane's zero-sync
    contract:

      * the traced run reads more device values on the host than the
        untraced one -- an obs hook (or the payload built for it) forces a
        device value to the host (`float()`, `.item()`, `.tolist()`): a
        device->host transfer per call. On the card the two runs also go
        under `torch.cuda.set_sync_debug_mode("warn")` and their
        synchronizing calls are counted; the traced run may make no more
        (the step's own reads, such as decode TAF's one read of
        `remaining`, are in both counts, which is why the mode is not
        "error");
      * an event/span payload holds a tensor: the port's `obs.trace`
        stores payloads as given, so a device tensor escapes to the host
        buffer, and reading or exporting it later synchronizes.

    `build()`, when given, makes a fresh (fn, example_args) for each run
    (a step that updates its arguments in place)."""
    from ..obs import trace as obs_trace

    def fresh():
        return build() if build is not None else (fn, example_args)

    tracer = obs_trace.Tracer()
    try:
        extra = -_host_reads(*fresh(), None)
        f1, a1 = fresh()
        extra += _host_reads(f1, a1, tracer)
        on_card = any(isinstance(t, torch.Tensor) and t.is_cuda
                      for _, t in taint_mod.leaf_paths(tuple(a1)))
        if on_card:
            _syncs(*fresh(), None)   # a first call's one-time work
            extra += _syncs(*fresh(), obs_trace.Tracer()) \
                - _syncs(*fresh(), None)
    except Exception as e:  # noqa: BLE001
        return [Finding("A008", Severity.WARNING, subject,
                        "instrumentation-safety target failed to trace",
                        {"error": _err(e)})]
    if extra > 0:
        return [Finding(
            "A008", Severity.ERROR, subject,
            "instrumentation concretizes a traced value inside the jitted "
            "region: a device->host transfer on every call",
            {"error": f"{extra} host read(s) or synchronization(s) added "
                      "by the active tracer"})]
    findings: List[Finding] = []
    for rec in tracer.records:
        for k, v in (rec.get("args") or {}).items():
            for _, leaf in taint_mod.leaf_paths(v):
                if isinstance(leaf, torch.Tensor):
                    findings.append(Finding(
                        "A008", Severity.ERROR,
                        f"{subject}.{rec['name']}",
                        f"obs payload {k!r} captures a traced value: the "
                        "abstract tracer escapes to the host-side event "
                        "buffer (device sync per call once read, crash on "
                        "export)",
                        {"event": rec["name"], "key": k,
                         "aval": f"{leaf.dtype}{list(leaf.shape)} on "
                                 f"{leaf.device}"}))
    return findings


class _HostReads(taint_mod.TaintMode):
    """Counts the device values a program reads on the host."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def on_op(self, func, name, args, kwargs, out, hit) -> None:
        self.n += name in taint_mod.HOST_READS


def _host_reads(fn, example_args, tracer) -> int:
    from ..obs import trace as obs_trace
    count = _HostReads()
    with obs_trace.use(tracer), count:
        fn(*example_args)
    return count.n


def _syncs(fn, example_args, tracer) -> int:
    """Synchronizing calls of one run on the card (sync debug mode
    "warn", its warnings counted)."""
    import warnings

    from ..obs import trace as obs_trace

    torch.cuda.synchronize()
    with obs_trace.use(tracer), warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn(*example_args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(m.message) for m in w)


def rule_a008(apps: Sequence[str], device="cpu") -> List[Finding]:
    findings: List[Finding] = []
    tt: List[targets_mod.TraceTarget] = []
    if "kernels" in apps:
        tt += [targets_mod.TraceTarget(
            t.subject.rsplit(".", 1)[0] + ".config",
            (lambda t=t: (t.build(), (torch.tensor(
                t.values[0], dtype=torch.float32, device=device),))))
            for t in targets_mod.kernel_knob_targets(device)]
    if "decode" in apps:
        tt.append(targets_mod.serve_taint_target(device))
    for t in tt:
        try:
            fn, example_args = t.build()
        except Exception as e:  # noqa: BLE001
            findings.append(Finding(
                "A008", Severity.WARNING, t.subject,
                "instrumentation-safety target failed to build",
                {"error": _err(e)}))
            continue
        findings += check_instrumentation_safety(fn, example_args,
                                                 t.subject, build=t.build)
    return findings


RULE_IDS = ("A001", "A002", "A003", "A004", "A005", "A006", "A007",
            "A008")
