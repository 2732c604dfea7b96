"""The port's approxlint (`repro_torch.analysis`) against the JAX package's
(`repro.analysis`), on the CPU: one counterpart of each test in
`tests/test_analysis.py` (the findings plumbing, each rule against
KNOWN-BAD fixtures, the two opt-in hooks, the CLI's exit codes and the
meta-test that the tree lints clean), plus the cross-package checks: the
A004 and A006 findings (rule, severity, subject) on the same policy
documents equal JAX's, and `run_lint` on each package's tree gives the
same summary and allowlisted subjects. The JAX programs are jaxprs; the
port's are the ops an eager program dispatches, so each known-bad fixture
is written as eager PyTorch (a Python `if` / `while` on a tensor is the
port's cond / while_loop predicate).

The `cuda`-marked class runs the card's probes (the CUDA-graph replay of
A001 and the sync-debug A008) and skips here.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.analysis import errorprop
from repro_torch.analysis import rules as rules_mod
from repro_torch.analysis.findings import (AllowEntry, Allowlist, Finding,
                                           Report, Severity,
                                           default_allowlist_path)
from repro_torch.analysis.lint import run_lint
from repro_torch.analysis.taint import find_taint_sinks
from repro_torch.analysis.trace import (_HEX_ADDR, probe_knob,
                                        program_fingerprint)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------- findings

def _f(rule="A001", sev=Severity.ERROR, subject="kernels.toy.knob"):
    return Finding(rule, sev, subject, "msg", {})


def test_severity_parse_and_order():
    assert Severity.parse("warning") is Severity.WARNING
    assert Severity.INFO < Severity.WARNING < Severity.ERROR
    with pytest.raises(ValueError):
        Severity.parse("fatal")


def test_allowlist_matches_by_rule_and_fnmatch():
    allow = Allowlist([AllowEntry("A001", "kernels.*", reason="r")])
    assert allow.match(_f()) is not None
    assert allow.match(_f(rule="A002")) is None
    assert allow.match(_f(subject="regions.toy")) is None


def test_allowlist_load_rejects_empty_reason(tmp_path):
    p = tmp_path / ".approxlint.json"
    p.write_text(json.dumps(
        {"version": 1,
         "allow": [{"rule": "A001", "subject": "x", "reason": ""}]}))
    with pytest.raises(ValueError, match="reason"):
        Allowlist.load(str(p))


def test_default_allowlist_path_walks_up(tmp_path):
    (tmp_path / ".approxlint.json").write_text('{"version":1,"allow":[]}')
    nested = tmp_path / "a" / "b"
    nested.mkdir(parents=True)
    assert default_allowlist_path(str(nested)) == str(
        tmp_path / ".approxlint.json")
    # the port finds the repo root's file, the JAX package's
    assert default_allowlist_path(os.path.join(
        _ROOT, "src", "repro_torch", "benchmarks")) == os.path.join(
            _ROOT, ".approxlint.json")


def test_report_routes_allowlisted_and_fails_on_rule_crash():
    rep = Report()
    allow = Allowlist([AllowEntry("A001", "kernels.*", reason="known")])
    rep.extend([_f(), _f(rule="A002", subject="bench.x")], allow)
    assert [f.rule for f in rep.findings] == ["A002"]
    assert len(rep.allowlisted) == 1
    assert rep.failed(Severity.ERROR)
    clean = Report()
    assert not clean.failed()
    clean.errors.append("A003: crashed")
    assert clean.failed()


# ---------------------------------------------------- A001: knob tracing

X = torch.arange(8.0)


def test_probe_knob_traced_clean():
    res = probe_knob(lambda th: torch.where(X.abs() < th, 0.0, X))
    assert res.verdict == "traced" and res.clean


def test_probe_knob_static_argument_is_a_finding():
    # the knob taken as a Python number (the port's static argument)
    def f(x, th: float):
        return torch.where(x.abs() < th, 0.0, x)
    res = probe_knob(lambda th: f(X, float(th)))
    assert res.verdict == "static"
    assert "_local_scalar_dense" in res.error


def test_probe_knob_python_control_flow_is_a_finding():
    def branchy(th):
        return X * 2 if th > 0.5 else X       # reads the knob on the host
    assert probe_knob(branchy).verdict == "static"


def test_probe_knob_baked_constant_is_a_finding():
    from repro_torch.analysis.trace import KnobTrace

    def build(v):          # captures the VALUE before the call: baked
        return lambda th: torch.where(X.abs() < float(v), 0.0, X) + th * 0
    prints = []
    for v in (0.25, 0.75):
        knob = torch.tensor(v)
        rec = KnobTrace(knob)
        with rec:
            build(v)(knob)
        prints.append(program_fingerprint(rec.ops))
    assert prints[0] != prints[1]

    holder = {"v": 0.0}

    def leaky(th):           # ignores th; bakes the swept value instead
        holder["v"] += 0.5
        return torch.where(X.abs() < holder["v"], 0.0, X)
    assert probe_knob(leaky).verdict == "baked"


def test_fingerprint_normalizes_hex_addresses():
    a = "custom_call[callback=<function f at 0x7f01>]"
    b = "custom_call[callback=<function f at 0x7f02>]"
    assert _HEX_ADDR.sub("0x", a) == _HEX_ADDR.sub("0x", b)
    assert program_fingerprint([a]) == program_fingerprint([b])


def _leaky_key(orig):
    def leaky(spec):         # the knob value leaks into the static key
        k = orig(spec)
        return k + (spec.taf.rsd_threshold,) if k and spec.taf else k
    return leaky


def test_check_spec_grouping_clean_and_leaky(monkeypatch):
    from repro_torch.core import batching
    from repro_torch.core.harness import taf_grid
    from repro_torch.core.types import Level
    grid = taf_grid(h_sizes=(3,), p_sizes=(2,), thresholds=(0.02, 0.1),
                    levels=(Level.BLOCK,))
    assert rules_mod.check_spec_grouping(grid) == []
    monkeypatch.setattr(batching, "static_key",
                        _leaky_key(batching.static_key))
    findings = rules_mod.check_spec_grouping(grid, subject_prefix="t")
    assert [f.rule for f in findings] == ["A001"]
    assert "static_key" in findings[0].subject


# -------------------------------------------------------- A003: taint

def _args():
    return torch.ones(4), torch.ones(4)   # two storages: taint is per storage


def test_taint_cond_predicate_sink():
    def step(memo, x):
        if torch.sum(memo) > 0.0:
            return x * 2.0
        return x
    sinks = find_taint_sinks(step, _args(), tainted_inputs=[0])
    assert any(s.kind == "branch predicate" for s in sinks)
    assert find_taint_sinks(step, _args(), tainted_inputs=[1]) == []


def test_taint_gather_indices_sink():
    def step(memo, x):
        idx = torch.argmax(memo).reshape(1)
        return x[idx]
    sinks = find_taint_sinks(step, _args(), tainted_inputs=[0])
    assert any("indices" in s.kind for s in sinks)


def test_taint_while_predicate_via_carry_fixpoint():
    def step(memo, x):
        i, acc = 0, torch.sum(memo)
        while acc < 10.0:          # acc is memo-derived
            i, acc = i + 1, acc + 1.0
        return acc
    sinks = find_taint_sinks(step, _args(), tainted_inputs=[0])
    assert any(s.kind == "while predicate" for s in sinks)


def test_taint_pure_arithmetic_is_clean():
    def step(memo, x):
        return x * torch.tanh(memo) + torch.sum(memo)
    assert find_taint_sinks(step, _args(), tainted_inputs=[0]) == []


def test_taint_walks_into_pjit():
    """A nested call is walked like any other op (the JAX case fails
    under jax 0.9.0, whose nested `jax.jit` is no longer the `pjit` the
    JAX walk enters): the sink is found, its path naming the callee."""
    def inner(m, v):
        return v if m[0] > 0 else -v

    def step(memo, x):
        return inner(memo, x)
    sinks = find_taint_sinks(step, _args(), tainted_inputs=[0])
    assert any(s.kind == "branch predicate" for s in sinks)
    assert all("inner" in s.path for s in sinks)


# ------------------------------------------------------ A004: ladders

def _spec_hash(spec):
    from repro_torch.core.harness import spec_hash
    return spec_hash(spec)


def _rung(thresh, error, speedup, h=2, p=4, **over):
    spec = {"technique": "taf", "level": "block", "hSize": h, "pSize": p,
            "thresh": thresh}
    d = {"spec": spec, "error": error, "speedup": speedup,
         "modeled_speedup": speedup, "spec_hash": _spec_hash(spec)}
    d.update(over)
    return d


def _precise_rung():
    spec = {"technique": "none"}
    return {"spec": spec, "error": 0.0, "speedup": 1.0,
            "modeled_speedup": 1.0, "spec_hash": _spec_hash(spec)}


def _doc(entries, **over):
    d = {"version": 1, "app": "toy", "metric": "mape",
         "use_modeled": False, "entries": entries}
    d.update(over)
    return d


def _a004(doc, **kw):
    return rules_mod.check_policy_document(doc, subject="p", **kw)


def _key(findings):
    return sorted((f.rule, f.severity.name, f.subject, f.message)
                  for f in findings)


def _same_as_jax_a004(doc, **kw):
    """The port's A004 findings equal the JAX rule's on the document."""
    from repro.analysis import rules as jrules
    mine = _a004(doc, **kw)
    assert _key(mine) == _key(jrules.check_policy_document(
        doc, subject="p", **kw))
    return mine


def test_a004_clean_ladder():
    doc = _doc([_precise_rung(), _rung(0.05, 0.01, 1.5),
                _rung(0.2, 0.04, 2.2)])
    assert _same_as_jax_a004(doc) == []


def test_a004_dominated_rung():
    doc = _doc([_precise_rung(), _rung(0.05, 0.01, 2.0),
                _rung(0.2, 0.04, 1.8)])
    assert any("dominated" in f.message for f in _same_as_jax_a004(doc))


def test_a004_non_ascending_error():
    doc = _doc([_precise_rung(), _rung(0.05, 0.04, 1.5),
                _rung(0.2, 0.04, 2.2)])
    assert any("ascending" in f.message for f in _same_as_jax_a004(doc))


def test_a004_missing_precise_anchor():
    doc = _doc([_rung(0.05, 0.01, 1.5)])
    assert any("#rung0" in f.subject for f in _same_as_jax_a004(doc))


def test_a004_sub_1x_rung_and_duplicate_spec():
    doc = _doc([_precise_rung(), _rung(0.05, 0.01, 0.9)])
    assert any("<= 1x" in f.message for f in _same_as_jax_a004(doc))
    doc = _doc([_precise_rung(), _rung(0.05, 0.01, 1.5),
                _rung(0.05, 0.04, 2.0)])
    assert any("duplicate spec" in f.message
               for f in _same_as_jax_a004(doc))


def test_a004_stale_spec_hash():
    bad = _rung(0.05, 0.01, 1.5)
    bad["spec_hash"] = "deadbeef"
    msgs = [f.message for f in _same_as_jax_a004(_doc([_precise_rung(),
                                                       bad]))]
    assert any("spec_hash" in m for m in msgs)


def test_a004_model_taf_mismatch_and_structural_split():
    doc = _doc([_precise_rung(), _rung(0.05, 0.01, 1.5, h=2, p=4)])
    assert _same_as_jax_a004(doc, model_taf=(2, 4)) == []
    assert any("target model" in f.message
               for f in _same_as_jax_a004(doc, model_taf=(8, 2)))
    split = _doc([_precise_rung(), _rung(0.05, 0.01, 1.5, h=2, p=4),
                  _rung(0.2, 0.04, 2.2, h=8, p=2)])
    assert any("structural" in f.message for f in _same_as_jax_a004(split))


def test_a004_raw_json_not_healed_load(tmp_path):
    """QosPolicy.load re-normalizes, so the linter must see the RAW file:
    a saved ladder with a dominated rung loads 'clean' but lints dirty."""
    from repro_torch import qos
    doc = _doc([_precise_rung(), _rung(0.05, 0.01, 2.0),
                _rung(0.2, 0.04, 1.8)])
    p = tmp_path / "policy.json"
    p.write_text(json.dumps(doc))
    healed = qos.QosPolicy.load(str(p))
    assert len(healed.entries) == 2
    findings = rules_mod.check_policy_file(str(p))
    assert any(f.rule == "A004" for f in findings)


def test_a004_saved_policy_roundtrip_is_clean(tmp_path):
    from repro_torch import qos
    from repro_torch.core.harness import Record
    recs = [Record(app="toy",
                   spec={"technique": "taf", "level": "block", "hSize": 2,
                         "pSize": 4, "thresh": t},
                   error=e, speedup=s, modeled_speedup=s,
                   approx_fraction=0.5, wall_time_s=1.0, exact_time_s=1.0,
                   extra={})
            for t, e, s in ((0.05, 0.002, 1.2), (0.1, 0.01, 1.5),
                            (0.2, 0.04, 2.2))]
    pol = qos.QosPolicy.from_records(recs)
    p = tmp_path / "ok.json"
    pol.save(str(p))
    assert rules_mod.check_policy_file(str(p)) == []


def test_a004_unreadable_file_reported():
    findings = rules_mod.check_policy_file("/nonexistent/policy.json")
    assert [f.rule for f in findings] == ["A004"]
    assert "unreadable" in findings[0].message


# --------------------------------- A006: statically-hopeless rungs

def _iact_rung(tsize, thresh, error, speedup):
    spec = {"technique": "iact", "level": "block", "tSize": tsize,
            "thresh": thresh, "tPerBlock": 1}
    return {"spec": spec, "error": error, "speedup": speedup,
            "modeled_speedup": speedup, "spec_hash": _spec_hash(spec)}


def _same_as_jax_a006(doc):
    """The port's A006 findings on the default machine equal the JAX
    rule's on its default machine (rule, severity, subject)."""
    from repro.analysis import rules as jrules
    mine = rules_mod.check_policy_cost(doc, subject="p")
    theirs = jrules.check_policy_cost(doc, subject="p")
    assert [(f.rule, f.severity.name, f.subject) for f in mine] == \
        [(f.rule, f.severity.name, f.subject) for f in theirs]
    return mine


def test_a006_oversized_iact_table_flagged():
    doc = _doc([_precise_rung(), _iact_rung(4096, 0.2, 0.01, 1.5)])
    findings = _same_as_jax_a006(doc)
    assert [f.rule for f in findings] == ["A006"]
    assert findings[0].subject == "p#rung1"
    assert findings[0].severity is Severity.ERROR
    assert findings[0].detail["predicted_speedup"] <= 1.0
    assert findings[0].detail["machine"] == "h100"


def test_a006_plausible_ladder_clean():
    doc = _doc([_precise_rung(), _rung(0.5, 0.01, 1.2),
                _iact_rung(2, 0.2, 0.04, 1.1)])
    assert _same_as_jax_a006(doc) == []


def test_a006_unparseable_spec_left_to_a004():
    doc = _doc([_precise_rung(),
                {"spec": {"technique": "taf", "hSize": -1},
                 "error": 0.01, "speedup": 1.5}])
    assert _same_as_jax_a006(doc) == []


def test_a006_policy_file_roundtrip(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(
        _doc([_precise_rung(), _iact_rung(4096, 0.2, 0.01, 1.5)])))
    good = tmp_path / "good.json"
    good.write_text(json.dumps(_doc([_precise_rung(),
                                     _rung(0.5, 0.01, 1.2)])))
    findings = rules_mod.rule_a006([str(bad), str(good)])
    assert [f.rule for f in findings] == ["A006"]
    assert str(bad) in findings[0].subject


# --------------------------------- A007: divergent loop carries

def _while_program(body_update):
    """A while loop with a data-dependent trip count whose carry folds in
    the tainted memo value via `body_update(v, memo_scalar)`."""
    def fn(state, x):
        def cond(c):
            return c[1] < 1e6

        def body(c):
            i, v = c
            return i + 1, body_update(v, state["memo"][0])
        return errorprop.while_loop(cond, body, (torch.tensor(0), x))
    args = ({"memo": torch.ones((4,), dtype=torch.float32)},
            torch.tensor(1.0))
    return fn, args


def test_a007_amplifying_while_carry_flagged():
    fn, args = _while_program(lambda v, m: 2.0 * v + m)
    findings = rules_mod.check_divergence(fn, args, ("memo",), "toy.loop")
    assert [f.rule for f in findings] == ["A007"]
    assert findings[0].severity is Severity.ERROR
    assert findings[0].detail["loop"]["kind"] == "while"
    assert findings[0].detail["loop"]["gain"] > 1.0


def test_a007_bounded_while_carry_clean():
    # v <- max(2v, memo): scaling and max keep the carry's bound at the
    # injected one, so the fixpoint converges (and, run for real, the
    # loop ends)
    fn, args = _while_program(lambda v, m: torch.maximum(2.0 * v, m))
    assert rules_mod.check_divergence(fn, args, ("memo",), "toy.loop") == []


def test_a007_no_tainted_leaves_is_a_warning():
    fn, args = _while_program(lambda v, m: 2.0 * v + m)
    findings = rules_mod.check_divergence(fn, args, ("nonexistent",), "toy")
    assert [f.rule for f in findings] == ["A007"]
    assert findings[0].severity is Severity.WARNING
    assert "unchecked" in findings[0].message


def test_a007_committed_region_steps_clean():
    assert rules_mod.rule_a007(("regions",), device="cpu") == []


def test_a007_transfer_table_is_the_jax_table():
    """The port keys the JAX transfer function by JAX primitive: every
    primitive and bound equals the JAX package's."""
    from repro.analysis import errorprop as jerr
    for name in (jerr._MUL_LIKE | jerr._ADD_LIKE | jerr._DOT_LIKE
                 | jerr._TRANS | jerr._PASS | jerr._EXACT | {"custom"}):
        for rels in ((0.5,), (0.25, 1.0), (0.0, 0.0)):
            assert errorprop._transfer(name, rels) == \
                jerr._transfer(name, rels), name
    assert errorprop.primitive("mm") == "dot_general"
    assert errorprop.primitive("maximum") == "max"
    assert errorprop.primitive("add_") == "add"


# ------------------------------------------- A005 + the two lint hooks

@pytest.fixture(scope="module")
def engine():
    """The A005 engine on a one-rank gloo group, which is gone again after
    the module (the test worker runs other files' groups after it)."""
    import torch.distributed as dist
    from repro_torch.analysis.targets import engine_fixture
    from repro_torch.runtime import elastic
    started = elastic.init_single("cpu")
    yield engine_fixture("cpu")
    if started:
        dist.destroy_process_group()


def test_a005_committed_engine_is_clean(engine):
    assert engine.mesh is not None
    assert rules_mod.check_engine_placement(engine) == []


def test_a005_uncommitted_leaves_flagged(engine):
    from repro_torch.analysis.targets import decode_fixture
    from repro_torch.serving.scheduler import ServingEngine
    fx = decode_fixture("cpu")
    eng = ServingEngine(fx["model"], fx["params"], slots=2, max_len=16,
                        prompt_len=4, devices=1)
    # host arrays, as the JAX fixture's raw params: not laid out
    eng.params = {k: np.zeros(2) for k in ("embed", "head")}
    findings = rules_mod.check_engine_placement(eng)
    assert [f.key for f in findings] == ["A005:serving.engine.params"]
    assert "without mesh commitment" in findings[0].message
    # a cache leaf whose lane dim is not this rank's 2 lanes
    eng.params = fx["params"]
    eng.cache = {"dense": {"k": torch.zeros(2, 5, 2, 16, 8)}}
    eng.tokens = torch.zeros(2, dtype=torch.int32)
    findings = rules_mod.check_engine_placement(eng)
    assert [f.key for f in findings] == ["A005:serving.engine.cache"]
    assert "this rank holds 2" in findings[0].detail["leaves"][0][1]


def test_engine_lint_hook_clean_and_raises(engine):
    from repro_torch.analysis.targets import decode_fixture
    from repro_torch.serving.scheduler import ServingEngine
    fx = decode_fixture("cpu")
    ServingEngine(fx["model"], fx["params"], slots=2, max_len=16,
                  prompt_len=4, devices=1, lint=True)   # must not raise
    on_meta = {k: v.to("meta") if isinstance(v, torch.Tensor) else v
               for k, v in fx["params"].items()}
    with pytest.raises(ValueError, match="A005"):
        ServingEngine(fx["model"], on_meta, slots=2, max_len=16,
                      prompt_len=4, devices=1, lint=True)


def test_run_specs_lint_hook(monkeypatch):
    from repro_torch.apps import approx_ffn
    from repro_torch.core import batching
    from repro_torch.core.harness import run_specs, taf_grid
    from repro_torch.core.types import Level
    grid = taf_grid(h_sizes=(3,), p_sizes=(2,), thresholds=(0.02, 0.1),
                    levels=(Level.BLOCK,))
    app = approx_ffn.make_app(substrate="host", device="cpu")
    assert len(run_specs(app, grid, repeats=1, lint=True)) == len(grid)
    monkeypatch.setattr(batching, "static_key",
                        _leaky_key(batching.static_key))
    with pytest.raises(ValueError, match="A001"):
        run_specs(app, grid, repeats=1, lint=True)


# ------------------------------------------------- CLI + the meta-test

def _cli(*argv):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(_ROOT, "src")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint", "--device",
         "cpu", *argv], capture_output=True, text=True, env=env, cwd=_ROOT,
        timeout=300)


def test_cli_bad_policy_exits_1_good_policy_0(tmp_path):
    bad = _doc([_precise_rung(), _rung(0.05, 0.01, 2.0),
                _rung(0.2, 0.04, 1.8)])
    bp = tmp_path / "bad.json"
    bp.write_text(json.dumps(bad))
    r = _cli("--rules", "A004", "--policies", str(bp), "--format", "json")
    assert r.returncode == 1, r.stderr
    doc = json.loads(r.stdout)
    assert doc["summary"]["errors"] >= 1
    assert all(f["rule"] == "A004" for f in doc["findings"])
    good = _doc([_precise_rung(), _rung(0.05, 0.01, 1.5)])
    gp = tmp_path / "good.json"
    gp.write_text(json.dumps(good))
    r = _cli("--rules", "A004", "--policies", str(gp))
    assert r.returncode == 0, r.stdout + r.stderr


def test_cli_exits_2_when_a_rule_crashes(monkeypatch, capsys):
    """A crashed rule is exit 2, never a clean tree."""
    from repro_torch.analysis import lint

    def boom(*a, **k):
        raise RuntimeError("planted")
    monkeypatch.setattr(rules_mod, "rule_a004", boom)
    assert lint.main(["--rules", "A004", "--device", "cpu"]) == 2
    assert "A004: RuntimeError: planted" in capsys.readouterr().out


def test_cli_device_defaults_to_cuda(capsys):
    """Without a card and without `--device cpu` the lint raises, as every
    port entry point does."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is a valid default")
    from repro_torch.analysis import lint
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lint.main(["--rules", "A004"])


def test_cli_allowlist_is_load_bearing():
    r = _cli("--apps", "kernels", "--rules", "A001", "--no-allowlist",
             "--format", "json")
    assert r.returncode == 1, r.stdout + r.stderr
    doc = json.loads(r.stdout)
    subjects = {f["subject"] for f in doc["findings"]}
    assert subjects == {"kernels.perforated_matmul.perfo",
                        "kernels.perforated_attention.perfo"}
    r = _cli("--apps", "kernels", "--rules", "A001")
    assert r.returncode == 0, r.stdout + r.stderr


def test_meta_current_tree_lints_clean():
    allow = Allowlist.load(default_allowlist_path(_ROOT))
    rep = run_lint(apps=("kernels", "regions", "ffn"), allowlist=allow,
                   device="cpu")
    assert not rep.errors, rep.errors
    assert not rep.findings, rep.render_text()
    assert len(rep.allowlisted) == 3


def test_run_lint_equals_jax_run_lint_on_its_tree():
    """Every group on each package's tree: the same summary and the same
    allowlisted subjects (JAX's targets traced, the port's run)."""
    from repro.analysis.lint import run_lint as jax_run_lint
    allow = Allowlist.load(default_allowlist_path(_ROOT))
    mine = run_lint(allowlist=allow, device="cpu").to_json()
    theirs = jax_run_lint(allowlist=allow).to_json()
    assert mine["summary"] == theirs["summary"]
    assert mine["rule_errors"] == theirs["rule_errors"] == []
    assert sorted(a["finding"]["subject"] for a in mine["allowlisted"]) == \
        sorted(a["finding"]["subject"] for a in theirs["allowlisted"])


# ------------------------------------------------- on the card

@pytest.mark.cuda
class TestOnCard:
    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no "
                        "interpret mode)")
        torch.backends.cuda.matmul.allow_tf32 = False

    def test_graph_replay_traces_the_masked_knobs(self):
        from repro_torch.analysis import targets
        for t in targets.kernel_knob_targets("cuda"):
            if t.graph:
                res = rules_mod.probe_target(t, "cuda")
                assert res.verdict == "traced", (t.subject, res)

    def test_a008_decode_target_is_sync_clean(self):
        assert rules_mod.rule_a008(("decode",), "cuda") == []
