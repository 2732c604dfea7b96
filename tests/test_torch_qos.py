"""The port's QoS control plane (`repro_torch.qos`) against the JAX
package's (`repro.qos`) on the same records, canary streams, weights and
request traces, on the CPU: policy ladders and selection, monitor errors
(bit for bit), controller trajectories, tick plans, the closed loop
through the serving engine, the calibration sweep and the `qos` drill.

The drill is held against a fresh run of the JAX drill on the same
weights, in the same test (not against the committed
benchmarks/baselines/BENCH_qos.json, which this container's JAX no
longer reproduces). Its wall-clock fields (throughputs, the ladder's
measured `speedup`) are not compared.
"""
import dataclasses
import json
import os
import sys

import numpy as np
import pytest

import jax

from repro import qos as jqos
from repro.core import harness as jharness
from repro.models import build as jax_build
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch import convert, qos
from repro_torch.core import harness
from repro_torch.core import types as tt
from repro_torch.models import build
from repro_torch.serving import Request, ServingEngine

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

# (thresh, error, speedup, modeled) rows of tests/test_qos.py's ladder
LADDER = [(0.05, 0.002, 1.2, None), (0.10, 0.010, 1.5, None),
          (0.20, 0.040, 2.2, None), (0.40, 0.200, 3.0, None),
          (0.15, 0.050, 1.1, None), (0.30, 0.300, 0.8, None)]


def _record(mod, thresh, error, speedup, modeled=None, h=2, p=4):
    spec = {"technique": "taf", "level": "block", "hSize": h, "pSize": p,
            "thresh": thresh}
    return mod.Record(app="toy", spec=spec, error=error, speedup=speedup,
                      modeled_speedup=modeled if modeled is not None
                      else speedup, approx_fraction=0.5, wall_time_s=1.0,
                      exact_time_s=1.0, extra={})


def _policies(rows=LADDER, **kw):
    return (jqos.QosPolicy.from_records(
        [_record(jharness, *r) for r in rows], **kw),
        qos.QosPolicy.from_records([_record(harness, *r) for r in rows],
                                   **kw))


def _ladder(pol):
    return [(e.spec, e.error, e.speedup, e.modeled_speedup, e.spec_hash)
            for e in pol.entries]


@pytest.mark.parametrize("kw", [{}, dict(use_modeled=True, app="toy"),
                                dict(metric="mcr")])
def test_policy_ladder_and_selection_match_jax(kw, tmp_path):
    jp, tp = _policies(**kw)
    assert _ladder(tp) == _ladder(jp)
    for target in (0.05, 0.011, 0.010, 1e-9, 0.3):
        assert tp.select(target) == jp.select(target)
        assert tp.choose(target).to_json() == jp.choose(target).to_json()
    assert tp.to_json() == jp.to_json()
    path = str(tmp_path / "policy.json")
    tp.save(path)
    assert _ladder(jqos.QosPolicy.load(path)) == _ladder(jp)
    assert tp.to_json() == qos.QosPolicy.load(path).to_json()


def test_policy_validation_matches_jax():
    skip = {"technique": "perfo", "level": "element", "kind": "small",
            "skip": 4, "fraction": 0.25, "herded": True}
    bad = qos.QosPolicy([qos.PolicyEntry(spec=skip, error=0.01, speedup=2.0,
                                         modeled_speedup=2.0)])
    with pytest.raises(ValueError, match="traced quality knob"):
        qos.validate_ladder_knobs(bad)
    _, tp = _policies()
    qos.validate_ladder_knobs(tp)
    with pytest.raises(ValueError, match="structural"):
        qos.validate_ladder_taf(tp, tt.TAFParams(5, 9, 0.1))
    with pytest.raises(ValueError, match="max_error"):
        qos.QosTarget(0.0)
    spec = tt.ApproxSpec(tt.Technique.TAF, tt.Level.BLOCK,
                         taf=tt.TAFParams(2, 4, 0.3))
    assert qos.spec_knob(spec) == pytest.approx(0.3)
    assert qos.spec_knob(None) is None


def test_monitor_errors_match_offline_metrics_bitwise():
    """The port's canary errors equal JAX's monitor and the offline
    metrics bit for bit, and so do window estimates and drift."""
    rng = np.random.RandomState(0)
    for metric in ("mape", "mcr"):
        jm = jqos.QualityMonitor(metric=metric, sample_fraction=1.0,
                                 window=4)
        tm = qos.QualityMonitor(metric=metric, sample_fraction=1.0, window=4)
        for _ in range(7):
            if metric == "mape":
                a, b = rng.randn(3, 7), rng.randn(3, 7)
            else:
                a, b = rng.randint(0, 5, 20), rng.randint(0, 5, 20)
            err = tm.observe(a, b)
            assert err == jm.observe(a, b) == getattr(harness, metric)(a, b)
            assert tm.stats() == jm.stats() or \
                dataclasses.asdict(tm.stats()) == dataclasses.asdict(
                    jm.stats())
        tm.inject(9.0)
        jm.inject(9.0)
        assert dataclasses.asdict(tm.stats()) == \
            dataclasses.asdict(jm.stats())


@pytest.mark.parametrize("fraction,phase", [(0.25, 0.0), (0.1, 0.0),
                                            (0.3, 0.5), (1.0, 0.0),
                                            (0.0, 0.0)])
def test_canary_schedule_matches_jax(fraction, phase):
    tm = qos.QualityMonitor(sample_fraction=fraction, phase=phase)
    jm = jqos.QualityMonitor(sample_fraction=fraction, phase=phase)
    assert [tm.should_sample() for _ in range(100)] == \
        [jm.should_sample() for _ in range(100)]


STREAMS = {
    "loosen": ([0.045, 0.045] + [0.0005] * 10, 0.05, {}),
    "explore": ([0.0005] * 8, 0.05, dict(trust_offline=False)),
    "pressure": ([0.045] * 4, 0.05, {}),
    "fallback": ([0.001, 0.001, 10.0, 0.0, 0.0, 0.0, 0.0] + [None] * 6,
                 0.05, {}),
    "drift": ([0.0001, 0.004] * 6, 0.05,
              dict(drift_limit=0.5, trust_offline=False)),
}


@pytest.mark.parametrize("stream", list(STREAMS))
def test_controller_trajectories_match_jax(stream):
    errors, target, cfg_kw = STREAMS[stream]
    base = dict(headroom=0.8, backoff=0.5, min_samples=2, hold_ticks=2,
                fallback_hold=3, drift_limit=10.0)
    base.update(cfg_kw)
    out = []
    for mod, pol in zip((jqos, qos), _policies()):
        mon = mod.QualityMonitor(sample_fraction=1.0, window=4)
        ctl = mod.QosController(pol, mon, target,
                                mod.ControllerConfig(**base))
        for e in errors:
            if e is not None:
                mon.inject(e)
            ctl.update()
        out.append((ctl.trajectory_json(), ctl.summary()))
    assert out[0] == out[1]


def test_plan_tick_and_engine_updates_match_jax():
    jp, tp = _policies()
    cfg = dict(headroom=0.8, backoff=0.5, min_samples=1, hold_ticks=1,
               fallback_hold=3, drift_limit=10.0)
    engines = [mod.QosEngine(pol, {"default": 0.05, "batch": 1.0},
                             sample_fraction=1.0, window=4,
                             config=mod.ControllerConfig(**cfg))
               for mod, pol in ((jqos, jp), (qos, tp))]
    script = [(["batch", "default", "batch"], None), (["batch"], 0.001),
              (["batch"], 10.0), (["default", "batch"], None),
              (["default"], 0.0), ([], None), (["unknown"], 0.02)]
    for classes, fault in script:
        plans = []
        for eng in engines:
            plan = eng.plan_tick(classes)
            groups = {tuple(getattr(k, "value", k) for k in key): v
                      for key, v in plan.groups.items()}
            plans.append((plan.index, plan.knob, groups,
                          plan.precise_lanes, plan.n_groups))
            if fault is not None:
                eng.monitor.inject(fault)
            eng.update(classes)
        assert plans[0] == plans[1]
    assert engines[0].summary() == engines[1].summary()


# --------------------------------------------------- through the engine

@pytest.fixture(scope="module")
def decode_pair():
    """default_decode_cfg's model in both packages on the same weights."""
    cfg, tcfg = jqos.default_decode_cfg(), qos.default_decode_cfg()
    model = jax_build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    return (cfg, model, params, build(tcfg, device="cpu"),
            convert.lm_params(params, tcfg, device="cpu"))


def _serving_policies(metric="mape"):
    rows = [(0.06, 0.02, 1.5, None), (0.3, 0.08, 3.0, None)]
    return _policies(rows, use_modeled=True, metric=metric)


def _requests(cfg, R, n, gen):
    rng = np.random.RandomState(7)
    return [R(uid=i, prompt=rng.randint(0, cfg.vocab_size, 8)
              .astype(np.int32), max_new_tokens=gen) for i in range(n)]


def test_closed_loop_through_the_engine_matches_jax(decode_pair):
    """tests/test_qos.py's closed-loop drill (mcr bound 2.0, an injected
    spike after six ticks) through both engines: the same tokens, counts,
    knob moves with their reasons, trajectories and summary; the fallback
    zeroes threshold and predictions; no step is built after construction."""
    from repro_torch.launch import steps as steps_mod
    cfg, model, params, tmodel, tparams = decode_pair
    ccfg = dict(headroom=0.8, backoff=0.5, min_samples=1, hold_ticks=1,
                fallback_hold=3, drift_limit=10.0)
    runs = []
    for mod, pol, eng_cls, req_cls, m, p in (
            (jqos, _serving_policies("mcr")[0], JaxEngine, JaxRequest, model,
             params),
            (qos, _serving_policies("mcr")[1], ServingEngine, Request,
             tmodel, tparams)):
        q = mod.QosEngine(pol, 2.0, sample_fraction=1.0, window=4,
                          config=mod.ControllerConfig(**ccfg))
        eng = eng_cls(m, p, slots=2, max_len=32, prompt_len=8, qos=q)
        reqs = _requests(cfg, req_cls, 2, 10)
        for r in reqs:
            eng.submit(r)
        for _ in range(6):
            eng.tick()
        q.monitor.inject(10.0)
        eng.tick()
        eng.tick()
        taf = eng.cache["taf"]
        thr = float(np.max(np.asarray(taf["threshold"])))
        rem = int(np.asarray(taf["remaining"]).sum())
        builds = steps_mod.builds()
        stats = eng.run_until_drained()
        assert steps_mod.builds() == builds
        runs.append(dict(
            tokens=[r.output for r in reqs], thr=thr, rem=rem,
            stats=(stats.ticks, stats.tokens_out, stats.taf_skipped,
                   stats.taf_total, stats.canary_ticks, stats.knob_moves),
            knobs=[(k.tick, k.value, k.previous, k.reason)
                   for k in eng.knob_events],
            traj=q.controllers["default"].trajectory_json(),
            summary=q.summary()))
    assert runs[1] == runs[0]
    assert runs[1]["thr"] == 0.0 and runs[1]["rem"] == 0
    assert runs[1]["summary"]["mean_error"] < 2.0


def test_precise_canaries_are_bit_exact(decode_pair):
    """With the knob pinned precise, the served step and the canary oracle
    are the same computation: every canary error is exactly 0.0."""
    cfg, _, _, tmodel, tparams = decode_pair
    q = qos.QosEngine(_serving_policies()[1], 1e-9, sample_fraction=1.0,
                      window=8)
    eng = ServingEngine(tmodel, tparams, slots=2, max_len=32, prompt_len=8,
                        qos=q)
    for r in _requests(cfg, Request, 2, 5):
        eng.submit(r)
    stats = eng.run_until_drained()
    ms = q.monitor.stats()
    assert stats.canary_ticks > 0 and ms.samples == stats.canary_ticks
    assert ms.mean_error == 0.0 and ms.estimate == 0.0
    assert stats.taf_skipped == 0


def test_engine_refuses_a_model_or_ladder_it_cannot_actuate(decode_pair):
    cfg, _, _, tmodel, tparams = decode_pair
    plain = build(dataclasses.replace(tmodel.cfg,
                                      approx_decode=tt.ApproxSpec()),
                  device="cpu")
    with pytest.raises(ValueError, match="decode-time TAF"):
        ServingEngine(plain, tparams,
                      qos=qos.QosEngine(_serving_policies()[1], 0.1))
    mismatched = qos.QosPolicy.from_records(
        [_record(harness, 0.1, 0.02, 1.5, h=5, p=9)], use_modeled=True)
    with pytest.raises(ValueError, match="structural"):
        ServingEngine(tmodel, tparams, qos=qos.QosEngine(mismatched, 0.1))


@pytest.mark.parametrize("metric", ["mcr", "mape"])
def test_calibration_sweep_matches_jax(decode_pair, tmp_path, metric):
    """`make_decode_app` + `harness.sweep` on the same weights: the same
    approx fractions and skip counts, and the same token-mismatch errors
    (mcr); threshold 0 reproduces the exact baseline bit for bit; the DB
    feeds `QosPolicy.from_db`. MAPE over logits divides by logits near
    zero (heavy-tailed, as calibrate's docstring warns), so logits equal to
    1e-6 give MAPEs equal to 1%."""
    cfg, _, params, _, tparams = decode_pair
    japp = jqos.make_decode_app(cfg, gen=4, batch=1, metric=metric)
    tapp = qos.make_decode_app(qos.default_decode_cfg(), gen=4, batch=1,
                               device="cpu", params=tparams, metric=metric)
    assert tapp.workload == japp.workload
    db = str(tmp_path / "db.json")
    jr = jharness.sweep(japp, jqos.threshold_grid(cfg, [0.02, 0.3, 5.0]),
                        repeats=1)
    tr = harness.sweep(tapp, qos.threshold_grid(qos.default_decode_cfg(),
                                                [0.02, 0.3, 5.0]),
                       repeats=1, db_path=db)
    for a, b in zip(jr, tr):
        assert (b.spec, b.approx_fraction, b.modeled_speedup, b.extra) == \
            (a.spec, a.approx_fraction, a.modeled_speedup, a.extra)
        if metric == "mcr":
            assert b.error == a.error
        else:
            assert b.error == pytest.approx(a.error, rel=1e-2)
    np.testing.assert_array_equal(tapp.exact().qoi,
                                  tapp.run(tt.ApproxSpec()).qoi)
    bad = tt.ApproxSpec(tt.Technique.TAF, tt.Level.BLOCK,
                        taf=tt.TAFParams(5, 9, 0.1))
    with pytest.raises(ValueError, match="structural"):
        tapp.run(bad)
    assert qos.QosPolicy.from_db(db, app="taf_decode",
                                 use_modeled=True).entries[0].precise


def test_decode_cost_model_and_prescreen_match_jax():
    from repro.qos import calibrate as jcal
    from repro_torch.qos import calibrate as tcal
    grid = (0.01, 0.06, 0.3, 2.0)
    for machine in ("host-sim",):
        jm = jcal.decode_cost_model(machine=machine)
        tm = tcal.decode_cost_model(machine=machine)
        for jspec, tspec in zip(jqos.threshold_grid(jqos.default_decode_cfg(),
                                                    grid),
                                qos.threshold_grid(qos.default_decode_cfg(),
                                                   grid)):
            a, b = jm.predict(jspec), tm.predict(tspec)
            assert b.speedup == pytest.approx(a.speedup, rel=1e-9)
            assert b.error_bound == pytest.approx(a.error_bound, rel=1e-9)
        kept_j = jcal.prescreen_thresholds(jqos.default_decode_cfg(), grid,
                                           machine=machine, max_error=0.5)
        kept_t = tcal.prescreen_thresholds(qos.default_decode_cfg(), grid,
                                           machine=machine, max_error=0.5)
        assert [s.taf.rsd_threshold for s in kept_t] == \
            [s.taf.rsd_threshold for s in kept_j]


def test_qos_drill_matches_the_jax_drill(tmp_path):
    """The `qos` drill's deterministic fields against the JAX drill
    (`benchmarks/qos_serving.main`) on the same weights, run here."""
    sys.path.insert(0, REPO)
    from benchmarks import qos_serving as jax_drill
    from repro_torch.benchmarks import qos_serving
    jax_drill.main(lambda *a: None, artifacts_dir=str(tmp_path / "jax"))
    with open(tmp_path / "jax" / "BENCH_qos.json") as f:
        want = json.load(f)
    params = jax_build(jqos.default_decode_cfg()).init(jax.random.PRNGKey(0))
    r = qos_serving.drill(
        device="cpu", artifacts_dir=str(tmp_path / "port"),
        params=convert.lm_params(params, qos.default_decode_cfg(),
                                 device="cpu"))
    ladder = [(e.spec, e.error, e.modeled_speedup)
              for e in r["policy"].entries]
    assert ladder == [(e["spec"], e["error"], e["modeled_speedup"])
                      for e in want["policy_ladder"]]
    summary = r["qos_engine"].summary()
    assert summary["genuine_mean_error"] == want["measured_error"]
    assert summary["mean_error"] == want["measured_error_with_faults"]
    assert summary["fallback_rate"] == want["fallback_rate"]
    assert r["qos_stats"].taf_skip_fraction == \
        want["approx"]["taf_skip_fraction"]
    assert r["qos_stats"].knob_moves == want["approx"]["knob_moves"]
    assert r["qos_stats"].canary_ticks == want["approx"]["canary_ticks"]
    assert [{"tick": m.tick, "threshold": m.value, "reason": m.reason}
            for m in r["serving_engine"].knob_events] == \
        want["knob_actuations"]
    assert {c: ctl.trajectory_json()
            for c, ctl in r["qos_engine"].controllers.items()} == \
        want["knob_trajectory"]
    assert [{"reason": d["reason"], "context": d["context"],
             "ticks": len(d["ticks"])} for d in r["flight"].dumps] == \
        want["flight_dumps"]
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(n for n in os.listdir(tmp_path / "jax")
               if n.startswith("flight_"))
