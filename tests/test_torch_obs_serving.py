"""The port's observability on the serving path against the JAX
package's, on the CPU: the flight recorder, the report renderer, typed
knob moves (`KnobMove`, `knob_log`) through both engines, and the
instrumentation contract -- a traced tick builds no step and reads the
device no more than an untraced one (the port's counterpart of JAX's
"zero extra compiles", which eager PyTorch has no literal meaning for).
"""
import json

import numpy as np
import pytest

import jax
import torch

from repro import qos as jqos
from repro.core import harness as jharness
from repro.models import build as jax_build
from repro.obs import recorder as jax_recorder
from repro.obs import report as jax_report
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch import convert, qos
from repro_torch.benchmarks import obs_overhead
from repro_torch.core import harness
from repro_torch.launch import steps as steps_mod
from repro_torch.models import build
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import recorder as obs_recorder
from repro_torch.obs import report as obs_report
from repro_torch.obs import trace as obs_trace
from repro_torch.serving import KnobMove, Request, ServingEngine


@pytest.fixture(autouse=True)
def _no_ambient_obs():
    obs_trace.disable()
    obs_metrics.reset()
    obs_recorder.uninstall()
    jax_recorder.uninstall()
    yield
    obs_trace.disable()
    obs_metrics.reset()
    obs_recorder.uninstall()
    jax_recorder.uninstall()


def _drive_recorder(mod, out_dir):
    rec = mod.FlightRecorder(capacity=3, out_dir=out_dir)
    rec.amend(x=1)                         # empty ring: no-op
    for i in range(5):
        rec.note(tick=i, rung=i % 2)
        rec.amend(tick_s=0.5 * i)
    first = rec.trip("fallback", request_class="batch", estimate=5.0)
    rec.note(tick=5)
    second = rec.trip("monitor", bound=0.1)
    strip = [{k: v for k, v in d.items() if k != "path"}
             for d in (first, second)]
    return len(rec), rec.window(), strip, len(rec.dumps)


def test_flight_recorder_matches_jax(tmp_path):
    got = _drive_recorder(obs_recorder, str(tmp_path / "port"))
    want = _drive_recorder(jax_recorder, str(tmp_path / "jax"))
    assert got == want
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "jax").iterdir())
    with pytest.raises(ValueError):
        obs_recorder.FlightRecorder(capacity=0)
    rec = obs_recorder.install(capacity=4)
    assert obs_recorder.get_recorder() is rec
    assert obs_recorder.uninstall() is rec and \
        obs_recorder.get_recorder() is None


def test_report_renders_as_the_jax_report(tmp_path, capsys):
    tracer = obs_trace.Tracer()
    with obs_trace.use(tracer):
        with obs_trace.span("engine.tick", tick=0):
            with obs_trace.span("tick.serve"):
                pass
        obs_trace.event("knob_move", value=0.3)
        obs_trace.counter("serving.tokens_out", 4)
    path = str(tmp_path / "trace.json")
    tracer.save(path)
    with open(path) as f:
        doc = json.load(f)
    stamped = obs_metrics.stamp({"metric": "x"})
    for d in (doc, stamped, {"counters": {"a": 1.0}}, {"nothing": 1}):
        for kw in ({}, dict(show_timeline=True, top=3)):
            assert obs_report.render(d, **kw) == jax_report.render(d, **kw)
    assert obs_report.main([path, "--timeline"]) == 0
    assert "engine.tick" in capsys.readouterr().out


def _rec(mod, thresh, error, speedup):
    spec = {"technique": "taf", "level": "block", "hSize": 2, "pSize": 4,
            "thresh": thresh}
    return mod.Record(app="toy", spec=spec, error=error, speedup=speedup,
                      modeled_speedup=speedup, approx_fraction=0.5,
                      wall_time_s=1.0, exact_time_s=1.0, extra={})


def test_knob_events_typed_and_equal_to_jax():
    """tests/test_obs.py's knob-event run through both engines on the same
    weights: the same typed moves (tick, value, previous, reason) and the
    `(tick, value)` view."""
    cfg = jqos.default_decode_cfg()
    params = jax_build(cfg).init(jax.random.PRNGKey(0))
    tcfg = qos.default_decode_cfg()
    runs = []
    for mod, hmod, eng_cls, req_cls, model, p in (
            (jqos, jharness, JaxEngine, JaxRequest, jax_build(cfg), params),
            (qos, harness, ServingEngine, Request,
             build(tcfg, device="cpu"),
             convert.lm_params(params, tcfg, device="cpu"))):
        pol = mod.QosPolicy.from_records(
            [_rec(hmod, 0.06, 0.02, 1.5), _rec(hmod, 0.3, 0.08, 3.0)],
            use_modeled=True)
        q = mod.QosEngine(pol, {"default": 0.5}, sample_fraction=1.0,
                          window=4, config=mod.ControllerConfig(
                              min_samples=1, hold_ticks=1))
        eng = eng_cls(model, p, slots=2, max_len=32, prompt_len=8, qos=q)
        rng = np.random.RandomState(7)
        for i in range(2):
            eng.submit(req_cls(uid=i, prompt=rng.randint(
                0, cfg.vocab_size, 8).astype(np.int32), max_new_tokens=8))
        eng.run_until_drained()
        runs.append(([(m.tick, m.value, m.previous, m.reason)
                      for m in eng.knob_events], eng.knob_log))
        if eng_cls is ServingEngine:
            assert all(isinstance(m, KnobMove) for m in eng.knob_events)
            assert eng.knob_events[0].reason == "init"
            assert eng.knob_events[0].previous is None
    assert runs[1] == runs[0] and runs[1][0]


def test_instrumented_tick_builds_nothing_and_reads_nothing_more():
    """Spans, metrics and the flight recorder are host-side appends: with
    tracing on, a tick builds no step and makes exactly the device reads an
    untraced tick makes; per-tick metrics are kept only while tracing."""
    model = build(qos.default_decode_cfg(), device="cpu")
    eng = ServingEngine(model, model.init(torch.Generator().manual_seed(0)),
                        slots=2, max_len=48, prompt_len=8)
    rng = np.random.RandomState(7)
    for i in range(2):
        eng.submit(Request(uid=i, prompt=rng.randint(
            0, model.cfg.vocab_size, 8).astype(np.int32), max_new_tokens=24))
    eng.warmup()
    for _ in range(4):
        eng.tick()
    builds, reads = steps_mod.builds(), obs_metrics.host_reads()
    t = obs_trace.Tracer()
    rec = obs_recorder.install(capacity=8)
    try:
        with obs_trace.use(t):
            for _ in range(4):
                eng.tick()
    finally:
        obs_recorder.uninstall()
    assert steps_mod.builds() == builds
    assert obs_metrics.host_reads() - reads == 4 * eng.host_reads_per_tick
    names = {r_["name"] for r_ in t.records}
    assert {"engine.tick", "tick.serve", "tick.host_read"} <= names
    assert rec.window() == []          # no QoS plane: nothing opened a note
    for _ in range(4):
        eng.tick()
    assert steps_mod.builds() == builds
    assert obs_metrics.registry().histogram("serving.tick_s") \
        .summary()["count"] == 4


def test_obs_overhead_contract_holds_on_the_cpu(tmp_path):
    """The `obs` module's counts (not its wall ratio, which a shared CPU
    cannot pin): no step built and no device read added, tracing off or
    on; BENCH_obs.json carries them under the gate's names."""
    rows = []
    doc = obs_overhead.main(lambda *a: rows.append(a),
                            artifacts_dir=str(tmp_path), device="cpu")
    for key in ("extra_step_builds_disabled", "extra_step_builds_enabled",
                "extra_host_reads_disabled", "extra_host_reads_enabled"):
        assert doc[key] == 0, key
    assert doc["trace_events"] > 0 and doc["metric"] == "obs_overhead"
    with open(tmp_path / "BENCH_obs.json") as f:
        assert json.load(f)["extra_host_reads_enabled"] == 0
    assert any(r[0] == "obs_overhead" for r in rows)
