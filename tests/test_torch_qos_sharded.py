"""The port's sharded QoS serving against the invariants of
`tests/test_qos_sharded.py` and against the JAX package's sharded engine.

- **rank-count invariance**: 8 logical shards on one gloo rank and the same
  8 shards on 4 ranks give equal decode outputs, canary estimates and knob
  logs -- a shard's compute never sees another shard's lanes;
- **one shard equals unsharded**: the sharded wrapper does not change
  numerics;
- **no step built, no host read added** by per-shard knob moves: the
  threshold vector is a tensor write into the cache;
- **deterministic, localized per-shard fallback** under the fault drill;
- the control-plane arithmetic (`plan_shards`, `observe_shard`,
  `inject(shard=)`) against the JAX `QosEngine` on the same inputs;
- float32 token streams and knob logs equal to the JAX sharded engine on
  8 fake devices, on the same weights (`convert.lm_params`).

One-rank runs happen in this process on a gloo group of world size 1
(`file://` rendezvous under tmp_path); the 4-rank run and the JAX engine
run in subprocesses.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_distributed import REPO, run_ranks

sys.path.insert(0, REPO)     # the JAX benchmarks package

# the smoke model, a 3-rung synthetic ladder, and a function that serves a
# seeded trace on a (devices, shards) engine -- tests/test_qos_sharded.py's
# preamble, on the port
_PORT_RUN = r"""
import numpy as np, torch
from repro_torch import convert, qos
from repro_torch.models import build
from repro_torch.serving import Request, ServingEngine

cfg = qos.default_decode_cfg()
model = build(cfg, device="cpu")
params = model.init(torch.Generator().manual_seed(0))
records = [
    {"app": "taf_decode", "spec": {"technique": "taf", "level": "block",
     "hSize": 2, "pSize": 4, "thresh": th}, "error": e, "speedup": s,
     "modeled_speedup": s, "workload": {}}
    for th, e, s in [(0.02, 0.005, 1.2), (0.06, 0.02, 1.5),
                     (0.3, 0.08, 2.0)]]
policy = qos.QosPolicy.from_records(records, metric="mcr")

def run(devices, shards, slots, *, seed=0, inject_at=None,
        inject_shard=None, weights=None):
    engine_qos = qos.QosEngine(policy, {"default": 0.10, "batch": 0.5},
                               sample_fraction=0.5, window=8)
    eng = ServingEngine(model, weights or params, slots=slots, max_len=48,
                        prompt_len=8, qos=engine_qos, devices=devices,
                        shards=shards)
    eng.warmup()
    rng = np.random.RandomState(seed)
    reqs = [Request(uid=i, prompt=rng.randint(0, cfg.vocab_size, 8),
                    max_new_tokens=6,
                    qos_class="default" if i % 2 == 0 else "batch")
            for i in range(slots * 2)]
    for r in reqs:
        eng.submit(r)
    for tick in range(200):
        if inject_at is not None and tick == inject_at:
            eng.qos.inject(10.0, shard=inject_shard)
        if eng.tick() == 0 and not eng.queue:
            break
    return eng, reqs

def artifacts(eng, reqs):
    s = eng.qos.summary()
    return {"outputs": [r.output for r in reqs],
            "estimate": s["estimate"],
            "genuine_mean_error": s["genuine_mean_error"],
            "knob_log": [[t, list(v)] for t, v in eng.knob_log],
            "tokens_out": eng.stats.tokens_out,
            "mesh_shape": list(eng.mesh_shape)}
"""


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """The port's serving run, in this process, on a one-rank gloo group."""
    init = tmp_path_factory.mktemp("pg") / "rendezvous"
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=0,
                            world_size=1)
    # smoke-size steps gain nothing from intra-op threads, and beside other
    # test workers they would oversubscribe the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    ns = {}
    exec(_PORT_RUN, ns)
    yield ns
    torch.set_num_threads(threads)
    dist.destroy_process_group()


class TestShardedParity:
    def test_device_count_invariance(self, port, tmp_path):
        """8 logical shards on 4 ranks vs the SAME 8 shards on one rank:
        decode outputs (per request, token for token), canary error
        estimates and knob logs are equal."""
        many = run_ranks(_PORT_RUN + r"""
eng, reqs = run(4, 8, 8)
emit(artifacts(eng, reqs))
""", 4, tmp_path, timeout=150)
        one = port["artifacts"](*port["run"](1, 8, 8))
        assert many[0]["mesh_shape"] == [4, 1]
        assert one["mesh_shape"] == [1, 1]
        for r in many:                   # every rank holds the same view
            assert {k: v for k, v in r.items() if k != "mesh_shape"} == \
                {k: v for k, v in many[0].items() if k != "mesh_shape"}
        for key in ("outputs", "estimate", "genuine_mean_error",
                    "knob_log", "tokens_out"):
            assert many[0][key] == one[key], key
        assert one["tokens_out"] > 0

    def test_sharded_vs_unsharded_outputs(self, port):
        """One shard on a one-rank mesh reproduces the plain (unsharded)
        engine's outputs token for token, and its knob log (per-shard
        1-tuples)."""
        es, rs = port["run"](1, 1, 4)
        ep, rp = port["run"](None, None, 4)
        assert ep.mesh_shape is None and es.mesh_shape == (1, 1)
        assert [r.output for r in rs] == [r.output for r in rp]
        assert es.knob_log == [(t, (v,)) for t, v in ep.knob_log]
        assert es.stats.taf_skipped == ep.stats.taf_skipped > 0
        assert es.stats.shard_skip_fractions == [
            ep.stats.taf_skip_fraction]


class TestNoRebuild:
    def test_per_shard_knob_moves_build_no_step(self, port):
        """The per-shard threshold vector is DATA: serving under a
        changing knob vector builds no step and adds no host read, and
        the written thresholds are live in the cache."""
        from repro_torch.launch import steps as steps_mod
        from repro_torch.obs import metrics as obs_metrics
        from repro_torch.qos import set_decode_threshold
        eng, reqs = port["run"](1, 8, 8)
        base = steps_mod.builds()
        vectors = [(0.3,) * 8, (0.0, 0.3) * 4,
                   tuple(0.1 * s for s in range(8)), (0.0,) * 8]
        for vec in vectors:
            reads = obs_metrics.host_reads()
            set_decode_threshold(eng.cache, vec)
            assert obs_metrics.host_reads() == reads
            rem = eng.cache["taf"]["remaining"].numpy()
            for s, v in enumerate(vec):   # precise shards cancel in-flight
                if v == 0.0:              # predictions
                    assert (rem[s] == 0).all()
            eng.tokens, _, eng.cache = eng._serve(eng.params, eng.cache,
                                                  eng.tokens, 10)
            assert obs_metrics.host_reads() - reads == 1   # the step's own
            th = eng.cache["taf"]["threshold"].numpy()
            np.testing.assert_allclose(th[:, 0], np.asarray(vec),
                                       rtol=1e-6)
        assert steps_mod.builds() == base
        # the engine's own ticks: per-shard knob moves, exact host reads
        eng2, _ = port["run"](1, 8, 8, seed=1)
        assert len(eng2.knob_log) > 1
        assert eng2.host_reads_per_tick == 2


class TestPerShardFallback:
    def test_fault_drill_deterministic_and_localized(self, port):
        """Injecting a spike into ONE shard's canary stream (a) backs off
        the classes live on that shard, and only those, (b) leaves the
        engine-wide estimate fault-free, and (c) is deterministic run to
        run."""
        runs = []
        for _ in range(2):
            eng, _ = port["run"](1, 8, 16, inject_at=4, inject_shard=7)
            s = eng.qos.summary()
            traj = {cls: [(p.step, p.index, p.event)
                          for p in ctl.trajectory]
                    for cls, ctl in eng.qos.controllers.items()}
            hit = {cls: m.injected
                   for cls, m in eng.qos.class_monitors.items()}
            runs.append((eng.knob_log, traj, s["injected_faults"],
                         s["fallback_rate"], hit))
        assert runs[0] == runs[1], "fault drill is nondeterministic"
        knob_log, traj, faults, fb, hit = runs[0]
        assert faults >= 1 and fb > 0.0
        events = [e for t in traj.values() for (_, _, e) in t]
        assert "fallback" in events, events
        # localized: with one lane a shard, shard 7 serves one "batch"
        # request at the drill; only the batch class's evidence is hit
        eng, reqs = port["run"](1, 8, 8, inject_at=4, inject_shard=7)
        assert eng.qos._last_shard_classes[7] == ["batch"]
        hit = {cls: m.injected for cls, m in eng.qos.class_monitors.items()}
        assert hit == {"default": 0, "batch": 1}, hit


def _engines(n_shards):
    """The JAX and the port QosEngine on the same ladder and targets."""
    from repro import qos as jqos
    from repro_torch import qos as tqos
    records = [
        {"app": "taf_decode", "spec": {"technique": "taf", "level": "block",
         "hSize": 2, "pSize": 4, "thresh": th}, "error": e, "speedup": s,
         "modeled_speedup": s, "workload": {}}
        for th, e, s in [(0.02, 0.005, 1.2), (0.06, 0.02, 1.5),
                         (0.3, 0.08, 2.0)]]
    out = []
    for q in (jqos, tqos):
        policy = q.QosPolicy.from_records(records, metric="mcr")
        eng = q.QosEngine(policy, {"default": 0.10, "batch": 0.5},
                          sample_fraction=1.0, window=8)
        if n_shards:
            eng.enable_sharding(n_shards)
        out.append(eng)
    return out


def _plan(p):
    return (p.index, p.knob, p.shard_indices, p.shard_knobs,
            p.precise_lanes, p.n_groups, p.sharded)


class TestShardPlanReduction:
    def test_strictest_live_rung_per_shard_and_global(self):
        plans = []
        for eng in _engines(4):
            eng.controller("default").index = 1
            eng.controller("batch").index = 3
            plans.append(eng.plan_shards([["default"], ["batch"],
                                          ["default", "batch"], []]))
        assert _plan(plans[0]) == _plan(plans[1])
        assert plans[1].shard_indices == (1, 3, 1, 1)
        assert plans[1].index == 1 and len(plans[1].shard_knobs) == 4

    def test_empty_shards_follow_default(self):
        plans = []
        for eng in _engines(2):
            eng.controller("default").index = 2
            plans.append(eng.plan_shards([[], []]))
        assert _plan(plans[0]) == _plan(plans[1])
        assert plans[1].shard_indices == (2, 2) and plans[1].index == 2

    def test_plan_validates_shard_count(self):
        for eng in _engines(4):
            with pytest.raises(ValueError, match="expected 4 shard"):
                eng.plan_shards([["default"]])
        for eng in _engines(0):
            with pytest.raises(ValueError, match="enable_sharding"):
                eng.plan_shards([["default"]])
            assert eng.n_shards is None

    def test_enable_sharding_idempotent_but_not_resizable(self):
        for eng in _engines(4):
            eng.enable_sharding(4)
            assert eng.n_shards == 4
            with pytest.raises(ValueError, match="cannot re-shard"):
                eng.enable_sharding(8)

    def test_regime_changes_reset_evidence_as_jax(self):
        """A seeded walk of plans, canaries, updates and faults: the two
        engines' plans, summaries and trajectories stay equal."""
        rng = np.random.RandomState(3)
        engs = _engines(3)
        classes = ["default", "batch"]
        for t in range(60):
            sc = [[classes[c] for c in rng.randint(0, 2, rng.randint(0, 3))]
                  for _ in range(3)]
            plans = [e.plan_shards(sc) for e in engs]
            assert _plan(plans[0]) == _plan(plans[1]), t
            for s in range(3):
                if sc[s] and rng.rand() < 0.5:
                    ex = rng.standard_normal((len(sc[s]), 6))
                    ap = ex.copy()
                    if rng.rand() < 0.3:
                        ap[:, 0] += 10.0
                    errs = [e.observe_shard(s, ex, ap, sc[s]) for e in engs]
                    assert errs[0] == errs[1]
            if t == 30:
                for e in engs:
                    e.inject(5.0, shard=1)
            for e in engs:
                e.update_shards(sc)
        sums = [e.summary() for e in engs]
        assert json.dumps(sums[0], sort_keys=True, default=str) == \
            json.dumps(sums[1], sort_keys=True, default=str)
        for cls in classes:
            assert [p.to_json() for p in engs[0].controllers[cls].trajectory] \
                == [p.to_json() for p in engs[1].controllers[cls].trajectory]


class TestShardExposure:
    def test_exposure_attributed_to_shard_and_class(self):
        sums = []
        for eng in _engines(2):
            eng.plan_shards([["default"], ["batch"]])
            same = np.zeros((1, 4), np.float32)
            diff = np.zeros((1, 4), np.float32)
            diff[:, 1] = 1.0                 # argmax flips: mcr error = 1
            eng.observe_shard(0, same, same, ["default"])
            eng.observe_shard(1, same, diff, ["batch"])
            sums.append(eng.summary())
        assert sums[0] == sums[1]
        exp = sums[1]["shard_exposure"]
        assert exp[0]["exposed_mean_error"] == 0.0
        assert exp[1]["exposed_mean_error"] == 1.0
        assert sums[1]["classes"]["batch"]["exposed_mean_error"] == 1.0

    def test_shard_inject_hits_only_that_shards_classes(self):
        for eng in _engines(2):
            eng.plan_shards([["default"], ["batch"]])
            eng.inject(5.0, shard=1)
            assert eng.monitor.injected == 1
            assert eng.class_monitors["batch"].injected == 1
            assert eng.class_monitors["default"].injected == 0
        for eng in _engines(0):
            with pytest.raises(ValueError, match="enable_sharding"):
                eng.inject(5.0, shard=0)


_JAX_RUN = r"""
import json, sys, numpy as np, jax
from repro import qos
from repro.models import build
from repro.serving import Request, ServingEngine

cfg = qos.default_decode_cfg()
model = build(cfg)
params = model.init(jax.random.PRNGKey(0))
records = [
    {"app": "taf_decode", "spec": {"technique": "taf", "level": "block",
     "hSize": 2, "pSize": 4, "thresh": th}, "error": e, "speedup": s,
     "modeled_speedup": s, "workload": {}}
    for th, e, s in [(0.02, 0.005, 1.2), (0.06, 0.02, 1.5),
                     (0.3, 0.08, 2.0)]]
policy = qos.QosPolicy.from_records(records, metric="mcr")
engine_qos = qos.QosEngine(policy, {"default": 0.10, "batch": 0.5},
                           sample_fraction=0.5, window=8)
eng = ServingEngine(model, params, slots=8, max_len=48, prompt_len=8,
                    qos=engine_qos, devices=8, shards=8)
eng.warmup()
rng = np.random.RandomState(0)
reqs = [Request(uid=i, prompt=rng.randint(0, cfg.vocab_size, 8),
                max_new_tokens=6,
                qos_class="default" if i % 2 == 0 else "batch")
        for i in range(16)]
for r in reqs:
    eng.submit(r)
for tick in range(200):
    if eng.tick() == 0 and not eng.queue:
        break
flat = {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(a)
        for path, a in jax.tree_util.tree_flatten_with_path(params)[0]}
np.savez(sys.argv[1], **flat)
print("RESULT " + json.dumps({
    "outputs": [[int(t) for t in r.output] for r in reqs],
    "knob_log": [[t, list(v)] for t, v in eng.knob_log],
    "estimate": engine_qos.summary()["estimate"]}))
"""


def test_matches_jax_sharded_engine(port, tmp_path):
    """The JAX sharded engine (8 devices, 8 shards) and the port's (one
    rank, 8 shards) on the same float32 weights: the same token streams
    and knob log."""
    from repro_torch import convert
    path = str(tmp_path / "params.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _JAX_RUN, path], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    want = json.loads([l for l in out.stdout.splitlines()
                       if l.startswith("RESULT ")][-1][len("RESULT "):])
    flat = np.load(path)
    params = {}
    for key in flat.files:
        node = params
        parts = key.split("/")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = flat[key]
    weights = convert.lm_params(params, port["cfg"], device="cpu")
    got = port["artifacts"](*port["run"](1, 8, 8, weights=weights))
    assert got["outputs"] == want["outputs"]
    assert got["knob_log"] == want["knob_log"]
    assert sum(len(o) for o in got["outputs"]) == 16 * 6
    assert len(want["knob_log"]) > 1


def test_qos_drill_sharded_matches_the_jax_drill(port, tmp_path):
    """The `qos` drill with devices=1, shards=2 against the JAX drill
    (`benchmarks/qos_serving.main`, one device, two shards) on the same
    weights: geometry, ladder, measured errors, skip fraction, per-shard
    knob actuations and trajectories and flight dumps equal."""
    import jax
    from benchmarks import qos_serving as jax_drill
    from repro.models import build as jax_build
    from repro import qos as jqos
    from repro_torch import convert, qos
    from repro_torch.benchmarks import qos_serving
    jax_drill.main(lambda *a: None, artifacts_dir=str(tmp_path / "jax"),
                   devices=1, shards=2)
    with open(tmp_path / "jax" / "BENCH_qos.json") as f:
        want = json.load(f)
    params = jax_build(jqos.default_decode_cfg()).init(jax.random.PRNGKey(0))
    r = qos_serving.drill(
        device="cpu", devices=1, shards=2,
        params=convert.lm_params(params, qos.default_decode_cfg(),
                                 device="cpu"))
    eng = r["serving_engine"]
    assert (r["devices"], list(eng.mesh_shape), r["shards"], r["slots"],
            r["requests"]) == (want["devices"], want["mesh_shape"],
                               want["shards"], want["slots"],
                               want["requests"]) == (1, [1, 1], 2, 8, 20)
    assert {str(s): [{"tick": t, "threshold": v[s]}
                     for t, v in eng.knob_log] for s in range(2)} == \
        want["knob_trajectory_per_shard"]
    summary = r["qos_engine"].summary()
    assert summary["genuine_mean_error"] == want["measured_error"]
    assert summary["fallback_rate"] == want["fallback_rate"]
    assert r["qos_stats"].taf_skip_fraction == \
        want["approx"]["taf_skip_fraction"]
    assert [{"tick": m.tick, "threshold": list(m.value),
             "reason": m.reason}
            for m in r["serving_engine"].knob_events] == \
        want["knob_actuations"]
    assert {c: ctl.trajectory_json()
            for c, ctl in r["qos_engine"].controllers.items()} == \
        want["knob_trajectory"]
    assert {str(s): v for s, v in summary["shard_exposure"].items()} == \
        want["shard_exposure"]


def test_runner_devices_flag(port, tmp_path, capsys):
    """`run --only qos --devices 1` on the one-rank group: exit 0, and the
    artifact's exact fields equal the committed H100 baseline's (one
    shard of the unsharded geometry); `--devices 2` on a one-rank group
    raises, naming torchrun."""
    from repro_torch.benchmarks import run as bench_run
    rc = bench_run.main(["--device", "cpu", "--only", "qos", "--devices",
                         "1", "--artifacts", str(tmp_path)])
    assert rc == 0, capsys.readouterr().out[-2000:]
    with open(tmp_path / "BENCH_qos.json") as f:
        doc = json.load(f)
    with open(os.path.join(bench_run.BASELINES, "BENCH_qos.json")) as f:
        base = json.load(f)
    assert doc["mesh_shape"] == [1, 1]
    for key in bench_run._BASELINE_CHECKS["BENCH_qos.json"]["exact"]:
        assert doc[key] == base[key], key
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        bench_run.main(["--device", "cpu", "--only", "qos", "--devices",
                        "2"])


def test_sharded_serve_step_matches_jax(port):
    """`launch.steps.make_sharded_serve_step` (4 shards of 2 lanes, one
    rank) against the JAX `make_sharded_serve_step` on a one-device mesh,
    from the same `shard_taf_state` cache and weights, JAX's greedy tokens
    fed to both: logits within 1e-5 relative and every shard's `remaining`
    equal at every step; mid-run, the per-shard `set_decode_threshold`
    writes the same thresholds and cancels the same predictions."""
    import jax
    import jax.numpy as jnp
    from repro import qos as jqos
    from repro.compat import make_mesh
    from repro.launch import steps as jsteps
    from repro.models import build as jax_build
    from repro.models.lm import shard_taf_state as jax_shard
    from repro.qos import set_decode_threshold as jax_set
    from repro_torch import convert
    from repro_torch.launch import steps as tsteps
    from repro_torch.models.lm import shard_taf_state
    from repro_torch.qos import set_decode_threshold
    from repro_torch.runtime import elastic
    jmodel = jax_build(jqos.default_decode_cfg())
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = convert.lm_params(jparams, port["cfg"], device="cpu")
    toks = np.random.RandomState(4).randint(
        0, port["cfg"].vocab_size, (8, 8)).astype(np.int32)
    _, jc = jax.jit(jsteps.make_prefill_step(jmodel, 32))(
        jparams, {"tokens": jnp.asarray(toks)})
    jc = jax_shard(jc, 4)
    tc = {g: {k: torch.from_numpy(np.array(v)) for k, v in leaves.items()}
          for g, leaves in jc.items()}
    assert {k: tuple(v.shape) for k, v in tc["taf"].items()} == {
        k: tuple(v.shape) for k, v in shard_taf_state(
            port["model"].init_cache(8, 32), 4)["taf"].items()}
    jstep = jax.jit(jsteps.make_sharded_serve_step(
        jmodel, make_mesh((1, 1), ("data", "model")), 4, 8))
    tstep = tsteps.make_sharded_serve_step(
        port["model"], elastic.data_mesh_for(1, device="cpu"), 4, 8)
    tok, skipped = toks[:, -1], 0
    for t in range(10):
        if t == 4:
            vec = (0.0, 0.5, 50.0, 0.5)
            jc = jax_set(jc, vec)
            set_decode_threshold(tc, vec)
            for k in ("threshold", "remaining"):
                np.testing.assert_array_equal(tc["taf"][k].numpy(),
                                              np.asarray(jc["taf"][k]))
        jn, jl, jc = jstep(jparams, jc, jnp.asarray(tok), jnp.int32(8 + t))
        tn, tl, tc = tstep(tparams, tc, torch.as_tensor(tok), 8 + t)
        jl = np.asarray(jl)
        assert np.abs(tl.numpy() - jl).max() / np.abs(jl).max() < 1e-5
        rem = np.asarray(jc["taf"]["remaining"])
        np.testing.assert_array_equal(tc["taf"]["remaining"].numpy(), rem)
        skipped += int((rem > 0).sum())
        tok = np.array(jn)
    assert skipped > 0
