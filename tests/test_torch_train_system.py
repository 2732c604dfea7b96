"""The training substrates of the port against the JAX package, on the
CPU: AdamW and the schedules, the synthetic data pipeline, the checkpoint
manager, the train steps (plain and accumulated), the train driver with
resume and preemption, the 100M example and the meta-device specs.

Tolerances: AdamW fed the same gradients within atol 1e-7 (params and
moments; one ulp where the value's dtype is coarser); schedules within 1e-7; data bit for bit. A train step: the loss
within 1e-5 relative, `grad_norm` within 1e-4, and each parameter within
atol 1e-6 of JAX's wherever its gradient |g| > 1e-4 * rms(g) and the
clipped gradient is above 100 eps. There AdamW moves a parameter by about
lr * sign(g) (m / sqrt(v) = g / |g| at step 1); a gradient of pure
rounding noise can flip sign and land that element 2 lr away, and where
the clipped gradient nears eps the update g / (|g| + eps) carries the
float32 rounding of g itself: only there is 2 lr allowed (plus the atol).
"""
import dataclasses
import os
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.configs.base import ShapeConfig as JShape
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch import specs as jspecs
from repro.launch import steps as jsteps
from repro.models import build as jax_build
from repro.optim import adamw as jadamw
from repro.optim import schedule as jsched
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint import manager as ckpt_manager
from repro_torch.configs import get_smoke_config, list_archs
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import DataConfig, PrefetchIterator, SyntheticLM
from repro_torch.launch import specs, steps
from repro_torch.launch import train as train_mod
from repro_torch.models import build
from repro_torch.optim import adamw, schedule

LR = 1e-3


def _leaves(tree, path=()):
    """(path, leaf) pairs in sorted key order (JAX's pytree order)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _leaves(v, path + (i,))]
    return [(path, tree)]


def _port(tree, cfg):
    """A JAX parameter-shaped tree (params, grads or moments) as the
    port's float32-exact tree, by path."""
    return dict(_leaves(convert.lm_params(tree, cfg, device="cpu",
                                          masters=True)))


def _setup(arch="qwen3-1.7b", cdt="float32", rows=4, seq=16, seed=7,
           **kw):
    cfg = dataclasses.replace(jax_smoke(arch), compute_dtype=cdt, **kw)
    tcfg = dataclasses.replace(get_smoke_config(arch), compute_dtype=cdt,
                               **kw)
    model = jax_build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)
    batch = {"tokens": rng.randint(0, cfg.vocab_size, (rows, seq))
             .astype(np.int32),
             "labels": rng.randint(0, cfg.vocab_size, (rows, seq))
             .astype(np.int32)}
    return cfg, tcfg, model, params, batch


def _masters(params, tcfg):
    return convert.lm_params(params, tcfg, device="cpu", masters=True)


# ----------------------------------------------------------------------------
# AdamW and the schedules
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("pdt", ["float32", "bfloat16"])
def test_adamw_fed_the_same_grads_matches_jax(pdt):
    """Three updates from the same params, state and gradients (seeded,
    with a clipping norm below the gradients' so the clip scale bites):
    params and moments within 1e-7 -- or one ulp of the value's dtype
    where that is coarser (a float32 norm scale near 1.0: 1.19e-7; the
    final rounding of p - lr delta can land on either neighbour) -- the
    step counter equal and grad_norm within 1e-5 (float32 sums of
    squares in another order). With param_dtype
    bfloat16 (deepseek-v3's) the masters are bfloat16 and the moments
    float32."""
    cfg, tcfg, _, params, _ = _setup(param_dtype=pdt)
    rng = np.random.RandomState(1)
    ocfg = adamw.AdamWConfig(lr=LR, grad_clip=0.5)
    jcfg = jadamw.AdamWConfig(lr=LR, grad_clip=0.5)
    jstate = jadamw.init(params)
    masters = _masters(params, tcfg)
    state = adamw.init(masters)
    jp = params
    jupdate = jax.jit(lambda g, st, p, lr: jadamw.update(jcfg, g, st, p, lr))
    for step in range(3):
        grads = jax.tree.map(lambda p: jnp.asarray(
            rng.standard_normal(p.shape) * 0.01, p.dtype), jp)
        lr_scale = jsched.warmup_cosine(jstate.step, warmup_steps=1,
                                        total_steps=3)
        jp, jstate, jm = jupdate(grads, jstate, jp, lr_scale)
        tgrads = convert.lm_params(grads, tcfg, device="cpu", masters=True)
        tl = schedule.warmup_cosine(state.step, warmup_steps=1, total_steps=3)
        masters, state, tm = adamw.update(ocfg, tgrads, state, masters, tl)
        assert int(state.step) == int(jstate.step) == step + 1
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-5 * float(jm["grad_norm"])
        jmv = convert.adamw_state(jstate, tcfg, device="cpu")
        for mine, ref in ((dict(_leaves(masters)), _port(jp, tcfg)),
                          (dict(_leaves(state.m)), dict(_leaves(jmv.m))),
                          (dict(_leaves(state.v)), dict(_leaves(jmv.v)))):
            for path, t in ref.items():
                assert mine[path].dtype == t.dtype, path
                err = (mine[path].double() - t.double()).abs()
                ulp = torch.from_numpy(np.spacing(np.abs(
                    t.float().numpy()))).double()
                assert bool((err <= 1e-7 + ulp).all()), \
                    (step, path, float(err.max()))


def test_adamw_state_converts_exactly():
    cfg, tcfg, _, params, _ = _setup("deepseek-v3-671b")
    state = jadamw.init(params)
    state = jadamw.AdamWState(
        jnp.int32(5),
        jax.tree.map(lambda p: jnp.full(p.shape, 0.123456789, jnp.float32),
                     params), state.v)
    mine = convert.adamw_state(state, tcfg, device="cpu")
    assert mine.step.dtype == torch.int32 and int(mine.step) == 5
    for _, t in _leaves(mine.m):
        assert t.dtype == torch.float32
        assert float(t.flatten()[0]) == float(np.float32(0.123456789))


def test_adamw_converges_on_quadratic_and_clips():
    ocfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw.init(params)
    for _ in range(200):
        params, state, _ = adamw.update(ocfg, {"w": 2 * params["w"]}, state,
                                        params)
    assert float(params["w"].abs().max()) < 0.05
    clipped, norm = adamw.clip_by_global_norm(
        {"w": torch.tensor([3.0, 4.0])}, 1.0)
    assert abs(float(norm) - 5.0) < 1e-6
    assert torch.allclose(clipped["w"], torch.tensor([0.6, 0.8]))


def test_adamw_groups_bound_the_temporaries(monkeypatch):
    """Leaves go through foreach groups of at most GROUP_ELEMENTS (a larger
    leaf alone), and the update is the same whatever the grouping."""
    monkeypatch.setattr(adamw, "GROUP_ELEMENTS", 9)
    assert [list(r) for r in adamw._groups([3, 3, 3, 9, 1])] == \
        [[0, 1, 2], [3], [4]]
    shapes = [(3,), (3,), (3,), (3, 3), (1,)]
    out = []
    for group in (9, 1 << 28):
        monkeypatch.setattr(adamw, "GROUP_ELEMENTS", group)
        rng = np.random.RandomState(0)
        p = [torch.tensor(rng.standard_normal(s), dtype=torch.float32)
             for s in shapes]
        g = [torch.tensor(rng.standard_normal(s), dtype=torch.float32)
             for s in shapes]
        st = adamw.init(p)
        adamw.update(adamw.AdamWConfig(lr=0.01), g, st, p)
        out.append(p)
    assert all(torch.equal(a, b) for a, b in zip(*out))


@pytest.mark.parametrize("kind", ["warmup_cosine", "constant"])
def test_schedules_match_jax(kind):
    kw = dict(warmup_steps=5, total_steps=20)
    for step in range(21):
        j = float(getattr(jsched, kind)(step, **kw))
        t = getattr(schedule, kind)(torch.tensor(step, dtype=torch.int32),
                                    **kw)
        assert t.dtype == torch.float32
        assert abs(float(t) - j) <= 1e-7, (step, float(t), j)
    assert float(schedule.warmup_cosine(0, **kw)) == 0.0
    assert float(schedule.warmup_cosine(20, **kw)) <= 0.11


# ----------------------------------------------------------------------------
# data
# ----------------------------------------------------------------------------

def test_data_batches_equal_jax_across_steps_and_shards():
    kw = dict(vocab_size=100, seq_len=16, global_batch=8, seed=3)
    jds, tds = JSyntheticLM(JDataConfig(**kw)), SyntheticLM(DataConfig(**kw))
    for step in (0, 1, 7):
        for shards in (1, 2, 4):
            for i in range(shards):
                a, b = jds.batch(step, i, shards), tds.batch(step, i, shards)
                assert a.keys() == b.keys()
                for k in a:
                    assert a[k].dtype == b[k].dtype
                    np.testing.assert_array_equal(a[k], b[k])
    it = PrefetchIterator(tds, start_step=2, shard_index=1, num_shards=2)
    try:
        for step in (2, 3):
            np.testing.assert_array_equal(next(it)["tokens"],
                                          jds.batch(step, 1, 2)["tokens"])
    finally:
        it.close()


# ----------------------------------------------------------------------------
# checkpoints
# ----------------------------------------------------------------------------

def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.int32)},
            "h": [torch.full((2,), 0.1, dtype=torch.bfloat16)]}


def test_checkpoint_roundtrip_keeps_values_and_dtypes(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = (_tree(), adamw.init({"w": torch.ones(3)}))
    mgr.save(5, tree)
    restored, step = mgr.restore(tree)
    assert step == 5 and isinstance(restored[1], adamw.AdamWState)
    for (pa, a), (pb, b) in zip(_leaves(tree[0]), _leaves(restored[0])):
        assert pa == pb and a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(restored[1].step, tree[1].step)


def test_checkpoint_retention_and_atomic_publish(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"a": torch.zeros(2)})
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_checkpoint_refuses_a_shape_mismatch(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.zeros(4)})
    with pytest.raises(ValueError):
        mgr.restore({"w": torch.zeros(5)})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore({"w": None})


def test_async_save_snapshots_before_the_writer_runs(tmp_path, monkeypatch):
    """The writer thread is held until the tree has been updated in place
    (as AdamW updates masters and moments): the checkpoint holds the
    values at save time."""
    gate, entered = threading.Event(), threading.Event()
    real = torch.save

    def held_save(obj, path):
        entered.set()
        gate.wait(10)
        real(obj, path)

    monkeypatch.setattr(ckpt_manager.torch, "save", held_save)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    tree = {"w": torch.arange(1000.0)}
    mgr.save(1, tree)
    assert entered.wait(10)
    tree["w"].add_(1.0)                      # the next step, in place
    gate.set()
    mgr.wait()
    restored, _ = mgr.restore({"w": torch.zeros(1000)})
    assert torch.equal(restored["w"], torch.arange(1000.0))


# ----------------------------------------------------------------------------
# train steps
# ----------------------------------------------------------------------------

def _params_close(mine, ref, grads, lr, grad_norm, eps=1e-8):
    """Each leaf within 1e-6 where |g| > 1e-4 rms(g) and AdamW moves the
    parameter by lr sign(g), i.e. the clipped gradient is far above eps
    (|g min(1, 1 / grad_norm)| > 100 eps: below it the update is
    g / (|g| + eps), which turns the float32 rounding of g itself into a
    relative change of the update); elsewhere within 2 lr + 1e-6 (a sign
    flip of a rounding-noise gradient)."""
    scale = min(1.0, 1.0 / grad_norm)
    for path, r in ref.items():
        g = grads[path].double()
        rms = float(torch.sqrt(torch.mean(g * g)))
        d = (mine[path].double() - r.double()).abs()
        big = (g.abs() > 1e-4 * rms) & (g.abs() * scale > 100 * eps)
        assert not bool(big.any()) or float(d[big].max()) <= 1e-6, path
        assert float(d.max()) <= 2 * lr + 1e-6, path


def test_train_step_matches_jax():
    """One make_train_step from the same masters and batch: loss, xent,
    grad_norm and the updated params against the JAX step (warmup-cosine
    at step 3 of 10, so the learning rate is past warmup)."""
    cfg, tcfg, model, params, batch = _setup()
    kw = dict(warmup_steps=2, total_steps=10)
    jstep = jax.jit(jsteps.make_train_step(
        model, jadamw.AdamWConfig(lr=LR), jsched.warmup_cosine, kw))
    jstate = jadamw.init(params)._replace(step=jnp.int32(3))
    jp, _, jm = jstep(params, jstate, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    jg = jax.grad(lambda p: model.loss(p, batch)[0])(params)
    tmodel = build(tcfg, device="cpu")
    masters = _masters(params, tcfg)
    state = adamw.init(masters)
    state.step.fill_(3)
    builds = steps.builds()
    step = steps.make_train_step(tmodel, adamw.AdamWConfig(lr=LR),
                                 schedule.warmup_cosine, kw)
    assert steps.builds() == builds + 1
    masters, state, m = step(masters, state, batch)
    assert set(m) == {"loss", "xent", "aux_loss", "grad_norm"}
    assert abs(float(m["loss"]) - float(jm["loss"])) <= \
        1e-5 * abs(float(jm["loss"]))
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
        1e-4 * float(jm["grad_norm"])
    assert int(state.step) == 4
    _params_close(dict(_leaves(masters)), _port(jp, tcfg), _port(jg, tcfg),
                  LR, float(jm["grad_norm"]))


def test_accumulated_step_equals_the_full_batch_and_jax():
    """accum_steps=4 against the full-batch step (tests/test_perf_features
    .py's bound, 1e-4) and against JAX's accumulated step."""
    cfg, tcfg, model, params, batch = _setup(rows=8, seq=32)
    tmodel = build(tcfg, device="cpu")
    ocfg = adamw.AdamWConfig(lr=LR)
    out = {}
    for name, make in (("full", lambda: steps.make_train_step(tmodel, ocfg)),
                       ("acc", lambda: steps.make_train_step_accum(
                           tmodel, ocfg, accum_steps=4))):
        masters = _masters(params, tcfg)
        p, _, m = make()(masters, adamw.init(masters), batch)
        out[name] = (dict(_leaves(p)), float(m["loss"]))
    assert abs(out["full"][1] - out["acc"][1]) < 1e-4
    assert max(float((out["full"][0][k] - v).abs().max())
               for k, v in out["acc"][0].items()) < 1e-4
    jp, _, jm = jax.jit(jsteps.make_train_step_accum(
        model, jadamw.AdamWConfig(lr=LR), accum_steps=4))(
            params, jadamw.init(params),
            {k: jnp.asarray(v) for k, v in batch.items()})
    assert abs(out["acc"][1] - float(jm["loss"])) <= \
        1e-5 * abs(float(jm["loss"]))
    jg = jax.grad(lambda p: model.loss(p, batch)[0])(params)
    _params_close(out["acc"][0], _port(jp, tcfg), _port(jg, tcfg), LR,
                  float(jm["grad_norm"]))


# ----------------------------------------------------------------------------
# the driver (tests/test_system.py's contracts)
# ----------------------------------------------------------------------------

def test_training_reduces_loss(tmp_path):
    losses = train_mod.main([
        "--arch", "qwen3-1.7b", "--smoke", "--steps", "30", "--batch", "4",
        "--seq-len", "64", "--ckpt-dir", str(tmp_path), "--ckpt-every", "10",
        "--log-every", "100", "--device", "cpu"])
    assert len(losses) == 30
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_checkpoint_resume_is_exact(tmp_path):
    """(20 steps) == (10 steps, 'crash', resume 10 more): the same final
    loss, the data replaying by step and the checkpoint holding (params,
    opt_state, step)."""
    common = ["--arch", "deepseek-7b", "--smoke", "--batch", "4",
              "--seq-len", "32", "--log-every", "100", "--device", "cpu"]
    full = train_mod.main(common + ["--steps", "20"])
    train_mod.main(common + ["--steps", "10", "--ckpt-dir", str(tmp_path),
                             "--ckpt-every", "10"])
    resumed = train_mod.main(common + ["--steps", "20", "--ckpt-dir",
                                       str(tmp_path), "--resume"])
    assert len(resumed) == 10
    np.testing.assert_allclose(resumed[-1], full[-1], rtol=1e-4)


class _TripAfter(train_mod.PreemptionGuard):
    """A guard whose preemption signal arrives after `TRIP` polls."""
    TRIP = 6

    def __init__(self, install=True):
        super().__init__(install=False)
        self.polls = 0

    @property
    def should_stop(self):
        self.polls += 1
        if self.polls == self.TRIP:
            self.trigger()
        return self._flag


def test_preemption_checkpoints_and_exits_42_then_resumes(tmp_path,
                                                         monkeypatch):
    common = ["--arch", "qwen3-1.7b", "--smoke", "--batch", "2",
              "--seq-len", "16", "--steps", "10", "--log-every", "100",
              "--device", "cpu"]
    full = train_mod.main(common)
    monkeypatch.setattr(train_mod, "PreemptionGuard", _TripAfter)
    with pytest.raises(SystemExit) as exc:
        train_mod.main(common + ["--ckpt-dir", str(tmp_path)])
    assert exc.value.code == train_mod.PREEMPTED_EXIT == 42
    assert CheckpointManager(str(tmp_path)).latest_step() == _TripAfter.TRIP
    monkeypatch.undo()
    resumed = train_mod.main(common + ["--ckpt-dir", str(tmp_path),
                                       "--resume"])
    assert len(resumed) == 10 - _TripAfter.TRIP
    np.testing.assert_allclose(resumed[-1], full[-1], rtol=1e-4)


def test_train_100m_config_is_the_jax_example_s(monkeypatch):
    import importlib.util
    import sys
    from repro_torch.configs import registry
    from repro_torch.examples import train_100m
    here = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(here, "..", "examples", "train_100m.py")
    spec = importlib.util.spec_from_file_location("_jax_train_100m", path)
    jmod = importlib.util.module_from_spec(spec)
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec.loader.exec_module(jmod)
    j = dataclasses.asdict(jmod.CONFIG_100M)
    t = dataclasses.asdict(train_100m.CONFIG_100M)
    for k in ("approx_attention", "approx_ffn", "approx_decode"):
        j.pop(k), t.pop(k)
    assert j == t
    assert train_100m.CONFIG_100M.param_count() == \
        jmod.CONFIG_100M.param_count()
    seen = []
    monkeypatch.setattr(train_100m.train_mod, "main", lambda argv: seen.append(
        (argv, registry.get_config("repro-100m"))) or [2.0, 1.0])
    assert train_100m.main(["--steps", "3", "--device", "cpu",
                            "--ckpt-dir", "x", "--resume"]) == [2.0, 1.0]
    argv, cfg = seen[0]
    assert cfg is train_100m.CONFIG_100M and "--resume" in argv
    assert argv[argv.index("--device") + 1] == "cpu"
    assert "repro-100m" not in registry.list_archs()


# ----------------------------------------------------------------------------
# specs on the meta device
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list_archs())
def test_specs_equal_jax_shapes_on_meta(arch):
    cfg, tcfg = jax_smoke(arch), get_smoke_config(arch)
    shape, jshape = ShapeConfig("t", 64, 4, "train"), JShape("t", 64, 4,
                                                             "train")
    for mine, ref in ((specs.train_batch_specs(tcfg, shape),
                       jspecs.train_batch_specs(cfg, jshape)),
                      (specs.prefill_batch_specs(tcfg, shape),
                       jspecs.prefill_batch_specs(cfg, jshape))):
        assert mine.keys() == ref.keys()
        for k, v in mine.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == ref[k].shape
            assert str(v.dtype).split(".")[-1] == str(ref[k].dtype)
    model = build(tcfg, device="cpu")
    cache, toks = specs.decode_specs(model, tcfg, shape)
    real = dict(_leaves(model.init_cache(4, 64)))
    meta = dict(_leaves(cache))
    assert real.keys() == meta.keys() and toks.shape == (4,)
    for k, t in meta.items():
        assert t.device.type == "meta" and t.shape == real[k].shape \
            and t.dtype == real[k].dtype
    assert model.device.type == "cpu"
    sh = specs.batch_shardings({"data": 2, "model": 4},
                               specs.train_batch_specs(tcfg, shape))
    assert sh["tokens"] == ("data", None)
    sh1 = specs.batch_shardings({"data": 8, "model": 1},
                                specs.train_batch_specs(
                                    tcfg, ShapeConfig("t", 64, 1, "train")))
    assert sh1["tokens"] == ()
