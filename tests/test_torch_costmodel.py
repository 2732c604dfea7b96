"""The port's app cost model (`repro_torch.analysis.cost`,
`repro_torch.benchmarks.costmodel`) against the JAX package's
(`repro.analysis.cost`, `benchmarks/costmodel.py`).

Both packages get the same machine profile: `host-sim`, which both carry,
or one `MachineProfile` built from the same numbers on each side (the JAX
`tpu-v5e` profile's numbers, where the committed JAX baseline was taken).
`trace_cost` counts aten ops on fake tensors where the JAX package walks a
jaxpr; the two counts of each app region agree within 10%. Everything
downstream of the counts -- predictions, pruning, bands, ladders -- is the
same arithmetic and agrees to rounding.
"""
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)                            # benchmarks package
sys.path.insert(0, os.path.join(REPO, "examples"))  # apps package

from benchmarks import costmodel as jcm  # noqa: E402
from benchmarks import approx_ffn_sweep as jsweep  # noqa: E402
from repro.analysis import cost as jcost  # noqa: E402
from repro.analysis import machine as jmachine  # noqa: E402
from repro.core import autotune as jauto  # noqa: E402
from repro.core import harness as jharness  # noqa: E402
from repro.core import pareto as jpareto  # noqa: E402
from repro.core import types as jtypes  # noqa: E402
from repro_torch.analysis import cost as tcost  # noqa: E402
from repro_torch.analysis import machine as tmachine  # noqa: E402
from repro_torch.benchmarks import costmodel as tcm  # noqa: E402
from repro_torch.benchmarks import run as trun  # noqa: E402
from repro_torch.core import autotune as tauto  # noqa: E402
from repro_torch.core import harness as tharness  # noqa: E402
from repro_torch.core import pareto as tpareto  # noqa: E402
from repro_torch.core import types as ttypes  # noqa: E402

COST_RTOL = 0.10     # trace_cost against the JAX jaxpr count
PREDICT_RTOL = 1e-9  # the same arithmetic on the same numbers
APPS = list(tcm.MODEL_BUILDERS)


def _tv5e():
    """The JAX `tpu-v5e` profile's numbers as a port profile."""
    j = jmachine.get_machine("tpu-v5e")
    return tmachine.MachineProfile(name=j.name, peak_flops=j.peak_flops,
                                   hbm_bw=j.hbm_bw, ici_bw=j.ici_bw,
                                   dispatch_s=j.dispatch_s)


def _keys_j(specs):
    return [jharness.spec_key(s) for s in specs]


def _keys_t(specs):
    return [tharness.spec_key(s) for s in specs]


def _to_t(spec):
    """A JAX spec as the port's (through the shared dict form)."""
    return tharness.spec_from_dict(jharness.spec_to_dict(spec))


# ------------------------------------------------------------ trace_cost

def _region_costs(name):
    w = jcm._WORKLOADS[name]
    from apps import (binomial_options as jbo, blackscholes as jbs,
                      kmeans as jkm, lavamd as jlm, minife_cg as jmf)
    from repro_torch.apps import (binomial_options as tbo,
                                  blackscholes as tbs, kmeans as tkm,
                                  lavamd as tlm, minife_cg as tmf)
    if name == "blackscholes":
        shape = (w["n_elements"], 5)
        return (jcost.trace_cost(jbs.bs_price, jnp.ones(shape, jnp.float32)),
                tcost.trace_cost(tbs.bs_price, torch.ones(shape)))
    if name == "binomial_options":
        ts, shape = w["tree_steps"], (w["n_elements"], 5)
        return (jcost.trace_cost(lambda x: jbo.binomial_price(x, ts),
                                 jnp.ones(shape, jnp.float32)),
                tcost.trace_cost(lambda x: tbo.binomial_price(x, ts),
                                 torch.ones(shape)))
    if name == "kmeans":
        p, c = (w["n"], w["d"]), (w["k"], w["d"])
        return (jcost.trace_cost(jkm._assign_exact, jnp.ones(p), jnp.ones(c)),
                tcost.trace_cost(tkm._assign_exact, torch.ones(p),
                                 torch.ones(c)))
    if name == "lavamd":
        jf, jxs, _ = jlm._region_setup(w["nx"], 0)
        tf, txs, _ = tlm.region_setup(w["nx"], 0, "cpu")
        return (jcost.trace_cost(jf, jnp.asarray(jxs[0])),
                tcost.trace_cost(tf, txs[0]))
    shape = (w["n"], w["n"])
    return (jcost.trace_cost(jmf.poisson_matvec, jnp.ones(shape)),
            tcost.trace_cost(tmf.poisson_matvec, torch.ones(shape)))


@pytest.mark.parametrize("name", APPS)
def test_trace_cost_within_ten_percent_of_jax(name):
    j, t = _region_costs(name)
    assert t.flops == pytest.approx(j.flops, rel=COST_RTOL), (j, t)
    assert t.bytes == pytest.approx(j.bytes, rel=COST_RTOL), (j, t)


def test_trace_cost_counts_by_op_class():
    a, b = torch.ones(4, 8), torch.ones(8, 3)
    # a dot: 2 * out * contraction; a transcendental 8 an element; a
    # reduction its input; a view bytes only
    assert tcost.trace_cost(lambda x, y: x @ y, a, b).flops == 2 * 12 * 8
    assert tcost.trace_cost(torch.exp, a).flops == 8 * 32
    assert tcost.trace_cost(lambda x: x.sum(0), a).flops == 32
    view = tcost.trace_cost(lambda x: x.reshape(8, 4), a)
    assert view.flops == 0 and view.bytes > 0
    assert tcost.trace_cost(lambda x: x + x, a).flops == 32


def test_trace_cost_runs_nothing():
    """Counting is shape-only: a region that would take far too long to
    compute at this size is counted at once, on fake tensors."""
    big = torch.empty((1 << 15, 1 << 14))
    c = tcost.trace_cost(lambda x: torch.tanh(x @ x.T).sum(), big)
    assert c.flops > 2.0 * (1 << 15) ** 2 * (1 << 14)


def test_reduction_annotation_counts_one_reduction():
    from repro_torch.apps import lavamd
    t = torch.ones(5, 7, 3)
    c = tcost.trace_cost(lambda x: lavamd.sum_in_order(x, dim=1), t)
    assert c.flops == 5 * 7 * 3
    assert c.bytes == (5 * 7 * 3 + 5 * 3) * 4
    torch.testing.assert_close(lavamd.sum_in_order(t, 1), t.sum(1))


def test_cost_vector_arithmetic_matches_jax():
    j = jcost.CostVector(3.0, 5.0) * 2.0 + jcost.CostVector(1.0, 1.0)
    t = tcost.CostVector(3.0, 5.0) * 2.0 + tcost.CostVector(1.0, 1.0)
    assert t.to_json() == j.to_json()
    assert (2.0 * tcost.CostVector(1.0, 2.0)).to_json() == \
        (2.0 * jcost.CostVector(1.0, 2.0)).to_json()


# ------------------------------------------------------------ predict

def _spec_pairs():
    jt, tt = jtypes, ttypes
    out = []
    for mod in (jt, tt):
        specs = [mod.ApproxSpec(mod.Technique.NONE)]
        for h, p, t in ((2, 4, 0.01), (3, 8, 0.5), (1, 2, 5.0)):
            specs.append(mod.ApproxSpec(mod.Technique.TAF,
                                        taf=mod.TAFParams(h, p, t)))
        for ts, t in ((2, 0.05), (64, 0.5), (4096, 0.2)):
            specs.append(mod.ApproxSpec(mod.Technique.IACT,
                                        iact=mod.IACTParams(ts, t)))
        for kind, f in (("ini", 0.25), ("fini", 0.5), ("random", 0.75)):
            specs.append(mod.ApproxSpec(
                mod.Technique.PERFORATION,
                perforation=mod.PerforationParams(
                    kind=mod.PerforationKind(kind), fraction=f)))
        specs.append(mod.ApproxSpec(
            mod.Technique.PERFORATION,
            perforation=mod.PerforationParams(
                kind=mod.PerforationKind.SMALL, skip=3)))
        out.append(specs)
    return list(zip(*out))


def _twin_models(machine_j, machine_t):
    site_kw = dict(invocations=24.0, in_dim=12, rsd_scale=0.3,
                   dist_scale=0.7, n_iters=16, amplification=3.0,
                   qoi_condition=0.02)
    models = []
    for c in (jcost, tcost):
        site = c.Site(region=c.CostVector(5000.0, 12000.0), **site_kw)
        tech = jtypes.Technique if c is jcost else ttypes.Technique
        models.append(c.AppCostModel(
            name="twin", total=c.CostVector(5000.0 * 24 + 7e4, 4e5),
            sites={tech.TAF: site, tech.IACT: site, tech.PERFORATION: site},
            machine=machine_j if c is jcost else machine_t, dispatches=5.0))
    return models


@pytest.mark.parametrize("profile", ["host-sim", "tpu-v5e"])
def test_predict_equals_jax_on_identical_sites(profile):
    mj = jmachine.get_machine(profile)
    mt = (tmachine.get_machine(profile) if profile == "host-sim"
          else _tv5e())
    jm, tm = _twin_models(mj, mt)
    for js, ts in _spec_pairs():
        a, b = jm.predict(js).to_json(), tm.predict(ts).to_json()
        assert a.keys() == b.keys()
        for k in a:
            assert b[k] == pytest.approx(a[k], rel=PREDICT_RTOL, abs=1e-300)


def _grid_pair():
    return tuple(mod_grid() for mod_grid in (
        lambda: jsweep._grid(),
        lambda: [_to_t(s) for s in jsweep._grid()]))


@pytest.mark.parametrize("profile", ["host-sim", "tpu-v5e"])
def test_select_and_band_give_the_same_specs(profile):
    jg, tg = _grid_pair()
    mj = jmachine.get_machine(profile)
    mt = (tmachine.get_machine(profile) if profile == "host-sim"
          else _tv5e())
    jm, tm = jcm.ffn_model(machine=mj), tcm.ffn_model(machine=mt)
    for kw in ({}, {"min_speedup": 1.0005}, {"max_error": 0.5}):
        jk, jd = jm.select(jg, **kw)
        tk, td = tm.select(tg, **kw)
        assert _keys_t(tk) == _keys_j(jk) and _keys_t(td) == _keys_j(jd)
    for kw in ({"budget": 6}, {"budget": 12, "band": 0.5}, {}):
        assert _keys_t(tm.select_band(tg, **kw)) == \
            _keys_j(jm.select_band(jg, **kw))
    if profile == "tpu-v5e":  # the committed JAX baseline's counts
        assert (len(tm.select(tg)[0]), len(tm.select(tg)[1])) == (28, 2)


def test_h100_profile_keeps_the_whole_ffn_grid():
    """On `h100` the dispatch floor flattens every predicted speedup at
    the reference size to within 1e-3 of 1, so nothing is dropped, and
    the band is the same six perforation specs."""
    jg, tg = _grid_pair()
    tm = tcm.ffn_model()
    kept, dropped = tm.select(tg)
    assert (len(kept), len(dropped)) == (30, 0)
    spd = [tm.predict(s).speedup for s in tg]
    assert max(spd) < 1.001 and min(spd) > 0.999
    assert _keys_t(tm.select_band(tg, budget=6)) == _keys_j(
        jcm.ffn_model().select_band(jg, budget=6))


def test_filter_specs_and_ladder_model_match_jax():
    jl = jcost.ladder_model("host-sim")
    tl = tcost.ladder_model("host-sim")
    pairs = _spec_pairs()
    js, ts = [p[0] for p in pairs], [p[1] for p in pairs]
    for kw in ({}, {"min_speedup": 1.2}, {"max_error": 0.3}):
        jk, jd = jcost.filter_specs(jl, js, **kw)
        tk, td = tcost.filter_specs(tl, ts, **kw)
        assert _keys_t(tk) == _keys_j(jk) and _keys_t(td) == _keys_j(jd)
        # a plain spec -> prediction callable prunes the same way
        jk2, _ = jcost.filter_specs(jl.predict, js, **kw)
        tk2, _ = tcost.filter_specs(tl.predict, ts, **kw)
        assert _keys_t(tk2) == _keys_j(jk2)
    bad = ttypes.ApproxSpec(ttypes.Technique.IACT,
                            iact=ttypes.IACTParams(4096, 0.2))
    assert tl.predict(bad).speedup <= 1.0


# ------------------------------------------------------------ the benchmark

def _jax_app_row(name):
    """The JAX benchmark's per-app row, run directly on host-sim."""
    app = jcm._make_app(name)
    model = jcm.MODEL_BUILDERS[name](**jcm._WORKLOADS[name],
                                     machine="host-sim")
    grid = jcm._validation_grid(name)
    kept, dropped = model.select(grid)
    recs = jharness.sweep(app, kept, repeats=1)
    preds = [model.predict(jcm._spec_of(r)) for r in recs]
    rho = jcm.spearman([p.speedup for p in preds],
                       [r.modeled_speedup for r in recs])
    bound = None
    if app.error_metric == "mape" and name != "minife_cg":
        bound = all(p.error_bound >= r.error for p, r in zip(preds, recs))
    return {"kept": len(kept), "dropped": len(dropped), "spearman": rho,
            "bound_holds": bound}


@pytest.fixture(scope="module")
def port_doc(tmp_path_factory):
    out = tmp_path_factory.mktemp("costmodel")
    doc = tcm.main(lambda *a: None, device="cpu", machine="host-sim",
                   artifacts_dir=str(out))
    with open(out / "BENCH_costmodel.json") as f:
        assert json.load(f)["machine"] == "host-sim"
    return doc


@pytest.mark.parametrize("name", APPS)
def test_costmodel_app_rows_match_jax(port_doc, name):
    want = _jax_app_row(name)
    got = port_doc["apps"][name]
    assert (got["kept"], got["dropped"], got["bound_holds"]) == \
        (want["kept"], want["dropped"], want["bound_holds"])
    assert got["spearman"] == pytest.approx(want["spearman"], abs=1e-9)


def test_costmodel_ffn_row_matches_jax(port_doc):
    """The JAX side runs its ffn model directly and measures its band on
    the host substrate (its Pallas substrate does not run on this jax)."""
    from apps import approx_ffn as jffn
    grid = jsweep._grid()
    model = jcm.ffn_model(machine="host-sim")
    kept, dropped = model.select(grid)
    band = model.select_band(grid, budget=len(grid) // 5)
    recs = jharness.sweep(jffn.make_app(substrate="host"), band, repeats=1)
    fs = jpareto.front_summary(recs, use_modeled=True)
    with open(os.path.join(REPO, "benchmarks", "baselines",
                           "BENCH_ffn.json")) as f:
        base_hv = json.load(f)["front"]["hypervolume"]
    rho = jcm.spearman([model.predict(jcm._spec_of(r)).speedup
                        for r in recs], [r.modeled_speedup for r in recs])
    got = port_doc["ffn"]
    assert (got["kept"], got["dropped"]) == (len(kept), len(dropped))
    assert [tharness.spec_key(s) for s in got["band"]] == _keys_j(band)
    assert got["band_measured"] == len(recs) == got["band_budget"] == 6
    assert got["spearman"] == pytest.approx(rho, abs=1e-9)
    assert got["front_recovery"]["hv_band"] == pytest.approx(
        fs["hypervolume"], abs=1e-4)
    assert got["front_recovery"]["ratio"] == pytest.approx(
        fs["hypervolume"] / base_hv, abs=1e-4)
    assert got["recovered"] and got["front_recovery"]["ratio"] >= \
        tcm.FRONT_TOLERANCE


def test_committed_h100_baseline_passes_its_own_rules():
    path = os.path.join(trun.BASELINES, "BENCH_costmodel.json")
    with open(path) as f:
        base = json.load(f)
    assert base["machine"] == "h100" and "card" in base
    assert base["ffn"]["recovered"] is True
    assert base["ffn"]["front_recovery"]["ratio"] >= tcm.FRONT_TOLERANCE
    assert trun.check_regression(os.path.dirname(path), path) == []


def test_predict_flag_runs_the_band_and_keeps_bench_ffn(tmp_path):
    rc = trun.main(["--device", "cpu", "--only", "ffn", "--predict",
                    "--artifacts", str(tmp_path)])
    assert rc == 0
    assert not (tmp_path / "BENCH_ffn.json").exists()
    with open(tmp_path / "BENCH_ffn_predict.json") as f:
        doc = json.load(f)
    assert doc["n_records"] == doc["band_budget"] == 6
    assert doc["front_recovery"]["recovered"] is True


# ------------------------------------------------------------ the hooks

def _bs_apps():
    from apps import blackscholes as jbs
    from repro_torch.apps import blackscholes as tbs
    w = jcm._WORKLOADS["blackscholes"]
    return jbs.make_app(**w), tbs.make_app(**w, device="cpu")


def _hashes(recs):
    return sorted(r.spec_hash for r in recs)


def _bs_models():
    w = jcm._WORKLOADS["blackscholes"]
    return (jcm.blackscholes_model(**w, machine="host-sim"),
            tcm.blackscholes_model(**w, machine="host-sim"))


def _taf_grids():
    kw = dict(h_sizes=(2, 6), p_sizes=(1, 4), thresholds=(0.005, 0.2, 1.0),
              levels=(jtypes.Level.ELEMENT,))
    jg = jharness.taf_grid(**kw)
    return jg, [_to_t(s) for s in jg]


def test_sweep_predict_prunes_as_jax_does():
    ja, ta = _bs_apps()
    jm, tm = _bs_models()
    jg, tg = _taf_grids()
    for floor in (1e9, 1.0, 1.05):
        jr = jharness.sweep(ja, jg, repeats=1, predict=jm,
                            predict_min_speedup=floor)
        tr = tharness.sweep(ta, tg, repeats=1, predict=tm,
                            predict_min_speedup=floor)
        assert _hashes(tr) == _hashes(jr)
    assert tharness.sweep(ta, tg, repeats=1, predict=tm,
                          predict_min_speedup=1e9) == []
    jr = jharness.sweep(ja, jg, repeats=1, predict=jm,
                        predict_max_error=0.5)
    tr = tharness.sweep(ta, tg, repeats=1, predict=tm,
                        predict_max_error=0.5)
    assert _hashes(tr) == _hashes(jr) and 0 < len(tr) < len(tg)


def test_autotune_predict_prunes_as_jax_does(monkeypatch):
    ja, ta = _bs_apps()
    jm, tm = _bs_models()
    jg, tg = _taf_grids()
    pools = {"jax": [], "port": []}

    def spy(mod, key, spec_key):
        real = mod._evaluate_all

        def wrapped(app, specs, *a, **kw):
            pools[key].append(sorted(spec_key(s) for s in specs))
            return real(app, specs, *a, **kw)
        return wrapped

    monkeypatch.setattr(jauto, "_evaluate_all",
                        spy(jauto, "jax", jharness.spec_key))
    monkeypatch.setattr(tauto, "_evaluate_all",
                        spy(tauto, "port", tharness.spec_key))
    jauto.successive_halving(ja, jg, max_error=0.3, predict=jm)
    tauto.successive_halving(ta, tg, max_error=0.3, predict=tm)
    assert pools["port"][0] == pools["jax"][0]
    assert 0 < len(pools["port"][0]) < len(tg)

    pools["jax"].clear()
    pools["port"].clear()
    jauto.random_search(ja, lambda r: r.choice(jg), budget=5,
                        max_error=0.3, predict=jm)
    tauto.random_search(ta, lambda r: r.choice(tg), budget=5,
                        max_error=0.3, predict=tm)
    assert pools["port"] == pools["jax"] and len(pools["port"][0]) == 5


def test_refine_predict_measures_the_band_as_jax_does():
    ja, ta = _bs_apps()
    jm, tm = _bs_models()
    jg, tg = _taf_grids()
    jr = jharness.sweep(ja, jg[:4], repeats=1)
    tr = tharness.sweep(ta, tg[:4], repeats=1)
    jn = jpareto.refine(ja, jr, budget=4, rounds=1, use_modeled=True,
                        predict=jm, predict_band=0.5)
    tn = tpareto.refine(ta, tr, budget=4, rounds=1, use_modeled=True,
                        predict=tm, predict_band=0.5)
    assert _hashes(tn) == _hashes(jn) and tn

