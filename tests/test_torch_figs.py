"""The port's figures against the JAX package's rows, on the CPU.

`src/repro_torch/benchmarks/fig6_fig7_reference.json` holds the JAX
package's rows of both figures: for every app x technique of fig6 and every
spec of fig7, the spec, modeled speedup, error and approx fraction, plus
fig6's best row under 10% error. It is made from the JAX package only, by
this file:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_figs.py --write

Here a few of its rows are recomputed live from the JAX package (so the file
cannot drift from the reference), and the port's fig6 (at blackscholes) and
fig7 run on the CPU and must pass the same `check` that `chip_smoke.py`
phase 9 applies on the card: the same best spec, modeled speedup within 1%,
error within 1e-4, every approx fraction within 0.005.

`src/repro_torch/benchmarks/figures_reference.json` holds the JAX rows of
fig3, fig8c, fig10c, fig11c, fig12c and pareto_refine, made by the same
`--write` from the JAX package only, at full precision (the JAX modules
print rounded values). Each JAX module's printed rows are recomputed live
here and must equal the file's rows in the module's own format; then each
port module runs on the CPU and must pass its `check`, the same one
`chip_smoke.py` applies on the card: fractions within 0.005, errors within
1e-4 (by class past 1), modeled speedups within 1%, K-Means iteration
counts and pareto counts exact, hypervolumes within 1e-4 relative. Walls
and everything taken from them (fig8c's wall, fig11c's wall speedups,
fig12c's R^2) are the device's own and are never compared.
"""
import json
import os
import sys

import numpy as np
import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)                            # benchmarks package
sys.path.insert(0, os.path.join(REPO, "examples"))  # apps package
sys.path.insert(0, os.path.join(REPO, "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from apps import binomial_options as jbinomial  # noqa: E402
from apps import blackscholes as jblackscholes  # noqa: E402
from apps import kmeans as jkmeans  # noqa: E402
from apps import lavamd as jlavamd  # noqa: E402
from benchmarks import fig3_table_memory as jfig3  # noqa: E402
from benchmarks import fig6_best_speedup as jfig6  # noqa: E402
from benchmarks import fig8c_items_per_thread as jfig8c  # noqa: E402
from benchmarks import fig10c_rsd_behavior as jfig10c  # noqa: E402
from benchmarks import fig11c_hierarchy as jfig11c  # noqa: E402
from benchmarks import fig12c_kmeans_convergence as jfig12c  # noqa: E402
from benchmarks import pareto_refine as jpareto_refine  # noqa: E402
from repro.core import pareto as jpareto  # noqa: E402
from repro.core import taf as jtaf  # noqa: E402
from repro.core import types as jtypes  # noqa: E402
from repro.core import harness as jharness  # noqa: E402
from repro.core.types import Level as JLevel  # noqa: E402
from repro.core.types import PerforationKind as JKind  # noqa: E402
from repro_torch.benchmarks import fig3_table_memory as tfig3  # noqa: E402
from repro_torch.benchmarks import fig6_best_speedup as tfig6  # noqa: E402
from repro_torch.benchmarks import fig7_cg_sweep as tfig7  # noqa: E402
from repro_torch.benchmarks import fig8c_items_per_thread as tfig8c  # noqa
from repro_torch.benchmarks import fig10c_rsd_behavior as tfig10c  # noqa
from repro_torch.benchmarks import fig11c_hierarchy as tfig11c  # noqa: E402
from repro_torch.benchmarks import (  # noqa: E402
    fig12c_kmeans_convergence as tfig12c)
from repro_torch.benchmarks import pareto_refine as tpareto  # noqa: E402
from repro_torch.core import harness as tharness  # noqa: E402

# recomputed live from the JAX package: same machine, same package -- only
# summation noise between runs may move an error
LIVE_ERROR_ATOL = 1e-6


def jax_fig7_grid():
    """The grid `benchmarks/fig7_cg_sweep.main` sweeps, in the JAX types."""
    return jharness.taf_grid(h_sizes=(3,), p_sizes=(8,),
                             thresholds=(0.5, 5.0),
                             levels=(JLevel.ELEMENT,)) + \
        jharness.perfo_grid(skips=(4, 16), fractions=(0.1,),
                            kinds=(JKind.SMALL, JKind.INI))


def _row(r):
    return {"spec": r.spec, "spec_hash": r.spec_hash,
            "modeled_speedup": r.modeled_speedup, "error": r.error,
            "approx_fraction": r.approx_fraction}


def jax_fig6_rows(name, tech, specs=None):
    make, kw = jfig6.APPS[name]
    grid = dict(taf=jfig6.TAF_GRID, iact=jfig6.IACT_GRID)[tech]
    recs = jharness.sweep(make(**kw), grid if specs is None else specs,
                          repeats=1)
    best = jharness.best_speedup_under_error(recs, 0.10, use_modeled=True)
    return {"rows": [_row(r) for r in recs],
            "best": None if best is None else dict(_row(best),
                                                   speedup=best.speedup)}


def jax_reference():
    """Both figures' rows, from the JAX package alone."""
    ref = {"source": "JAX package: benchmarks/fig6_best_speedup.py (APPS, "
                     "TAF_GRID, IACT_GRID) and benchmarks/fig7_cg_sweep.py's "
                     "grid, swept by repro.core.harness.sweep on the CPU",
           "fig6": {}, "fig7": {}}
    for name, (make, kw) in jfig6.APPS.items():
        ref["fig6"][name] = {"workload": dict(make(**kw).workload)}
        for tech in ("taf", "iact"):
            ref["fig6"][name][tech] = jax_fig6_rows(name, tech)
    sys.path.insert(0, os.path.join(REPO, "examples"))
    from apps import minife_cg
    app = minife_cg.make_app(n=tfig7.N)
    recs = jharness.sweep(app, jax_fig7_grid(), repeats=1)
    ref["fig7"]["minife_cg"] = {"workload": dict(app.workload),
                                "rows": [_row(r) for r in recs]}
    return ref


@pytest.fixture(scope="module")
def reference():
    return tfig6.load_reference()


def test_grids_and_sizes_are_the_jax_ones(reference):
    for name, (make, kw) in jfig6.APPS.items():
        assert tfig6.APPS[name][1] == kw
        assert reference["fig6"][name]["workload"] == make(**kw).workload
    for tgrid, jgrid in ((tfig6.TAF_GRID, jfig6.TAF_GRID),
                         (tfig6.IACT_GRID, jfig6.IACT_GRID),
                         (tfig7.GRID, jax_fig7_grid())):
        assert [tharness.spec_hash(s) for s in tgrid] == \
            [jharness.spec_hash(s) for s in jgrid]
    assert reference["fig7"]["minife_cg"]["workload"] == \
        dict(n=tfig7.N, seed=0, iters=60)


@pytest.mark.parametrize("name,tech,idx", [
    ("blackscholes", "taf", (0, 1, 12, 13)),
    ("lavamd", "taf", (0, 13)),
    ("kmeans", "iact", (0, 1)),
])
def test_reference_rows_recompute_live(reference, name, tech, idx):
    grid = dict(taf=jfig6.TAF_GRID, iact=jfig6.IACT_GRID)[tech]
    live = jax_fig6_rows(name, tech, [grid[i] for i in idx])["rows"]
    rows = reference["fig6"][name][tech]["rows"]
    for i, got in zip(idx, live):
        want = rows[i]
        assert got["spec_hash"] == want["spec_hash"]
        assert got["approx_fraction"] == want["approx_fraction"]
        assert got["modeled_speedup"] == pytest.approx(
            want["modeled_speedup"], rel=1e-12)
        assert abs(got["error"] - want["error"]) <= LIVE_ERROR_ATOL


def test_reference_best_rows_are_the_best_of_their_rows(reference):
    for name, app in reference["fig6"].items():
        for tech in ("taf", "iact"):
            rows, best = app[tech]["rows"], app[tech]["best"]
            ok = [r for r in rows if r["error"] < 0.10]
            assert (best is None) == (not ok)
            if ok:
                top = max(ok, key=lambda r: r["modeled_speedup"])
                assert best["spec_hash"] == top["spec_hash"]


def test_port_fig6_matches_the_reference_at_blackscholes(reference):
    res = tfig6.main(report=lambda *a: None, device="cpu",
                     apps=["blackscholes"], repeats=1)
    assert tfig6.check(res, reference) == []
    best = res["blackscholes"]["taf"]["best"]
    assert best["spec_hash"] == \
        reference["fig6"]["blackscholes"]["taf"]["best"]["spec_hash"]


def test_port_fig7_matches_the_reference(reference):
    res = tfig7.main(report=lambda *a: None, device="cpu")
    assert tfig7.check(res, reference) == []
    errs = np.array([r["error"] for r in res["minife_cg"]["rows"]])
    # the paper's finding: the implicit solver amplifies AC error
    assert (errs >= 0.10).sum() >= 1


def test_checks_catch_a_departure(reference):
    res = {"blackscholes": json.loads(json.dumps(
        {k: reference["fig6"]["blackscholes"][k] for k in ("taf", "iact")}))}
    assert tfig6.check(res, reference) == []
    res["blackscholes"]["taf"]["best"]["error"] += 2e-4
    res["blackscholes"]["iact"]["rows"][0]["approx_fraction"] += 0.01
    assert len(tfig6.check(res, reference)) == 2
    fig7 = json.loads(json.dumps(reference["fig7"]))
    assert tfig7.check(fig7, reference) == []
    fig7["minife_cg"]["rows"][0]["modeled_speedup"] *= 1.02
    assert len(tfig7.check(fig7, reference)) == 1


# -- fig3, fig8c, fig10c, fig11c, fig12c, pareto_refine ----------------------

def _jspec(spec):
    return jharness.spec_from_dict(tharness.spec_to_dict(spec))


def jax_fig8c():
    spec = jtypes.TAFParams(*[getattr(tfig8c.SPEC, f) for f in (
        "history_size", "prediction_size", "rsd_threshold")])
    fn = lambda x: jbinomial.binomial_price(x, tfig8c.TREE_STEPS)  # noqa
    run = jax.jit(lambda xs: jtaf.run_sequence(spec, xs, fn,
                                               jtypes.Level.ELEMENT)[2])
    rows = []
    for items in tfig8c.ITEMS:
        n_elem = jfig8c.TOTAL // items
        frac = float(run(jnp.asarray(jbinomial.gen_inputs(n_elem, items,
                                                          seed=1))))
        modeled = 1.0 / max(1.0 - frac, 1e-3)
        util = min(n_elem / jfig8c.LANES, 1.0)
        rows.append({"items": items, "n_elements": n_elem,
                     "approx_frac": frac, "modeled": modeled, "util": util,
                     "effective": modeled * util})
    return {"rows": rows}


def jax_fig10c():
    app = jblackscholes.make_app(**tfig10c.APP)
    exact = app.exact()
    rows, prev, non_monotone = [], None, 0
    for t in tfig10c.THRESHOLDS:
        r = app.run(jtypes.ApproxSpec(jtypes.Technique.TAF,
                                      jtypes.Level.ELEMENT,
                                      taf=jtypes.TAFParams(5, 16, t)))
        err = jharness.mape(exact.qoi, r.qoi)
        non_monotone += prev is not None and err < prev
        prev = err
        rows.append({"T": t, "error": err,
                     "approx_fraction": r.approx_fraction})
    return {"workload": dict(app.workload), "rows": rows,
            "non_monotone_steps": int(non_monotone)}


def jax_fig11c():
    app = jlavamd.make_app(**tfig11c.APP)
    exact = app.exact()
    rows = []
    for t in tfig11c.THRESHOLDS:
        row = {"T": t}
        for level in tfig11c.LEVELS:
            r = app.run(jtypes.ApproxSpec(jtypes.Technique.TAF,
                                          jtypes.Level(level.value),
                                          taf=jtypes.TAFParams(3, 16, t)))
            row[level.value] = {"error": jharness.mape(exact.qoi, r.qoi),
                                "approx_fraction": r.approx_fraction}
        rows.append(row)
    return {"workload": dict(app.workload), "rows": rows}


def jax_fig12c():
    app = jkmeans.make_app(**tfig12c.APP)
    iters_exact = app.exact().extra["iters"]
    recs = jharness.sweep(app, [_jspec(s) for s in tfig12c.GRID], repeats=1)
    return {"workload": dict(app.workload), "iters_exact": iters_exact,
            "rows": [{"spec": r.spec, "spec_hash": r.spec_hash,
                      "iters": r.extra.get("iters", iters_exact),
                      "approx_fraction": r.approx_fraction,
                      "error": r.error} for r in recs]}


def jax_pareto():
    app = jblackscholes.make_app(**tpareto.APP)
    recs = jharness.sweep(app, jpareto_refine.COARSE, repeats=1)
    new = jpareto.refine(app, recs, budget=8, rounds=2, repeats=1,
                         use_modeled=True)
    return {"workload": dict(app.workload),
            "coarse": jpareto.front_summary(recs, use_modeled=True),
            "refined": jpareto.front_summary(list(recs) + new,
                                             use_modeled=True),
            "new_evals": len(new), "new_specs": [r.spec_hash for r in new]}


def jax_figures_reference():
    """The JAX rows of fig3 ... pareto_refine, from the JAX package alone
    (the machine-independent columns only)."""
    return {
        "source": "JAX package: benchmarks/fig3_table_memory.py, "
                  "fig8c_items_per_thread.py, fig10c_rsd_behavior.py, "
                  "fig11c_hierarchy.py, fig12c_kmeans_convergence.py and "
                  "pareto_refine.py at their own sizes, specs and grids, on "
                  "the CPU",
        "fig3": {"rows": [{k: r[k] for k in ("n_threads",
                                             "per_thread_tables_bytes")}
                          for r in jfig3.rows()]},
        "fig8c": jax_fig8c(), "fig10c": jax_fig10c(),
        "fig11c": jax_fig11c(), "fig12c": jax_fig12c(),
        "pareto": jax_pareto()}


@pytest.fixture(scope="module")
def figures():
    return tfig6.load_reference(tfig6.FIGURES_REFERENCE)


def _printed(mod, **kw):
    lines = []
    mod.main(lambda name, value, derived="": lines.append(
        (value, derived)), **kw)
    return lines


def test_jax_module_rows_recompute_live(figures):
    """Each JAX module's printed rows, run now, equal the file's rows in
    the module's own format (so the file cannot drift from the modules)."""
    f3 = _printed(jfig3)
    assert [v for v, _ in f3] == [
        f"threads=2^{r['n_threads'].bit_length() - 1}"
        for r in figures["fig3"]["rows"]]
    share = [100.0 * r["per_thread_tables_bytes"] / jfig3.V100_GLOBAL
             for r in figures["fig3"]["rows"]]
    assert [d.split(",")[0] for _, d in f3] == [
        f"per_thread={x:.1f}%V100" for x in share]
    assert _printed(jfig8c) == [
        (f"items={r['items']}",
         f"approx_frac={r['approx_frac']:.2f},modeled={r['modeled']:.2f}x,"
         f"util={r['util']:.2f},effective={r['effective']:.2f}x")
        for r in figures["fig8c"]["rows"]]
    f10 = figures["fig10c"]
    assert _printed(jfig10c) == [
        (f"T={r['T']}", f"err={r['error']:.4%},"
         f"approx_frac={r['approx_fraction']:.2f}") for r in f10["rows"]] + [
        ("non_monotone_steps", f"{f10['non_monotone_steps']} (unintuitive "
         "RSD interactions -- matches paper)")]
    f11 = _printed(jfig11c)
    want = [(f"T={r['T']}", [
        f"(frac={r[lv]['approx_fraction']:.2f},err={r[lv]['error']:.2%})"
        for lv in ("element", "block")]) for r in figures["fig11c"]["rows"]]
    assert [(v, [p[p.index("("):] for p in d.split(";")]) for v, d in f11] \
        == want
    f12 = figures["fig12c"]
    conv = [f12["iters_exact"] / r["iters"] for r in f12["rows"]]
    (value, derived), = _printed(jfig12c)
    assert value == "r_squared" and derived.endswith(
        f"over {len(conv)} configs (conv_speedup range "
        f"{min(conv):.1f}..{max(conv):.1f})")
    p = figures["pareto"]
    assert _printed(jpareto_refine) == [
        ("coarse_front", f"n={p['coarse']['n_front']}/"
         f"{p['coarse']['n_records']},hv={p['coarse']['hypervolume']:.3f}"),
        ("refined_front", f"n={p['refined']['n_front']}/"
         f"{p['refined']['n_records']},hv={p['refined']['hypervolume']:.3f},"
         f"new_evals={p['new_evals']}")]


def test_reference_rows_are_the_quoted_values(figures):
    """The rows the JAX package gives on the CPU, as they are quoted."""
    assert [round(r["approx_frac"], 2) for r in figures["fig8c"]["rows"]] \
        == [0.0, 0.75, 0.94, 0.96, 0.97]
    assert figures["fig10c"]["non_monotone_steps"] == 2
    f12 = figures["fig12c"]
    conv = [f12["iters_exact"] / r["iters"] for r in f12["rows"]]
    assert (len(conv), min(conv), max(conv)) == (6, 3.0, 7.5)
    p = figures["pareto"]
    assert (p["coarse"]["n_front"], p["coarse"]["n_records"],
            p["refined"]["n_front"], p["refined"]["n_records"],
            p["new_evals"]) == (2, 4, 6, 12, 8)


def test_port_sizes_and_grids_are_the_jax_ones():
    assert [tharness.spec_hash(s) for s in tfig12c.GRID] == \
        [tharness.spec_hash(s) for s in [
            tharness.spec_from_dict(jharness.spec_to_dict(j)) for j in
            jharness.taf_grid(h_sizes=(2, 3), p_sizes=(8,),
                              thresholds=(0.3, 1.5),
                              levels=(jtypes.Level.ELEMENT,)) +
            jharness.iact_grid(t_sizes=(4,), thresholds=(0.5, 3.0),
                               tables_per_block=(0,),
                               levels=(jtypes.Level.ELEMENT,))]]
    assert [tharness.spec_hash(s) for s in tpareto.COARSE] == \
        [jharness.spec_hash(s) for s in jpareto_refine.COARSE]
    assert (tfig8c.TOTAL, tfig8c.LANES) == (jfig8c.TOTAL, jfig8c.LANES)
    assert (tfig3.ENTRY_BYTES, tfig3.TABLE_ENTRIES) == \
        (jfig3.ENTRY_BYTES, jfig3.TABLE_ENTRIES)


def test_port_fig3_rows(figures):
    res = tfig3.main(report=lambda *a: None, device="cpu")
    assert tfig3.check(res, figures) == []
    # the port's own columns: K3's schedule table against a block's shared
    # memory, and no V100 or TPU number
    row = res["rows"][0]
    assert row["block_table_bytes"] == 10772
    assert row["pct_of_block_smem"] == pytest.approx(100 * 10772 / 232448)
    assert res["memory"]["bytes"] == tfig3.H100_TOTAL_MEMORY
    assert not any("V100" in k or "VMEM" in k or "tpu" in k.lower()
                   for k in row)


@pytest.mark.parametrize("name", ["fig8c", "fig10c", "fig11c", "fig12c",
                                  "pareto"])
def test_port_figure_matches_the_reference(figures, name):
    mod, kw = dict(fig8c=(tfig8c, dict(repeats=1)), fig10c=(tfig10c, {}),
                   fig11c=(tfig11c, dict(repeats=1)), fig12c=(tfig12c, {}),
                   pareto=(tpareto, {}))[name]
    res = mod.main(report=lambda *a: None, device="cpu", **kw)
    assert mod.check(res, figures) == []


def test_figure_checks_catch_a_departure(figures):
    def copy(x):
        return json.loads(json.dumps(x))

    res = {"rows": copy(figures["fig3"]["rows"])}
    res["rows"][2]["per_thread_tables_bytes"] += 36
    assert len(tfig3.check(res, figures)) == 1
    res = copy(figures["fig8c"])
    assert tfig8c.check(res, figures) == []
    res["rows"][1]["approx_frac"] += 0.006
    res["rows"][3]["modeled"] *= 1.011
    assert len(tfig8c.check(res, figures)) == 2
    res = {"jax_size": copy(figures["fig10c"])}
    assert tfig10c.check(res, figures) == []
    res["jax_size"]["rows"][0]["error"] += 2e-4
    res["jax_size"]["non_monotone_steps"] += 1
    assert len(tfig10c.check(res, figures)) == 2
    res = {"jax_size": copy(figures["fig11c"])}
    assert tfig11c.check(res, figures) == []
    rows = res["jax_size"]["rows"]
    rows[0]["element"]["error"] += 2e-4          # under 1: by value
    rows[1]["block"]["error"] *= 1.5             # past 1: the class holds
    rows[2]["block"]["error"] = float("nan")     # a new class
    rows[2]["element"]["approx_fraction"] -= 0.01
    assert len(tfig11c.check(res, figures)) == 3
    res = {"jax_size": copy(figures["fig12c"])}
    assert tfig12c.check(res, figures) == []
    res["jax_size"]["rows"][4]["iters"] += 1
    assert len(tfig12c.check(res, figures)) == 1
    res = copy(figures["pareto"])
    assert tpareto.check(res, figures) == []
    res["refined"]["hypervolume"] *= 1 + 2e-4
    res["new_evals"] -= 1
    assert len(tpareto.check(res, figures)) == 2


if __name__ == "__main__":
    if "--write" not in sys.argv:
        sys.exit(__doc__)
    for path, make in ((tfig6.REFERENCE, jax_reference),
                       (tfig6.FIGURES_REFERENCE, jax_figures_reference)):
        with open(path, "w") as f:
            json.dump(make(), f, indent=1)
        print(path)
