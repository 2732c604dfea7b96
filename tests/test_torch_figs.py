"""The port's fig6 / fig7 sweeps against the JAX package's rows, on the CPU.

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

from benchmarks import fig6_best_speedup as jfig6  # noqa: E402
from repro.core import harness as jharness  # noqa: E402
from repro.core.types import Level as JLevel  # noqa: E402
from repro.core.types import PerforationKind as JKind  # noqa: E402
from repro_torch.benchmarks import fig6_best_speedup as tfig6  # noqa: E402
from repro_torch.benchmarks import fig7_cg_sweep as tfig7  # noqa: E402
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


if __name__ == "__main__":
    if "--write" not in sys.argv:
        sys.exit(__doc__)
    with open(tfig6.REFERENCE, "w") as f:
        json.dump(jax_reference(), f, indent=1)
    print(tfig6.REFERENCE)
