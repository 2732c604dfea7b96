"""Parity of the port's perforation masks and spec plumbing with the JAX
package: the same inputs, made from numpy seeds, through both."""
import os
import sys

import numpy as np
import pytest
import torch

from repro.core import perforation as jperf
from repro.core import harness as jharness
from repro.core import types as jtypes
from repro_torch.core import harness as tharness
from repro_torch.core import perforation as tperf
from repro_torch.core import types as ttypes
from repro_torch.benchmarks import approx_ffn_sweep as tsweep

REPO = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, REPO)                            # benchmarks package
sys.path.insert(0, os.path.join(REPO, "examples"))  # apps package
from benchmarks import approx_ffn_sweep as jsweep  # noqa: E402

KINDS = ("small", "large", "ini", "fini", "random")
FRACTIONS = (0.0, 0.1, 0.25, 0.3, 0.5, 0.7, 0.75, 0.9, 0.99)


def _params(mod, kind, arg, seed=0):
    k = mod.PerforationKind(kind)
    if kind in ("small", "large"):
        return mod.PerforationParams(kind=k, skip=arg, seed=seed)
    return mod.PerforationParams(kind=k, fraction=arg, seed=seed)


def _args(kind):
    return (2, 3, 4, 7) if kind in ("small", "large") else FRACTIONS


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n_iters", (1, 4, 10, 33, 128))
def test_execute_mask_and_kept_indices_match(kind, n_iters):
    for arg in _args(kind):
        for seed in (0, 3):
            jp, tp = _params(jtypes, kind, arg, seed), \
                _params(ttypes, kind, arg, seed)
            assert np.array_equal(tperf.execute_mask(n_iters, tp),
                                  jperf.execute_mask(n_iters, jp))
            assert np.array_equal(tperf.kept_indices(n_iters, tp),
                                  jperf.kept_indices(n_iters, jp))


@pytest.mark.parametrize("kind", ("ini", "fini", "random"))
@pytest.mark.parametrize("n_iters", (1, 4, 10, 33, 128))
def test_traced_execute_mask_matches(kind, n_iters):
    for frac in FRACTIONS:
        jp, tp = _params(jtypes, kind, 0.0, 5), _params(ttypes, kind, 0.0, 5)
        want = np.asarray(jperf.traced_execute_mask(n_iters, jp,
                                                    np.float32(frac)))
        knob = torch.tensor(frac, dtype=torch.float32)
        got = tperf.traced_execute_mask(n_iters, tp, knob)
        assert got.dtype == torch.bool and got.device == knob.device
        assert np.array_equal(got.numpy(), want)
        # the static path agrees with the tensor path at the same fraction
        sp = _params(ttypes, kind, frac, 5)
        assert np.array_equal(tperf.execute_mask(n_iters, sp), want)


def test_traced_execute_mask_rejects_skip_kinds():
    with pytest.raises(ValueError):
        tperf.traced_execute_mask(8, _params(ttypes, "small", 4), 0.5)


def test_spec_hash_and_dict_match_over_the_sweep_grid():
    tgrid, jgrid = tsweep.grid(), jsweep._grid()
    assert len(tgrid) == len(jgrid) == 30
    for ts, js in zip(tgrid, jgrid):
        td, jd = tharness.spec_to_dict(ts), jharness.spec_to_dict(js)
        assert td == jd
        assert tharness.spec_hash(ts) == jharness.spec_hash(js)
        assert tharness.spec_hash(tharness.spec_from_dict(td)) == \
            jharness.spec_hash(jharness.spec_from_dict(jd))


def test_grids_match_jax():
    pairs = [(tharness.taf_grid(), jharness.taf_grid()),
             (tharness.iact_grid(), jharness.iact_grid()),
             (tharness.perfo_grid(), jharness.perfo_grid())]
    for tgrid, jgrid in pairs:
        assert [tharness.spec_hash(s) for s in tgrid] == \
            [jharness.spec_hash(s) for s in jgrid]


@pytest.mark.parametrize("pragma", [
    "memo(out:3:8:0.5) level(team)", "memo(in:4:0.2:1) level(warp)",
    "perfo(small:4)", "perfo(fini:0.25)", "none"])
def test_parse_pragma_round_trips(pragma):
    t, j = ttypes.parse_pragma(pragma), jtypes.parse_pragma(pragma)
    assert tharness.spec_to_dict(t) == jharness.spec_to_dict(j)
    assert tharness.spec_hash(t) == jharness.spec_hash(j)


def test_record_rows_interoperate(tmp_path):
    """A DB written by the JAX harness is read back by the port's."""
    spec = jsweep._grid()[0]
    row = jharness.Record(app="approx_ffn",
                          spec=jharness.spec_to_dict(spec), error=0.1,
                          speedup=1.0, modeled_speedup=1.2,
                          approx_fraction=0.5, wall_time_s=1.0,
                          exact_time_s=1.0, extra={},
                          workload={"substrate": "host", "seq": 128})
    path = str(tmp_path / "db.json")
    jharness.save_db([row], path)
    rec = tharness.record_from_row(tharness.load_db(path)[0])
    assert rec.spec_hash == row.spec_hash
    assert tharness.workload_hash(rec.workload) == \
        jharness.workload_hash(row.workload)


# -- element_masks, perforated_bounds, perforated_sum ------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("herded", (True, False))
@pytest.mark.parametrize("n_iters,n_elements", ((16, 8), (33, 5), (1, 3)))
def test_element_masks_match_bit_for_bit(kind, herded, n_iters, n_elements):
    for arg in _args(kind):
        for seed in (0, 3):
            jp = _params(jtypes, kind, arg, seed)
            tp = _params(ttypes, kind, arg, seed)
            jp = jtypes.PerforationParams(kind=jp.kind, skip=jp.skip,
                                          fraction=jp.fraction, seed=seed,
                                          herded=herded)
            tp = ttypes.PerforationParams(kind=tp.kind, skip=tp.skip,
                                          fraction=tp.fraction, seed=seed,
                                          herded=herded)
            got = tperf.element_masks(n_iters, n_elements, tp)
            want = jperf.element_masks(n_iters, n_elements, jp)
            assert got.dtype == want.dtype == np.bool_
            assert got.shape == (n_elements, n_iters)
            assert np.array_equal(got, want)


def test_element_masks_herded_rows_identical_and_divergent_otherwise():
    """`tests/test_core_ac.py`'s two element_masks cases, on the port."""
    p = ttypes.PerforationParams(kind=ttypes.PerforationKind.SMALL, skip=4,
                                 herded=True)
    m = tperf.element_masks(16, 8, p)
    assert (m == m[0]).all()
    p = ttypes.PerforationParams(kind=ttypes.PerforationKind.SMALL, skip=4,
                                 herded=False)
    m = tperf.element_masks(16, 8, p)
    assert not (m == m[0]).all()
    # every row still drops exactly 1/4
    np.testing.assert_allclose(m.mean(axis=1), 0.75)


@pytest.mark.parametrize("kind", ("ini", "fini"))
@pytest.mark.parametrize("n_iters", (1, 4, 10, 16, 33, 128))
def test_perforated_bounds_match(kind, n_iters):
    for frac in FRACTIONS:
        assert tperf.perforated_bounds(n_iters, _params(ttypes, kind, frac)) \
            == jperf.perforated_bounds(n_iters, _params(jtypes, kind, frac))
    # `tests/test_core_ac.py::test_ini_fini_bounds`
    assert tperf.perforated_bounds(16, _params(ttypes, "ini", 0.25)) == \
        (4, 16)
    assert tperf.perforated_bounds(16, _params(ttypes, "fini", 0.25)) == \
        (0, 12)


@pytest.mark.parametrize("kind", ("small", "large", "random"))
def test_perforated_bounds_reject_other_kinds(kind):
    with pytest.raises(ValueError, match="ini/fini only"):
        tperf.perforated_bounds(8, _params(ttypes, kind, _args(kind)[1]))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("axis", (0, 1, -1))
@pytest.mark.parametrize("rescale", (True, False))
def test_perforated_sum_matches(kind, axis, rescale):
    """The same seeded (12, 10, 3) tensor reduced over its kept iterations:
    float32 sums of at most 12 terms of order 1, taken in the two
    libraries' orders, agree within rtol 1e-6 / atol 1e-6."""
    import jax.numpy as jnp
    xs = np.random.RandomState(11).standard_normal((12, 10, 3)).astype(
        np.float32)
    for arg in _args(kind):
        jp, tp = _params(jtypes, kind, arg, 2), _params(ttypes, kind, arg, 2)
        got = tperf.perforated_sum(torch.from_numpy(xs), tp, axis=axis,
                                   rescale=rescale)
        want = np.asarray(jperf.perforated_sum(jnp.asarray(xs), jp,
                                               axis=axis, rescale=rescale))
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_perforated_sum_rescales_by_n_over_kept():
    xs = torch.ones(8, 2)
    p = _params(ttypes, "small", 4)  # keeps 6 of 8
    assert torch.equal(tperf.perforated_sum(xs, p, rescale=False),
                       torch.full((2,), 6.0))
    assert torch.equal(tperf.perforated_sum(xs, p), torch.full((2,), 8.0))
    # nothing kept: an empty sum, never a division by zero
    drop_all = _params(ttypes, "random", 0.99)
    assert tperf.kept_indices(8, drop_all).size == 0
    assert torch.equal(tperf.perforated_sum(xs, drop_all), torch.zeros(2))
