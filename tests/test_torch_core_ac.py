"""The port's programming model against the JAX package, on the CPU.

`repro_torch.core` (rsd, hierarchy, taf, iact, approx, batching, harness,
pareto, autotune) is held against `repro.core` on the same numpy inputs,
with the cases of `tests/test_core_ac.py` mirrored. Tolerances: approx
masks, votes, hits and table contents are equal exactly; outputs that pass
through the same float32 arithmetic are equal within 1e-6 (RSD within
1e-6 relative); the kernels' plain versions within 1e-5 (the tolerance of
`tests/test_torch_kernels.py`). Module tests feed both packages the same
accurate outputs, so every decision is taken on identical numbers; a
state carried across (`repro_torch.convert.taf_state` / `iact_state`)
lets both continue from one mid-run state.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import approx as japprox
from repro.core import autotune as jautotune
from repro.core import batching as jbatching
from repro.core import harness as jharness
from repro.core import hierarchy as jhier
from repro.core import iact as jiact
from repro.core import pareto as jpareto
from repro.core import rsd as jrsd
from repro.core import taf as jtaf
from repro.core import types as jtypes
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core import (ApproxRegion, ApproxSpec, IACTParams, Level,
                              PerforationKind, PerforationParams, TAFParams,
                              Technique, autotune, batching, harness,
                              hierarchy, iact, pareto, parse_pragma,
                              perforated_loop, rsd, substrate, taf)
from repro_torch.obs import metrics

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "examples"))  # apps package
from apps import blackscholes as jbs  # noqa: E402
from repro_torch.apps import blackscholes as tbs  # noqa: E402

OUT_ATOL = 1e-6
KERNEL_ATOL = 1e-5
LEVELS = (Level.ELEMENT, Level.TILE, Level.BLOCK)


def jspec(spec):
    """The same spec in the JAX package's types."""
    return jharness.spec_from_dict(harness.spec_to_dict(spec))


def t(a):
    return torch.from_numpy(np.array(a))


def j(a):
    return jnp.asarray(np.array(a))


def npy(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# -- pragma and RSD ---------------------------------------------------------

@pytest.mark.parametrize("text", [
    "memo(in:2:0.5:4) level(warp)", "memo(out:3:5:1.5) level(thread)",
    "perfo(small:4)", "perfo(ini:0.3) level(team)", "none"])
def test_parse_pragma_matches(text):
    assert harness.spec_to_dict(parse_pragma(text)) == \
        jharness.spec_to_dict(jtypes.parse_pragma(text))


def test_rsd_matches_and_is_scale_invariant():
    rng = np.random.RandomState(0)
    w = (rng.uniform(0.5, 2.0, (64, 5)) *
         rng.choice([-1, 1], (64, 1))).astype(np.float32)
    got = npy(rsd.rsd(t(w), dim=1))
    np.testing.assert_allclose(got, npy(jrsd.rsd(j(w), axis=1)), rtol=1e-6)
    np.testing.assert_allclose(npy(rsd.rsd(t(w * 7.5), dim=1)), got,
                               rtol=1e-5)
    assert float(rsd.rsd(torch.ones(5))) == 0.0
    x = torch.tensor([1.0, 2.0, 3.0])
    np.testing.assert_allclose(float(rsd.rsd(x)),
                               np.std([1, 2, 3]) / np.mean([1, 2, 3]),
                               rtol=1e-6)
    # near-zero mean: sigma / eps scale, finite
    assert torch.isfinite(rsd.rsd(torch.tensor([-1.0, 1.0])))
    y = t(rng.randn(6, 3, 4).astype(np.float32))
    np.testing.assert_allclose(npy(rsd.rsd_scalar_summary(y)),
                               npy(jrsd.rsd_scalar_summary(j(y.numpy()))),
                               rtol=1e-6)


def test_welford_matches_two_pass():
    vals = np.random.RandomState(1).randn(20).astype(np.float64)
    c, m, m2 = 0, 0.0, 0.0
    for v in vals:
        c, m, m2 = rsd.welford_update(c, m, m2, v)
    np.testing.assert_allclose(m, vals.mean())
    np.testing.assert_allclose(m2 / c, vals.var())


# -- hierarchy ----------------------------------------------------------------

def test_majority_ties_go_accurate():
    mask = torch.tensor([True, False, True, False])
    assert not bool(hierarchy.block_majority(mask))
    assert bool(hierarchy.vote(torch.tensor([True, True, True, False]),
                               Level.BLOCK).all())
    voted = hierarchy.vote(torch.tensor([True] * 3 + [False] * 4 + [True]),
                           Level.TILE, tile_size=4)
    assert voted.tolist() == [True] * 4 + [False] * 4
    m = torch.tensor([True, False, True])
    assert torch.equal(hierarchy.vote(m, Level.ELEMENT), m)


@pytest.mark.parametrize("n,tile", [(256, None), (256, 32), (256, 128),
                                    (300, None), (300, 32), (37, 8)])
@pytest.mark.parametrize("p", [0.3, 0.5, 0.7])
def test_votes_match(n, tile, p):
    mask = np.random.RandomState(n + int(10 * p)).uniform(size=n) < p
    for level in LEVELS:
        got = hierarchy.vote(t(mask), level, tile_size=tile)
        want = jhier.vote(j(mask), jtypes.Level(level.value),
                          tile_size=tile)
        assert np.array_equal(npy(got), npy(want)), (level, tile)


def test_grouped_and_2d_votes_match():
    rng = np.random.RandomState(3)
    m = rng.uniform(size=(4, 64)) < 0.5
    for g in (1, 2, 8, 64):
        assert np.array_equal(
            npy(hierarchy.grouped_majority(t(m), g)),
            npy(jhier.grouped_majority(j(m), g)))
    assert np.array_equal(npy(hierarchy.grouped_majority(t(m), 2, dim=0)),
                          npy(jhier.grouped_majority(j(m), 2, axis=0)))
    with pytest.raises(ValueError):
        hierarchy.grouped_majority(t(m), 5)
    m2 = rng.uniform(size=(2, 16, 256)) < 0.5
    assert np.array_equal(npy(hierarchy.tile_vote_2d(t(m2))),
                          npy(jhier.tile_vote_2d(j(m2))))
    assert np.array_equal(npy(hierarchy.tile_vote_2d(t(m2), (4, 32))),
                          npy(jhier.tile_vote_2d(j(m2), (4, 32))))
    with pytest.raises(ValueError):
        hierarchy.tile_vote_2d(t(m2[:, :5]))


def test_fraction_is_xla_mean():
    for n in (7, 320, 4096):
        m = np.random.RandomState(n).uniform(size=n) < 0.37
        assert float(hierarchy.fraction(t(m))) == \
            float(jnp.mean(j(m).astype(jnp.float32)))


# -- TAF -------------------------------------------------------------------

def test_taf_state_machine_cycle():
    params = TAFParams(history_size=3, prediction_size=4, rsd_threshold=0.5)
    state = taf.init(params, 1, device="cpu")
    outs, masks = [], []
    for _ in range(12):
        out, state, mask = taf.step(state, lambda: torch.tensor([1.0]),
                                    params)
        outs.append(float(out[0]))
        masks.append(bool(mask[0]))
    assert masks[:3] == [False] * 3 and masks[3:7] == [True] * 4
    assert masks[7] is False and masks[8:12] == [True] * 4
    assert all(o == 1.0 for o in outs)


def test_taf_memo_returns_last_accurate():
    params = TAFParams(2, 2, 10.0)
    state = taf.init(params, 1)
    _, state, _ = taf.step(state, lambda: torch.tensor([5.0]), params)
    _, state, _ = taf.step(state, lambda: torch.tensor([7.0]), params)
    out, state, m = taf.step(state, lambda: torch.tensor([9.0]), params)
    assert bool(m[0]) and float(out[0]) == 7.0


def test_taf_noisy_never_stabilizes():
    xs = torch.from_numpy(np.random.RandomState(0).standard_normal(
        (30, 8, 4)) * 100)
    _, _, frac = taf.run_sequence(TAFParams(3, 4, 0.01), xs,
                                  lambda x: x.sum(-1))
    assert float(frac) < 0.05


def test_taf_block_level_skips_the_accurate_path():
    params = TAFParams(2, 4, 10.0)
    state = taf.init(params, 8)
    calls = []

    def accurate():
        calls.append(1)
        return torch.ones(8)

    masks = []
    for _ in range(6):
        _, state, mask = taf.step(state, accurate, params, Level.BLOCK)
        masks.append(bool(mask.all()))
    assert masks == [False, False, True, True, True, True]
    assert len(calls) == 2  # approximated steps never call it


def _taf_xs(seed, steps, n, d=3, noise=0.05):
    rng = np.random.RandomState(seed)
    return (1.0 + noise * rng.standard_normal((steps, n, d))).astype(
        np.float32)


@pytest.mark.parametrize("level", LEVELS, ids=lambda lv: lv.value)
@pytest.mark.parametrize("hook", [None, "float", "tensor"])
def test_taf_run_sequence_matches(level, hook):
    xs = _taf_xs(0, 24, 16)
    fn = lambda x: x.sum(-1)  # noqa: E731
    params = TAFParams(2, 3, 0.5 if hook is None else 9.0)
    th = {None: None, "float": 0.03, "tensor": torch.tensor(0.03)}[hook]
    jth = None if th is None else jnp.float32(0.03)
    ys, st, frac = taf.run_sequence(params, t(xs), fn, level, tile_size=4,
                                    rsd_threshold=th)
    jys, jst, jfrac = jtaf.run_sequence(
        jtypes.TAFParams(*params.__dict__.values()), j(xs), fn,
        jtypes.Level(level.value), tile_size=4, rsd_threshold=jth)
    assert float(frac) == float(jfrac)
    np.testing.assert_allclose(npy(ys), npy(jys), atol=OUT_ATOL)
    for a, b in zip(st, jst):
        np.testing.assert_allclose(npy(a), npy(b), atol=OUT_ATOL)


@pytest.mark.parametrize("level", LEVELS, ids=lambda lv: lv.value)
def test_taf_steps_from_a_carried_state(level):
    """Run the JAX state machine half way, carry its state across, and step
    both packages on the same accurate outputs: masks equal every step."""
    params = TAFParams(3, 4, 0.05)
    jparams = jtypes.TAFParams(3, 4, 0.05)
    jlevel = jtypes.Level(level.value)
    outs = _taf_xs(1, 20, 32, d=2, noise=0.03)
    jst = jtaf.init(jparams, 32, (2,))
    for k in range(10):
        _, jst, _ = jtaf.step(jst, lambda k=k: j(outs[k]), jparams, jlevel,
                              tile_size=8)
    st = convert.taf_state(jst, device="cpu")
    approximated = 0
    for k in range(10, 20):
        out, st, m = taf.step(st, lambda k=k: t(outs[k]), params, level,
                              tile_size=8, rsd_threshold=torch.tensor(0.05))
        jout, jst, jm = jtaf.step(jst, lambda k=k: j(outs[k]), jparams,
                                  jlevel, tile_size=8)
        assert np.array_equal(npy(m), npy(jm)), f"step {k}"
        np.testing.assert_allclose(npy(out), npy(jout), atol=OUT_ATOL)
        approximated += int(npy(m).sum())
    for a, b in zip(st, jst):
        np.testing.assert_allclose(npy(a), npy(b), atol=OUT_ATOL)
    assert approximated > 0


@pytest.mark.parametrize("n", [1, 2, 5, 8, 9])
def test_taf_block_run_length_matches_jax_stepping(n):
    """From a state whose elements have different `remaining`, the run of
    approximated BLOCK steps the port predicts with one read equals the
    one the JAX package steps through."""
    jparams = jtypes.TAFParams(2, 8, 0.5)
    rem = np.random.RandomState(n).randint(0, 9, n).astype(np.int32)
    jst = jtaf.init(jparams, n)._replace(remaining=jnp.asarray(rem))
    st = convert.taf_state(jst, device="cpu")
    run = 0
    while True:
        _, jst, m = jtaf.step(jst, lambda: jnp.ones((n,)), jparams,
                              jtypes.Level.BLOCK)
        if not bool(m[0]):
            break
        run += 1
    assert int(taf.block_run_length(st)) == run


def test_taf_block_run_counts_one_read_per_accurate_step():
    xs = torch.ones(40, 16, 2)
    before = metrics.host_reads()
    _, _, frac = taf.run_sequence(TAFParams(2, 5, 0.5), xs,
                                  lambda x: x.sum(-1), Level.BLOCK)
    accurate = round((1 - float(frac)) * 40)
    assert metrics.host_reads() - before == accurate
    assert 0 < accurate < 40


# -- iACT --------------------------------------------------------------------

def test_iact_exact_reuse_and_zero_threshold():
    xs = torch.arange(6.0)[None, :, None].repeat(10, 1, 3)
    ys, _, frac = iact.run_sequence(IACTParams(4, 0.5, 0), xs,
                                    lambda x: x.sum(-1))
    assert float(frac) > 0.8
    np.testing.assert_allclose(npy(ys), npy(xs.sum(-1)), atol=1e-5)
    xs = torch.from_numpy(np.random.RandomState(0).standard_normal(
        (10, 8, 3)))
    _, _, frac = iact.run_sequence(IACTParams(4, 1e-9, 0), xs,
                                   lambda x: x.sum(-1))
    assert float(frac) == 0.0


def test_iact_round_robin_and_table_counts():
    params = IACTParams(table_size=2, threshold=0.1, tables_per_block=1)
    state = iact.init(params, 1, 2)
    for v in (0.0, 10.0, 20.0):
        _, state, _ = iact.step(state, torch.full((1, 2), v),
                                lambda x: x.sum(-1), params)
    assert sorted(state.keys[0, :, 0].tolist()) == [10.0, 20.0]
    assert iact.n_tables_for(IACTParams(4, 0.5, 0), 64) == 64
    assert iact.n_tables_for(IACTParams(4, 0.5, 8), 64) == 8
    assert iact.n_tables_for(IACTParams(4, 0.5, 100), 64) == 64
    with pytest.raises(ValueError):
        iact.step(iact.init(params, 3, 2), torch.zeros(4, 2),
                  lambda x: x.sum(-1), params)


def _iact_xs(seed, steps, n, d):
    """Inputs that revisit a few points, so some probes hit."""
    rng = np.random.RandomState(seed)
    pts = rng.standard_normal((4, n, d))
    pick = rng.randint(0, 4, steps)
    return (pts[pick] + 0.03 * rng.standard_normal((steps, n, d))).astype(
        np.float32)


@pytest.mark.parametrize("level", LEVELS, ids=lambda lv: lv.value)
@pytest.mark.parametrize("tpb,hook", [(0, None), (2, "float"),
                                      (4, "tensor")])
def test_iact_run_sequence_matches(level, tpb, hook):
    xs = _iact_xs(0, 24, 16, 3)
    fn = lambda x: (x * x).sum(-1)  # noqa: E731
    params = IACTParams(2, 0.2 if hook is None else 5.0, tpb)
    th = {None: None, "float": 0.2, "tensor": torch.tensor(0.2)}[hook]
    jth = None if th is None else jnp.float32(0.2)
    ys, st, frac = iact.run_sequence(params, t(xs), fn, level, tile_size=4,
                                     threshold=th)
    jys, jst, jfrac = jiact.run_sequence(
        jtypes.IACTParams(*params.__dict__.values()), j(xs), fn,
        jtypes.Level(level.value), tile_size=4, threshold=jth)
    assert float(frac) == float(jfrac)
    assert tpb != 0 or float(frac) > 0  # private tables: some probes hit
    np.testing.assert_allclose(npy(ys), npy(jys), atol=OUT_ATOL)
    for a, b in zip(st, jst):
        np.testing.assert_allclose(npy(a), npy(b), atol=OUT_ATOL)


@pytest.mark.parametrize("level", LEVELS, ids=lambda lv: lv.value)
def test_iact_steps_from_a_carried_state(level):
    jparams = jtypes.IACTParams(3, 0.3, 0)
    params = IACTParams(3, 0.3, 0)
    jlevel = jtypes.Level(level.value)
    xs = _iact_xs(2, 16, 32, 2)
    outs = (xs ** 2).sum(-1)  # the same accurate outputs for both
    jst = jiact.init(jparams, 32, 2)
    for k in range(8):
        _, jst, _ = jiact.step(jst, j(xs[k]), lambda x, k=k: j(outs[k]),
                               jparams, jlevel, tile_size=8)
    st = convert.iact_state(jst, device="cpu")
    hits = 0
    for k in range(8, 16):
        out, st, m = iact.step(st, t(xs[k]), lambda x, k=k: t(outs[k]),
                               params, level, tile_size=8)
        jout, jst, jm = jiact.step(jst, j(xs[k]), lambda x, k=k: j(outs[k]),
                                   jparams, jlevel, tile_size=8)
        assert np.array_equal(npy(m), npy(jm)), f"step {k}"
        np.testing.assert_allclose(npy(out), npy(jout), atol=OUT_ATOL)
        hits += int(npy(m).sum())
    for a, b in zip(st, jst):
        assert np.array_equal(npy(a), npy(b))
    assert hits > 0


def test_iact_block_reads_are_bounded():
    xs = _iact_xs(3, 40, 8, 2)
    before = metrics.host_reads()
    _, _, frac = iact.run_sequence(IACTParams(4, 0.3, 0), t(xs),
                                   lambda x: x.sum(-1), Level.BLOCK)
    reads = metrics.host_reads() - before
    accurate = round((1 - float(frac)) * 40)
    # one read per accurate step and one per batched read phase
    assert accurate <= reads <= 2 * accurate + 6


# -- ApproxRegion and perforated_loop ---------------------------------------

def test_region_host_matches_jax():
    n = 16
    xs = _taf_xs(4, 12, n, d=2)
    fn = lambda x: x.sum(-1) * 2.0  # noqa: E731
    for spec in (ApproxSpec(Technique.TAF, Level.TILE,
                            taf=TAFParams(2, 4, 0.05)),
                 ApproxSpec(Technique.IACT, Level.ELEMENT,
                            iact=IACTParams(2, 0.1, 4)),
                 ApproxSpec()):
        reg = ApproxRegion(spec, fn, n_elements=n, in_dim=2, tile_size=8,
                           substrate="host", device="cpu")
        jreg = japprox.ApproxRegion(jspec(spec), fn, n_elements=n, in_dim=2,
                                    tile_size=8, substrate="host")
        ys, frac = reg.run(t(xs))
        jys, jfrac = jreg.run(j(xs))
        assert float(frac) == float(jfrac)
        np.testing.assert_allclose(npy(ys), npy(jys), atol=OUT_ATOL)
        st, jst = reg.init_state(), jreg.init_state()
        for k in range(4):
            out, st, m = reg.step(st, t(xs[k]))
            jout, jst, jm = jreg.step(jst, j(xs[k]))
            assert np.array_equal(npy(m), npy(jm))
            np.testing.assert_allclose(npy(out), npy(jout), atol=OUT_ATOL)


def test_region_cuda_substrate_matches_pallas_impl():
    """On the "cuda" substrate the region calls its cuda_impl (K2 / K3 over
    `substrate.*_region`; their plain versions on CPU tensors) where the JAX
    region calls its pallas_impl (the Pallas kernels in interpret mode,
    pipeline=False)."""
    rng = np.random.RandomState(5)
    # four row blocks, each twice: the second of a pair can hit
    base = rng.randn(4, 1, 32)[[0, 0, 1, 1, 2, 2, 3, 3]]
    x = np.repeat(base, 16, axis=1).reshape(128, 32)
    x = (x + 0.01 * rng.randn(128, 32)).astype(np.float32)
    w = (rng.randn(32, 32) / 6).astype(np.float32)
    w1 = (rng.randn(32, 64) / 6).astype(np.float32)
    w2 = (rng.randn(64, 32) / 8).astype(np.float32)
    taf_spec = ApproxSpec(Technique.TAF, Level.BLOCK,
                          taf=TAFParams(2, 4, 0.2))
    iact_spec = ApproxSpec(Technique.IACT, Level.BLOCK,
                           iact=IACTParams(2, 0.3, 1))

    def taf_impl(xx, rsd_threshold=None, threshold=None):
        return substrate.taf_matmul_region(xx, t(w), taf_spec, block_m=16,
                                           block_n=32,
                                           rsd_threshold=rsd_threshold)

    def jtaf_impl(xx, rsd_threshold=None, threshold=None):
        th = 0.2 if rsd_threshold is None else rsd_threshold
        return jops.taf_matmul(xx, j(w), block_m=16, block_n=32,
                               history_size=2, prediction_size=4,
                               rsd_threshold=th, interpret=True,
                               pipeline=False)

    def iact_impl(xx, rsd_threshold=None, threshold=None):
        return substrate.iact_ffn_region(xx, t(w1), t(w2), iact_spec,
                                         block_rows=16, threshold=threshold)

    def jiact_impl(xx, rsd_threshold=None, threshold=None):
        th = 0.3 if threshold is None else threshold
        return jops.iact_rowfn(xx, j(w1), j(w2), block_rows=16,
                               table_size=2, threshold=th, interpret=True)

    for spec, impl, jimpl, hook in (
            (taf_spec, taf_impl, jtaf_impl, "rsd_threshold"),
            (iact_spec, iact_impl, jiact_impl, "threshold")):
        reg = ApproxRegion(spec, None, n_elements=128, substrate="cuda",
                           cuda_impl=impl, device="cpu")
        jreg = japprox.ApproxRegion(jspec(spec), None, n_elements=128,
                                    substrate="pallas", pallas_impl=jimpl)
        for knob in (None, 0.25):
            kw = {} if knob is None else {hook: knob}
            jkw = {} if knob is None else {hook: jnp.float32(knob)}
            ys, frac = reg.run(t(x), **kw)
            jys, jfrac = jreg.run(j(x), **jkw)
            assert float(frac) == float(jfrac)
            np.testing.assert_allclose(npy(ys), npy(jys), atol=KERNEL_ATOL)
            out, st, m = reg.step("state", t(x), **kw)
            jout, _, jm = jreg.step("state", j(x), **jkw)
            assert st == "state" and np.array_equal(npy(m), npy(jm))
        assert float(frac) > 0
    with pytest.raises(ValueError, match="cuda_impl"):
        ApproxRegion(taf_spec, None, n_elements=4, substrate="cuda").run(
            t(x))


def test_region_hooks_pass_through_and_reject():
    n = 8
    region = ApproxRegion(ApproxSpec(Technique.TAF, taf=TAFParams(2, 4, 0.5)),
                          lambda x: x * 2.0, n_elements=n, substrate="host")
    xs = torch.ones(5, n)
    ys_s, frac_s = region.run(xs)
    ys_t, frac_t = region.run(xs, rsd_threshold=torch.tensor(0.5))
    assert torch.equal(ys_s, ys_t) and float(frac_s) == float(frac_t)
    iact_region = ApproxRegion(ApproxSpec(Technique.IACT), lambda x: x,
                               n_elements=n, substrate="host")
    with pytest.raises(ValueError):
        region.run(xs, threshold=0.5)
    with pytest.raises(ValueError):
        iact_region.run(xs, rsd_threshold=0.5)
    with pytest.raises(ValueError):
        region.step(None, xs[0], threshold=0.5)
    with pytest.raises(ValueError):
        ApproxRegion(ApproxSpec(Technique.PERFORATION), lambda x: x,
                     n_elements=n, substrate="host").run(xs)


@pytest.mark.parametrize("kind,arg,herded", [
    (PerforationKind.SMALL, 4, True), (PerforationKind.LARGE, 3, True),
    (PerforationKind.INI, 0.25, True), (PerforationKind.FINI, 0.4, True),
    (PerforationKind.SMALL, 4, False), (PerforationKind.RANDOM, 0.3, False)])
def test_perforated_loop_matches(kind, arg, herded):
    kw = dict(skip=arg) if isinstance(arg, int) else dict(fraction=arg)
    spec = ApproxSpec(Technique.PERFORATION, perforation=PerforationParams(
        kind=kind, herded=herded, **kw))
    got, frac = perforated_loop(spec, 16, lambda i, c: c + float(i) ** 2,
                                torch.zeros(()))
    want, jfrac = japprox.perforated_loop(
        jspec(spec), 16, lambda i, c: c + jnp.float32(i) ** 2,
        jnp.float32(0))
    assert float(got) == float(want) and float(frac) == float(jfrac)


@pytest.mark.parametrize("kind", [PerforationKind.INI, PerforationKind.FINI,
                                  PerforationKind.RANDOM])
def test_perforated_loop_traced_fraction(kind):
    spec = ApproxSpec(Technique.PERFORATION, perforation=PerforationParams(
        kind=kind, fraction=0.25, herded=False))
    body = lambda i, c: (c[0] + i, c[1] * 1.5)  # noqa: E731
    for fr in (0.0, 0.25, 0.5):
        got, frac = perforated_loop(spec, 8, body,
                                    (torch.zeros(()), torch.ones(())),
                                    fraction=torch.tensor(fr))
        want, jfrac = japprox.perforated_loop(
            jspec(spec), 8, body, (jnp.float32(0), jnp.float32(1)),
            fraction=jnp.float32(fr))
        assert [float(g) for g in got] == [float(w) for w in want]
        assert float(frac) == float(jfrac)
    # the hook on a spec that cannot honour it raises
    with pytest.raises(ValueError):
        perforated_loop(ApproxSpec(Technique.TAF), 4, body, (0, 1),
                        fraction=0.5)
    out, frac = perforated_loop(ApproxSpec(), 4, lambda i, c: c + i, 0)
    assert out == 6 and frac == 1.0


# -- batching, harness, pareto, autotune ------------------------------------

def test_sequence_runner_matches_jax():
    xs = _taf_xs(6, 16, 16)
    fn = lambda x: x.sum(-1)  # noqa: E731
    for spec in (ApproxSpec(Technique.TAF, Level.ELEMENT,
                            taf=TAFParams(2, 4, 0.5)),
                 ApproxSpec(Technique.IACT, Level.TILE,
                            iact=IACTParams(2, 0.5, 0))):
        key = batching.static_key(spec)
        jkey = jbatching.static_key(jspec(spec))
        run = batching.sequence_runner(key, t(xs), fn)
        jrun = jbatching.sequence_runner(jkey, j(xs), fn)
        for th in (0.02, 0.1):
            ys, frac = run(torch.tensor(th))
            jys, jfrac = jrun(jnp.float32(th))
            assert float(frac) == float(jfrac)
            np.testing.assert_allclose(npy(ys), npy(jys), atol=OUT_ATOL)
    perfo = batching.static_key(ApproxSpec(
        Technique.PERFORATION, perforation=PerforationParams(
            kind=PerforationKind.INI)))
    assert batching.sequence_runner(perfo, t(xs), fn) is None


def test_group_lanes_matches_jax():
    specs = [None, ApproxSpec(Technique.TAF, taf=TAFParams(2, 4, 0.5)),
             ApproxSpec(Technique.TAF, taf=TAFParams(2, 4, 0.9)),
             ApproxSpec(), ApproxSpec(Technique.IACT,
                                      iact=IACTParams(2, 0.3, 1))]
    groups, precise = batching.group_lanes(specs)
    jgroups, jprecise = jbatching.group_lanes(
        [None if s is None else jspec(s) for s in specs])
    assert precise == jprecise == [0, 3]
    assert [v for v in groups.values()] == [v for v in jgroups.values()]
    with pytest.raises(ValueError):
        batching.group_lanes([ApproxSpec(
            Technique.PERFORATION,
            perforation=PerforationParams(kind=PerforationKind.SMALL))])


@pytest.fixture(scope="module")
def bs_apps():
    return (tbs.make_app(n_elements=64, steps=24, device="cpu"),
            jbs.make_app(n_elements=64, steps=24))


def _same_record(r, jr):
    assert r.spec_hash == jr.spec_hash and r.spec == jr.spec
    assert r.approx_fraction == jr.approx_fraction
    assert r.modeled_speedup == pytest.approx(jr.modeled_speedup,
                                              rel=1e-12)
    assert r.error == pytest.approx(jr.error, abs=1e-5)


def test_evaluate_spec_matches(bs_apps):
    app, japp = bs_apps
    spec = ApproxSpec(Technique.TAF, Level.ELEMENT, taf=TAFParams(2, 8, 0.5))
    rec = harness.evaluate_spec(app, spec, app.exact())
    jrec = jharness.evaluate_spec(japp, jspec(spec), japp.exact())
    _same_record(rec, jrec)
    assert rec.workload == jrec.workload


def test_refine_matches(bs_apps):
    app, japp = bs_apps
    grid = harness.taf_grid(h_sizes=(2,), p_sizes=(4, 16),
                            thresholds=(0.1, 0.5), levels=(Level.ELEMENT,))
    recs = harness.sweep(app, grid, repeats=1)
    jrecs = jharness.sweep(japp, [jspec(s) for s in grid], repeats=1)
    for r, jr in zip(recs, jrecs):
        _same_record(r, jr)
    cands = pareto.propose_candidates(recs, use_modeled=True)
    jcands = jpareto.propose_candidates(jrecs, use_modeled=True)
    assert [harness.spec_hash(c) for c in cands] == \
        [jharness.spec_hash(c) for c in jcands]
    assert pareto.dominates(recs[0], recs[0]) is False
    new = pareto.refine(app, recs, budget=3, rounds=2, use_modeled=True)
    jnew = jpareto.refine(japp, jrecs, budget=3, rounds=2, use_modeled=True)
    assert len(new) == len(jnew) > 0
    for r, jr in zip(new, jnew):
        _same_record(r, jr)


def test_successive_halving_and_random_search_match(bs_apps):
    app, japp = bs_apps
    grid = harness.taf_grid(h_sizes=(2, 3), p_sizes=(8,),
                            thresholds=(0.1, 0.5, 1.5),
                            levels=(Level.ELEMENT,))
    out = autotune.successive_halving(app, grid, eta=2, seed=3)
    jout = jautotune.successive_halving(japp, [jspec(s) for s in grid],
                                        eta=2, seed=3)
    assert len(out) == len(jout) >= 1
    for r, jr in zip(out, jout):
        _same_record(r, jr)

    def sampler(rng):
        return ApproxSpec(Technique.TAF, Level.ELEMENT, taf=TAFParams(
            rng.choice([2, 3]), 8, rng.choice([0.1, 0.5])))

    recs = autotune.random_search(app, sampler, budget=3, seed=1)
    jrecs = jautotune.random_search(japp, lambda rng: jspec(sampler(rng)),
                                    budget=3, seed=1)
    for r, jr in zip(recs, jrecs):
        _same_record(r, jr)


def test_substrate_reads_the_environment(monkeypatch):
    monkeypatch.setattr(substrate, "_default", None)
    monkeypatch.delenv("REPRO_SUBSTRATE", raising=False)
    assert substrate.get_default() == substrate.CUDA
    for value, want in (("host", substrate.HOST), (" CUDA ", substrate.CUDA)):
        monkeypatch.setattr(substrate, "_default", None)
        monkeypatch.setenv("REPRO_SUBSTRATE", value)
        assert substrate.get_default() == want
        with substrate.use(substrate.CUDA if want == substrate.HOST
                           else substrate.HOST):
            assert substrate.get_default() != want
        assert substrate.get_default() == want
    monkeypatch.setattr(substrate, "_default", None)
    monkeypatch.setenv("REPRO_SUBSTRATE", "pallas")
    with pytest.raises(ValueError, match="REPRO_SUBSTRATE"):
        substrate.get_default()
    monkeypatch.setattr(substrate, "_default", None)
