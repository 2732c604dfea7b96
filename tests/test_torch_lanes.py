"""The lane-grid form of the port's K1-K3 against `jax.vmap` of the Pallas
kernels.

The JAX package runs a structural group of specs as one `jax.vmap` of a
Pallas kernel over a stack of knobs; the port's wrappers take the (L,)
knob tensor itself and run every lane in one call. On the CPU each wrapper
takes its plain lane version (`ref.*_lanes_ref`); it is held here against
the vmapped Pallas kernel in interpret mode (`pipeline=False`) on the same
numpy inputs, with shared and with lane-stacked operands. Masks are equal
lane by lane; values agree within the single-call tolerances (TAF / iACT
1e-3, attention 1e-4: `tests/test_kernels.py`). The CUDA lane kernels are
held against these plain versions on the card in `tests/test_torch_cuda.py`.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import types as jtypes
from repro.kernels.iact_memo import iact_rowfn as pallas_iact
from repro.kernels.perforated_attention import \
    perforated_attention as pallas_attention
from repro.kernels.taf_matmul import taf_matmul as pallas_taf
from repro_torch.apps import approx_ffn as tffn
from repro_torch.benchmarks import approx_ffn_sweep as tsweep
from repro_torch.core import batching
from repro_torch.core import substrate as tsub
from repro_torch.core import types as ttypes
from repro_torch.kernels import ops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAF_ATOL = IACT_ATOL = 1e-3
ATTN_ATOL = 1e-4


def _stableish(rng, m, k, noise):
    base = rng.randn(1, k).astype(np.float32)
    return np.tile(base, (m, 1)) + noise * rng.randn(m, k).astype(np.float32)


def _lanes_x(rng, lanes, m, k, noise):
    return np.stack([_stableish(rng, m, k, noise) for _ in range(lanes)])


# ----------------------------------------------------------------------------
# K2: TAF matmul over a threshold stack
# ----------------------------------------------------------------------------

TAF_CASES = [
    # m, k, n, bm, bn, h, p, thresholds, stacked (x, w)
    (128, 32, 64, 32, 32, 3, 4, (0.01, 0.1, 0.5, 2.0), (False, False)),
    (128, 32, 32, 16, 32, 2, 4, (0.05, 0.2, 1.0), (True, False)),
    (64, 16, 32, 16, 16, 1, 2, (0.1, 5.0), (True, True)),
    (128, 32, 32, 16, 32, 2, 4, (0.2,), (False, True)),
]


def _taf_inputs(m, k, n, lanes, stacked, seed):
    rng = np.random.RandomState(seed)
    x = (_lanes_x(rng, lanes, m, k, 0.05) if stacked[0]
         else _stableish(rng, m, k, 0.05))
    w = rng.randn(*((lanes, k, n) if stacked[1] else (k, n))) \
        .astype(np.float32)
    return x, w


@pytest.mark.parametrize("m,k,n,bm,bn,h,p,ths,stacked", TAF_CASES)
def test_taf_lanes_match_vmapped_pallas(m, k, n, bm, bn, h, p, ths,
                                        stacked):
    lanes = len(ths)
    x, w = _taf_inputs(m, k, n, lanes, stacked, m + n + lanes)
    th = np.asarray(ths, np.float32)
    y, mask = ops.taf_matmul(torch.from_numpy(x), torch.from_numpy(w),
                             block_m=bm, block_n=bn, history_size=h,
                             prediction_size=p,
                             rsd_threshold=torch.from_numpy(th))
    run = jax.vmap(
        lambda xx, ww, t: pallas_taf(xx, ww, block_m=bm, block_n=bn,
                                     history_size=h, prediction_size=p,
                                     rsd_threshold=t, interpret=True,
                                     pipeline=False),
        in_axes=(0 if stacked[0] else None, 0 if stacked[1] else None, 0))
    yp, mp = run(jnp.asarray(x), jnp.asarray(w), jnp.asarray(th))
    assert tuple(y.shape) == (lanes, m, n)
    assert tuple(mask.shape) == (lanes, m // bm, n // bn)
    for lane in range(lanes):
        assert np.array_equal(mask[lane].numpy(), np.asarray(mp[lane]))
    np.testing.assert_allclose(y.numpy(), np.asarray(yp), atol=TAF_ATOL)


def test_taf_lane_equals_single_call():
    x, w = _taf_inputs(128, 32, 64, 3, (True, False), 5)
    th = torch.tensor([0.02, 0.3, 1.5])
    y, mask = ops.taf_matmul(torch.from_numpy(x), torch.from_numpy(w),
                             block_m=16, block_n=32, history_size=2,
                             prediction_size=4, rsd_threshold=th)
    for lane in range(3):
        y1, m1 = ops.taf_matmul(torch.from_numpy(x[lane]),
                                torch.from_numpy(w), block_m=16, block_n=32,
                                history_size=2, prediction_size=4,
                                rsd_threshold=th[lane])
        assert torch.equal(m1, mask[lane]) and torch.equal(y1, y[lane])
    assert mask.any() and not mask.all()


# ----------------------------------------------------------------------------
# K3: iACT row function over a threshold stack
# ----------------------------------------------------------------------------

def _iact_x(rng, n, din, br):
    distinct = rng.randn(max(n // (2 * br), 1), din).astype(np.float32)
    return np.repeat(distinct, 2 * br, axis=0)[:n] + \
        0.001 * rng.randn(n, din).astype(np.float32)


IACT_CASES = [
    # n, din, dh, dout, br, ts, thresholds, stacked (x, w1, w2)
    (128, 16, 32, 8, 32, 4, (1e-9, 0.05, 0.5, 5.0), (False, False, False)),
    (128, 32, 64, 32, 16, 2, (0.05, 0.5, 2.0), (True, False, False)),
    (64, 8, 16, 8, 16, 8, (0.5, 1e-9), (True, True, True)),
]


@pytest.mark.parametrize("n,din,dh,dout,br,ts,ths,stacked", IACT_CASES)
def test_iact_lanes_match_vmapped_pallas(n, din, dh, dout, br, ts, ths,
                                         stacked):
    lanes = len(ths)
    rng = np.random.RandomState(n + din + lanes)
    x = (np.stack([_iact_x(rng, n, din, br) for _ in range(lanes)])
         if stacked[0] else _iact_x(rng, n, din, br))
    w1 = (rng.randn(*((lanes,) if stacked[1] else ()), din, dh)
          * 0.1).astype(np.float32)
    w2 = (rng.randn(*((lanes,) if stacked[2] else ()), dh, dout)
          * 0.1).astype(np.float32)
    th = np.asarray(ths, np.float32)
    y, mask = ops.iact_rowfn(torch.from_numpy(x), torch.from_numpy(w1),
                             torch.from_numpy(w2), block_rows=br,
                             table_size=ts, threshold=torch.from_numpy(th))
    run = jax.vmap(
        lambda xx, a, b, t: pallas_iact(xx, a, b, block_rows=br,
                                        table_size=ts, threshold=t,
                                        interpret=True),
        in_axes=tuple(0 if s else None for s in stacked) + (0,))
    yp, mp = run(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2),
                 jnp.asarray(th))
    assert tuple(y.shape) == (lanes, n, dout)
    assert tuple(mask.shape) == (lanes, n // br)
    for lane in range(lanes):
        assert np.array_equal(mask[lane].numpy(), np.asarray(mp[lane]))
    np.testing.assert_allclose(y.numpy(), np.asarray(yp), atol=IACT_ATOL)
    assert mask.any() and not mask.all()


def test_iact_lane_equals_single_call():
    rng = np.random.RandomState(3)
    x = torch.from_numpy(_iact_x(rng, 128, 16, 16))
    w1 = torch.from_numpy((rng.randn(16, 32) * 0.1).astype(np.float32))
    w2 = torch.from_numpy((rng.randn(32, 8) * 0.1).astype(np.float32))
    th = torch.tensor([1e-9, 0.05, 0.5])
    y, mask = ops.iact_rowfn(x, w1, w2, block_rows=16, table_size=2,
                             threshold=th)
    for lane in range(3):
        y1, m1 = ops.iact_rowfn(x, w1, w2, block_rows=16, table_size=2,
                                threshold=th[lane])
        assert torch.equal(m1, mask[lane]) and torch.equal(y1, y[lane])


# ----------------------------------------------------------------------------
# K1: masked perforated attention over a fraction stack
# ----------------------------------------------------------------------------

def _qkv(rng, lead, b, hq, hkv, sq, skv, d):
    return (rng.randn(*lead, b, hq, sq, d).astype(np.float32),
            rng.randn(*lead, b, hkv, skv, d).astype(np.float32),
            rng.randn(*lead, b, hkv, skv, d).astype(np.float32))


@pytest.mark.parametrize("kind,fracs,stacked", [
    ("ini", (0.0, 0.25, 0.5), False),
    ("fini", (0.25, 0.5, 0.75), False),
    ("random", (0.1, 0.5), False),
    ("fini", (0.25, 0.75), True),
])
def test_attention_lanes_match_vmapped_pallas(kind, fracs, stacked):
    lanes = len(fracs)
    rng = np.random.RandomState(len(kind) + lanes)
    lead = (lanes,) if stacked else ()
    q, k, v = _qkv(rng, lead, 1, 4, 2, 64, 128, 16)
    fr = np.asarray(fracs, np.float32)
    tp = ttypes.PerforationParams(kind=ttypes.PerforationKind(kind))
    jp = jtypes.PerforationParams(kind=jtypes.PerforationKind(kind))
    o = ops.perforated_attention(*map(torch.from_numpy, (q, k, v)),
                                 block_q=32, block_kv=32, perfo=tp,
                                 fraction=torch.from_numpy(fr))
    ax = 0 if stacked else None
    run = jax.vmap(
        lambda qq, kk, vv, f: pallas_attention(
            qq, kk, vv, block_q=32, block_kv=32, perfo=jp, fraction=f,
            interpret=True, pipeline=False),
        in_axes=(ax, ax, ax, 0))
    op = run(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
             jnp.asarray(fr))
    assert tuple(o.shape) == (lanes, 1, 4, 64, 16)
    np.testing.assert_allclose(o.numpy(), np.asarray(op), atol=ATTN_ATOL)


def test_attention_lane_equals_single_call_and_region_mask():
    rng = np.random.RandomState(9)
    q, k, v = map(torch.from_numpy, _qkv(rng, (), 1, 2, 2, 64, 128, 16))
    spec = ttypes.ApproxSpec(
        ttypes.Technique.PERFORATION, ttypes.Level.BLOCK,
        perforation=ttypes.PerforationParams(kind=ttypes.PerforationKind.INI))
    fr = torch.tensor([0.0, 0.25, 0.75])
    o, kept = tsub.attention_region(q, k, v, spec, block_q=32, block_kv=32,
                                    fraction=fr)
    assert tuple(kept.shape) == (3, 4)
    for lane in range(3):
        o1, k1 = tsub.attention_region(q, k, v, spec, block_q=32,
                                       block_kv=32, fraction=fr[lane])
        assert torch.equal(o1, o[lane]) and torch.equal(k1, kept[lane])
    assert kept.sum(1).tolist() == [4, 3, 1]


def test_lane_stacks_need_a_knob_stack():
    x, w = torch.zeros(3, 64, 16), torch.zeros(16, 32)
    with pytest.raises(ValueError, match="knob"):
        ops.taf_matmul(x, w, block_m=16, block_n=32, rsd_threshold=0.5)
    with pytest.raises(ValueError, match="knob"):
        ops.taf_matmul(x, w, block_m=16, block_n=32,
                       rsd_threshold=torch.tensor([0.1, 0.2]))


# ----------------------------------------------------------------------------
# approx_ffn: one group call against the group's specs run one by one
# ----------------------------------------------------------------------------

GRID = tsweep.grid()


@pytest.mark.parametrize("technique", ["TAF", "IACT", "PERFORATION"])
def test_ffn_group_equals_serial_runs(technique):
    app = tffn.make_app(substrate="cuda", device="cpu")
    groups, _ = batching.group_specs(GRID)
    key = next(k for k in groups if k[0] == ttypes.Technique[technique])
    specs = [GRID[i] for i in groups[key]]
    batched = app.run_batch(specs)
    for spec, b in zip(specs, batched):
        s = app.run(spec)
        np.testing.assert_allclose(b.qoi, s.qoi, rtol=0, atol=1e-6)
        assert b.approx_fraction == s.approx_fraction
        assert b.extra["approx_mask"] == s.extra["approx_mask"]


def test_group_is_one_kernel_call(monkeypatch):
    """A group of L knobs reaches the kernel wrapper once, with the (L,)
    stack, where the port used to call it once a lane."""
    calls = []
    real = ops.taf_matmul

    def spy(*a, **kw):
        calls.append(kw["rsd_threshold"])
        return real(*a, **kw)

    monkeypatch.setattr(ops, "taf_matmul", spy)
    app = tffn.make_app(substrate="cuda", device="cpu")
    groups, _ = batching.group_specs(GRID)
    key = next(k for k in groups if k[0] == ttypes.Technique.TAF)
    app.run_batch([GRID[i] for i in groups[key]])
    # one warm-up call and one timed call, each with the whole stack
    assert len(calls) == 2
    assert all(tuple(c.shape) == (len(groups[key]),) for c in calls)


def test_batched_sweep_reproduces_committed_front():
    with open(os.path.join(REPO, "benchmarks", "baselines",
                           "BENCH_ffn.json")) as f:
        baseline = json.load(f)
    summary = tsweep.main(report=lambda *a: None, device="cpu", jobs=4)
    assert tsweep.check_front(summary, baseline) == []
