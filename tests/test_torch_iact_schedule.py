"""K3's decide-then-compute plain versions against the JAX package.

`iact_memo.schedule_plain` (the plain version of the `iact_schedule`
kernel) decides every block from x alone; `iact_memo.iact_rowfn_plain`
composes it with the FFN over the computed rows and the copy of each
approximated row. Both are held against the JAX Pallas `iact_rowfn`
(interpret mode) and the JAX `ref.iact_rowfn_ref` on the same numpy inputs:
masks equal, values within 1e-5 (float32 products of the same rows, summed
in another order). The CUDA kernel itself is held against `schedule_plain`
on the card in `tests/test_torch_cuda.py`.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.iact_memo import iact_rowfn as pallas_iact
from repro_torch.kernels import iact_memo, ref

ATOL = 1e-5


def _inputs(n, din, dh, dout, br, seed):
    """A new point every second block, so the second of a pair can hit."""
    rng = np.random.RandomState(seed)
    distinct = rng.randn(max(n // (2 * br), 1), din).astype(np.float32)
    x = np.repeat(distinct, 2 * br, axis=0)[:n] + \
        0.001 * rng.randn(n, din).astype(np.float32)
    w1 = (rng.randn(din, dh) * 0.1).astype(np.float32)
    w2 = (rng.randn(dh, dout) * 0.1).astype(np.float32)
    return x, w1, w2


def _all_alike(n, din, dh, dout, seed):
    """Every row near one point: each block after the first approximates."""
    rng = np.random.RandomState(seed)
    x = np.tile(rng.randn(1, din), (n, 1)).astype(np.float32) + \
        1e-4 * rng.randn(n, din).astype(np.float32)
    return (x, (rng.randn(din, dh) * 0.1).astype(np.float32),
            (rng.randn(dh, dout) * 0.1).astype(np.float32))


# (n, din, dh, dout, br, ts, thr, kind): the five geometries of
# test_torch_kernels.py::test_iact_rowfn_matches_pallas_and_ref, one where
# every block after the first approximates, one where the table wraps
CASES = [
    (128, 16, 32, 8, 32, 4, 0.5, "pairs"),
    (256, 32, 64, 16, 64, 2, 0.5, "pairs"),
    (64, 8, 16, 8, 16, 8, 0.5, "pairs"),
    (128, 32, 64, 32, 16, 2, 0.05, "pairs"),
    (64, 16, 32, 8, 32, 4, 1e-9, "pairs"),
    (128, 16, 32, 8, 16, 2, 0.5, "all_alike"),
    (256, 8, 16, 8, 16, 2, 0.5, "wraps"),
]


def _case(n, din, dh, dout, br, kind):
    if kind == "all_alike":
        return _all_alike(n, din, dh, dout, seed=n + din)
    # "wraps": a new point every second block, 8 points through 2 slots
    return _inputs(n, din, dh, dout, br, seed=n + din)


@pytest.mark.parametrize("n,din,dh,dout,br,ts,thr,kind", CASES)
def test_schedule_and_composition_match_pallas_and_ref(n, din, dh, dout, br,
                                                       ts, thr, kind):
    x, w1, w2 = _case(n, din, dh, dout, br, kind)
    tx, tw1, tw2 = (torch.from_numpy(a) for a in (x, w1, w2))
    mask, computed, src = iact_memo.schedule_plain(tx, br, ts, thr)
    y, mask2 = iact_memo.iact_rowfn_plain(tx, tw1, tw2, block_rows=br,
                                          table_size=ts, threshold=thr)
    yp, mp = pallas_iact(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2),
                         block_rows=br, table_size=ts, threshold=thr,
                         interpret=True)
    yr, mr = jref.iact_rowfn_ref(x, w1, w2, block_rows=br, table_size=ts,
                                 threshold=thr)
    yt, mt = ref.iact_rowfn_ref(tx, tw1, tw2, block_rows=br, table_size=ts,
                                threshold=thr)
    for other in (np.asarray(mp), np.asarray(mr), mt.numpy(),
                  mask2.numpy()):
        assert np.array_equal(mask.numpy(), other)
    np.testing.assert_allclose(y.numpy(), np.asarray(yp), atol=ATOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=ATOL)
    np.testing.assert_allclose(y.numpy(), yt.numpy(), atol=ATOL)
    # the list is the unmasked blocks in order
    assert computed.tolist() == np.flatnonzero(~mask.numpy()).tolist()
    if kind == "all_alike":
        assert computed.tolist() == [0]
    if kind == "wraps":
        assert len(computed) > ts and mask.any()
    if kind == "pairs" and thr < 1e-6:
        assert not mask.any()
    elif kind == "pairs":
        assert mask.any()


@pytest.mark.parametrize("n,din,dh,dout,br,ts,thr,kind", CASES)
def test_src_points_into_an_earlier_computed_block(n, din, dh, dout, br, ts,
                                                   thr, kind):
    x, _, _ = _case(n, din, dh, dout, br, kind)
    mask, computed, src = iact_memo.schedule_plain(torch.from_numpy(x), br,
                                                   ts, thr)
    done = set(computed.tolist())
    for r, s in enumerate(src.tolist()):
        b = r // br
        if not mask[b]:
            assert s == r
        else:
            assert s >= 0 and s // br in done and s // br < b


def test_schedule_threshold_tensor_equals_float():
    x, _, _ = _inputs(128, 16, 32, 8, 16, seed=3)
    a = iact_memo.schedule(torch.from_numpy(x), 16, 2, 0.5)
    b = iact_memo.schedule(torch.from_numpy(x), 16, 2, torch.tensor(0.5))
    assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.parametrize("shapes,rows,ts,ok", [
    (((4096, 2048), (2048, 6144), (6144, 2048)), 16, 2, True),
    (((4096, 2048), (2048, 6144), (6144, 2048)), 512, 4, True),
    (((64, 6), (6, 8), (8, 4)), 16, 2, False),     # d_in not a multiple of 4
    (((64, 8), (8, 8), (8, 6)), 16, 2, False),     # d_out not a multiple of 4
    (((4096, 16384), (16384, 8), (8, 8)), 16, 4, True),
    (((8192, 64), (64, 8), (8, 8)), 4096, 8, False),  # partials: 512 KB
])
def test_launchable_states_the_kernels_rules(shapes, rows, ts, ok):
    why = iact_memo.launchable(shapes, {"block_rows": rows}, ts)
    assert (why is None) == ok
