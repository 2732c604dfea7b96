"""The port's kernel wrappers (K1-K3) against the JAX package.

On the CPU each wrapper takes its plain PyTorch version; it is held against
the JAX Pallas kernel run in interpret mode (`pipeline=False`) and the JAX
`ref.py` oracle on the same numpy inputs. Masks must be equal; values agree
within the JAX tests' tolerances (TAF/iACT 1e-3, attention 1e-4 in float32
and 0.05 in bfloat16: `tests/test_kernels.py`).

The CUDA kernels themselves are held against their plain versions on the
card in `tests/test_torch_cuda.py`.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import types as jtypes
from repro.kernels import ref as jref
from repro.kernels.iact_memo import iact_rowfn as pallas_iact
from repro.kernels.perforated_attention import \
    perforated_attention as pallas_attention
from repro.kernels.taf_matmul import taf_matmul as pallas_taf
from repro_torch.core import types as ttypes
from repro_torch.kernels import (ops, perforated_attention, ref, taf_matmul,
                                 tuning)

TAF_ATOL = IACT_ATOL = 1e-3
ATTN_ATOL = {torch.float32: 1e-4, torch.bfloat16: 0.05}


def _stableish(rng, m, k, noise=0.02):
    """Row-block-correlated inputs: exercises TAF/iACT state transitions."""
    base = rng.randn(1, k).astype(np.float32)
    return np.tile(base, (m, 1)) + noise * rng.randn(m, k).astype(np.float32)


def _np(t):
    return np.asarray(t, np.float32) if not isinstance(t, torch.Tensor) \
        else t.float().numpy()


def _perfo(mod, kind, arg):
    k = mod.PerforationKind(kind)
    if kind in ("small", "large"):
        return mod.PerforationParams(kind=k, skip=arg)
    return mod.PerforationParams(kind=k, fraction=arg)


# ----------------------------------------------------------------------------
# K2: TAF matmul
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n,bm,bn,h,p,t,noise", [
    (128, 32, 64, 32, 32, 3, 4, 0.5, 0.02),
    (256, 64, 128, 64, 64, 3, 4, 0.5, 0.02),
    (64, 16, 32, 16, 16, 3, 4, 0.5, 0.02),
    (128, 32, 32, 32, 32, 1, 2, 0.1, 0.1),
    (128, 32, 32, 32, 32, 5, 16, 2.0, 0.1),
    (128, 32, 32, 16, 32, 2, 4, 0.2, 0.1),   # the app's block geometry
])
def test_taf_matmul_matches_pallas_and_ref(m, k, n, bm, bn, h, p, t, noise):
    rng = np.random.RandomState(m + k + n + h)
    x = _stableish(rng, m, k, noise)
    w = rng.randn(k, n).astype(np.float32)
    y, mask = ops.taf_matmul(torch.from_numpy(x), torch.from_numpy(w),
                             block_m=bm, block_n=bn, history_size=h,
                             prediction_size=p, rsd_threshold=t)
    yp, mp = pallas_taf(jnp.asarray(x), jnp.asarray(w), block_m=bm,
                        block_n=bn, history_size=h, prediction_size=p,
                        rsd_threshold=t, interpret=True, pipeline=False)
    yr, mr = jref.taf_matmul_ref(x, w, block_m=bm, block_n=bn,
                                 history_size=h, prediction_size=p,
                                 rsd_threshold=t)
    assert mask.dtype == torch.bool and tuple(mask.shape) == (m // bm,
                                                              n // bn)
    assert np.array_equal(mask.numpy(), np.asarray(mp))
    assert np.array_equal(mask.numpy(), np.asarray(mr))
    np.testing.assert_allclose(_np(y), _np(yp), atol=TAF_ATOL)
    np.testing.assert_allclose(_np(y), _np(yr), atol=TAF_ATOL)


def test_taf_threshold_tensor_equals_float():
    rng = np.random.RandomState(1)
    x = torch.from_numpy(_stableish(rng, 128, 32, 0.05))
    w = torch.from_numpy(rng.randn(32, 32).astype(np.float32))
    a = ops.taf_matmul(x, w, block_m=16, block_n=32, rsd_threshold=0.2)
    b = ops.taf_matmul(x, w, block_m=16, block_n=32,
                       rsd_threshold=torch.tensor(0.2))
    assert torch.equal(a[1], b[1]) and torch.equal(a[0], b[0])


@pytest.mark.parametrize("bn,cols", [(2048, 16), (32, 16), (16, 16),
                                     (48, 16), (8, 8), (6, 2), (7, 1)])
def test_taf_column_slice_is_widest_dividing_power_of_two(bn, cols):
    assert taf_matmul.column_slice(bn) == cols


def test_taf_rejects_bad_geometry():
    x, w = torch.zeros(64, 16), torch.zeros(16, 32)
    with pytest.raises(ValueError):
        ops.taf_matmul(x, w, block_m=24, block_n=32)
    with pytest.raises(ValueError):
        ops.taf_matmul(x, torch.zeros(8, 32), block_m=16, block_n=32)


# ----------------------------------------------------------------------------
# K3: iACT memoized row function
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("n,din,dh,dout,br,ts,thr", [
    (128, 16, 32, 8, 32, 4, 0.5),
    (256, 32, 64, 16, 64, 2, 0.5),
    (64, 8, 16, 8, 16, 8, 0.5),
    (128, 32, 64, 32, 16, 2, 0.05),   # the app's widths
    (64, 16, 32, 8, 32, 4, 1e-9),     # never approximates
])
def test_iact_rowfn_matches_pallas_and_ref(n, din, dh, dout, br, ts, thr):
    rng = np.random.RandomState(n + din)
    distinct = rng.randn(max(n // (2 * br), 1), din).astype(np.float32)
    x = np.repeat(distinct, 2 * br, axis=0)[:n] + \
        0.001 * rng.randn(n, din).astype(np.float32)
    w1 = (rng.randn(din, dh) * 0.1).astype(np.float32)
    w2 = (rng.randn(dh, dout) * 0.1).astype(np.float32)
    y, mask = ops.iact_rowfn(torch.from_numpy(x), torch.from_numpy(w1),
                             torch.from_numpy(w2), block_rows=br,
                             table_size=ts, threshold=thr)
    yp, mp = pallas_iact(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2),
                         block_rows=br, table_size=ts, threshold=thr,
                         interpret=True)
    yr, mr = jref.iact_rowfn_ref(x, w1, w2, block_rows=br, table_size=ts,
                                 threshold=thr)
    assert np.array_equal(mask.numpy(), np.asarray(mp))
    assert np.array_equal(mask.numpy(), np.asarray(mr))
    np.testing.assert_allclose(_np(y), _np(yp), atol=IACT_ATOL)
    np.testing.assert_allclose(_np(y), _np(yr), atol=IACT_ATOL)
    if thr > 1e-6:
        assert mask.any()  # some blocks must hit
    else:
        assert not mask.any()


def test_iact_rejects_bad_geometry():
    with pytest.raises(ValueError):
        ops.iact_rowfn(torch.zeros(60, 8), torch.zeros(8, 16),
                       torch.zeros(16, 8), block_rows=16)
    with pytest.raises(ValueError):
        ops.iact_rowfn(torch.zeros(64, 8), torch.zeros(4, 16),
                       torch.zeros(16, 8), block_rows=16)


# ----------------------------------------------------------------------------
# K1: perforated / flash attention
# ----------------------------------------------------------------------------

def _qkv(seed, b, hq, hkv, sq, skv, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, hq, sq, d).astype(np.float32),
            rng.randn(b, hkv, skv, d).astype(np.float32),
            rng.randn(b, hkv, skv, d).astype(np.float32))


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d", [
    (1, 2, 2, 64, 64, 32),
    (2, 4, 2, 64, 128, 32),   # GQA + decode offset
    (1, 8, 1, 32, 96, 16),    # MQA
    (1, 2, 2, 128, 128, 16),  # the app's geometry
])
def test_flash_attention_matches_pallas(b, hq, hkv, sq, skv, d):
    q, k, v = _qkv(b + hq + sq, b, hq, hkv, sq, skv, d)
    o = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), block_q=32,
                            block_kv=32)
    op = pallas_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          block_q=32, block_kv=32, interpret=True,
                          pipeline=False)
    rep = hq // hkv
    orf = jref.attention_ref(q, np.repeat(k, rep, 1), np.repeat(v, rep, 1),
                             causal=True)
    np.testing.assert_allclose(_np(o), _np(op), atol=ATTN_ATOL[torch.float32])
    np.testing.assert_allclose(_np(o), _np(orf),
                               atol=ATTN_ATOL[torch.float32])


@pytest.mark.parametrize("kind,arg", [
    ("ini", 0.5), ("fini", 0.25), ("small", 2), ("large", 2),
])
def test_structural_perforation_matches_pallas(kind, arg):
    q, k, v = _qkv(11, 1, 2, 2, 64, 128, 32)
    o = ops.perforated_attention(*map(torch.from_numpy, (q, k, v)),
                                 block_q=32, block_kv=32,
                                 perfo=_perfo(ttypes, kind, arg))
    jp = _perfo(jtypes, kind, arg)
    op = pallas_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          block_q=32, block_kv=32, perfo=jp, interpret=True,
                          pipeline=False)
    orf = jref.attention_ref(q, k, v, causal=True, block_kv=32, perfo=jp)
    np.testing.assert_allclose(_np(o), _np(op), atol=ATTN_ATOL[torch.float32])
    np.testing.assert_allclose(_np(o), _np(orf),
                               atol=ATTN_ATOL[torch.float32])


@pytest.mark.parametrize("kind,frac,hkv", [
    ("ini", 0.5, 2), ("fini", 0.25, 2), ("fini", 0.75, 1), ("random", 0.3, 2),
])
def test_masked_perforation_matches_pallas(kind, frac, hkv):
    q, k, v = _qkv(21, 1, 2, hkv, 64, 128, 32)
    tp = _perfo(ttypes, kind, 0.0)
    o = ops.perforated_attention(*map(torch.from_numpy, (q, k, v)),
                                 block_q=32, block_kv=32, perfo=tp,
                                 fraction=torch.tensor(frac))
    jp = _perfo(jtypes, kind, 0.0)
    op = pallas_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          block_q=32, block_kv=32, perfo=jp,
                          fraction=jnp.float32(frac), interpret=True,
                          pipeline=False)
    np.testing.assert_allclose(_np(o), _np(op), atol=ATTN_ATOL[torch.float32])
    # masked mode == structural mode at the same fraction
    so = ops.perforated_attention(*map(torch.from_numpy, (q, k, v)),
                                  block_q=32, block_kv=32,
                                  perfo=_perfo(ttypes, kind, frac))
    np.testing.assert_allclose(_np(o), _np(so), atol=1e-6)


def test_non_causal_matches_pallas():
    q, k, v = _qkv(12, 1, 2, 2, 32, 64, 16)
    o = ops.perforated_attention(*map(torch.from_numpy, (q, k, v)),
                                 block_q=32, block_kv=32, causal=False)
    op = pallas_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          block_q=32, block_kv=32, causal=False,
                          interpret=True, pipeline=False)
    orf = jref.attention_ref(q, k, v, causal=False)
    np.testing.assert_allclose(_np(o), _np(op), atol=ATTN_ATOL[torch.float32])
    np.testing.assert_allclose(_np(o), _np(orf),
                               atol=ATTN_ATOL[torch.float32])


def test_bf16_matches_pallas():
    rng = np.random.RandomState(13)
    q, k, v = (rng.randn(1, 2, 32, 16).astype(np.float32) for _ in range(3))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    o = ops.flash_attention(tq, tk, tv, block_q=32, block_kv=32)
    assert o.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    op = pallas_attention(jq, jk, jv, block_q=32, block_kv=32,
                          interpret=True, pipeline=False)
    orf = jref.attention_ref(jq, jk, jv, causal=True)
    np.testing.assert_allclose(_np(o), _np(op), atol=ATTN_ATOL[torch.bfloat16])
    np.testing.assert_allclose(_np(o), _np(orf),
                               atol=ATTN_ATOL[torch.bfloat16])


def test_attention_rejects_bad_arguments():
    q = torch.zeros(1, 2, 64, 16)
    with pytest.raises(ValueError):  # fraction needs a fraction kind
        ops.perforated_attention(q, q, q, block_q=32, block_kv=32,
                                 perfo=_perfo(ttypes, "small", 2),
                                 fraction=0.5)
    with pytest.raises(ValueError):  # blocks must divide the sequence
        ops.perforated_attention(q, q, q, block_q=24, block_kv=32)
    with pytest.raises(ValueError):  # every block dropped
        ops.perforated_attention(q, q, q, block_q=32, block_kv=64,
                                 perfo=_perfo(ttypes, "random", 0.99))


def test_attention_kernel_geometry_limits():
    """The CUDA kernel's limits are checked before launch (host-side)."""
    q = torch.zeros(1, 2, 128, 128)
    perforated_attention._check_kernel_geometry(q, q, q, 32, 32)
    perforated_attention._check_kernel_geometry(q, q, q, 128, 32)
    with pytest.raises(ValueError):  # at most 8 warps of 16 query rows
        perforated_attention._check_kernel_geometry(q, q, q, 256, 32)
    q3 = torch.zeros(1, 2, 64, 48)
    with pytest.raises(ValueError):  # D must be an instantiated head dim
        perforated_attention._check_kernel_geometry(q3, q3, q3, 32, 32)
    with pytest.raises(ValueError):  # KV blocks of whole 32-key chunks
        perforated_attention._check_kernel_geometry(q, q, q, 32, 16)
    # two chunk buffers of 32 K rows (D + 8) and 32 V rows (D + 4) in
    # float32, and the list of 4 KV blocks with its length
    assert perforated_attention.smem_bytes(128, 4) == 68628


# ----------------------------------------------------------------------------
# the K4 oracle (the kernel itself: tests/test_torch_perforated_matmul.py)
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("kind,arg,rescale", [
    (None, None, False), ("small", 2, False), ("ini", 0.5, True),
    ("random", 0.3, True),
])
def test_perforated_matmul_ref_matches_jax(kind, arg, rescale):
    rng = np.random.RandomState(5)
    x = rng.randn(32, 128).astype(np.float32)
    w = rng.randn(128, 48).astype(np.float32)
    tp = None if kind is None else _perfo(ttypes, kind, arg)
    jp = None if kind is None else _perfo(jtypes, kind, arg)
    got = ref.perforated_matmul_ref(torch.from_numpy(x), torch.from_numpy(w),
                                    block_k=16, perfo=tp, rescale=rescale)
    want = jref.perforated_matmul_ref(x, w, block_k=16, perfo=jp,
                                      rescale=rescale)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4)
    np.testing.assert_allclose(
        _np(ref.matmul_ref(torch.from_numpy(x), torch.from_numpy(w))),
        _np(jref.matmul_ref(x, w)), atol=1e-4)


def test_blocks_resolve_from_fallbacks():
    x = torch.from_numpy(_stableish(np.random.RandomState(2), 256, 16))
    w = torch.zeros(16, 128)
    tuning.set_default_cache(tuning.TuningCache())  # no tuned entry
    try:
        assert ops.resolve_blocks("taf_matmul", (x, w), x.dtype,
                                  block_m=None, block_n=16) == \
            {"block_m": 128, "block_n": 16}
    finally:
        tuning.set_default_cache(None)
    y, mask = ops.taf_matmul(x, w)
    assert tuple(mask.shape) == (2, 1)
