"""The precision of 3xTF32, the arithmetic of the port's K1 and K4 kernels,
against the JAX package's float32 oracles.

The CUDA kernels run only on the card; here their arithmetic is emulated in
plain torch on the CPU, on the same numpy inputs as the JAX oracle:

  * TF32 rounding as `cvt.rna.tf32.f32` does it: add 0x1000 to the float32
    bits and clear the 13 low mantissa bits;
  * the split v = hi + lo of `csrc/mma_tf32.cuh`: hi = tf32_rna(v), lo =
    v - hi (exact), of which the tensor core reads the TF32 part (emulated
    here by truncation, the least accurate reading);
  * a product as hi_a hi_b + hi_a lo_b + lo_a hi_b (TF32 products are
    exact in float32), summed in float32 one 32-deep chunk at a time, the
    chunks added in float32, as the kernels do.

Tolerances are the kernels' own: K4 atol 1e-3 at 256^3 and 1e-2 at its
full-width contraction length (sums of 3072 products of order 1, values of
order 80), K1 atol 1e-4 in float32. Single-pass TF32 fails the full-width
K4 tolerance, which is why the kernels take three products. The emulation
is not a plain version of any kernel and is on no path of the port.
"""
import numpy as np
import pytest
import torch

from repro.core import types as jtypes
from repro.kernels import ref as jref
from repro_torch.core import perforation
from repro_torch.core import types as ttypes

CHUNK = 32  # k of one tensor-core sum in both kernels


def tf32_rna(t: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32, round to nearest with ties away from zero."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(t: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 toward zero (the 13 low mantissa bits cleared)."""
    return (t.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(t: torch.Tensor):
    hi = tf32_rna(t)
    return hi, tf32_trunc(t - hi)


def mm3(a: torch.Tensor, b: torch.Tensor, chunk: int = CHUNK
        ) -> torch.Tensor:
    """a @ b in 3xTF32, one float32 sum per `chunk` of the contraction."""
    out = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], chunk):
        a_hi, a_lo = split(a[..., k0:k0 + chunk])
        b_hi, b_lo = split(b[..., k0:k0 + chunk, :])
        out = out + (a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi)
    return out


def mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in single-pass TF32, summed as mm3 sums."""
    out = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], CHUNK):
        out = out + tf32_rna(a[..., k0:k0 + CHUNK]) @ \
            tf32_rna(b[..., k0:k0 + CHUNK, :])
    return out


def perforated_matmul(x, w, block_k, perfo, product):
    """K4's sum over the kept K blocks, each block's chunks in order."""
    nk = x.shape[1] // block_k
    kept = np.arange(nk) if perfo is None else \
        perforation.kept_indices(nk, perfo)
    cols = (kept[:, None] * block_k + np.arange(block_k)).ravel()
    idx = torch.as_tensor(cols)
    return product(x[:, idx], w[idx])


def _operands(seed, m, k, n):
    rng = np.random.RandomState(seed)
    return (rng.randn(m, k).astype(np.float32),
            rng.randn(k, n).astype(np.float32))


def test_rna_rounds_half_away_from_zero():
    one = 1.0
    ulp = 2.0 ** -10  # TF32 keeps 10 explicit mantissa bits
    t = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                      one + 3 * ulp / 4, 3.0], dtype=torch.float32)
    got = tf32_rna(t)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + ulp, 3.0])
    assert torch.equal(got, want)
    assert not bool((got.view(torch.int32) & 0x1FFF).any())


def test_split_residual_is_small_and_exact():
    rng = np.random.RandomState(0)
    v = torch.from_numpy((rng.randn(4096) * 10.0 ** rng.randint(
        -3, 4, 4096)).astype(np.float32))
    hi = tf32_rna(v)
    lo = v - hi
    assert torch.equal(hi + lo, v)  # the residual is exact in float32
    assert bool((lo.abs() <= 2.0 ** -11 * v.abs()).all())


@pytest.mark.parametrize("m,k,n,block_k,skip,atol", [
    (256, 256, 256, 64, None, 1e-3),   # the JAX test's size
    (256, 6144, 256, 128, 2, 1e-2),    # K4's full-width contraction
])
def test_3xtf32_meets_k4_tolerance(m, k, n, block_k, skip, atol):
    x, w = _operands(1, m, k, n)
    jp = tp = None
    if skip:
        jp = jtypes.PerforationParams(kind=jtypes.PerforationKind.SMALL,
                                      skip=skip)
        tp = ttypes.PerforationParams(kind=ttypes.PerforationKind.SMALL,
                                      skip=skip)
    want = np.asarray(jref.perforated_matmul_ref(x, w, block_k=block_k,
                                                 perfo=jp))
    got = perforated_matmul(torch.from_numpy(x), torch.from_numpy(w),
                            block_k, tp, mm3).numpy()
    assert np.abs(got - want).max() <= atol


def test_single_pass_tf32_fails_full_width_k4():
    x, w = _operands(1, 256, 6144, 256)
    small2 = ttypes.PerforationParams(kind=ttypes.PerforationKind.SMALL,
                                      skip=2)
    want = np.asarray(jref.perforated_matmul_ref(
        x, w, block_k=128, perfo=jtypes.PerforationParams(
            kind=jtypes.PerforationKind.SMALL, skip=2)))
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    one = np.abs(perforated_matmul(tx, tw, 128, small2, mm1).numpy()
                 - want).max()
    three = np.abs(perforated_matmul(tx, tw, 128, small2, mm3).numpy()
                   - want).max()
    assert one > 1e-2  # single-pass TF32 breaks K4's full-width tolerance
    assert three <= 1e-2 and three * 10 < one


def attention_3xtf32(q, k, v, scale):
    """Causal attention (queries at the end of the timeline) with both
    products in 3xTF32 and the softmax in float32, as K1 computes it: a
    score in one sum over D, P V in one sum per chunk of 32 keys."""
    s = mm3(q, k.transpose(-1, -2), chunk=q.shape[-1]) * scale
    sq, skv = q.shape[-2], k.shape[-2]
    qi = torch.arange(sq)[:, None] + (skv - sq)
    mask = torch.arange(skv)[None, :] <= qi
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return mm3(p, v) / p.sum(-1, keepdim=True)


@pytest.mark.parametrize("d", [16, 128])
def test_3xtf32_attention_meets_k1_tolerance(d):
    rng = np.random.RandomState(2)
    q, k, v = (rng.randn(1, 2, 256, d).astype(np.float32) for _ in range(3))
    want = np.asarray(jref.attention_ref(q, k, v, causal=True))
    got = attention_3xtf32(*(torch.from_numpy(a) for a in (q, k, v)),
                           scale=1.0 / np.sqrt(d)).numpy()
    assert np.abs(got - want).max() <= 1e-4
