"""The port's K4 (herded-perforated matmul) against the JAX package.

On the CPU the wrapper takes its plain PyTorch version; it is held against
the Pallas kernel run in interpret mode with `pipeline=False` (the
pipelined variant raises on this jax version) and the JAX `ref.py` oracle,
on the same numpy inputs. Tolerance: atol 1e-3, the JAX test's
(`tests/test_kernels.py`). The CUDA kernel itself is held against its plain
version on the card in `tests/test_torch_cuda.py` and `chip_smoke.py`.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import types as jtypes
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.perforated_matmul import \
    perforated_matmul as pallas_pmm
from repro_torch.core import types as ttypes
from repro_torch.kernels import ops, perforated_matmul, ref

ATOL = 1e-3


def _perfo(mod, kind, arg=None):
    if kind is None:
        return None
    k = mod.PerforationKind(kind)
    if kind in ("small", "large"):
        return mod.PerforationParams(kind=k, skip=arg)
    return mod.PerforationParams(kind=k, fraction=0.0 if arg is None
                                 else arg)


def _operands(seed, m, k, n):
    rng = np.random.RandomState(seed)
    return (rng.randn(m, k).astype(np.float32),
            rng.randn(k, n).astype(np.float32))


def _port(x, w, **kw):
    return ops.perforated_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                 **kw).numpy()


def _pallas(x, w, perfo, **kw):
    return np.asarray(pallas_pmm(jnp.asarray(x), jnp.asarray(w),
                                 perfo=perfo, interpret=True,
                                 pipeline=False, **kw))


@pytest.mark.parametrize("kind,arg", [
    (None, None), ("small", 2), ("small", 4), ("large", 4), ("ini", 0.5),
    ("fini", 0.25), ("random", 0.3),
])
@pytest.mark.parametrize("rescale", [False, True])
def test_structural_matches_pallas_and_ref(kind, arg, rescale):
    x, w = _operands(5, 64, 256, 64)
    blocks = dict(block_m=32, block_n=32, block_k=32)
    y = _port(x, w, perfo=_perfo(ttypes, kind, arg), rescale=rescale,
              **blocks)
    jp = _perfo(jtypes, kind, arg)
    yp = _pallas(x, w, jp, rescale=rescale, **blocks)
    yr = np.asarray(jref.perforated_matmul_ref(x, w, block_k=32, perfo=jp,
                                               rescale=rescale))
    np.testing.assert_allclose(y, yp, atol=ATOL)
    np.testing.assert_allclose(y, yr, atol=ATOL)


@pytest.mark.parametrize("kind,fraction", [
    ("ini", 0.0), ("ini", 0.25), ("ini", 0.5), ("fini", 0.25),
    ("fini", 0.75), ("random", 0.5), ("random", 0.9),
])
@pytest.mark.parametrize("rescale", [False, True])
def test_masked_matches_pallas(kind, fraction, rescale):
    x, w = _operands(7, 64, 256, 64)
    blocks = dict(block_m=32, block_n=64, block_k=32)
    y = _port(x, w, perfo=_perfo(ttypes, kind), fraction=fraction,
              rescale=rescale, **blocks)
    yp = _pallas(x, w, _perfo(jtypes, kind), fraction=fraction,
                 rescale=rescale, **blocks)
    np.testing.assert_allclose(y, yp, atol=ATOL)


@pytest.mark.parametrize("kind,fr", [("ini", 0.25), ("ini", 0.5),
                                     ("fini", 0.25), ("random", 0.5)])
def test_masked_matches_structural(kind, fr):
    """Mirror of `test_kernel_substrate.py::TestMaskedMatmul`."""
    x, w = _operands(7, 64, 256, 64)
    p = _perfo(ttypes, kind, fr)
    blocks = dict(block_m=32, block_n=32, block_k=32)
    y_struct = _port(x, w, perfo=p, **blocks)
    y_masked = _port(x, w, perfo=p, fraction=fr, **blocks)
    np.testing.assert_allclose(y_masked, y_struct, atol=ATOL)


@pytest.mark.parametrize("fr", [0.0, 0.25, 0.5, 0.75])
def test_masked_rescale_matches_ref(fr):
    x, w = _operands(8, 32, 128, 32)
    y = _port(x, w, block_m=32, block_n=32, block_k=32,
              perfo=_perfo(ttypes, "ini", fr if fr else 0.1), rescale=True,
              fraction=fr)
    yr = np.asarray(jref.perforated_matmul_ref(
        x, w, block_k=32, perfo=_perfo(jtypes, "ini", fr), rescale=True))
    np.testing.assert_allclose(y, yr, rtol=1e-4, atol=ATOL)


def test_rescale_of_ones():
    x = np.ones((32, 128), np.float32)
    w = np.ones((128, 32), np.float32)
    y = _port(x, w, block_m=32, block_n=32, block_k=32,
              perfo=_perfo(ttypes, "small", 2), rescale=True)
    np.testing.assert_allclose(y, 128.0, rtol=1e-5)


@pytest.mark.parametrize("kind", ["ini", "fini", "random"])
@pytest.mark.parametrize("rescale", [False, True])
def test_masked_drop_all_gives_zeros(kind, rescale):
    """A fraction that drops every block: nk / max(0, 1) * 0, as Pallas."""
    x, w = _operands(9, 32, 128, 32)
    blocks = dict(block_m=32, block_n=32, block_k=32)
    y = _port(x, w, perfo=_perfo(ttypes, kind), fraction=1.0,
              rescale=rescale, **blocks)
    yp = _pallas(x, w, _perfo(jtypes, kind), fraction=1.0, rescale=rescale,
                 **blocks)
    assert not y.any() and not yp.any()


def test_fraction_tensor_equals_float():
    x, w = _operands(10, 32, 128, 32)
    p = _perfo(ttypes, "fini")
    kw = dict(block_m=32, block_n=32, block_k=32, perfo=p, rescale=True)
    a = _port(x, w, fraction=0.25, **kw)
    b = _port(x, w, fraction=torch.tensor(0.25), **kw)
    np.testing.assert_array_equal(a, b)


def test_dead_block_adds_nothing():
    """The plain version, like the kernel, skips a dead block outright:
    an inf in it does not become 0 * inf = nan."""
    x = torch.ones(4, 8)
    w = torch.ones(8, 4)
    x[:, 4:] = float("inf")
    kept, live, factor = ref.perforated_matmul_operands(
        2, _perfo(ttypes, "fini"), fraction=0.5)
    assert kept.tolist() == [0, 1] and live.tolist() == [1, 0]
    y = ref.perforated_matmul_plain(x, w, kept, live, factor, block_k=4)
    assert torch.equal(y, torch.full((4, 4), 4.0))


def test_operands_are_what_the_kernel_takes():
    p = _perfo(ttypes, "small", 2)
    kept, live, factor = ref.perforated_matmul_operands(8, p, rescale=True)
    assert kept.dtype == live.dtype == torch.int32
    assert kept.tolist() == [0, 2, 4, 6] and live.tolist() == [1] * 4
    assert factor.dtype == torch.float32 and factor.tolist() == [2.0]
    kept, live, factor = ref.perforated_matmul_operands(
        8, _perfo(ttypes, "ini"), fraction=torch.tensor(0.25), rescale=True)
    assert kept.tolist() == list(range(8))
    assert live.tolist() == [0, 0, 1, 1, 1, 1, 1, 1]
    assert factor.tolist() == [np.float32(8) / np.float32(6)]


def test_errors_match_jax():
    x, w = _operands(11, 64, 64, 32)
    cases = [
        (dict(w=np.zeros((32, 32), np.float32)), {}),   # contraction
        ({}, dict(block_m=48)),                          # block mismatch
        ({}, dict(block_k=24)),
    ]
    for ops_kw, block_kw in cases:
        xx = x
        ww = ops_kw.get("w", w)
        blocks = dict(dict(block_m=32, block_n=32, block_k=32), **block_kw)
        with pytest.raises(ValueError) as port_err:
            _port(xx, ww, **blocks)
        with pytest.raises(ValueError) as jax_err:
            jops.perforated_matmul(jnp.asarray(xx), jnp.asarray(ww),
                                   pipeline=False, **blocks)
        assert str(port_err.value) == str(jax_err.value)


def test_drop_all_structural_and_bad_hook_raise_as_jax():
    x, w = _operands(12, 32, 64, 32)
    blocks = dict(block_m=32, block_n=32, block_k=32)
    for kind, arg, fraction, match in (
            ("random", 0.999, None, "dropped every K block"),
            ("small", 2, 0.5, "traced hook")):
        with pytest.raises(ValueError, match=match):
            _port(x, w, perfo=_perfo(ttypes, kind, arg), fraction=fraction,
                  **blocks)
        with pytest.raises(ValueError, match=match):
            _pallas(x, w, _perfo(jtypes, kind, arg), fraction=fraction,
                    **blocks)


@pytest.mark.parametrize("block,ok", [(8, False), (16, False), (48, False),
                                      (96, False), (128, True),
                                      (512, False)])
def test_block_sides_are_cta_tiles(block, ok):
    """block_m and block_n are the CTA tile itself: 32, 64 or 128. A
    larger block would repeat the 128 launch, so it is rejected."""
    shapes = ((1024, 256), (256, 1024))
    for key in ("block_m", "block_n"):
        cfg = {"block_m": 128, "block_n": 128, "block_k": 64, key: block}
        why = perforated_matmul.launchable(shapes, cfg)
        assert (why is None) == ok
        if not ok:
            assert key in why


def test_launchable_rule():
    shapes = ((4096, 6144), (6144, 2048))
    ok = dict(block_m=128, block_n=128, block_k=128)
    assert perforated_matmul.launchable(shapes, ok) is None
    # four chunks of A (128 x (32 + 8)) and B (32 x (128 + 4)), float32,
    # and the list of 48 K blocks with its length
    assert perforated_matmul.smem_bytes(ok, 48) == \
        4 * (4 * (128 * 40 + 32 * 132) + 48 + 1)
    assert "block_m" in perforated_matmul.launchable(
        shapes, dict(ok, block_m=8))
    assert "block_n" in perforated_matmul.launchable(
        shapes, dict(ok, block_n=8))
    assert "block_k" in perforated_matmul.launchable(
        shapes, dict(ok, block_k=12))
    assert "CTA rows" in perforated_matmul.launchable(
        ((32 * 70000, 64), (64, 64)), dict(ok, block_m=32))


def test_wrapper_names_its_kernels():
    assert perforated_matmul.REPLACES == \
        "src/repro/kernels/perforated_matmul.py:66"
    assert perforated_matmul.SOURCE.endswith("csrc/perforated_matmul.cu")
    assert "perforated_matmul" in ops.KERNELS
