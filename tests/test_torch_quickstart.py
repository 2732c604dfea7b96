"""The port's quickstart (`repro_torch.quickstart`) against the JAX
package's `examples/quickstart.py`, on the CPU.

Sections 1-3 (pragma, `ApproxRegion.run`, `perforated_loop`, the TAF sweep)
are recomputed here with the JAX package's functions, as the JAX script
runs them, and must give the same values: approx fractions and the
perforated sum equal, the best spec equal, modeled speedups within 1e-12
relative, errors (MAPE) within 1e-6 -- float32 outputs of order 1 in two
libraries' rounding, averaged over 6400 outputs. The JAX script's printed
lines of sections 1-3 must equal the port's. The JAX script's section 4
calls the Pallas kernel with `pipeline=True`, which jax 0.9's Pallas TPU
module cannot build (it has no `TPUCompilerParams`), so section 4 is held
against the JAX oracle `repro.kernels.ref.taf_matmul_ref` and the Pallas
kernel with `pipeline=False` in interpret mode: y within atol 1e-4 (the
script's own tolerance) and the mask equal.
"""
import contextlib
import io
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import (ApproxRegion as JRegion, ApproxSpec as JSpec,
                        Level as JLevel, PerforationKind as JKind,
                        PerforationParams as JPerfo, Technique as JTech,
                        parse_pragma as jparse, perforated_loop as jloop)
from repro.core import harness as jharness
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import quickstart

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
import quickstart as jquickstart  # noqa: E402

MAPE_ATOL = 1e-6


def jfoo(x):
    return jnp.sum(jnp.sin(x) * jnp.cos(x) ** 2, axis=-1)


def jax_sections():
    """Sections 1-3 of `examples/quickstart.py` at full precision."""
    out = {}
    spec = jparse("memo(out:3:8:0.5) level(thread)")
    xs = jnp.asarray(np.random.RandomState(0).standard_normal((100, 64, 4))
                     * 0.01) + 1.0
    ys, frac = JRegion(spec, jfoo, n_elements=64, in_dim=4).run(xs)
    exact = jax.lax.map(jfoo, xs)
    out["taf_fraction"] = float(frac)
    out["taf_mape"] = jharness.mape(np.asarray(exact), np.asarray(ys))
    pspec = JSpec(JTech.PERFORATION,
                  perforation=JPerfo(kind=JKind.SMALL, skip=4))
    total, kept = jloop(pspec, 32, lambda i, acc: acc + jnp.float32(i),
                        jnp.float32(0))
    out["perforated_sum"], out["perforated_kept"] = float(total), kept

    def run(s):
        ys_, frac_ = jax.jit(JRegion(s, jfoo, n_elements=64, in_dim=4).run)(
            xs)
        return jharness.AppResult(qoi=np.asarray(ys_), wall_time_s=1.0,
                                  approx_fraction=float(frac_),
                                  flop_fraction=max(1 - float(frac_), 1e-3))

    records = jharness.sweep(
        jharness.ApproxApp("quickstart", run),
        jharness.taf_grid(h_sizes=(2, 3), p_sizes=(8, 64),
                          thresholds=(0.1, 1.0), levels=(JLevel.ELEMENT,)),
        repeats=1)
    best = max((r for r in records if r.error < 0.1),
               key=lambda r: r.modeled_speedup)
    out["best"] = dict(spec=best.spec, modeled_speedup=best.modeled_speedup,
                       error=best.error)
    return out


@pytest.fixture(scope="module")
def port():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = quickstart.main(device="cpu")
    return out, buf.getvalue().splitlines()


def test_sections_1_to_3_match_jax(port):
    got, _ = port
    want = jax_sections()
    assert got["taf_fraction"] == want["taf_fraction"]
    assert abs(got["taf_mape"] - want["taf_mape"]) <= MAPE_ATOL
    assert got["perforated_sum"] == want["perforated_sum"] == 360.0
    assert got["perforated_kept"] == want["perforated_kept"] == 0.75
    assert got["best"]["spec"] == want["best"]["spec"]
    assert got["best"]["modeled_speedup"] == pytest.approx(
        want["best"]["modeled_speedup"], rel=1e-12)
    assert abs(got["best"]["error"] - want["best"]["error"]) <= MAPE_ATOL


def test_printed_lines_match_the_jax_script(port):
    _, lines = port
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            jquickstart.main()
        except Exception:  # section 4's Pallas build (reference drift)
            pass
    jlines = buf.getvalue().splitlines()
    assert len(jlines) >= 4
    assert lines[:4] == jlines[:4]
    assert lines[1] == "TAF: approximated 87% of invocations, MAPE 1.2295%"


def test_section_4_matches_the_jax_oracle_and_kernel(port):
    got, lines = port
    x = np.random.RandomState(1).standard_normal((256, 128)).astype(
        np.float32) * 0.01 + 1.0
    w = np.random.RandomState(2).standard_normal((128, 128)).astype(
        np.float32)
    from repro_torch import convert
    from repro_torch.kernels import ops
    y, mask = ops.taf_matmul(convert.to_tensor(x, "cpu"),
                             convert.to_tensor(w, "cpu"), block_m=64,
                             block_n=64, rsd_threshold=1.0)
    y_ref, mask_ref = jref.taf_matmul_ref(
        jnp.asarray(x), jnp.asarray(w), block_m=64, block_n=64,
        history_size=3, prediction_size=8, rsd_threshold=1.0)
    y_pal, mask_pal = jops.taf_matmul(
        jnp.asarray(x), jnp.asarray(w), block_m=64, block_n=64,
        rsd_threshold=1.0, interpret=True, pipeline=False)
    for yy, mm in ((y_ref, mask_ref), (y_pal, mask_pal)):
        np.testing.assert_allclose(y.numpy(), np.asarray(yy), rtol=0,
                                   atol=1e-4)
        assert np.array_equal(mask.numpy(), np.asarray(mm))
    assert got["k2_matches"]
    assert got["k2_approx_blocks"] == float(np.asarray(mask_ref).mean())
    assert lines[4].startswith("taf_matmul kernel == oracle: True; "
                               "blocks approximated: 25%")
