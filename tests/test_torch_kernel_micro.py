"""The port's kernel_micro on the CPU at the `ref` geometry (the JAX
module's own shapes), against the JAX package.

Its structural fields must equal those computed from the JAX package's
`drop_fraction` and its `ref.py` oracles on the same numpy inputs. The JAX
`kernel_micro.main` itself is not run: its pipelined kernels raise on this
jax version. On the CPU every wrapper takes its plain version, so the times
are host times and no kernel launches.
"""
import json
import os
import sys

import numpy as np
import pytest

from repro.core import perforation as jperf
from repro.core import types as jtypes
from repro.kernels import ref as jref
from repro.kernels import tuning as jtuning
from repro_torch.benchmarks import kernel_micro
from repro_torch.core import perforation as tperf
from repro_torch.core import types as ttypes
from repro_torch.kernels import tuning

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from benchmarks import kernel_micro as jax_micro  # noqa: E402

# the keys `benchmarks/run.py` gates in BENCH_kernel.json
GATED = ("metric", "substrate", "oracle_match.taf", "oracle_match.iact",
         "sweep.n", "sweep.recompiles", "pipeline_parity.taf_matmul",
         "pipeline_parity.perforated_matmul",
         "pipeline_parity.perforated_attention", "tuning.all_beat_default",
         "executed_grid_fraction.taf", "executed_grid_fraction.iact",
         "tuning.taf_matmul.speedup", "tuning.iact_rowfn.speedup",
         "tuning.perforated_matmul.speedup",
         "tuning.perforated_attention.speedup")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("kernel_micro"))
    rows = []
    bench = kernel_micro.main(lambda *r: rows.append(r), out,
                              geometry="ref", device="cpu")
    return bench, rows, out


def _jax_fields():
    """executed_grid_fraction of the memoizing rows, from the JAX oracles
    on the inputs the JAX kernel_micro makes."""
    rng = np.random.RandomState(0)
    x = np.tile(rng.randn(1, 256), (256, 1)).astype(np.float32)
    w = rng.randn(256, 256).astype(np.float32)
    _, mask = jref.taf_matmul_ref(x, w, block_m=64, block_n=64,
                                  history_size=3, prediction_size=8,
                                  rsd_threshold=0.5)
    x2 = np.repeat(rng.randn(4, 64), 64, 0).astype(np.float32)
    w1 = rng.randn(64, 128).astype(np.float32) * 0.1
    w2 = rng.randn(128, 32).astype(np.float32) * 0.1
    _, m2 = jref.iact_rowfn_ref(x2, w1, w2, block_rows=32, table_size=4,
                                threshold=0.5)
    return (1.0 - float(np.asarray(mask).mean()),
            1.0 - float(np.asarray(m2).mean()))


def test_structural_fields_equal_the_jax_ones(run):
    bench, _, _ = run
    taf, iact = _jax_fields()
    assert bench["executed_grid_fraction"] == {"taf": taf, "iact": iact}
    assert bench["oracle_match"] == {"taf": True, "iact": True}


def test_perforation_rows_equal_jax_drop_fraction(run):
    _, _, out = run
    rows = json.load(open(os.path.join(out, "kernel_micro.json")))
    pmm = [r for r in rows if r["name"] == "kernel_perforated_matmul"]
    assert [r["skip"] for r in pmm] == [2, 4, 8]
    for r in pmm:
        p = jtypes.PerforationParams(kind=jtypes.PerforationKind.SMALL,
                                     skip=r["skip"])
        assert r["executed_grid_fraction"] == \
            1.0 - jperf.drop_fraction(256 // 64, p)
        assert r["flops_total"] == 2.0 * 256 ** 3
    attn = [r for r in rows if r["name"] == "kernel_perforated_attention"]
    assert [(r["ini_drop"], r["executed_grid_fraction"]) for r in attn] == \
        [(0.0, 1.0), (0.5, 0.5)]


@pytest.mark.parametrize("kind,arg", [("small", 2), ("large", 4),
                                      ("ini", 0.3), ("fini", 0.75),
                                      ("random", 0.5)])
@pytest.mark.parametrize("n", [4, 7, 48])
def test_drop_fraction_matches_jax(kind, arg, n):
    def params(mod):
        k = mod.PerforationKind(kind)
        return (mod.PerforationParams(kind=k, skip=arg)
                if kind in ("small", "large") else
                mod.PerforationParams(kind=k, fraction=arg))
    assert tperf.drop_fraction(n, params(ttypes)) == \
        jperf.drop_fraction(n, params(jtypes))


def test_parity_sweep_and_tuning(run):
    bench, _, _ = run
    assert bench["pipeline_parity"] == {"taf_matmul": True,
                                        "perforated_matmul": True,
                                        "perforated_attention": True}
    assert bench["sweep"] == {"n": 16, "recompiles": 0}
    assert (bench["substrate"], bench["machine"]) == ("host", "host-sim")
    arrays = jax_micro._tuning_arrays()
    for kernel in tuning.KERNELS:
        t = bench["tuning"][kernel]
        assert t["default"] == jax_micro._TUNE_DEFAULTS[kernel]
        shapes = tuning.key_shapes(kernel,
                                   tuning.operand_shapes(arrays[kernel]))
        assert t["shapes"] == [list(s) for s in shapes]
        assert t["candidates"] == len(tuning.search_space(kernel, shapes))
        # the cost model's top 4, and the default where it is not among them
        assert min(4, t["candidates"]) <= t["measured"] <= \
            min(4, t["candidates"]) + 1
        assert tuning.validate_config(kernel, shapes, t["tuned"]) is None
        assert t["tuned_launches"] == 0  # plain
        # one pass times both, so the tuned config never loses
        assert t["speedup"] >= 1.0 and t["default_us"] >= t["tuned_us"]
        assert t["tuned"] != t["default"] or t["speedup"] == 1.0
    assert isinstance(bench["tuning"]["all_beat_default"], bool)


def test_artifacts_carry_the_gated_keys(run):
    _, rows, out = run
    doc = json.load(open(os.path.join(out, "BENCH_kernel.json")))
    for dotted in GATED:
        node = doc
        for part in dotted.split("."):
            node = node[part]
    assert doc["metric"] == "kernel_micro"
    cache = json.load(open(os.path.join(out, "tuning_cache.json")))
    assert len(cache["entries"]) == 4
    for key, entry in cache["entries"].items():
        assert jtuning.validate_entry(key, entry) is None
    names = [r[0] for r in rows]
    assert names[:2] == ["kernel_taf_matmul", "kernel_iact_rowfn"]
    assert "kernel_tuning_all_beat_default" in names
