"""The port's block-shape autotuner, cost count and machine profiles
against the JAX package (`repro.kernels.tuning`, `repro.analysis`).

The JAX side runs with `pipeline=False` only: its pipelined variants raise
on this jax version. Cost counts agree with the JAX `trace_cost` within
10% on every candidate at the kernel_micro shapes.
"""
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from repro.analysis import machine as jmachine
from repro.analysis.cost import trace_cost
from repro.kernels import tuning as jtuning
from repro_torch.analysis import cost, machine
from repro_torch.apps import approx_ffn
from repro_torch.kernels import ops, tuning

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from benchmarks import kernel_micro as jax_micro  # noqa: E402

COST_RTOL = 0.10
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _isolated_cache():
    """No test reads or writes the committed cache: pin an empty in-memory
    ambient cache and restore lazy loading afterwards."""
    tuning.set_default_cache(tuning.TuningCache())
    yield
    tuning.set_default_cache(None)


def _micro_arrays():
    """kernel -> (JAX arrays, port tensors) at the JAX kernel_micro
    shapes, the same numbers on both sides."""
    out = {}
    for k, arrs in jax_micro._tuning_arrays().items():
        out[k] = (arrs, tuple(torch.from_numpy(np.array(a))
                              for a in arrs))
    return out


MICRO = _micro_arrays()


def _arrays(kernel, seed=0):
    rng = np.random.RandomState(seed)

    def f32(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    if kernel == "taf_matmul":
        return (f32(128, 32), f32(32, 32))
    if kernel == "iact_rowfn":
        return (f32(128, 32), f32(32, 64), f32(64, 32))
    if kernel == "perforated_matmul":
        return (f32(64, 64), f32(64, 64))
    if kernel == "perforated_attention":
        q = f32(1, 2, 128, 16)
        return (q, q, q)
    raise ValueError(kernel)


# --------------------------------------------------------------------------
# the same strings and numbers as the JAX tuner
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kernel,shapes,config", [
    ("taf_matmul", ((128, 32), (32, 32)), {"block_m": 48, "block_n": 32}),
    ("taf_matmul", ((128, 32), (32, 32)), {"block_m": 32}),
    ("taf_matmul", ((128, 32), (32, 32)),
     {"block_m": 32, "block_n": 32, "block_k": 32}),
    ("taf_matmul", ((128, 32), (32, 32)), {"block_m": 0, "block_n": 32}),
    ("nope", ((128, 32),), {}),
    ("iact_rowfn", ((96, 32), (32, 64), (64, 32)), {"block_rows": 32}),
    ("perforated_matmul", ((256, 256), (256, 256)),
     {"block_m": 64, "block_n": 64, "block_k": 96}),
    ("perforated_attention", ((1, 2, 128, 16),), {"block_q": 32,
                                                  "block_kv": 32}),
])
def test_validate_config_matches_jax(kernel, shapes, config):
    assert tuning.validate_config(kernel, shapes, config) == \
        jtuning.validate_config(kernel, shapes, config)


@pytest.mark.parametrize("kernel", tuning.KERNELS)
def test_keys_and_grid_match_jax(kernel):
    jarrs, tarrs = MICRO[kernel]
    shapes = tuning.operand_shapes(tarrs)
    assert shapes == jtuning.operand_shapes(jarrs)
    assert tuning.key_shapes(kernel, shapes) == \
        jtuning.key_shapes(kernel, shapes)
    assert tuning.cache_key(kernel, tuning.key_shapes(kernel, shapes),
                            "float32", "h100", "cuda") == \
        jtuning.cache_key(kernel, jtuning.key_shapes(kernel, shapes),
                          "float32", "h100", "cuda")
    for cfg in tuning.search_space(kernel, shapes):
        assert tuning.grid_steps(kernel, shapes, cfg) == \
            jtuning.grid_steps(kernel, shapes, cfg)
    assert tuning.FALLBACK_BLOCKS == jtuning.FALLBACK_BLOCKS
    assert tuning.KERNELS == jtuning.KERNELS


@pytest.mark.parametrize("kernel", tuning.KERNELS)
def test_search_space_is_jax_filtered_by_launchable(kernel):
    _, tarrs = MICRO[kernel]
    shapes = tuning.key_shapes(kernel, tuning.operand_shapes(tarrs))
    want = [c for c in jtuning.search_space(kernel, shapes)
            if tuning.launchable(kernel, shapes, c) is None]
    assert tuning.search_space(kernel, shapes) == want
    assert want


def test_launchable_rules_bound_the_space_at_full_width():
    q = (1, 16, 4096, 128)
    space = tuning.search_space("perforated_attention", (q, q))
    assert space and all(c["block_kv"] % 32 == 0 and c["block_q"] <= 128
                         for c in space)
    pmm = tuning.search_space("perforated_matmul",
                              ((4096, 6144), (6144, 2048)))
    # block_m, block_n in 32..128; block_k whole 32-deep chunks, 32..512
    assert len(pmm) == 3 * 3 * 5
    # the JAX VMEM budget would empty K3's space here (w1 + w2 = 100.7 MB);
    # the port's bound is the kernel's own: the schedule's keys and
    # distances fit one CTA at every block_rows from 8 to 512
    ffn = ((4096, 2048), (2048, 6144), (6144, 2048))
    assert jtuning.search_space("iact_rowfn", ffn) == []
    assert len(tuning.search_space("iact_rowfn", ffn)) == 7
    # K2: every divisor-valid (block_m, block_n) down to 8 launches
    taf = tuning.search_space("taf_matmul", ((4096, 2048), (2048, 2048)))
    assert len(taf) == 7 * 7


@pytest.mark.parametrize("kernel", tuning.KERNELS)
def test_kernel_cost_within_10pct_of_trace_cost(kernel):
    jarrs, tarrs = MICRO[kernel]
    shapes = tuning.operand_shapes(tarrs)
    for cfg in tuning.search_space(kernel, tuning.key_shapes(kernel,
                                                             shapes)):
        want = trace_cost(jtuning.build_call(kernel, cfg, pipeline=False),
                          *jarrs)
        got = cost.kernel_cost(kernel, shapes, cfg)
        assert abs(got.flops - want.flops) <= COST_RTOL * want.flops, cfg
        assert abs(got.bytes - want.bytes) <= COST_RTOL * want.bytes, cfg


def test_launches_are_the_invocation_term():
    shapes = ((4096, 2048), (2048, 2048))
    # one persistent launch for K2 and four for K3, at any block shape
    for bm in (16, 512):
        assert tuning.launches("taf_matmul", shapes,
                               {"block_m": bm, "block_n": 2048}) == 1
    for rows in (16, 512):
        assert tuning.launches("iact_rowfn", ((4096, 2048), (2048, 6144),
                                              (6144, 2048)),
                               {"block_rows": rows}) == 4
    assert tuning.launches("perforated_matmul", shapes,
                           {"block_m": 16, "block_n": 16,
                            "block_k": 16}) == 1
    x, w = _arrays("taf_matmul")
    mp = machine.get_machine("host")
    c = cost.kernel_cost("taf_matmul", tuning.operand_shapes((x, w)),
                         {"block_m": 16, "block_n": 32})
    assert tuning.predict_time_s("taf_matmul", (x, w),
                                 {"block_m": 16, "block_n": 32}) == \
        mp.time_s(c.flops, c.bytes, invocations=1.0)


def test_machine_profiles():
    assert machine.SUBSTRATE_MACHINES == {"cuda": "h100",
                                          "host": "host-sim"}
    h100 = machine.get_machine("cuda")
    assert (h100.peak_flops, h100.hbm_bw) == (67e12, 3.35e12)
    assert h100.dispatch_s > 0
    assert dataclasses.astuple(machine.get_machine("host")) == \
        dataclasses.astuple(jmachine.get_machine("host"))
    assert machine.get_machine(None) is h100
    with pytest.raises(KeyError):
        machine.get_machine("tpu-v5e")
    assert tuning.current_machine_name("cpu") == "host-sim"
    assert tuning.current_substrate("cpu") == "host"


def test_measure_machine_on_the_cpu_registers_a_process_profile():
    prof = machine.measure_machine("measured-test", device="cpu", size=64,
                                   copy_mb=1, repeats=1)
    try:
        assert prof.peak_flops >= 1e9 and prof.dispatch_s >= 1e-7
        assert prof.ici_bw == machine.get_machine("host").ici_bw
        assert machine.get_machine("measured-test") is prof
    finally:
        machine.MACHINES.pop("measured-test")


# --------------------------------------------------------------------------
# the autotuner and its cache
# --------------------------------------------------------------------------

def test_port_cache_passes_jax_validate_entry(tmp_path):
    path = str(tmp_path / "cache.json")
    cache = tuning.TuningCache(path=path)
    for kernel in tuning.KERNELS:
        tuning.autotune(kernel, *_arrays(kernel), cache=cache,
                        measure=False)
    doc = json.load(open(path))
    assert doc["version"] == 1 and len(doc["entries"]) == 4
    for key, entry in doc["entries"].items():
        assert jtuning.validate_entry(key, entry) is None
        assert tuning.validate_entry(key, entry) is None
        assert (entry["machine"], entry["substrate"], entry["dtype"]) == \
            ("host-sim", "host", "float32")
    assert tuning.TuningCache.load(path).entries == cache.entries


def test_deterministic_winner_and_hit_skips_measurement():
    x, w = _arrays("taf_matmul")
    calls = []

    def fake_timer(fn, args):
        calls.append(1)
        return 1.0 / float(fn(*args).numel() or 1)

    c1, c2 = tuning.TuningCache(), tuning.TuningCache()
    cfg1 = tuning.autotune("taf_matmul", x, w, cache=c1,
                           measure_fn=fake_timer)
    n_after_first = len(calls)
    cfg2 = tuning.autotune("taf_matmul", x, w, cache=c2,
                           measure_fn=fake_timer)
    assert cfg1 == cfg2
    cfg3 = tuning.autotune("taf_matmul", x, w, cache=c1,
                           measure_fn=fake_timer)
    assert cfg3 == cfg1
    assert len(calls) == 2 * n_after_first


def test_measured_winner_is_one_of_the_measured():
    x, w = _arrays("perforated_matmul")
    cache = tuning.TuningCache()
    base = {"block_m": 32, "block_n": 32, "block_k": 32}
    cfg = tuning.autotune("perforated_matmul", x, w, cache=cache,
                          max_measure=2, warmup=1, repeats=1, baseline=base)
    (entry,) = cache.entries.values()
    # the top 2 by the cost model, and the baseline (not among them)
    assert entry["measured"] == 3 and entry["config"] == cfg
    assert entry["baseline"] == base and entry["baseline_us"] >= entry["us"]
    assert entry["candidates"] == len(tuning.search_space(
        "perforated_matmul", tuning.operand_shapes((x, w))))


@pytest.mark.parametrize("baseline_wins", [True, False])
def test_baseline_is_timed_beside_the_top_candidates(baseline_wins):
    """The default is measured in the same pass as the cost model's top
    `max_measure`, and a winner never loses to it."""
    rng = np.random.RandomState(3)
    x, w = (torch.from_numpy(rng.randn(*s).astype(np.float32))
            for s in ((96, 32), (32, 32)))
    base = {"block_m": 48, "block_n": 32}  # outside the power-of-two space
    seen = []

    def timer(fn, args):
        seen.append(len(seen))
        return 1.0 if len(seen) <= 2 else (0.5 if baseline_wins else 2.0)

    cache = tuning.TuningCache()
    cfg = tuning.autotune("taf_matmul", x, w, cache=cache, max_measure=2,
                          baseline=base, measure_fn=timer)
    (entry,) = cache.entries.values()
    assert len(seen) == 3 and entry["measured"] == 3
    assert (cfg == base) == baseline_wins
    assert entry["baseline_us"] == (0.5 if baseline_wins else 2.0) * 1e6
    assert entry["predicted_us"] > 0
    with pytest.raises(ValueError, match="does not launch"):
        tuning.autotune("taf_matmul", x, w, cache=tuning.TuningCache(),
                        baseline={"block_m": 40, "block_n": 32},
                        measure_fn=timer)


def test_attention_key_uses_canonical_operands():
    q, k, v = _arrays("perforated_attention")
    cache = tuning.TuningCache()
    cfg = tuning.autotune("perforated_attention", q, k, v, cache=cache,
                          measure=False)
    assert tuning.tuned_config("perforated_attention",
                               tuning.operand_shapes((q, k)), cache=cache,
                               device="cpu") == cfg


def test_none_blocks_resolve_from_ambient_cache():
    x, w = _arrays("taf_matmul")
    cache = tuning.TuningCache()
    key = tuning.cache_key("taf_matmul", ((128, 32), (32, 32)), "float32",
                           tuning.current_machine_name(CPU),
                           tuning.current_substrate(CPU))
    cache.put(key, {"config": {"block_m": 64, "block_n": 16}})
    tuning.set_default_cache(cache)
    assert ops.resolve_blocks("taf_matmul", (x, w), x.dtype, block_m=None,
                              block_n=None) == {"block_m": 64,
                                                "block_n": 16}
    assert ops.resolve_blocks("taf_matmul", (x, w), x.dtype, block_m=32,
                              block_n=32) == {"block_m": 32, "block_n": 32}
    _, mask = ops.taf_matmul(x, w)  # the wrapper resolves the same way
    assert tuple(mask.shape) == (2, 2)
    # an entry for the card is not one for the CPU
    cache.entries = {key.replace("host-sim|host", "h100|cuda"):
                     {"config": {"block_m": 64, "block_n": 16}}}
    assert ops.resolve_blocks("taf_matmul", (x, w), x.dtype, block_m=None,
                              block_n=None) == \
        tuning.FALLBACK_BLOCKS["taf_matmul"]


def test_miss_falls_back_to_the_fallbacks():
    x = torch.zeros((256, 256))
    b = ops.resolve_blocks("perforated_matmul", (x, x), x.dtype,
                           block_m=None, block_n=None, block_k=None)
    assert b == tuning.FALLBACK_BLOCKS["perforated_matmul"]


def test_tuned_blocks_join_the_app_workload():
    """Mirror of the JAX app's `make_app(blocks="tuned")`: the resolved
    blocks go into the workload dict."""
    cache = tuning.TuningCache()
    seq, d, d_h, heads = 128, 32, 64, 2
    for kernel, shapes, cfg in (
            ("taf_matmul", ((seq, d), (d, d)),
             {"block_m": 32, "block_n": 32}),
            ("iact_rowfn", ((seq, d), (d, d_h), (d_h, d)),
             {"block_rows": 32}),
            ("perforated_attention", ((1, heads, seq, d // heads),) * 2,
             {"block_q": 64, "block_kv": 64})):
        key = tuning.cache_key(kernel, shapes, "float32", "host-sim",
                               "host")
        cache.put(key, {"config": cfg})
    tuning.set_default_cache(cache)
    assert approx_ffn.tuned_blocks(seq, d, d_h, heads,
                                   device="cpu") == (32, 32, 64)
    app = approx_ffn.make_app(substrate="host", blocks="tuned",
                              device="cpu")
    assert app.workload["blocks"] == [32, 32, 64]
    tuning.set_default_cache(tuning.TuningCache())  # every lookup misses
    assert approx_ffn.tuned_blocks(device="cpu") == (16, 16, 32)
    assert "blocks" not in approx_ffn.make_app(
        substrate="host", blocks="tuned", device="cpu").workload


def test_committed_cache_holds_h100_entries():
    """The committed cache (written on the card by `chip_smoke.py` phase
    7): every entry is valid and keys on the H100 profile and "cuda"."""
    path = tuning.COMMITTED_CACHE
    assert os.path.exists(path)
    cache = tuning.TuningCache.load(path)
    assert {e["kernel"] for e in cache.entries.values()} == \
        set(tuning.KERNELS)
    for key, entry in cache.entries.items():
        assert tuning.validate_entry(key, entry) is None
        assert (entry["machine"], entry["substrate"]) == ("h100", "cuda")
        assert tuning.launchable(entry["kernel"], entry["shapes"],
                                 entry["config"]) is None
