"""The port's approx_ffn slice against the JAX package, on the CPU.

The port's app runs with `device="cpu"` (its kernel wrappers then take
their plain versions); the JAX app runs on its host substrate (the
`ref.py` oracles). Both compute on identical data: the JAX app's own
arrays, carried across by `repro_torch.convert`, equal the port's. For
every spec of the 30-spec grid the QoI agrees within 1e-5 and the approx
fraction and mask are equal; the port's sweep reproduces the committed
front `benchmarks/baselines/BENCH_ffn.json`.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from repro.core import harness as jharness
from repro_torch import convert
from repro_torch.apps import approx_ffn as tffn
from repro_torch.benchmarks import approx_ffn_sweep as tsweep
from repro_torch.core import harness as tharness

REPO = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, os.path.join(REPO, "examples"))  # apps package
from apps import approx_ffn as jffn  # noqa: E402

QOI_ATOL = 1e-5
GRID = tsweep.grid()


@pytest.fixture(scope="module")
def apps():
    return (tffn.make_app(substrate="cuda", device="cpu"),
            tffn.make_app(substrate="host", device="cpu"),
            jffn.make_app(substrate="host"))


def test_convert_carries_the_jax_arrays_exactly():
    jx = jffn._arrays(128, 32, 64, 2, 0)
    got = convert.ffn_arrays(*jx, device="cpu")
    want = convert.ffn_arrays(*tffn.host_arrays(128, 32, 64, 0),
                              device="cpu")
    for g, w, j in zip(got, want, jx):
        assert g.dtype == torch.float32 and g.device.type == "cpu"
        assert torch.equal(g, w)
        assert np.array_equal(g.numpy(), np.asarray(j))


@pytest.mark.parametrize("idx", range(len(GRID)),
                         ids=[tharness.spec_key(s) for s in GRID])
def test_spec_matches_jax_host(apps, idx):
    port, port_host, jax_host = apps
    spec = GRID[idx]
    want = jax_host.run(jharness.spec_from_dict(tharness.spec_to_dict(spec)))
    for app in (port, port_host):
        got = app.run(spec)
        np.testing.assert_allclose(got.qoi, np.asarray(want.qoi),
                                   atol=QOI_ATOL)
        assert got.approx_fraction == want.approx_fraction
        assert got.extra["approx_mask"] == want.extra["approx_mask"]
        assert got.flop_fraction == want.flop_fraction


def test_exact_matches_jax(apps):
    port, _, jax_host = apps
    np.testing.assert_allclose(port.exact().qoi,
                               np.asarray(jax_host.exact().qoi),
                               atol=QOI_ATOL)


def test_workload_fingerprint_names_the_substrate(apps):
    port, port_host, jax_host = apps
    assert port.workload["substrate"] == "cuda"
    # the host rows of the two packages share DB cache keys
    assert port_host.workload_hash == jax_host.workload_hash


def test_sweep_reproduces_committed_front():
    with open(os.path.join(REPO, "benchmarks", "baselines",
                           "BENCH_ffn.json")) as f:
        baseline = json.load(f)
    summary = tsweep.main(report=lambda *a: None, device="cpu")
    assert tsweep.check_front(summary, baseline) == []


def test_batched_sweep_equals_serial():
    app = tffn.make_app(substrate="cuda", device="cpu")
    specs = GRID[:8] + GRID[-6:]
    serial = tharness.sweep(app, specs, repeats=1)
    batched = tharness.sweep(app, specs, repeats=1, jobs=4)
    for s, b in zip(serial, batched):
        assert s.spec_hash == b.spec_hash
        assert s.error == pytest.approx(b.error, abs=1e-9)
        assert s.approx_fraction == b.approx_fraction
        assert list(s.extra["approx_mask"]) == list(b.extra["approx_mask"])


def test_blocks_join_the_fingerprint():
    default = tffn.make_app(device="cpu")
    same = tffn.make_app(device="cpu", blocks=(16, 16, 32))
    other = tffn.make_app(device="cpu", blocks=(32, 16, 32))
    assert default.workload == same.workload
    assert other.workload["blocks"] == [32, 16, 32]
    with pytest.raises(ValueError):
        tffn.make_app(device="cpu", blocks=(48, 16, 32))
