"""The port's collectives on several gloo ranks of the CPU (the cases of
`tests/test_distributed.py`): the GPipe pipeline against serial layer
application, the int8-compressed all-reduce against the exact mean, and
`runtime.sharding.place` round-tripping the qwen3 smoke params.

`run_ranks` runs a snippet on several ranks, each in its own process:
every rank runs `PREAMBLE + code` with RANK / WORLD / INIT in its
environment; the preamble starts the default process group (gloo, a
`file://` rendezvous under the test's tmp_path, so concurrent test workers
never share a port), and the snippet ends by calling `emit(obj)`, which
prints one JSON line. The other multi-rank test files import it.
"""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PREAMBLE = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK, WORLD = int(os.environ["RANK"]), int(os.environ["WORLD"])
dist.init_process_group("gloo", init_method=os.environ["INIT"], rank=RANK,
                        world_size=WORLD)

def emit(obj):
    print("RESULT " + json.dumps(obj), flush=True)
"""


def run_ranks(code: str, world: int, tmp_path, timeout: float = 120.0):
    """Every rank's emitted object, in rank order; a rank that fails or
    outlasts `timeout` seconds fails the test (all ranks are killed)."""
    init = f"file://{os.path.join(str(tmp_path), 'rendezvous')}"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               WORLD=str(world), INIT=init, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", PREAMBLE + code],
                              env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"rank failed:\n{err[-3000:]}"
            lines = [l for l in out.splitlines() if l.startswith("RESULT ")]
            assert lines, f"rank emitted nothing:\n{out[-2000:]}"
            outs.append(json.loads(lines[-1][len("RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


_COLLECTIVES = r"""
from repro_torch.runtime import elastic, sharding
from repro_torch.runtime.pipeline import pipeline_apply
from repro_torch.optim import compress
out = {}

# GPipe over 4 stages (tests/test_distributed.py's case)
mesh = elastic.make_mesh((4,), ("stage",), device="cpu")
rng = np.random.RandomState(0)
n_stages, d = 4, 16
ws = torch.tensor(rng.standard_normal((n_stages, d, d)) * 0.3,
                  dtype=torch.float32)
x = torch.tensor(rng.standard_normal((8, d)), dtype=torch.float32)

def layer(w, h):
    return torch.tanh(h @ w)

serial = x
for i in range(n_stages):
    serial = layer(ws[i], serial)
piped = pipeline_apply(layer, ws, x, mesh, axis="stage", n_microbatches=4)
out["pipeline_err"] = float((piped - serial).abs().max())

# int8-compressed data-parallel mean: rank r holds row r
g_global = torch.tensor(np.random.RandomState(0).standard_normal((4, 128)),
                        dtype=torch.float32)
mean = compress.compressed_allreduce(g_global[RANK])
out["allreduce_err"] = float((mean - g_global.mean(dim=0)).abs().max())

# the qwen3 smoke params placed on a (2, 2) mesh and gathered back
from repro_torch.configs import get_smoke_config
from repro_torch.models import build
cfg = get_smoke_config("qwen3-1.7b")
params = build(cfg, device="cpu").init(torch.Generator().manual_seed(0))
mesh2 = elastic.make_mesh((2, 2), ("data", "model"), device="cpu")
specs = sharding.param_specs(mesh2, params)
placed = sharding.place(params, mesh2, specs)
errs, sharded = [], 0

def walk(a, b, s):
    global sharded
    if isinstance(a, dict):
        for k in a:
            walk(a[k], b[k], s[k])
    elif isinstance(a, list):
        for u, v, t in zip(a, b, s):
            walk(u, v, t)
    else:
        full = b.full_tensor()
        errs.append(bool(torch.equal(full, a)) and full.dtype == a.dtype)
        sharded += any(e is not None for e in s)

walk(params, placed, specs)
out["place_equal"] = all(errs)
out["place_leaves"] = len(errs)
out["place_sharded"] = sharded
emit(out)
"""


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    return run_ranks(_COLLECTIVES, 4, tmp_path_factory.mktemp("coll"))


def test_pipeline_parallel_matches_serial(collectives):
    """GPipe over 4 gloo ranks == serial layer application (1e-5)."""
    for r in collectives:
        assert r["pipeline_err"] < 1e-5, r


def test_compressed_gradient_allreduce(collectives):
    """The dequantized mean over 4 ranks is within 0.05 of the exact
    mean, and every rank holds the same result."""
    errs = [r["allreduce_err"] for r in collectives]
    assert max(errs) < 0.05 and len(set(errs)) == 1, errs


def test_place_round_trips_the_smoke_params(collectives):
    """`place` of the qwen3 smoke params on a (2, 2) mesh: every leaf's
    `full_tensor()` equals the original, and the rules shard some."""
    for r in collectives:
        assert r["place_equal"] and r["place_sharded"] > 0, r
