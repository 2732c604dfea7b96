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

import numpy as np
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


# the training half on 8 gloo ranks (tests/test_distributed.py's
# train-step and checkpoint-reshard cases, and the driver on a mesh)
_TRAIN = r"""
import copy, dataclasses, tempfile
from torch.distributed.tensor import DTensor
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.launch import specs as specs_mod
from repro_torch.launch import steps, train
from repro_torch.models import build
from repro_torch.optim import adamw
from repro_torch.runtime import elastic, sharding
out = {}

def full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t

# a (2 data x 4 model) train step against the one-rank step
cfg = dataclasses.replace(get_smoke_config('deepseek-7b'), remat=False,
                          compute_dtype='float32')
model = build(cfg, device='cpu')
masters = model.masters(torch.Generator().manual_seed(0))
rng = np.random.RandomState(0)
batch = {'tokens': rng.randint(0, cfg.vocab_size, (4, 16)).astype(np.int32),
         'labels': rng.randint(0, cfg.vocab_size, (4, 16)).astype(np.int32)}
ocfg = adamw.AdamWConfig(lr=1e-3)
single = copy.deepcopy(masters)
p1, _, m1 = steps.make_train_step(model, ocfg)(single, adamw.init(single),
                                               batch)
mesh = elastic.make_mesh((2, 4), ('data', 'model'), device='cpu')
opt = adamw.init(masters)
pspec = sharding.param_specs(mesh, masters)
ospec = sharding.opt_state_specs(mesh, opt)
pm = sharding.place(masters, mesh, pspec)
om = adamw.AdamWState(*sharding.place(list(opt), mesh, ospec))
tb = {k: torch.as_tensor(v) for k, v in batch.items()}
tb = sharding.place(tb, mesh, specs_mod.batch_shardings(mesh, tb))
p2, o2, m2 = steps.make_train_step(model, ocfg)(pm, om, tb)
out['loss_single'] = float(m1['loss'])
out['loss_sharded'] = float(full(m2['loss']))
out['param_err'] = max(float((full(a) - b).abs().max())
                       for a, b in zip(adamw.leaves(p2), adamw.leaves(p1)))
out['sharded_leaves'] = sum(
    any(type(pl).__name__ == 'Shard' for pl in t.placements)
    for t in adamw.leaves(p2))
out['all_dtensors'] = all(isinstance(t, DTensor) for t in
                          adamw.leaves(p2) + adamw.leaves(o2.m))

# checkpoint: save on (4, 2), restore onto (2, 4)
tree = {'w': torch.arange(64.0).reshape(8, 8)}
mesh_a = elastic.make_mesh((4, 2), ('data', 'model'), device='cpu')
mesh_b = elastic.make_mesh((2, 4), ('data', 'model'), device='cpu')
spec = {'w': ('data', 'model')}
d = os.environ['CKPT']
mgr = CheckpointManager(d)
mgr.save(3, sharding.place(tree, mesh_a, spec))
restored, step = mgr.restore(tree, mesh=mesh_b, specs=spec)
w = restored['w']
out['reshard_step'] = step
out['reshard_mesh'] = list(w.device_mesh.shape)
out['reshard_placements'] = [type(p).__name__ + str(getattr(p, 'dim', ''))
                             for p in w.placements]
out['reshard_local'] = list(w.to_local().shape)
out['reshard_equal'] = bool(torch.equal(w.full_tensor(), tree['w']))

# the driver on the (2, 4) mesh
out['driver_losses'] = train.main([
    '--arch', 'deepseek-7b', '--smoke', '--steps', '3', '--batch', '4',
    '--seq-len', '16', '--model-parallel', '4', '--log-every', '100',
    '--device', 'cpu'])
emit(out)
"""


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train")
    os.environ["CKPT"] = str(tmp / "ckpt")
    try:
        return run_ranks(_TRAIN, 8, tmp, timeout=300.0)
    finally:
        os.environ.pop("CKPT", None)


def test_dp_tp_train_step_matches_one_rank(trained):
    """A (2 data x 4 model) train step on DTensor masters and AdamW state
    placed by `param_specs` / `opt_state_specs` computes the one-rank
    step's loss and update within 1e-3 (JAX's bound), on every rank."""
    for r in trained:
        assert abs(r["loss_sharded"] - r["loss_single"]) < 1e-3, r
        assert r["param_err"] < 1e-3, r
        assert r["all_dtensors"] and r["sharded_leaves"] > 0, r


def test_checkpoint_reshards_across_meshes(trained):
    """Saved from a (4, 2) mesh, restored onto (2, 4): the target layout
    (an 8 x 8 leaf as 4 x 2 local blocks), the same values."""
    for r in trained:
        assert r["reshard_step"] == 3 and r["reshard_equal"], r
        assert r["reshard_mesh"] == [2, 4], r
        assert r["reshard_placements"] == ["Shard0", "Shard1"], r
        assert r["reshard_local"] == [4, 2], r


def test_driver_trains_on_a_mesh_as_on_one_rank(trained):
    """`launch.train` under 8 ranks (mesh (2, 4), --model-parallel 4)
    gives the one-process driver's losses, within the bfloat16 bound of
    the forward tests (0.02: the smoke config computes in bfloat16, and a
    model-sharded product rounds its partial sums before they meet)."""
    from repro_torch.launch import train
    one = train.main(["--arch", "deepseek-7b", "--smoke", "--steps", "3",
                      "--batch", "4", "--seq-len", "16", "--log-every",
                      "100", "--device", "cpu"])
    for r in trained:
        np.testing.assert_allclose(r["driver_losses"], one, rtol=0.02)
