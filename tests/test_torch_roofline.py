"""The port's dry run and roofline (`repro_torch.launch.dryrun` /
`roofline`) against the JAX package's (`repro.launch`), on the CPU.

* `model_flops` equals JAX's for every (arch, shape), and the status
  matrix of the 80 cells (10 archs x 4 shapes x {16x16, 2x16x16}) equals
  the one JAX's `run_all` takes: 64 ok, 16 skipped by `shape_applicable`.
* olmoe-1b-7b / decode_32k / 16x16: JAX's `lower_cell` (a subprocess with
  512 host devices, as `tests/test_system.py` runs it) against the port's
  (a subprocess: the fake process group of 256 ranks is the process's
  default group). Parameter counts equal; per-device argument bytes equal
  but for the 4-byte position scalar, which JAX's step takes as an int32
  array and the port's as a host int. FLOPs: XLA counts a `while` body
  once, so the HLO count is one layer's body plus the rest; the port
  traces all 16 layers and reports one layer's count from the same trace
  (`detail`). The products are compared -- the HLO's dots against the
  port's products outside the layers plus one layer's -- within 10%;
  XLA's elementwise count (its converts and selects over the whole cache)
  has no eager counterpart.
* An 8-rank gloo run of the (2 data x 4 model) train step on real tensors
  counts the same per-device FLOPs, bytes and collective bytes as the
  fake group's dry run of that cell.

Records are written under tmp_path, never under results/.
"""
import json
import os
import subprocess
import sys

import pytest

from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.launch import dryrun, roofline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_distributed import run_ranks  # noqa: E402


def _run(code: str, timeout: float = 600.0):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=timeout)
    assert r.returncode == 0, r.stderr[-3000:]
    line = [l for l in r.stdout.splitlines() if l.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def test_model_flops_equal_jax_for_every_cell():
    from repro.configs import get_config as jax_config
    from repro.launch import roofline as jroof
    for arch in list_archs():
        for shape in SHAPES:
            assert roofline.model_flops(get_config(arch), shape) == \
                jroof.model_flops(jax_config(arch), shape), (arch, shape)


def test_status_matrix_equals_jax():
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jax_config
    from repro.configs import shape_applicable as jax_applicable
    from repro.configs import list_archs as jax_archs
    mine = dryrun.status_matrix()
    theirs = {}
    for arch in jax_archs():
        for s in JSHAPES:
            ok, _ = jax_applicable(jax_config(arch), JSHAPES[s])
            for mesh in ("16x16", "2x16x16"):
                theirs[(arch, s, mesh)] = "ok" if ok else "skipped"
    assert mine == theirs
    assert len(mine) == 80
    assert sum(v == "ok" for v in mine.values()) == 64
    assert sum(v == "skipped" for v in mine.values()) == 16


_JAX_CELL = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import json, math, re
from repro.launch import dryrun
from repro.runtime import hlo
texts = []
orig = hlo.collective_stats
def keep(text):
    texts.append(text)
    return orig(text)
dryrun.hlo_mod.collective_stats = keep
rec = dryrun.lower_cell("olmoe-1b-7b", "decode_32k", False)
text = texts[-1]
shapes = {}
for m in re.finditer(r"%?([\w.\-]+)\s*=\s*[a-z0-9]+\[([0-9,]*)\]", text):
    shapes[m.group(1)] = [int(d) for d in m.group(2).split(",") if d]
dots = 0
for m in re.finditer(r"=\s*[a-z0-9]+\[([0-9,]*)\][^=\n]*?\sdot\(%?([\w.\-]+)"
                     r",[^\n]*?lhs_contracting_dims=\{([0-9,]*)\}", text):
    out = [int(d) for d in m.group(1).split(",") if d]
    lhs = shapes[m.group(2)]
    k = math.prod(lhs[int(i)] for i in m.group(3).split(",") if i)
    dots += 2 * math.prod(out) * k
rec["hlo_dot_flops"] = dots
print("RESULT " + json.dumps(rec))
"""

_PORT_CELL = r"""
import json
from repro_torch.launch import dryrun
rec = dryrun.lower_cell("olmoe-1b-7b", "decode_32k", False, device="cpu")
print("RESULT " + json.dumps(rec))
"""


@pytest.fixture(scope="module")
def olmoe_cells():
    return _run(_JAX_CELL), _run(_PORT_CELL)


def test_olmoe_decode_cell_counts_and_sizes_as_jax(olmoe_cells, tmp_path):
    jax_rec, rec = olmoe_cells
    assert rec["status"] == jax_rec["status"] == "ok"
    assert (rec["mesh"], rec["chips"]) == (jax_rec["mesh"], 256)
    assert rec["params"] == jax_rec["params"]
    assert rec["active_params"] == jax_rec["active_params"]
    # JAX's step takes the position as an int32 array argument
    assert rec["memory"]["argument_bytes"] == \
        jax_rec["memory"]["argument_bytes"] - 4
    assert rec["fits"] and rec["per_device_bytes"] < dryrun.HBM_BYTES
    d = rec["detail"]
    scan_form = d["outside_layers_dot_flops"] + d["moe_blocks"][
        "layer_dot_flops"]
    assert d["moe_blocks"]["n_layers"] == 16
    assert abs(scan_form - jax_rec["hlo_dot_flops"]) <= \
        0.10 * jax_rec["hlo_dot_flops"], (scan_form, jax_rec["hlo_dot_flops"])
    # collectives counted by kind and by mesh axis, both axes across nodes
    coll = rec["collectives"]
    assert coll["total_bytes_per_device"] == sum(
        coll["bytes_by_kind"].values()) == sum(coll["bytes_by_axis"].values())
    assert set(coll["bytes_by_axis"]) <= {"data", "model"}
    assert coll["links"] == {"data": "infiniband", "model": "infiniband"}
    # the roofline from the same record, written under tmp_path
    roof = roofline.analyze("olmoe-1b-7b", "decode_32k", record=rec)
    assert roof["status"] == "ok" and roof["memory_adj_s"] == \
        roof["memory_s"]
    assert roof["bound_s"] == max(roof["compute_s"], roof["memory_s"],
                                  roof["collective_s"]) > 0
    out = tmp_path / "olmoe.json"
    out.write_text(json.dumps(roof))
    assert json.loads(out.read_text())["dominant"] == roof["dominant"]


def test_dryrun_cli_prints_an_ok_record(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "olmoe-1b-7b", "--shape", "decode_32k", "--single-pod", "--device",
         "cpu"], capture_output=True, text=True, cwd=str(tmp_path),
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")),
        timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    rec = json.loads(r.stdout[r.stdout.index("{"):])
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"


_GLOO_STEP = r"""
import dataclasses
from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch import specs as specs_mod
from repro_torch.launch import steps
from repro_torch.models import build
from repro_torch.optim import adamw
from repro_torch.runtime import elastic, sharding
cfg = dataclasses.replace(get_smoke_config('deepseek-7b'), remat=False,
                          compute_dtype='float32')
model = build(cfg, device='cpu')
masters = model.masters(torch.Generator().manual_seed(0))
mesh = elastic.make_mesh((2, 4), ('data', 'model'), device='cpu')
opt = adamw.init(masters)
pm = sharding.place(masters, mesh, sharding.param_specs(mesh, masters,
                                                        fsdp=cfg.fsdp))
om = adamw.AdamWState(*sharding.place(list(opt), mesh,
                                      sharding.opt_state_specs(
                                          mesh, list(opt), fsdp=cfg.fsdp)))
rng = np.random.RandomState(0)
tb = {k: torch.as_tensor(rng.randint(0, cfg.vocab_size, (4, 16))
                         .astype(np.int32)) for k in ('tokens', 'labels')}
tb = sharding.place(tb, mesh, specs_mod.batch_shardings(mesh, tb))
step = steps.make_train_step(model, adamw.AdamWConfig())
c = dryrun.count_step(step, (pm, om, tb), dryrun._leaves([pm, list(om), tb]),
                      pm, mesh)
emit({'flops': c.total_flops, 'dot': c.dot_flops, 'bytes': c.bytes,
      'counts': c.counts, 'coll': c.coll_bytes, 'axis': c.axis_bytes,
      'args': c.arguments})
"""

_FAKE_STEP = r"""
import dataclasses, json
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
cfg = dataclasses.replace(get_smoke_config('deepseek-7b'), remat=False,
                          compute_dtype='float32')
rec = dryrun.lower_cell('deepseek-7b', 'small', False, cfg,
                        shape=ShapeConfig('small', 16, 4, 'train'),
                        mesh_shape={'data': 2, 'model': 4}, device='cpu')
print("RESULT " + json.dumps(rec))
"""


def test_fake_group_counts_equal_an_8_rank_gloo_run(tmp_path):
    real = run_ranks(_GLOO_STEP, 8, tmp_path, timeout=300.0)[0]
    fake = _run(_FAKE_STEP)
    assert fake["status"] == "ok" and fake["chips"] == 8
    assert fake["hlo_flops_per_device"] == real["flops"]
    assert fake["dot_flops_per_device"] == real["dot"]
    assert fake["hlo_bytes_per_device"] == real["bytes"]
    assert fake["memory"]["argument_bytes"] == real["args"]
    assert fake["collectives"]["counts"] == real["counts"]
    assert fake["collectives"]["bytes_by_kind"] == real["coll"]
    assert sum(real["coll"].values()) > 0
    assert fake["collectives"]["links"] == {"data": "nvlink",
                                            "model": "nvlink"}
