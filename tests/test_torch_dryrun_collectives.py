"""The dry run's count of collectives (`launch.dryrun.DeviceCount`): DTensor's
Shard-to-Shard move is one all-to-all of its output's bytes on its mesh
axis, whether a card runs it (`_dtensor.shard_dim_alltoall`) or a cpu mesh
falls back to an all-gather of the whole dim and a chunk of it; an op of a
collective namespace that `COLLECTIVES` does not name raises; and the cells
whose models moved a split so count the move, or no longer make it.

Each check runs in a subprocess of its own (the dry run's fake process
group is the process's default group), on a cpu mesh of 2 x 4 fake ranks
and meta tensors."""
import json
import os
import subprocess
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _dryrun_cells as dc  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_UNITS = r"""
import json
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.launch import dryrun

def record(count):
    return {"counts": count.counts, "coll_bytes": count.coll_bytes,
            "axis_bytes": count.axis_bytes, "bytes": count.bytes,
            "flops": count.total_flops, "ops": count.ops,
            "rows": dryrun.shape_rows(count.coll_shapes)}

out = {}
with dryrun.fake_world(8):
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    axes = {i["group"]: n for n, i in dryrun.mesh_axes(mesh).items()}
    group = mesh.get_group("model").group_name

    # the op a cuda mesh issues, called directly
    count = dryrun.DeviceCount(axes)
    x = torch.empty(8, 16, device="meta")
    with count:
        y = torch.ops._dtensor.shard_dim_alltoall(x, 0, 1, group)
    out["op"] = dict(record(count), shape=list(y.shape))

    # a DTensor's split moved from dim 0 to dim 1 over `model`
    count = dryrun.DeviceCount(axes)
    t = DTensor.from_local(torch.empty(4, 16, device="meta"), mesh,
                           [Replicate(), Shard(0)], run_check=False,
                           shape=(16, 16), stride=(16, 1))
    with count:
        u = t.redistribute(mesh, [Replicate(), Shard(1)])
    out["redistribute"] = dict(record(count), shape=list(u.to_local().shape),
                               placements=[repr(p) for p in u.placements])

    # a collective op COLLECTIVES does not name
    count = dryrun.DeviceCount(axes)
    try:
        with count:
            torch.ops._c10d_functional.isend(x, 1, 0, group)
        out["unnamed"] = None
    except NotImplementedError as e:
        out["unnamed"] = str(e)
    # the functions DTensor moves splits with are its own again
    import torch.distributed.tensor._collective_utils as cu
    import torch.distributed.tensor.placement_types as pt
    out["restored"] = (pt.shard_dim_alltoall is cu.shard_dim_alltoall
                       and cu.shard_dim_alltoall.__module__ == cu.__name__)
print("RESULT " + json.dumps(out))
"""

# whisper-large-v3 decode_32k's short cell on the 16x16 mesh
WHISPER = ("whisper-large-v3", "decode_32k", False)


def _start(code: str) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-c", code], env=env, cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


@pytest.fixture(scope="module")
def results():
    """(the unit checks' results, whisper's short cell record), the two
    subprocesses run side by side."""
    proc = _start(_UNITS)
    try:
        cell = dc.trace([WHISPER], timeout=300)[WHISPER]
        out, err = proc.communicate(timeout=300)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-3000:]
    line = [l for l in out.splitlines() if l.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):]), cell


def _one_all_to_all(rec, shape, nbytes):
    assert rec["counts"] == {"all-to-all": 1}
    assert rec["coll_bytes"] == {"all-to-all": nbytes}
    assert rec["axis_bytes"] == {"model": nbytes}
    assert rec["rows"] == [{"phase": "forward", "kind": "all-to-all",
                            "axis": "model", "dtype": "float32",
                            "shape": shape, "count": 1, "bytes": nbytes}]
    assert rec["flops"] == 0


def test_shard_dim_alltoall_op_is_one_all_to_all(results):
    # (8, 16) gathered along dim 0 over 4 ranks and split along dim 1
    rec = results[0]["op"]
    assert rec["shape"] == [32, 4]
    _one_all_to_all(rec, [32, 4], 32 * 4 * 4)
    # the op's operand read and result written, as a collective's
    assert rec["bytes"] == 8 * 16 * 4 + 32 * 4 * 4 and rec["ops"] == 1


def test_cpu_mesh_fallback_counts_the_same_all_to_all(results):
    # (16, 16) split by rows over 4 model ranks, then by columns: DTensor's
    # all-gather of the rows and chunk of the columns count as the
    # all-to-all a card runs, of the (16, 4) shard it leaves
    rec = results[0]["redistribute"]
    assert rec["shape"] == [16, 4]
    assert rec["placements"] == ["Replicate()", "Shard(dim=1)"]
    _one_all_to_all(rec, [16, 4], 16 * 4 * 4)
    assert "all-gather" not in rec["counts"]
    assert rec["bytes"] == 4 * 16 * 4 + 16 * 4 * 4


def test_unnamed_collective_op_raises(results):
    msg = results[0]["unnamed"]
    assert msg is not None and "_c10d_functional.isend" in msg
    assert results[0]["restored"]


def test_whisper_decode_memory_gathered_once(results):
    """whisper-large-v3 decode_32k: the encoder memory (split along d_model
    by the cache's rules) is made whole once a step, so no layer moves wk /
    wv to rows or all-reduces its K / V over `model` (each a Shard-to-Shard
    move of a (1280, 80) bf16 shard and an all-reduce of (8, 20, 1500, 64)
    bf16 a layer before): its model all-gathers are the memory's (8, 1500,
    1280) bf16 and small ones."""
    rec = results[1]
    assert rec["status"] == "ok", rec.get("error")
    rows = rec["collectives"]["by_shape"]
    memory = 8 * 1500 * 1280 * 2
    gathers = [r for r in rows if r["kind"] == "all-gather"
               and r["axis"] == "model"]
    assert max(r["bytes"] for r in gathers) == memory
    assert sum(r["bytes"] for r in gathers) < 1.1 * memory
    assert not [r for r in rows if r["shape"] in ([80, 1280], [1280, 80],
                                                  [20480, 80])]
    assert not [r for r in rows if r["kind"] == "all-reduce"
                and r["bytes"] >= 1500 * 64]
    assert not dc.head_gathers(rec)
