"""Shared code of the `test_torch_dryrun_cells_*.py` files, of
`test_torch_cuda.py::TestDryRunOnCard` and of `chip_smoke.py` phase 15 (d):
every applicable (arch x shape x mesh) cell of the dry run, cut for a
quick check (`launch.dryrun.short_cell`: full width, the roofline's
smallest depth variant, train 256 x 256, prefill 32 x 512, decode 128 x
512), traced on a "cpu" mesh (the card's: "cuda").

A file's cells run in one subprocess (the dry run's fake process group is
the process's default group), each cell's failure recorded with its
traceback. Each case asserts: status ok; the collectives (`counts`,
`bytes_by_kind`, `bytes_by_axis`) the card's torch counts on a cuda mesh
(`CARD_RECORDS`, held by `mesh_differences`); params and active params
equal to the JAX config cut the same way; argument bytes equal to the local
shards of the placed leaves, summed here from the sharding rules alone;
the record's keys those of the dry run's ok records; for a prefill, output
bytes equal to the local shards of the cache laid out by `cache_specs` and
of the last logits, summed from the rules alone. `projection_gathers`
finds the all-gathers of a Mamba2 input projection's columns over the
model ranks (the hybrid file and `chip_smoke.py` (d) want none), and
`head_gathers` those of attention heads made whole (`chip_smoke.py` (d)
wants none in any cell). A cpu mesh counts the collectives a cuda mesh
does: DTensor's Shard-to-Shard move, an all-gather and a chunk on a cpu
mesh, counts as the all-to-all a card runs (`launch.dryrun.DeviceCount`);
`mesh_differences` holds two meshes' records of a cell to each other
(`chip_smoke.py` (d) traces every cell on both, and holds the cuda mesh's
to `CARD_RECORDS`). The two-layer `VARIANTS` of three train cells are
traced beside their arch's cells and held to `CARD_RECORDS` too.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import torch

from repro_torch.configs import SHAPES, get_config, shape_applicable
from repro_torch.launch import dryrun
from repro_torch.launch import specs as specs_mod
from repro_torch.models import build
from repro_torch.optim import adamw
from repro_torch.runtime import sharding

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RECORD_KEYS = {"arch", "shape", "mesh", "chips", "kind", "status",
               "lower_s", "compile_s", "memory", "per_device_bytes", "fits",
               "hlo_flops_per_device", "hlo_bytes_per_device",
               "flops_by_class", "dot_flops_per_device", "collectives",
               "params", "active_params", "ops", "detail"}

_TRACE = r"""
import dataclasses, json, sys, traceback
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun
out = {}
for arch, shape, multi, *layers in json.loads(sys.argv[1]):
    cfg, short = dryrun.short_cell(get_config(arch), SHAPES[shape])
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers[0])
    try:
        rec = dryrun.lower_cell(arch, shape, multi, cfg, shape=short,
                                device=sys.argv[2])
    except Exception:
        rec = {"status": "FAILED", "error": traceback.format_exc()[-3000:]}
    out["|".join(map(str, (arch, shape, int(multi), *layers)))] = rec
print("RESULT " + json.dumps(out))
"""

# cells cut as `short_cell` cuts them but two layers deep (arch, shape,
# multi_pod, n_layers): DTensor's layouts settle only after a model's first
# layer of a type (`launch.roofline.depth_variants`), so the collectives
# of a layer between two others (the backward all-reduce of the residual
# stream a norm each way) show only from the second layer on
VARIANTS = (("qwen1.5-4b", "train_4k", False, 2),
            ("whisper-large-v3", "train_4k", False, 2),
            ("starcoder2-3b", "train_4k", False, 2))

# each cell's collectives as the card's torch counts them on a cuda mesh
# (`counts`, `bytes_by_kind`, `bytes_by_axis`, `by_shape`): the 64 cells of
# `cells` and the `VARIANTS`, written by `python tests/_dryrun_moves.py
# record` on the card; every mesh, on any torch, must count the same
CARD_RECORDS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "_dryrun_card_collectives.json")


def cells(archs):
    """The applicable cells of `archs`, as (arch, shape, multi_pod)."""
    return [(a, s, m) for a in archs for s in SHAPES for m in (False, True)
            if shape_applicable(get_config(a), SHAPES[s])[0]]


def variants(archs):
    """The `VARIANTS` of `archs`."""
    return [v for v in VARIANTS if v[0] in archs]


def cell_id(cell):
    arch, shape, multi, *layers = cell
    return (f"{arch}-{shape}-{'2x16x16' if multi else '16x16'}"
            + "".join(f"-{n}layers" for n in layers))


def trace(cells_, timeout: float = 900.0, device: str = "cpu"):
    """{cell: dry-run record} of `cells_`, traced in one subprocess on a
    `device` mesh."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", _TRACE, json.dumps(cells_),
                        device],
                       capture_output=True, text=True, env=env, cwd=REPO,
                       timeout=timeout)
    assert r.returncode == 0, r.stderr[-3000:]
    line = [l for l in r.stdout.splitlines() if l.startswith("RESULT ")][-1]
    out = json.loads(line[len("RESULT "):])
    return {(a, s, bool(int(m)), *map(int, n)): rec for (a, s, m, *n), rec
            in ((k.split("|"), v) for k, v in out.items())}


def trace_by_arch(archs, devices, jobs: int = 8,
                  cell_timeout: float = 120.0):
    """{device: {cell: dry-run record}} of every applicable cell of
    `archs`, and of their `VARIANTS`, on a mesh of each of `devices`, an
    arch's cells on one mesh traced in a subprocess of their own
    (`trace`), `jobs` at a time in one pool. An arch whose subprocess runs
    past `cell_timeout` seconds a cell gets TIMEOUT records, one that
    fails outside a cell FAILED ones."""
    import concurrent.futures as cf

    def one(job):
        arch, device = job
        cs = cells((arch,)) + variants((arch,))
        try:
            return trace(cs, cell_timeout * len(cs), device)
        except subprocess.TimeoutExpired:
            return {c: {"status": "TIMEOUT", "error":
                        f"over {cell_timeout * len(cs)} s"} for c in cs}
        except AssertionError as e:
            return {c: {"status": "FAILED", "error": str(e)} for c in cs}

    jobs_ = [(a, d) for a in archs for d in devices]
    out = {d: {} for d in devices}
    with cf.ThreadPoolExecutor(jobs) as pool:
        for (_, device), recs in zip(jobs_, pool.map(one, jobs_)):
            out[device].update(recs)
    return out


def mesh_differences(a, b):
    """The fields of two dry-run records of one cell (on two meshes) whose
    collectives differ: {field: (a's, b's)} for `counts`, `bytes_by_kind`
    and `bytes_by_axis`, and under "by_shape" the rows either has that the
    other has not."""
    ca, cb = a["collectives"], b["collectives"]
    out = {k: (ca[k], cb[k]) for k in ("counts", "bytes_by_kind",
                                       "bytes_by_axis") if ca[k] != cb[k]}
    if out:
        out["by_shape"] = ([r for r in ca["by_shape"]
                            if r not in cb["by_shape"]],
                           [r for r in cb["by_shape"]
                            if r not in ca["by_shape"]])
    return out


def card_records():
    """{cell id: collectives} of `CARD_RECORDS` (the card's torch, a cuda
    mesh)."""
    with open(CARD_RECORDS) as f:
        return json.load(f)["cells"]


def card_differences(rec, cell, card=None):
    """`mesh_differences` of a dry-run record of `cell` and the card's
    record of it (`card`: `card_records()` by default)."""
    card = card if card is not None else card_records()
    return mesh_differences(rec, {"collectives": card[cell_id(cell)]})


def _local_bytes(t, spec, mesh):
    shape = list(t.shape)
    for d, entry in enumerate(spec):
        if entry is not None:
            names = entry if isinstance(entry, tuple) else (entry,)
            n = math.prod(mesh[a] for a in names)
            shape[d] = -(-shape[d] // n)
    return math.prod(shape) * t.element_size()


def _placed_bytes(tree, specs, mesh):
    if tree is None:
        return 0
    if isinstance(tree, dict):
        return sum(_placed_bytes(v, specs[k], mesh) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return sum(_placed_bytes(v, s, mesh) for v, s in zip(tree, specs))
    return _local_bytes(tree, specs, mesh)


def argument_bytes(arch, shape_name, multi):
    """The bytes one device holds of the step's arguments, from the
    sharding rules: each leaf's local shard (a split dim's extent over the
    product of its mesh axes, rounded up), summed."""
    cfg, shape = dryrun.short_cell(get_config(arch), SHAPES[shape_name])
    # the dry run's mesh: the multi-pod (pod, data) axes as one of 32
    mesh = {"data": 32 if multi else 16, "model": 16}
    meta = specs_mod.meta_model(build(cfg, device="cpu"))
    draw = specs_mod.MetaDraw()
    if shape.kind == "train":
        params = meta.masters(draw)
        opt = adamw.init(params)
        batch = specs_mod.train_batch_specs(cfg, shape)
        return (_placed_bytes(params, sharding.param_specs(
                    mesh, params, fsdp=cfg.fsdp), mesh)
                + _placed_bytes(list(opt), list(sharding.opt_state_specs(
                    mesh, opt, fsdp=cfg.fsdp)), mesh)
                + _placed_bytes(batch, specs_mod.batch_shardings(
                    mesh, batch), mesh))
    params = adamw.tree_map(lambda t: t.to(meta.cdt) if t.is_floating_point()
                            else t, meta.init(draw))
    total = _placed_bytes(params, sharding.param_specs(mesh, params), mesh)
    if shape.kind == "prefill":
        batch = specs_mod.prefill_batch_specs(cfg, shape)
        return total + _placed_bytes(batch, specs_mod.batch_shardings(
            mesh, batch), mesh)
    cache, tokens = specs_mod.decode_specs(meta, cfg, shape)
    total += _placed_bytes(cache, sharding.cache_specs(
        mesh, cache, shape.global_batch), mesh)
    return total + _placed_bytes({"tokens": tokens},
                                 specs_mod.batch_shardings(
                                     mesh, {"tokens": tokens}), mesh)


def output_bytes(arch, shape_name, multi):
    """The bytes one device holds of a prefill step's outputs, from the
    sharding rules: the cache laid out by `sharding.cache_specs` (as the
    JAX dry run's `out_shardings` place it) and the last position's float32
    logits, split as the batch (the data axes) and the head's vocab
    (`model`) are, each leaf's local shard summed."""
    cfg, shape = dryrun.short_cell(get_config(arch), SHAPES[shape_name])
    mesh = {"data": 32 if multi else 16, "model": 16}
    meta = specs_mod.meta_model(build(cfg, device="cpu"))
    b, v = shape.global_batch, cfg.padded_vocab_size
    cache = meta.init_cache(b, shape.seq_len)
    logits = torch.empty((b, v), dtype=torch.float32, device="meta")
    spec = ("data" if b % mesh["data"] == 0 else None,
            "model" if v % mesh["model"] == 0 else None)
    return (_placed_bytes(cache, sharding.cache_specs(mesh, cache, b), mesh)
            + _local_bytes(logits, spec, mesh))


def check_variant(records, cell):
    """The assertions of one `VARIANTS` case: status ok, and the
    collectives the card's torch counts on a cuda mesh."""
    rec = records[cell]
    assert rec["status"] == "ok", rec.get("error")
    assert card_differences(rec, cell) == {}


def jax_counts(arch, shape_name):
    """(params, active params) of the JAX config cut as `short_cell` cuts
    the port's."""
    from repro.configs import get_config as jax_config
    cut, _ = dryrun.short_cell(get_config(arch), SHAPES[shape_name])
    kw = {"n_layers": cut.n_layers}
    jcfg = jax_config(arch)
    if cut.moe is not None:
        kw["moe"] = dataclasses.replace(
            jcfg.moe, n_dense_layers=cut.moe.n_dense_layers)
    jcfg = dataclasses.replace(jcfg, **kw)
    return jcfg.param_count(), jcfg.active_param_count()


def projection_gathers(rec):
    """The all-gathers over `model` in a dry-run record's
    `collectives.by_shape` that carry activation columns of a Mamba2
    input projection, whole where the rules split them: tensors whose
    last dim is the projection's share of one model rank (its columns as
    `w_in`'s column split leaves them, gathered), or the scan's input made
    whole (an activation d_in wide, d_in over the model ranks, or the
    heads of either). An arch with no Mamba2 mixer has none."""
    cfg = get_config(rec["arch"])
    if cfg.ssm is None:
        return []
    s = cfg.ssm
    n = dryrun.production_mesh_shape(False)["model"]
    d_in = s.expand * cfg.d_model
    heads = d_in // s.head_dim
    width = 2 * d_in + 2 * s.n_groups * s.d_state + heads
    return [r for r in rec["collectives"]["by_shape"]
            if r["kind"] == "all-gather" and r["axis"] == "model" and (
                r["shape"][-1] == -(-width // n)
                or len(r["shape"]) >= 3 and (
                    r["shape"][-1] in (d_in, d_in // n)
                    or r["shape"][-2:] in ([heads, s.head_dim],
                                           [heads // n, s.head_dim])))]


def head_gathers(rec):
    """The all-gathers over `model` in a dry-run record's
    `collectives.by_shape` that carry attention heads made whole where the
    rules split them: an activation of more than one position whose last
    dim is a head's (query, key or value heads, repeated KV heads, the WKV
    scan's heads: all of them or a rank's share, gathered), or one model
    rank's share of the query or the K / V projection's columns (a
    projection gathered before its heads are split), or whose inner dims
    hold every head or the heads padded to a multiple of the ranks (a
    repeated KV head is a query head's). MLA's heads are its query and
    value heads, found by their dims alone: its projections' columns a
    rank are its latent ranks' widths, which it gathers by design. A decode
    step's one position is gathered by design too: the query meets a cache
    split along the sequence, and the position's K / V go into it. So is
    an audio model's encoder memory in a decode step: the cache splits its
    d_model over `model`, and the step makes it whole once, ahead of the
    layers, as GSPMD does (one all-gather of the encoder's frames; the K /
    V columns of a layer gathered from it would add two to that row's
    count)."""
    cfg = get_config(rec["arch"])
    n = dryrun.production_mesh_shape(False)["model"]
    if cfg.use_mla:
        dims = {cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim,
                cfg.mla.v_head_dim}
        cols = set()
    else:
        dims = {cfg.resolved_head_dim}
        cols = {-(-h * cfg.resolved_head_dim // n)
                for h in (cfg.n_heads, cfg.n_kv_heads)}
    heads = {cfg.n_heads, -(-cfg.n_heads // n) * n}
    memory = rec["kind"] == "decode" and cfg.family == "audio"
    return [r for r in rec["collectives"]["by_shape"]
            if r["kind"] == "all-gather" and r["axis"] == "model"
            and len(r["shape"]) >= 3 and r["shape"][-2] > 1 and (
                r["shape"][-1] in dims | cols
                or heads & set(r["shape"][1:-1]))
            and not (memory and r["count"] == 1
                     and r["shape"][1:-1] == [cfg.max_source_positions])]


def check(records, cell):
    """The assertions of one case."""
    arch, shape, multi = cell
    rec = records[cell]
    assert rec["status"] == "ok", rec.get("error")
    # the collectives the card's torch counts on a cuda mesh, on any torch
    assert card_differences(rec, cell) == {}
    assert set(rec) == RECORD_KEYS
    assert rec["mesh"] == ("2x16x16" if multi else "16x16")
    assert rec["chips"] == (512 if multi else 256)
    assert (rec["params"], rec["active_params"]) == jax_counts(arch, shape)
    assert rec["memory"]["argument_bytes"] == argument_bytes(arch, shape,
                                                             multi)
    if rec["kind"] == "prefill":
        assert rec["memory"]["output_bytes"] == output_bytes(arch, shape,
                                                             multi)
    assert rec["hlo_flops_per_device"] > 0 and rec["hlo_bytes_per_device"] > 0
    assert torch.isfinite(torch.tensor(rec["per_device_bytes"]))
