"""DTensor's Shard-to-Shard moves in the dry run, and the collectives two
meshes, two torches or two trees count: a diagnostic run by hand, and the
writer of the card's record that the tests hold every mesh to.

`moves` traces every applicable short cell of some archs
(`launch.dryrun.short_cell`, as `tests/_dryrun_cells.py` cuts them) on one
mesh kind, with DTensor's `shard_dim_alltoall` wrapped to list each move by
cell, phase, dtype, local shard, result, mesh axis, count and the model
lines that issued it; `collectives` does the same for every collective
`launch.dryrun.DeviceCount` counts, over the short cells and the
two-layer `VARIANTS` of those archs (in backward, the lines are the
forward op's whose gradient issued it, from autograd's anomaly mode, and
the autograd node's name; "accumulate" where the engine sums two
gradients of one tensor); `diff` lists, for each cell whose counts differ
between two `collectives` runs (files, or directories of them), the
`by_shape` rows that differ with the lines that issued them on each
side; `variants` traces the roofline's depth variants
(`launch.roofline.depth_variants`) of some cells at their full shape and
keeps each variant's collectives and weight, whose weighted sum is the
composed count; `record` traces the 64 short cells and the `VARIANTS` on
one mesh kind (`_dryrun_cells.trace_by_arch`) and writes each cell's
`counts`, `bytes_by_kind`, `bytes_by_axis` and `by_shape`, the file
`_dryrun_cells.CARD_RECORDS` when run on the card with `--device cuda`
(this checkout's tree).
Each writes one JSON file. `--src` names the `src` directory of the tree
to trace (this checkout's by default), so that a parent commit unpacked
beside it can be traced with the same script:

  python tests/_dryrun_moves.py moves --archs whisper-large-v3 \\
      --device cpu --out moves.json [--src DIR]
  python tests/_dryrun_moves.py collectives --archs qwen1.5-4b \\
      --device cpu --out coll.json [--src DIR]
  python tests/_dryrun_moves.py diff --out diff.json A.json B.json
  python tests/_dryrun_moves.py variants --cells qwen1.5-4b:train_4k \\
      --device cuda --out variants.json [--src DIR]
  python tests/_dryrun_moves.py record --device cuda \\
      --out tests/_dryrun_card_collectives.json

Run each in a process of its own: the dry run's fake process group is the
process's default group.
"""
import argparse
import collections
import json
import math
import os
import re
import sys
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _wrap_moves(moves, where):
    """Wrap DTensor's `shard_dim_alltoall` wherever its modules imported
    it, adding each call to `moves` under the cell `where[0]`."""
    import torch
    import torch.distributed.tensor._collective_utils as cu
    move = cu.shard_dim_alltoall

    def call(input, gather_dim, shard_dim, mesh, mesh_dim):
        out = move(input, gather_dim, shard_dim, mesh, mesh_dim)
        lines = [f"{os.path.basename(f.filename)}:{f.lineno}"
                 for f in traceback.extract_stack()
                 if f"{os.sep}models{os.sep}" in f.filename]
        phase = ("backward" if torch._C._current_graph_task_id() != -1
                 else "forward")
        moves[(where[0], phase, str(input.dtype).replace("torch.", ""),
               tuple(input.shape), tuple(out.shape),
               mesh.mesh_dim_names[mesh_dim], " < ".join(lines[::-1][:3]))
              ] += 1
        return out

    sites = [name for name, mod in list(sys.modules.items())
             if name.startswith("torch.distributed")
             and getattr(mod, "shard_dim_alltoall", None) is move]
    for name in sites:
        sys.modules[name].shard_dim_alltoall = call
    return sites


def _model_lines(frames, top=3):
    """The last `top` lines of the model modules among `frames` (file
    name, line number pairs, outermost first), innermost first."""
    lines = [f"{os.path.basename(f)}:{n}" for f, n in frames
             if f"{os.sep}models{os.sep}" in f]
    return " < ".join(lines[::-1][:top])


def _node_lines(node):
    """The model lines of the forward op whose gradient autograd's node
    `node` computes (anomaly mode keeps its forward stack), or ""."""
    stack = (node.metadata.get("traceback_") or []) if node else []
    frames = []
    for entry in stack:
        m = re.match(r'\s*File "([^"]+)", line (\d+)', entry)
        if m:
            frames.append((m.group(1), int(m.group(2))))
    return _model_lines(frames)


def _wrap_collectives(rows, where):
    """Wrap `DeviceCount._collective` so that each collective it counts is
    added to `rows` under the cell `where[0]`, by phase, kind, axis, dtype,
    shape and the model lines that issued it."""
    import torch
    from repro_torch.launch import dryrun
    count = dryrun.DeviceCount._collective

    def call(self, kind, group, ins, out, name):
        count(self, kind, group, ins, out, name)
        phase = self._phase(name)
        now = _model_lines([(f.filename, f.lineno)
                            for f in traceback.extract_stack()])
        node, origin = None, ""
        if phase == "backward":
            node = torch._C._current_autograd_node()
            origin = (f"{type(node).__name__} of {_node_lines(node)}"
                      if node is not None else "accumulate")
        for t in dryrun._tensors(out):
            rows[(where[0], phase, kind, self.axes.get(group, group),
                  str(t.dtype).replace("torch.", ""), tuple(t.shape), now,
                  origin)] += 1

    dryrun.DeviceCount._collective = call


def trace_collectives(archs, device):
    """{"rows": every collective of the short cells of `archs` and of
    their `VARIANTS`, with the model lines that issued it; "records":
    {cell id: status and collectives}}."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import dataclasses
    import torch
    import _dryrun_cells as dc
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun
    rows, where = collections.Counter(), [None]
    _wrap_collectives(rows, where)
    records = {}
    for cell in dc.cells(archs) + dc.variants(archs):
        arch, shape, multi, *layers = cell
        where[0] = dc.cell_id(cell)
        cfg, short = dryrun.short_cell(get_config(arch), SHAPES[shape])
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers[0])
        try:
            with torch.autograd.detect_anomaly(check_nan=False):
                rec = dryrun.lower_cell(arch, shape, multi, cfg, shape=short,
                                        device=device)
            records[where[0]] = {"status": rec["status"],
                                 "collectives": rec["collectives"]}
        except Exception:
            records[where[0]] = {"status": "FAILED",
                                 "error": traceback.format_exc()[-1500:]}
    out = [dict(zip(("cell", "phase", "kind", "axis", "dtype", "shape",
                     "lines", "origin"), k), count=n,
                bytes=n * math.prod(k[5]) * getattr(torch, k[4]).itemsize)
           for k, n in rows.items()]
    return {"rows": out, "records": records}


def _load(path):
    """A `collectives` file, or every one in a directory merged."""
    names = ([os.path.join(path, n) for n in sorted(os.listdir(path))
              if n.endswith(".json")] if os.path.isdir(path) else [path])
    out = {"rows": [], "records": {}}
    for name in names:
        with open(name) as f:
            doc = json.load(f)
        out["rows"] += doc["rows"]
        out["records"].update(doc["records"])
    return out


def diff(a, b):
    """{cell: {field: (a's, b's), "rows": [...]}} for each cell whose
    `counts`, `bytes_by_kind` or `bytes_by_axis` differ between two
    `collectives` runs: each (phase, kind, axis, dtype, shape) row of
    `by_shape` whose count differs, with the model lines and autograd
    origins that issued it on each side."""
    def rows(c):
        return {(r["phase"], r["kind"], r["axis"], r["dtype"],
                 tuple(r["shape"])): r["count"] for r in c["by_shape"]}

    lines = collections.defaultdict(set)
    for side, doc in (("a", a), ("b", b)):
        for r in doc["rows"]:
            lines[(side, r["cell"], r["phase"], r["kind"], r["axis"],
                   r["dtype"], tuple(r["shape"]))].add(
                f"{r['lines']} | {r['origin']}".strip(" |"))
    out = {}
    for cell in sorted(set(a["records"]) & set(b["records"])):
        ra, rb = a["records"][cell], b["records"][cell]
        if "ok" != ra["status"] or "ok" != rb["status"]:
            out[cell] = {"status": (ra["status"], rb["status"])}
            continue
        ca, cb = ra["collectives"], rb["collectives"]
        fields = {k: (ca[k], cb[k]) for k in (
            "counts", "bytes_by_kind", "bytes_by_axis") if ca[k] != cb[k]}
        if not fields:
            continue
        x, y = rows(ca), rows(cb)
        fields["rows"] = [
            dict(zip(("phase", "kind", "axis", "dtype", "shape"), k),
                 a=x.get(k, 0), b=y.get(k, 0),
                 a_lines=sorted(lines[("a", cell) + k]),
                 b_lines=sorted(lines[("b", cell) + k]))
            for k in sorted(set(x) | set(y), key=str)
            if x.get(k, 0) != y.get(k, 0)]
        out[cell] = fields
    return out


def record(device, jobs):
    """{cell id: collectives} of the 64 short cells and the `VARIANTS` on
    a `device` mesh, as `_dryrun_cells.card_records` reads them."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import _dryrun_cells as dc
    from repro_torch.configs import list_archs
    recs = dc.trace_by_arch(list_archs(), (device,), jobs=jobs)[device]
    bad = {dc.cell_id(c): r.get("error", "")[-300:]
           for c, r in recs.items() if r["status"] != "ok"}
    if bad:
        raise SystemExit(f"cells that did not trace: {bad}")
    return {dc.cell_id(c): {k: r["collectives"][k] for k in (
        "counts", "bytes_by_kind", "bytes_by_axis", "by_shape")}
        for c, r in sorted(recs.items())}


def trace_moves(archs, device):
    """{"sites", "moves": rows, "records": {cell id: status and
    collectives}} of every applicable short cell of `archs`."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import _dryrun_cells as dc
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun
    moves, where = collections.Counter(), [None]
    sites = _wrap_moves(moves, where)
    records = {}
    for cell in dc.cells(archs):
        arch, shape, multi = cell
        where[0] = dc.cell_id(cell)
        cfg, short = dryrun.short_cell(get_config(arch), SHAPES[shape])
        try:
            rec = dryrun.lower_cell(arch, shape, multi, cfg, shape=short,
                                    device=device)
            records[where[0]] = {"status": rec["status"],
                                 "collectives": rec["collectives"]}
        except Exception:
            records[where[0]] = {"status": "FAILED",
                                 "error": traceback.format_exc()[-1500:]}
    rows = [dict(zip(("cell", "phase", "dtype", "local", "result", "axis",
                      "lines"), k), count=n) for k, n in moves.items()]
    return {"sites": sites, "moves": rows, "records": records}


def trace_variants(cells, device):
    """{cell: [{"layers", "weight", "status", "collectives"}]} of each
    (arch, shape) of `cells` on the single-pod mesh, at its full shape."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, roofline
    out = {}
    for arch, shape in cells:
        variants, _ = roofline.depth_variants(get_config(arch))
        out[f"{arch}:{shape}"] = [
            {"layers": v.n_layers, "weight": w, "status": rec["status"],
             "collectives": rec.get("collectives")}
            for v, w in variants
            for rec in [dryrun.lower_cell(arch, shape, False, v,
                                          device=device)]]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("moves", "collectives", "diff",
                                     "variants", "record"))
    ap.add_argument("files", nargs="*",
                    help="diff: two collectives files or directories")
    ap.add_argument("--archs", default="",
                    help="moves, collectives: comma-separated")
    ap.add_argument("--cells", default="",
                    help="variants: comma-separated arch:shape")
    ap.add_argument("--device", default="cpu", help="cpu or cuda mesh")
    ap.add_argument("--src", default=os.path.join(REPO, "src"))
    ap.add_argument("--jobs", type=int, default=8,
                    help="record: archs traced at once")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if args.mode == "diff":
        cells = diff(*map(_load, args.files))
        with open(args.out, "w") as f:
            json.dump({"a": args.files[0], "b": args.files[1],
                       "cells": cells}, f, indent=1)
        print(f"{len(cells)} cells differ")
        return
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if args.mode == "record":
        import subprocess
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip() if args.device == "cuda" else ""
        out = {"cells": record(args.device, args.jobs)}
        out.update(torch=torch.__version__, device=args.device, card=card)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=0, sort_keys=True)
        return
    if args.mode == "moves":
        out = trace_moves(args.archs.split(","), args.device)
    elif args.mode == "collectives":
        out = trace_collectives(args.archs.split(","), args.device)
    else:
        out = trace_variants([tuple(c.split(":"))
                              for c in args.cells.split(",")], args.device)
    out.update(torch=torch.__version__, device=args.device, src=args.src)
    with open(args.out, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
