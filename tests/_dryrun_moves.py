"""DTensor's Shard-to-Shard moves in the dry run, and the collectives two
meshes or two trees count: a diagnostic run by hand (not a test).

`moves` traces every applicable short cell of some archs
(`launch.dryrun.short_cell`, as `tests/_dryrun_cells.py` cuts them) on one
mesh kind, with DTensor's `shard_dim_alltoall` wrapped to list each move by
cell, phase, dtype, local shard, result, mesh axis, count and the model
lines that issued it; `variants` traces the roofline's depth variants
(`launch.roofline.depth_variants`) of some cells at their full shape and
keeps each variant's collectives and weight, whose weighted sum is the
composed count. Either writes one JSON file. `--src` names the `src`
directory of the tree to trace (this checkout's by default), so that a
parent commit unpacked beside it can be traced with the same script:

  python tests/_dryrun_moves.py moves --archs whisper-large-v3 \\
      --device cpu --out moves.json [--src DIR]
  python tests/_dryrun_moves.py variants --cells qwen1.5-4b:train_4k \\
      --device cuda --out variants.json [--src DIR]

Run each in a process of its own: the dry run's fake process group is the
process's default group.
"""
import argparse
import collections
import json
import os
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
    ap.add_argument("mode", choices=("moves", "variants"))
    ap.add_argument("--archs", default="", help="moves: comma-separated")
    ap.add_argument("--cells", default="",
                    help="variants: comma-separated arch:shape")
    ap.add_argument("--device", default="cpu", help="cpu or cuda mesh")
    ap.add_argument("--src", default=os.path.join(REPO, "src"))
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if args.mode == "moves":
        out = trace_moves(args.archs.split(","), args.device)
    else:
        out = trace_variants([tuple(c.split(":"))
                              for c in args.cells.split(",")], args.device)
    out.update(torch=torch.__version__, device=args.device, src=args.src)
    with open(args.out, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
