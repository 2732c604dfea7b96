"""Roofline analysis of the dry run's per-device counts on the H100 (port
of `repro.launch.roofline`).

Three terms per cell, from `launch.dryrun.lower_cell`'s full-depth count
against the `h100` profile of `analysis.machine`:

  compute_s    = tensor-core FLOPs / 989e12 + other FLOPs / 67e12
                 (bf16 / fp16 products on the tensor cores; everything
                 else, float32 products included, at the float32 rate)
  memory_s     = bytes per device / 3.35e12 (HBM3)
  collective_s = sum over mesh axes of that axis's collective bytes over
                 the links it crosses: NVLink, 450 GB/s, when the axis
                 stays inside one 8-card node, else InfiniBand, 50 GB/s a
                 card (`collective_links` says which each axis used)

`bound_s` is the largest. The JAX record's keys are kept. `memory_adj_s`
equals `memory_s`: the JAX package subtracts the converts XLA's CPU
backend leaves in (`runtime.hlo.convert_bytes`), but on the card an eager
cast is a kernel that moves its bytes. No composition from small-depth
lowerings is needed: the dry run traces every layer (see `launch.dryrun`).

Usage:
  python -m repro_torch.launch.roofline --arch qwen3-1.7b --shape train_4k
      [--multi-pod] [--record] [--device cpu] [--results-dir D]
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, Optional, Sequence, Union

from .. import device as device_mod
from ..analysis.machine import INTERNODE_BW, TENSOR_CORE_FLOPS, get_machine
from ..configs import SHAPES, get_config, shape_applicable
from ..configs.base import ModelConfig, ShapeConfig
from . import dryrun

MACHINE = get_machine("h100")
TENSOR_CORE_PEAK = TENSOR_CORE_FLOPS[MACHINE.name]   # 989 TFLOP/s
INTERNODE = INTERNODE_BW[MACHINE.name]               # 50 GB/s a card

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "torch", "roofline")


def model_flops(cfg: ModelConfig, shape: Union[str, ShapeConfig]) -> float:
    """MODEL_FLOPS: 6*N*D train (fwd+bwd), 2*N*D forward-only (N =
    active params, D = tokens; a decode step is one token a sequence)."""
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


def terms(rec: Dict[str, Any]) -> Dict[str, Any]:
    """The roofline terms of one dry-run record."""
    fl = rec["flops_by_class"]
    compute_s = (fl["tensor_core"] / TENSOR_CORE_PEAK
                 + fl["float32"] / MACHINE.peak_flops)
    memory_s = rec["hlo_bytes_per_device"] / MACHINE.hbm_bw
    coll = rec["collectives"]
    # a group outside the mesh's axes (none so far) is taken across nodes
    # when the mesh spans more than one
    other = "infiniband" if rec["chips"] > dryrun.NODE_CARDS else "nvlink"
    links = {}
    for axis, b in coll["bytes_by_axis"].items():
        link = coll["links"].get(axis, other)
        links[axis] = {"link": link, "bytes": b,
                       "bw": MACHINE.ici_bw if link == "nvlink"
                       else INTERNODE}
    collective_s = sum(v["bytes"] / v["bw"] for v in links.values())
    bound = max(compute_s, memory_s, collective_s)
    dominant = max((("compute", compute_s), ("memory", memory_s),
                    ("collective", collective_s)), key=lambda kv: kv[1])[0]
    return {"compute_s": compute_s, "memory_s": memory_s,
            "memory_adj_s": memory_s, "collective_s": collective_s,
            "collective_links": links, "dominant": dominant,
            "bound_s": bound}


def analyze(arch: str, shape_name: str, cfg: Optional[ModelConfig] = None,
            tag: str = "baseline", *, shape: Optional[ShapeConfig] = None,
            multi_pod: bool = False,
            mesh_shape: Optional[Dict[str, int]] = None, device=None,
            record: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The roofline record of one cell (the single-pod mesh unless
    `multi_pod` or `mesh_shape` says otherwise); `record` reuses a dry-run
    record of the same cell instead of tracing it again."""
    cfg = cfg if cfg is not None else get_config(arch)
    shape = shape if shape is not None else SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skipped",
                "reason": reason, "tag": tag}
    rec = record or dryrun.lower_cell(arch, shape_name, multi_pod, cfg,
                                      shape=shape, mesh_shape=mesh_shape,
                                      device=device)
    t = terms(rec)
    mf = model_flops(cfg, shape)
    flops = rec["hlo_flops_per_device"]
    out = {"arch": arch, "shape": shape_name, "tag": tag, "status": "ok",
           "chips": rec["chips"], "mesh": rec["mesh"],
           "machine": MACHINE.name,
           "flops_per_device": flops,
           "bytes_per_device": rec["hlo_bytes_per_device"],
           "coll_bytes_per_device":
               rec["collectives"]["total_bytes_per_device"],
           "flops_by_class": rec["flops_by_class"]}
    out.update(t)
    out.update({
        "model_flops": mf,
        "useful_flops_ratio": mf / max(flops * rec["chips"], 1.0),
        "roofline_fraction": t["compute_s"] / max(t["bound_s"], 1e-30),
        "per_device_bytes": rec["per_device_bytes"],
        "fits": rec["fits"],
        "detail": rec["detail"],
    })
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--device", default="cuda",
                    help="the dry run's mesh device type: cuda or cpu")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2x16x16 mesh (16x16 otherwise)")
    ap.add_argument("--results-dir", default=None,
                    help="records go to <dir>/roofline/ (and <dir>/dryrun/ "
                    "with --record); results/torch/ by default")
    ap.add_argument("--record", action="store_true",
                    help="also write the cell's dry-run record")
    args = ap.parse_args(argv)
    device_mod.resolve(args.device)
    results = args.results_dir or os.path.dirname(RESULTS_DIR)
    mesh = "2x16x16" if args.multi_pod else "16x16"
    dry = dryrun.lower_cell(args.arch, args.shape, args.multi_pod,
                            device=args.device)
    rec = analyze(args.arch, args.shape, tag=args.tag,
                  record=dry if dry["status"] == "ok" else None)
    rec["mesh"] = mesh
    outs = [("roofline", f"{args.arch}__{args.shape}__{mesh}__{args.tag}",
             rec)]
    if args.record:
        outs.append(("dryrun", f"{args.arch}__{args.shape}__{mesh}", dry))
    for sub, name, doc in outs:
        os.makedirs(os.path.join(results, sub), exist_ok=True)
        with open(os.path.join(results, sub, name + ".json"), "w") as f:
            json.dump(doc, f, indent=1)
    print(json.dumps(rec, indent=1))
    return rec


if __name__ == "__main__":
    main()
