"""Roofline analysis of the dry run's per-device counts on the H100 (port
of `repro.launch.roofline`).

Three terms per cell, from the dry run's per-device counts at full depth
(`composed_cost`) against the `h100` profile of `analysis.machine`:

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
cast is a kernel that moves its bytes.

Full depth is composed from small-depth traces, as the JAX roofline
composes it (`composed_cost`): the variants of `depth_variants` (JAX's,
each with one more layer of every type) are traced by `launch.dryrun`,
and every count of the record that is a base plus a fixed amount per layer
of each type -- FLOPs, bytes, collectives by kind and axis, argument bytes
-- is composed as base + sum over types of layers x marginal. The port's
layers of one type are identical Python calls, so these compose exactly
(`composition_check`). The peak of live bytes is composed phase by phase
(`_composed_peak`): exact while the same op holds each phase's peak at
every depth, below the truth where it moves with depth, and bounded from
above; `fits` is True under the bound, False at or over the composed peak
and None between. `--full-depth` traces the full depth too, takes a
device's memory and `fits` from it and records the composition held to
it (`roofline_all` passes it on). JAX composes because XLA counts a
`while` body once; here the roofline's terms cost a few layers' traces
instead of the full depth's (a 32k prefill runs 64 x 64 attention chunk
pairs a layer, each op evaluated on meta tensors).

Usage:
  python -m repro_torch.launch.roofline --arch qwen3-1.7b --shape train_4k
      [--multi-pod] [--record] [--device cpu] [--results-dir D]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

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


def depth_variants(cfg: ModelConfig) -> Tuple[List[Tuple[ModelConfig, int]],
                                              Dict[str, Any]]:
    """The small-depth variants of `cfg` whose weighted sum is the full
    depth, and the names JAX's `detail` gives the marginals.

    JAX's variants (1 and 2 layers; (dense, MoE) = (1, 1), (2, 1), (1, 2);
    the hybrid's period, twice it and period + 1) each with one more layer
    of every type: DTensor's eager layouts settle only after a model's
    first layer of a type (its input comes from the embedding, not from a
    layer), so layers from the second on are alike. A count that is a base
    plus a fixed amount per layer of each type is then, at full depth,
    `a + n_1 (b - a) + n_2 (c - a)` with n_i the layers beyond the variant
    `a`'s: dense and every other family a = 2, b = 3 layers; MoE with
    leading dense layers a = (2, 2), b = (3, 2), c = (2, 3). The hybrid's
    tail of mixers is traced whole (a = two groups and the tail, b = three
    groups and the tail): the groups' mixers are recomputed in backward
    and the tail's are not, so a tail composed from one mixer moves the
    step's peak of live bytes. Its third variant, weighted 0, differs from
    a by one tail mixer, for JAX's `mamba_marginal`. Returns ([(variant,
    weight)], {marginal name: (variant index, variant index)} plus the
    counts JAX's `detail` names)."""
    def variant(n_layers, **kw):
        return dataclasses.replace(cfg, n_layers=n_layers, **kw)

    n = cfg.n_layers
    if cfg.family == "moe" and cfg.moe.n_dense_layers > 0:
        nd = cfg.moe.n_dense_layers
        nm = n - nd

        def moe(n_dense, n_moe):
            return variant(n_dense + n_moe, moe=dataclasses.replace(
                cfg.moe, n_dense_layers=n_dense))
        out = [(moe(2, 2), 5 - nd - nm), (moe(3, 2), nd - 2),
               (moe(2, 3), nm - 2)]
        names = {"dense_marginal": (1, 0), "moe_marginal": (2, 0),
                 "n_dense": nd, "n_moe": nm}
    elif cfg.family == "hybrid":
        period = cfg.hybrid.attn_period
        groups, tail = n // period, n % period
        one = tail - 1 if tail else 1
        out = [(variant(2 * period + tail), 3 - groups),
               (variant(3 * period + tail), groups - 2),
               (variant(2 * period + one), 0)]
        names = {"group_marginal": (1, 0),
                 "mamba_marginal": (0, 2) if tail else (2, 0),
                 "n_groups": groups, "tail": tail}
    else:
        out = [(variant(2), 3 - n), (variant(3), n - 2)]
        names = {"layer_marginal": (1, 0), "n_layers": n}
    return out, names


def _weighted(values: Sequence, weights: Sequence[int]):
    """The weighted sum of numbers, or of dicts of numbers key by key
    (a key missing from one is 0 there; keys that sum to 0 are dropped)."""
    if isinstance(values[0], dict):
        keys = sorted({k for v in values for k in v})
        out = {k: _weighted([v.get(k, 0) for v in values], weights)
               for k in keys}
        return {k: v for k, v in out.items() if v}
    return sum(w * v for v, w in zip(values, weights))


# the dry-run record's counts that compose (the rest is the cell's own)
_COMPOSED = ("hlo_flops_per_device", "hlo_bytes_per_device",
             "dot_flops_per_device", "flops_by_class", "ops")


def _composed_peak(recs: Sequence[Dict[str, Any]], weights: Sequence[int]
                   ) -> Tuple[Dict[str, int], int, int]:
    """(each phase's peak of live bytes composed, the largest of them, an
    upper bound) at full depth from the variants' records.

    A phase's peak is the largest live total over the phase's ops, each a
    base plus a fixed amount per layer (a layer's saved activations before
    its backward, its gradients after), so the peak is the largest of
    lines in the depth: convex, and composed from two depths it is exact
    while one line stays the largest, and below the true peak where a
    steeper one overtakes it at full depth (a backward whose peak moves
    from its first layers, activations, to its last, gradients). A line
    grows a layer by that layer's saved activations or by its gradients
    (a layer's backward frees the one and makes the other), which the
    forward's and the gradients' peaks grow by, so no line grows faster
    than the largest growth of a phase's peak between the variants, nor
    starts above the base variant's largest peak: that growth from that
    peak bounds the peak from above."""
    phases = {ph: _weighted([r["memory"]["temp_by_phase"][ph]
                             for r in recs], weights)
              for ph in dryrun.PHASES}
    base = recs[0]["memory"]["temp_by_phase"]
    bound = max(base.values())
    for r, w in zip(recs[1:], weights[1:]):
        step = [r["memory"]["temp_by_phase"][ph] - base[ph]
                for ph in dryrun.PHASES]
        bound += w * (max(step) if w > 0 else min(step))
    return phases, max(phases.values()), max(bound, max(phases.values()))


def fits(per_device: float, per_device_max: float) -> Optional[bool]:
    """Whether a device's memory fits one H100: True under the upper bound,
    False at or over the composed peak (which is no more than the true
    one), None between the two."""
    if per_device_max < dryrun.HBM_BYTES:
        return True
    return False if per_device >= dryrun.HBM_BYTES else None


def composed_cost(arch: str, shape_name: str,
                  cfg: Optional[ModelConfig] = None, *,
                  shape: Optional[ShapeConfig] = None,
                  multi_pod: bool = False,
                  mesh_shape: Optional[Dict[str, int]] = None,
                  device=None) -> Dict[str, Any]:
    """The cell's dry-run record at full depth, composed from the traces
    of `depth_variants` (`launch.dryrun.lower_cell` on each): the record's
    keys, each count the variants' weighted sum, `per_device_bytes` and
    `per_device_bytes_max` the composed peak and its upper bound
    (`_composed_peak`), `fits` from both (`fits`), and JAX's `detail`
    (each layer type's marginal FLOPs and the layer counts) with
    `variants`, the (n_layers, weight) pairs traced."""
    cfg = cfg if cfg is not None else get_config(arch)
    variants, names = depth_variants(cfg)
    recs = [dryrun.lower_cell(arch, shape_name, multi_pod, v, shape=shape,
                              mesh_shape=mesh_shape, device=device)
            for v, _ in variants]
    weights = [w for _, w in variants]
    out = dict(recs[0])
    if out["status"] != "ok":
        return out
    for key in _COMPOSED:
        out[key] = _weighted([r[key] for r in recs], weights)
    out["memory"] = dict(_weighted([
        {k: v for k, v in r["memory"].items() if k != "peak_by_op"}
        for r in recs], weights))
    for key in ("argument_bytes", "output_bytes", "alias_bytes",
                "code_bytes"):
        out["memory"].setdefault(key, 0)
    # what holds the peak is read off the deepest variant's trace
    deep = max(range(len(recs)), key=lambda i: variants[i][0].n_layers)
    out["memory"]["peak_by_op"] = recs[deep]["memory"].get("peak_by_op", [])
    out["memory"]["peak_by_op_layers"] = variants[deep][0].n_layers
    phases, temp, temp_max = _composed_peak(recs, weights)
    out["memory"].update(temp_by_phase=phases, temp_bytes=temp,
                         temp_bytes_max=temp_max)
    coll = {k: _weighted([r["collectives"][k] for r in recs], weights)
            for k in ("counts", "bytes_by_kind", "bytes_by_axis")}
    coll["links"] = recs[0]["collectives"]["links"]
    coll["total_bytes_per_device"] = sum(coll["bytes_by_kind"].values())
    coll["by_shape"] = dryrun.shape_rows(_weighted([{
        (r["phase"], r["kind"], r["axis"], r["dtype"], tuple(r["shape"])):
            r["count"] for r in rec["collectives"].get("by_shape", ())}
        for rec in recs], weights))
    out["collectives"] = coll
    args = out["memory"]["argument_bytes"]
    out["per_device_bytes"] = args + temp
    out["per_device_bytes_max"] = args + temp_max
    out["fits"] = fits(out["per_device_bytes"], out["per_device_bytes_max"])
    out["lower_s"] = round(sum(r["lower_s"] for r in recs), 2)
    out["compile_s"] = round(sum(r["compile_s"] for r in recs), 2)
    out["params"] = cfg.param_count()
    out["active_params"] = cfg.active_param_count()
    flops = [r["hlo_flops_per_device"] for r in recs]
    out["detail"] = {
        (k + "_flops" if isinstance(v, tuple) else k):
            (flops[v[0]] - flops[v[1]] if isinstance(v, tuple) else v)
        for k, v in names.items()}
    out["detail"]["variants"] = [[v.n_layers, w] for v, w in variants]
    return out


def composition_check(composed: Dict[str, Any],
                      full: Dict[str, Any]) -> Dict[str, Any]:
    """A composed record held to the full-depth trace of the same cell:
    whether FLOPs (by class and of the products) and collectives (counts
    and bytes by kind and axis) are equal, and the relative differences of
    bytes, argument bytes and per-device memory, and whether the full
    trace's memory lies between the composed peak and its bound."""
    def rel(a, b):
        return abs(a - b) / max(abs(b), 1.0)
    cc, fc = composed["collectives"], full["collectives"]
    return {
        "counts_equal": all(composed[k] == full[k] for k in
                            ("hlo_flops_per_device", "dot_flops_per_device",
                             "flops_by_class")),
        "collectives_equal": all(cc[k] == fc[k] for k in
                                 ("counts", "bytes_by_kind",
                                  "bytes_by_axis")),
        "bytes_rel": rel(composed["hlo_bytes_per_device"],
                         full["hlo_bytes_per_device"]),
        "argument_rel": rel(composed["memory"]["argument_bytes"],
                            full["memory"]["argument_bytes"]),
        "memory_rel": rel(composed["per_device_bytes"],
                          full["per_device_bytes"]),
        "memory_bounded": (composed["per_device_bytes"]
                           <= full["per_device_bytes"]
                           <= composed["per_device_bytes_max"]),
    }


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
    `multi_pod` or `mesh_shape` says otherwise), from its `composed_cost`;
    `record` reuses a dry-run record of the same cell (composed or traced
    at full depth) instead of tracing it again."""
    cfg = cfg if cfg is not None else get_config(arch)
    shape = shape if shape is not None else SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skipped",
                "reason": reason, "tag": tag}
    rec = record or composed_cost(arch, shape_name, cfg, shape=shape,
                                  multi_pod=multi_pod,
                                  mesh_shape=mesh_shape, device=device)
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
        "per_device_bytes_max": rec.get("per_device_bytes_max",
                                        rec["per_device_bytes"]),
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
    ap.add_argument("--full-depth", action="store_true",
                    help="also trace the cell at full depth: the record "
                    "and a device's memory are that trace's, and the "
                    "composition is held to it")
    args = ap.parse_args(argv)
    device_mod.resolve(args.device)
    results = args.results_dir or os.path.dirname(RESULTS_DIR)
    mesh = "2x16x16" if args.multi_pod else "16x16"
    comp = composed_cost(args.arch, args.shape, multi_pod=args.multi_pod,
                         device=args.device)
    rec = analyze(args.arch, args.shape, tag=args.tag,
                  record=comp if comp["status"] == "ok" else None)
    dry = comp
    if args.full_depth:
        # the full-depth trace's peak of live bytes is exact
        dry = dryrun.lower_cell(args.arch, args.shape, args.multi_pod,
                                device=args.device)
        if rec["status"] == "ok":
            rec.update(per_device_bytes=dry["per_device_bytes"],
                       per_device_bytes_max=dry["per_device_bytes"],
                       fits=dry["fits"],
                       composition=composition_check(comp, dry))
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
