"""Markdown tables of the dry run and the roofline from the records under
results/torch/ (port of `repro.launch.report`).

  PYTHONPATH=src python -m repro_torch.launch.report [--section dryrun|roofline]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List, Optional, Sequence

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "results", "torch")

_SHAPE_KIND = {"train_4k": "train", "prefill_32k": "prefill",
               "decode_32k": "decode", "long_500k": "decode"}
# the JAX table's one-line levers, by (dominant term, shape kind)
LEVERS = {
    ("memory", "train"): "cut activation materializations (fuse QKV, "
                         "bf16 norm internals, bigger attn chunks)",
    ("memory", "decode"): "quantize the KV cache (int8) and fold "
                          "valid-len masking into fewer passes",
    ("memory", "prefill"): "larger attention chunks; bf16 intermediates",
    ("collective", "train"): "shard activations 2D / reduce-scatter "
                             "instead of all-reduce; overlap with compute",
    ("collective", "decode"): "keep decode TP-local (replicate small "
                              "caches) to remove per-step all-gathers",
    ("compute", "train"): "drop remat recompute on cheap layers; "
                          "herded perforation where error budget allows",
    ("compute", "decode"): "TAF layer skipping (the paper's technique)",
    ("compute", "prefill"): "herded KV-block perforation",
}


def load(subdir: str, results: Optional[str] = None) -> List[dict]:
    recs = []
    for p in sorted(glob.glob(os.path.join(results or RESULTS, subdir,
                                           "*.json"))):
        with open(p) as f:
            recs.append(json.load(f))
    return recs


def _gib(b):
    return b / 2 ** 30


def dryrun_table(results: Optional[str] = None) -> str:
    out = ["| arch | shape | mesh | status | mem/dev GiB | fits 80 GB | "
           "GFLOP/dev | coll MB/dev | collectives | trace s |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in load("dryrun", results):
        if r["status"] == "ok":
            colls = ", ".join(f"{k}:{v}" for k, v in sorted(
                r["collectives"]["counts"].items()))
            out.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | "
                f"{_gib(r['per_device_bytes']):.2f} | "
                f"{'yes' if r['fits'] else 'no'} | "
                f"{r['hlo_flops_per_device'] / 1e9:.1f} | "
                f"{r['collectives']['total_bytes_per_device'] / 1e6:.1f} | "
                f"{colls} | {r['compile_s']} |")
        else:
            reason = r.get("reason", r.get("error", ""))[:60]
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                       f"{r['status']} | — | — | — | — | {reason} | — |")
    out.append("")
    out.append("Full depth: the port traces every layer (no scan-form "
               "artifact).")
    return "\n".join(out)


def roofline_table(tag: str = "baseline",
                   results: Optional[str] = None) -> str:
    out = ["| arch | shape | compute s | memory s | collective s | "
           "dominant | roofline frac | MODEL/counted flops | one-line "
           "lever |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in load("roofline", results):
        if r.get("tag") != tag:
            continue
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                       f"{r.get('reason', r['status'])[:40]} | — | — | — |")
            continue
        lever = LEVERS.get((r["dominant"], _SHAPE_KIND.get(r["shape"], "")),
                           "")
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3g} | "
            f"{r['memory_s']:.3g} | {r['collective_s']:.3g} | "
            f"{r['dominant']} | {r['roofline_fraction']:.3f} | "
            f"{r['useful_flops_ratio']:.2f} | {lever} |")
    return "\n".join(out)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--section", default="all")
    ap.add_argument("--tag", default="baseline")
    args = ap.parse_args(argv)
    if args.section in ("all", "dryrun"):
        print("### Dry-run matrix\n")
        print(dryrun_table())
        print()
    if args.section in ("all", "roofline"):
        print(f"### Roofline ({args.tag})\n")
        print(roofline_table(args.tag))


if __name__ == "__main__":
    main()
