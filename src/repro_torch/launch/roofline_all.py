"""Every (arch x shape x mesh) cell's dry-run and roofline record, each cell
in a process of its own (port of `repro.launch.roofline_all`).

  python -m repro_torch.launch.roofline_all [--device cpu] [--jobs 8]
      [--cell-timeout 900] [--single-pod] [--results-dir D] [--full-depth]

A cell's fake process group is its process's default group, so cells run
as `python -m repro_torch.launch.roofline --arch A --shape S [--multi-pod]
--record [--full-depth]` subprocesses (full depth composed from
small-depth traces, `roofline.composed_cost`; with `--full-depth` the
dry-run record and a device's memory are a full-depth trace's and the
composition is held to it), `--jobs` at a time, each stopped after
`--cell-timeout` seconds (status TIMEOUT). Records go to
<results>/dryrun/ and <results>/roofline/ (results/torch/ by default), a
cell whose roofline record exists is not traced again (its row says
`reused`), and a summary of every cell (status, per-device GiB and its
bound, fits, dominant term, bound, useful-FLOPs ratio, the composition
held to the full-depth trace) is printed and written to
<results>/roofline_all.json.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import os
import subprocess
import sys
import time
from typing import Dict, Optional, Sequence

from .. import device as device_mod
from ..configs import SHAPES, list_archs

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "results", "torch")


def _cell(arch: str, shape: str, multi: bool, device: str, results: str,
          tag: str, timeout: float, full_depth: bool) -> Dict:
    mesh = "2x16x16" if multi else "16x16"
    out = os.path.join(results, "roofline",
                       f"{arch}__{shape}__{mesh}__{tag}.json")
    t0 = time.time()
    reused = os.path.exists(out)
    if reused:
        with open(out) as f:
            rec = json.load(f)
    else:
        argv = [sys.executable, "-m", "repro_torch.launch.roofline",
                "--arch", arch, "--shape", shape, "--tag", tag,
                "--device", device, "--results-dir", results, "--record"]
        if multi:
            argv.append("--multi-pod")
        if full_depth:
            argv.append("--full-depth")
        env = dict(os.environ, OMP_NUM_THREADS="1")
        try:
            proc = subprocess.run(argv, capture_output=True, text=True,
                                  timeout=timeout, env=env)
            if proc.returncode == 0:
                with open(out) as f:
                    rec = json.load(f)
            else:
                rec = {"status": "FAILED", "error": proc.stderr[-2000:]}
        except subprocess.TimeoutExpired:
            rec = {"status": "TIMEOUT", "error": f"over {timeout} s"}
        rec.update(arch=arch, shape=shape, mesh=mesh, tag=tag)
        if rec["status"] in ("FAILED", "TIMEOUT"):
            with open(out, "w") as f:
                json.dump(rec, f, indent=1)
    ok = rec["status"] == "ok"
    return {"arch": arch, "shape": shape, "mesh": mesh,
            "status": rec["status"], "wall_s": round(time.time() - t0, 1),
            "reused": reused,
            "gib": rec["per_device_bytes"] / 2 ** 30 if ok else None,
            "gib_max": (rec.get("per_device_bytes_max",
                                rec.get("per_device_bytes")) / 2 ** 30
                        if ok else None),
            "fits": rec.get("fits"), "dominant": rec.get("dominant"),
            "bound_s": rec.get("bound_s"),
            "useful_flops_ratio": rec.get("useful_flops_ratio"),
            "composition": rec.get("composition"),
            "error": (rec.get("error") or rec.get("reason") or "")[-300:]}


def _line(row: Dict) -> str:
    if row["status"] != "ok":
        extra = row["error"][-140:]
    else:
        extra = (f"{row['gib']:.2f} GiB (at most {row['gib_max']:.2f}) "
                 f"fits={row['fits']} "
                 f"{row['dominant']} bound={row['bound_s']:.4g}s")
    if row.get("composition"):
        extra += f" composition {json.dumps(row['composition'])}"
    wall = "reused" if row["reused"] else f"{row['wall_s']:.0f}s"
    return (f"[{row['status']:7s}] {row['arch']}/{row['shape']}/"
            f"{row['mesh']} ({wall}) {extra}")


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, int]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--device", default="cuda",
                    help="the dry run's mesh device type: cuda or cpu")
    ap.add_argument("--results-dir", default=None)
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, one process each")
    ap.add_argument("--cell-timeout", type=float, default=3600.0)
    ap.add_argument("--single-pod", action="store_true",
                    help="only the 16x16 mesh")
    ap.add_argument("--full-depth", action="store_true",
                    help="also trace each cell at full depth (`roofline "
                    "--full-depth`)")
    args = ap.parse_args(argv)
    device_mod.resolve(args.device)
    results = args.results_dir or RESULTS
    for sub in ("dryrun", "roofline"):
        os.makedirs(os.path.join(results, sub), exist_ok=True)
    cells = [(a, s, m) for a in list_archs() for s in SHAPES
             for m in ((False,) if args.single_pod else (False, True))]
    rows = []
    with cf.ThreadPoolExecutor(max(args.jobs, 1)) as pool:
        futs = [pool.submit(_cell, a, s, m, args.device, results, args.tag,
                            args.cell_timeout, args.full_depth)
                for a, s, m in cells]
        for fut in cf.as_completed(futs):
            row = fut.result()
            rows.append(row)
            print(_line(row), flush=True)
    n: Dict[str, int] = {}
    for row in rows:
        n[row["status"]] = n.get(row["status"], 0) + 1
    with open(os.path.join(results, "roofline_all.json"), "w") as f:
        json.dump({"counts": n, "cells": sorted(
            rows, key=lambda r: (r["arch"], r["shape"], r["mesh"]))},
            f, indent=1)
    print(f"roofline cells done: {json.dumps(n)}")
    return n


if __name__ == "__main__":
    main()
