"""The dry-run and roofline records as driver rows (port of
`benchmarks/roofline_table.py`): a count of results/torch/dryrun/*.json by
status, and one row per ok record of results/torch/roofline/*.json
(written by `launch.dryrun` / `launch.roofline` / `launch.roofline_all`).
"""
from __future__ import annotations

import os
from typing import Optional

from ..launch import report as report_mod


def main(report, results_dir: Optional[str] = None):
    results = results_dir or report_mod.RESULTS
    dr = report_mod.load("dryrun", results)
    n = {s: sum(r.get("status") == s for r in dr)
         for s in ("ok", "skipped", "FAILED")}
    report("dryrun_matrix", f"{len(dr)}",
           f"ok={n['ok']},skipped={n['skipped']},failed={n['FAILED']}")
    rows = []
    for rec in report_mod.load("roofline", results):
        if rec.get("status") != "ok":
            continue
        report("roofline",
               f"{rec['arch']}/{rec['shape']}/{rec.get('tag', 'baseline')}",
               f"dominant={rec['dominant']},"
               f"compute={rec['compute_s']:.3g}s,"
               f"memory={rec['memory_s']:.3g}s,"
               f"coll={rec['collective_s']:.3g}s,"
               f"frac={rec['roofline_fraction']:.3f}")
        rows.append(rec)
    return {"dryrun": n, "roofline": len(rows),
            "results": os.path.abspath(results)}
