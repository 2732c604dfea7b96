"""approxlint as a benchmark module (port of `benchmarks/lint.py`): one
pass over every target group, reported in the driver's CSV rows.

The "measurement" is the analyzer itself -- the wall time of the full pass
plus the finding counts it produced. A non-zero error count (or a crashed
rule) is a FAIL row, and the regression gate pins the counts exactly via
the port's ``baselines/BENCH_lint.json``: a new finding OR a new allowlist
entry both show up as baseline drift and must be reviewed. With
``artifacts_dir``, the full report (every finding, every allowlisted
finding with its reason, every rule crash) goes to
``<artifacts_dir>/BENCH_lint.json``. The allowlist is the repo root's
``.approxlint.json``, the JAX package's.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional


def main(report, artifacts_dir: Optional[str] = None, device=None):
    from ..analysis.findings import Allowlist, default_allowlist_path
    from ..analysis.lint import run_lint
    from ..obs import metrics as obs_metrics

    allow_path = default_allowlist_path(os.path.dirname(__file__))
    allow = Allowlist.load(allow_path) if allow_path else None
    t0 = time.perf_counter()
    rep = run_lint(allowlist=allow, device=device)  # all groups, no policies
    us = (time.perf_counter() - t0) * 1e6

    doc = rep.to_json()
    doc["metric"] = "approxlint"
    s = doc["summary"]
    report("lint_pass", f"{us:.0f}",
           f"findings={s['total']} allowlisted={s['allowlisted']}")
    for rule, n in sorted(s["by_rule"].items()):
        report(f"lint_{rule}", f"{us:.0f}", f"n={n}")
    if rep.errors:
        report("lint_rule_crash", "FAIL", "; ".join(rep.errors)[:200])
    if s["errors"]:
        subjects = ", ".join(sorted(
            f"{f['rule']} {f['subject']}" for f in doc["findings"]
            if f["severity"] == "error"))
        report("lint_errors", "FAIL", subjects[:200])

    if artifacts_dir:
        os.makedirs(artifacts_dir, exist_ok=True)
        out = os.path.join(artifacts_dir, "BENCH_lint.json")
        with open(out, "w") as f:
            json.dump(obs_metrics.stamp(doc), f, indent=1, sort_keys=True)
        report("lint_artifact", f"{us:.0f}", out)
    return doc
