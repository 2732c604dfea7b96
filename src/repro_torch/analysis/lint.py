"""approxlint CLI -- lint for approximation regions, kernels, QoS ladders
and the serving data plane (port of `repro.analysis.lint`).

    PYTHONPATH=src python -m repro_torch.analysis.lint \
        --apps all --policies 'artifacts/policies/*.json' --format text \
        [--device cpu]

Exit codes: 0 = clean (below --fail-on), 1 = findings at/above --fail-on,
2 = a rule crashed (the lint itself is broken -- never mistake that for a
clean tree).

`--device` is where the targets run: cuda (the default; it raises with no
card) or cpu. On the card the kernels' knobs are asked of the CUDA kernels
themselves (CUDA-graph replay); on the CPU of the launch operands their
wrappers build (`analysis.targets`).

The allowlist (`.approxlint.json`, discovered upward from the CWD or named
with --allowlist) records INTENTIONAL findings with reasons; allowlisted
findings are reported but do not gate. The port reads the repo root's
file, the JAX package's.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional, Sequence, Tuple

from .. import device as device_mod
from . import rules as rules_mod
from .findings import Allowlist, Report, Severity, default_allowlist_path
from .targets import APP_NAMES


def run_lint(*, apps: Sequence[str] = APP_NAMES,
             policies: Sequence[str] = (),
             rules: Sequence[str] = rules_mod.RULE_IDS,
             allowlist: Optional[Allowlist] = None,
             model_taf: Optional[Tuple[int, int]] = None,
             device=None) -> Report:
    """Programmatic entry point (the CLI, the harness / engine lint hooks
    and the tests all come through here), with the targets on `device`
    (cuda unless "cpu" is asked for). Rule crashes are captured in
    `report.errors`, not raised: a broken rule must fail the lint loudly
    instead of silently checking nothing."""
    dev = str(device_mod.resolve(device))
    report = Report()
    runners = {
        "A001": lambda: rules_mod.rule_a001(apps, dev),
        "A002": lambda: rules_mod.rule_a002(apps, dev),
        "A003": lambda: rules_mod.rule_a003(apps, dev),
        "A004": lambda: rules_mod.rule_a004(policies, model_taf=model_taf),
        "A005": lambda: rules_mod.rule_a005(apps, dev),
        "A006": lambda: rules_mod.rule_a006(policies),
        "A007": lambda: rules_mod.rule_a007(apps, dev),
        "A008": lambda: rules_mod.rule_a008(apps, dev),
    }
    for rid in rules_mod.RULE_IDS:
        if rid not in rules:
            continue
        try:
            report.extend(runners[rid](), allowlist)
        except Exception as e:  # noqa: BLE001
            report.errors.append(f"{rid}: {type(e).__name__}: {e}"[:500])
    return report


def _expand_policies(patterns: Sequence[str]) -> List[str]:
    import glob
    out: List[str] = []
    for p in patterns:
        hits = sorted(glob.glob(p))
        if not hits:
            # a named-but-missing policy: A004 reports it unreadable
            out.append(p)
        out.extend(hits)
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="approxlint: static analysis for approximation "
        "regions, kernels, and QoS ladders (rules A001-A008)")
    ap.add_argument("--apps", default="all",
                    help="comma-separated target groups "
                    f"({','.join(APP_NAMES)}) or 'all'")
    ap.add_argument("--policies", nargs="*", default=[],
                    help="saved QosPolicy JSON files/globs for A004")
    ap.add_argument("--rules", default=",".join(rules_mod.RULE_IDS),
                    help="comma-separated rule ids to run")
    ap.add_argument("--format", default="text", choices=["text", "json"])
    ap.add_argument("--out", default=None,
                    help="also write the JSON report to this path")
    ap.add_argument("--allowlist", default=None,
                    help="allowlist file (default: nearest .approxlint.json)")
    ap.add_argument("--no-allowlist", action="store_true",
                    help="ignore any allowlist (report raw findings)")
    ap.add_argument("--fail-on", default="error",
                    choices=["info", "warning", "error"],
                    help="minimum severity that makes the exit code 1")
    ap.add_argument("--no-serve", action="store_true",
                    help="skip the decode/serving targets (the group that "
                    "builds a model and starts a one-rank process group)")
    ap.add_argument("--model-taf", default=None, metavar="H,P",
                    help="structural TAF params the serving model runs; "
                    "A004 cross-checks every policy's rungs against them")
    ap.add_argument("--device", default="cuda",
                    help="where the targets run: cuda (the default) or cpu")
    args = ap.parse_args(argv)

    apps = list(APP_NAMES) if args.apps == "all" else \
        [a.strip() for a in args.apps.split(",") if a.strip()]
    for a in apps:
        if a not in APP_NAMES:
            ap.error(f"unknown app group {a!r} "
                     f"(choose from: {','.join(APP_NAMES)})")
    if args.no_serve:
        apps = [a for a in apps if a != "decode"]
    rules = [r.strip().upper() for r in args.rules.split(",") if r.strip()]
    for r in rules:
        if r not in rules_mod.RULE_IDS:
            ap.error(f"unknown rule {r!r} "
                     f"(choose from: {','.join(rules_mod.RULE_IDS)})")
    model_taf = None
    if args.model_taf:
        try:
            h, p = (int(v) for v in args.model_taf.split(","))
            model_taf = (h, p)
        except ValueError:
            ap.error("--model-taf expects 'H,P' (two integers)")

    allowlist = None
    if not args.no_allowlist:
        path = args.allowlist or default_allowlist_path()
        if args.allowlist and not path:
            ap.error(f"allowlist {args.allowlist!r} not found")
        if path:
            allowlist = Allowlist.load(path)

    report = run_lint(apps=apps, policies=_expand_policies(args.policies),
                      rules=rules, allowlist=allowlist, model_taf=model_taf,
                      device=args.device)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(report.to_json(), f, indent=1)
    if args.format == "json":
        print(json.dumps(report.to_json(), indent=1))
    else:
        print(report.render_text())

    if report.errors:
        return 2
    return 1 if report.failed(Severity.parse(args.fail_on)) else 0


if __name__ == "__main__":
    sys.exit(main())
