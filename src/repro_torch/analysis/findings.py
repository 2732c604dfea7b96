"""Typed findings, severities, allowlists, and reports for approxlint
(port of `repro.analysis.findings`: plain Python, copied).

A finding is one violated invariant at one subject. Subjects are dotted
paths naming what was analyzed ("kernels.taf_matmul.rsd_threshold",
"policy:benchmarks/policies/chat.json#rung3"), stable across runs so they
can be allowlisted. The allowlist is the mechanism for *intentional*
structural knobs: a `skip`-driven perforation kernel legitimately bakes
its kept set into the compiled program (the herded payoff), so its A001
finding is recorded with a reason instead of failing the lint.
"""
from __future__ import annotations

import dataclasses
import enum
import fnmatch
import json
import os
from typing import Dict, List, Optional, Sequence


class Severity(enum.IntEnum):
    """Ordered: gate thresholds compare with >=."""

    INFO = 10
    WARNING = 20
    ERROR = 30

    @classmethod
    def parse(cls, name: str) -> "Severity":
        try:
            return cls[name.strip().upper()]
        except KeyError:
            raise ValueError(
                f"unknown severity {name!r}; expected one of "
                f"{[s.name.lower() for s in cls]}") from None


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violated invariant.

    rule:     the rule id ("A001" .. "A008").
    severity: gate weight.
    subject:  dotted path of what was analyzed (allowlist match key).
    message:  one-line human statement of the defect.
    detail:   machine-readable evidence (trace diff excerpt, offending
              rung index, unplaced leaf path, ...).
    """

    rule: str
    severity: Severity
    subject: str
    message: str
    detail: Dict = dataclasses.field(default_factory=dict)

    @property
    def key(self) -> str:
        return f"{self.rule}:{self.subject}"

    def to_json(self) -> Dict:
        return {
            "rule": self.rule,
            "severity": self.severity.name.lower(),
            "subject": self.subject,
            "message": self.message,
            "detail": self.detail,
        }


@dataclasses.dataclass(frozen=True)
class AllowEntry:
    rule: str
    subject: str            # fnmatch pattern over Finding.subject
    reason: str = ""

    def matches(self, finding: Finding) -> bool:
        return (self.rule == finding.rule
                and fnmatch.fnmatchcase(finding.subject, self.subject))


class Allowlist:
    """Intentional-finding registry (the `.approxlint.json` file).

    Schema:

        {"version": 1,
         "allow": [{"rule": "A001",
                    "subject": "kernels.perforated_matmul.perfo",
                    "reason": "skip-driven kept set is structural"}]}

    Every entry MUST carry a reason: an allowlist without rationale decays
    into a mute button.
    """

    def __init__(self, entries: Sequence[AllowEntry] = ()):
        self.entries: List[AllowEntry] = list(entries)

    @classmethod
    def load(cls, path: str) -> "Allowlist":
        with open(path) as f:
            doc = json.load(f)
        if not isinstance(doc, dict) or "allow" not in doc:
            raise ValueError(
                f"{path}: allowlist must be an object with an 'allow' list")
        entries = []
        for i, e in enumerate(doc["allow"]):
            missing = {"rule", "subject", "reason"} - set(e)
            if missing:
                raise ValueError(
                    f"{path}: allow[{i}] is missing {sorted(missing)} "
                    "(every entry needs rule, subject, and a reason)")
            if not str(e["reason"]).strip():
                raise ValueError(
                    f"{path}: allow[{i}] has an empty reason; an "
                    "unexplained allowlist entry is a mute button")
            entries.append(AllowEntry(rule=e["rule"], subject=e["subject"],
                                      reason=e["reason"]))
        return cls(entries)

    def match(self, finding: Finding) -> Optional[AllowEntry]:
        for e in self.entries:
            if e.matches(finding):
                return e
        return None


def default_allowlist_path(start: Optional[str] = None) -> Optional[str]:
    """Walk up from `start` (default: cwd) looking for `.approxlint.json`
    -- the same discovery shape as every linter's config file."""
    cur = os.path.abspath(start or os.getcwd())
    while True:
        cand = os.path.join(cur, ".approxlint.json")
        if os.path.exists(cand):
            return cand
        parent = os.path.dirname(cur)
        if parent == cur:
            return None
        cur = parent


@dataclasses.dataclass
class Report:
    """The lint result: active findings plus the allowlisted ones (kept so
    the JSON artifact shows what was *deliberately* accepted, not just what
    failed)."""

    findings: List[Finding] = dataclasses.field(default_factory=list)
    allowlisted: List[Dict] = dataclasses.field(default_factory=list)
    errors: List[str] = dataclasses.field(default_factory=list)  # rule crashes

    def extend(self, findings: Sequence[Finding],
               allowlist: Optional[Allowlist] = None) -> None:
        for f in findings:
            entry = allowlist.match(f) if allowlist is not None else None
            if entry is not None:
                self.allowlisted.append(
                    {"finding": f.to_json(), "reason": entry.reason,
                     "pattern": entry.subject})
            else:
                self.findings.append(f)

    def count(self, at_least: Severity = Severity.INFO) -> int:
        return sum(1 for f in self.findings if f.severity >= at_least)

    def failed(self, fail_on: Severity = Severity.ERROR) -> bool:
        return bool(self.errors) or self.count(fail_on) > 0

    def to_json(self) -> Dict:
        by_rule: Dict[str, int] = {}
        for f in self.findings:
            by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
        return {
            "version": 1,
            "findings": [f.to_json() for f in self.findings],
            "allowlisted": self.allowlisted,
            "rule_errors": self.errors,
            "summary": {
                "total": len(self.findings),
                "errors": self.count(Severity.ERROR),
                "warnings": sum(1 for f in self.findings
                                if f.severity == Severity.WARNING),
                "by_rule": by_rule,
                "allowlisted": len(self.allowlisted),
            },
        }

    def render_text(self) -> str:
        lines = []
        order = {Severity.ERROR: 0, Severity.WARNING: 1, Severity.INFO: 2}
        for f in sorted(self.findings,
                        key=lambda f: (order[f.severity], f.rule, f.subject)):
            lines.append(f"{f.severity.name.lower():7s} {f.rule} "
                         f"{f.subject}: {f.message}")
            for k, v in f.detail.items():
                text = str(v)
                if len(text) > 200:
                    text = text[:200] + "..."
                lines.append(f"        {k}: {text}")
        for a in self.allowlisted:
            fj = a["finding"]
            lines.append(f"allowed {fj['rule']} {fj['subject']} "
                         f"({a['reason']})")
        for e in self.errors:
            lines.append(f"error   rule crashed: {e}")
        s = self.to_json()["summary"]
        lines.append(
            f"approxlint: {s['total']} finding(s) "
            f"({s['errors']} error, {s['warnings']} warning), "
            f"{s['allowlisted']} allowlisted")
        return "\n".join(lines)
