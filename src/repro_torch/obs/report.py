"""`python -m repro_torch.obs.report <file.json>` -- render an obs artifact
into a human-readable summary (a copy of `repro.obs.report`, pure Python).

Accepts either artifact the layer produces:

  * a Chrome/Perfetto trace (`{"traceEvents": [...]}`, as written by
    `Tracer.save()` / `repro_torch.benchmarks.run --trace`): prints a top-k table
    of span names by total duration, final counter values, instant-event
    counts, and (with `--timeline`) the first N spans as an indented
    wall-clock timeline;
  * a `BENCH_*.json` with an embedded `{"obs": {"metrics": ...}}` stamp:
    prints the counters/gauges/histogram summaries.

For interactive digging, load the trace file in https://ui.perfetto.dev
instead -- this CLI is the terminal-grade view.
"""
from __future__ import annotations

import argparse
import json
from collections import Counter as _TallyCounter
from typing import Dict, List


def _fmt_us(us: float) -> str:
    if us >= 1e6:
        return f"{us / 1e6:.3f}s"
    if us >= 1e3:
        return f"{us / 1e3:.3f}ms"
    return f"{us:.1f}us"


def summarize_trace(doc: Dict, top: int = 15) -> List[str]:
    events = doc.get("traceEvents", [])
    spans = [e for e in events if e.get("ph") == "X"]
    instants = [e for e in events if e.get("ph") == "i"]
    counters = [e for e in events if e.get("ph") == "C"]

    lines = [f"trace: {len(spans)} spans, {len(instants)} events, "
             f"{len(counters)} counter samples"]

    if spans:
        total: Dict[str, float] = {}
        calls: Dict[str, int] = {}
        for e in spans:
            total[e["name"]] = total.get(e["name"], 0.0) + e.get("dur", 0.0)
            calls[e["name"]] = calls.get(e["name"], 0) + 1
        lines.append("")
        lines.append(f"top {min(top, len(total))} spans by total time:")
        lines.append(f"  {'name':<36} {'calls':>6} {'total':>10} {'mean':>10}")
        for name, dur in sorted(total.items(), key=lambda kv: -kv[1])[:top]:
            n = calls[name]
            lines.append(f"  {name:<36} {n:>6} {_fmt_us(dur):>10} "
                         f"{_fmt_us(dur / n):>10}")

    if counters:
        finals: Dict[str, float] = {}
        for e in counters:  # samples are cumulative; last one wins
            finals[e["name"]] = e.get("args", {}).get("value", 0.0)
        lines.append("")
        lines.append("counters (final):")
        for name in sorted(finals):
            lines.append(f"  {name:<36} {finals[name]:g}")

    if instants:
        tally = _TallyCounter(e["name"] for e in instants)
        lines.append("")
        lines.append("events:")
        for name, n in tally.most_common():
            lines.append(f"  {name:<36} {n}")
    return lines


def timeline(doc: Dict, limit: int = 40) -> List[str]:
    spans = sorted((e for e in doc.get("traceEvents", [])
                    if e.get("ph") == "X"), key=lambda e: e.get("ts", 0.0))
    lines = [f"timeline (first {min(limit, len(spans))} of {len(spans)} "
             f"spans):"]
    # Indent by how many earlier spans are still open at this start time.
    open_ends: List[float] = []
    for e in spans[:limit]:
        ts, dur = e.get("ts", 0.0), e.get("dur", 0.0)
        open_ends = [t for t in open_ends if t > ts]
        depth = len(open_ends)
        open_ends.append(ts + dur)
        lines.append(f"  {_fmt_us(ts):>10}  {'  ' * depth}{e['name']} "
                     f"[{_fmt_us(dur)}]")
    return lines


def summarize_metrics(snap: Dict) -> List[str]:
    lines = []
    if snap.get("counters"):
        lines.append("counters:")
        for name, v in snap["counters"].items():
            lines.append(f"  {name:<36} {v:g}")
    if snap.get("gauges"):
        lines.append("gauges:")
        for name, v in snap["gauges"].items():
            lines.append(f"  {name:<36} {v:g}")
    if snap.get("histograms"):
        lines.append("histograms:")
        for name, h in snap["histograms"].items():
            mean = h.get("mean")
            p50, p99 = h.get("p50"), h.get("p99")
            lines.append(
                f"  {name:<36} n={h.get('count', 0)}"
                + (f" mean={mean:.6g}" if mean is not None else "")
                + (f" p50={p50:.6g}" if p50 is not None else "")
                + (f" p99={p99:.6g}" if p99 is not None else ""))
    return lines or ["(no metrics)"]


def render(doc: Dict, top: int = 15, show_timeline: bool = False,
           timeline_limit: int = 40) -> str:
    lines: List[str] = []
    if "traceEvents" in doc:
        lines += summarize_trace(doc, top=top)
        if show_timeline:
            lines.append("")
            lines += timeline(doc, limit=timeline_limit)
    elif "obs" in doc:
        lines.append("embedded obs metrics stamp "
                     f"(schema {doc['obs'].get('schema')}):")
        lines += summarize_metrics(doc["obs"].get("metrics", {}))
    elif "counters" in doc or "histograms" in doc:
        lines += summarize_metrics(doc)
    else:
        lines.append("no obs data found (expected traceEvents or an "
                     "'obs' stamp)")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Summarize an obs trace or BENCH metrics stamp.")
    ap.add_argument("path", help="trace JSON or BENCH_*.json")
    ap.add_argument("--top", type=int, default=15,
                    help="rows in the top-spans table")
    ap.add_argument("--timeline", action="store_true",
                    help="also print a wall-clock span timeline")
    ap.add_argument("--timeline-limit", type=int, default=40)
    args = ap.parse_args(argv)
    with open(args.path) as f:
        doc = json.load(f)
    print(render(doc, top=args.top, show_timeline=args.timeline,
                 timeline_limit=args.timeline_limit))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
