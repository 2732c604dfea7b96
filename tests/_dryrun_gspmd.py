"""Shared code of `tests/test_torch_dryrun_gspmd_*.py`: the port's dry run
held against the program GSPMD compiles for the same cell.

JAX's `repro.launch.dryrun.lower_cell` runs in a subprocess with 512 host
devices (as `_JAX_CELL` in `test_torch_roofline.py`), on the config cut to
a few layers with `unroll_layers=True`, and its compiled HLO text is kept.
XLA's count (`repro.runtime.hlo.collective_stats`) takes each `while`
body once; `weighted_collectives` weights each collective by the product
of the `known_trip_count`s of the loops around it, so the SSD chunk loop
and the attention chunk loops count every trip, as the port's trace does
(its loops are Python loops, traced trip by trip). The port's
`lower_cell(..., device="cpu")` runs in a subprocess of its own on the same
cut (its fake process group is the process's default group). Both count
the result bytes of each collective a device runs.

`check` holds every cell of `CELLS` to both bounds: the port's total
bytes to `TOTAL_RATIO` of GSPMD's, and its all-gathers over `model` to
`GATHER_RATIO` of GSPMD's all-gathers and collective-permutes.
`python tests/_dryrun_gspmd.py` prints the readings of every cell, and of
`MORE_CELLS` (the other train cells, read but not asserted).
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from typing import Dict, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))

# (arch, shape, layers) of each cell, all on the 16x16 mesh
CELLS = {
    "zamba2_train": ("zamba2-7b", "train_4k", 6),
    "zamba2_prefill": ("zamba2-7b", "prefill_32k", 6),
    "qwen3_train": ("qwen3-1.7b", "train_4k", 2),
    "qwen15_train": ("qwen1.5-4b", "train_4k", 2),
    "olmoe_train": ("olmoe-1b-7b", "train_4k", 2),
    "whisper_train": ("whisper-large-v3", "train_4k", 2),
    "rwkv6_train": ("rwkv6-1.6b", "train_4k", 2),
    "starcoder2_train": ("starcoder2-3b", "train_4k", 2),
    "pixtral_train": ("pixtral-12b", "train_4k", 2),
}
# read by `python tests/_dryrun_gspmd.py` beside CELLS, not asserted
MORE_CELLS = {
    "deepseek7b_train": ("deepseek-7b", "train_4k", 2),
}
# the port's collective bytes at most this many times GSPMD's
TOTAL_RATIO = 1.5
# the port's all-gathers over `model` at most this many times GSPMD's
# all-gathers and collective-permutes (zamba2's projection, heads that the
# ranks do not divide, RWKV6's decay and norm)
GATHER_RATIO = 2.0

# `%name (params) -> type {` opens a computation (`ENTRY %name ...` the
# entry); a line `}` closes it
_COMP = re.compile(r"^(ENTRY\s+)?%?([\w.\-]+)\s*\(.*\)\s*->.*\{\s*$")
_CALLEE = re.compile(r"\b(?:to_apply|calls|body|condition|true_computation|"
                     r"false_computation)=%?([\w.\-]+)")
_BRANCHES = re.compile(r"branch_computations=\{([^}]*)\}")
_TRIPS = re.compile(r'"known_trip_count"\s*:\s*\{\s*"n"\s*:\s*"(\d+)"')


def computations(text: str) -> Tuple[str, Dict[str, list]]:
    """(the entry's name, {computation name: its lines})."""
    comps: Dict[str, list] = {}
    entry, cur = None, None
    for line in text.splitlines():
        m = _COMP.match(line)
        if m and not line.startswith(" "):
            cur = m.group(2)
            comps[cur] = []
            if m.group(1):
                entry = cur
        elif line.startswith("}"):
            cur = None
        elif cur is not None:
            comps[cur].append(line)
    assert entry is not None, "no ENTRY computation"
    return entry, comps


def multipliers(text: str) -> Dict[str, int]:
    """How many times each computation runs in one run of the entry: the
    sum over its call sites of the caller's count, times the loop's
    `known_trip_count` where the site is a `while` body or condition."""
    entry, comps = computations(text)
    calls: Dict[str, list] = {c: [] for c in comps}
    for caller, lines in comps.items():
        for line in lines:
            trips = 1
            if " while(" in line:
                m = _TRIPS.search(line)
                assert m, f"a while loop with no known trip count: {line[:200]}"
                trips = int(m.group(1))
            names = _CALLEE.findall(line)
            for b in _BRANCHES.findall(line):
                names += [n.strip().lstrip("%") for n in b.split(",")]
            for name in names:
                if name in comps:
                    calls[caller].append((name, trips))
    count = {c: 0 for c in comps}
    count[entry] = 1
    order, seen = [], set()

    def visit(c):                       # callees after every caller
        if c in seen:
            return
        seen.add(c)
        for callee, _ in calls[c]:
            visit(callee)
        order.append(c)

    visit(entry)
    for c in reversed(order):
        for callee, trips in calls[c]:
            count[callee] += count[c] * trips
    return count


def weighted_collectives(text: str) -> Dict[str, Dict[str, int]]:
    """{"bytes_by_kind": XLA's count (each computation once),
    "weighted_by_kind": each computation's collectives times its run
    count}, result bytes as `repro.runtime.hlo.collective_stats` counts
    them."""
    from repro.runtime import hlo
    _, comps = computations(text)
    runs = multipliers(text)
    plain: Dict[str, int] = {}
    weighted: Dict[str, int] = {}
    for name, lines in comps.items():
        stats = hlo.collective_stats("\n".join(lines))
        for kind, b in stats.bytes_by_kind.items():
            plain[kind] = plain.get(kind, 0) + b
            weighted[kind] = weighted.get(kind, 0) + b * runs[name]
    return {"bytes_by_kind": plain, "weighted_by_kind": weighted}


_JAX = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import dataclasses, json
sys.path.insert(0, {tests!r})
from _dryrun_gspmd import weighted_collectives
from repro.configs import get_config
from repro.launch import dryrun
from repro.runtime import hlo
texts = []
orig = hlo.collective_stats
def keep(text):
    texts.append(text)
    return orig(text)
dryrun.hlo_mod.collective_stats = keep
cfg = dataclasses.replace(get_config({arch!r}), n_layers={layers},
                          unroll_layers=True)
rec = dryrun.lower_cell({arch!r}, {shape!r}, False, cfg)
assert rec["status"] == "ok", rec
out = weighted_collectives(texts[-1])
assert out["bytes_by_kind"] == rec["collectives"]["bytes_by_kind"], (
    out, rec["collectives"])
print("RESULT " + json.dumps(out))
"""

_PORT = r"""
import dataclasses, json
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
cfg = dataclasses.replace(get_config({arch!r}), n_layers={layers})
rec = dryrun.lower_cell({arch!r}, {shape!r}, False, cfg, device="cpu")
assert rec["status"] == "ok", rec
print("RESULT " + json.dumps(rec["collectives"]))
"""


def _start(code: str) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-c", code], env=env, cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _result(proc: subprocess.Popen, timeout: float = 600.0):
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-3000:]
    line = [l for l in out.splitlines() if l.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def cells(name: str) -> Tuple[Dict, Dict]:
    """(GSPMD's collective bytes of a cell of `CELLS` per device, the
    port's dry-run `collectives` record of it), the two run side by
    side."""
    arch, shape, layers = {**CELLS, **MORE_CELLS}[name]
    jax = _start(_JAX.format(tests=TESTS, arch=arch, shape=shape,
                             layers=layers))
    port = _start(_PORT.format(arch=arch, shape=shape, layers=layers))
    try:
        return _result(jax), _result(port)
    finally:
        jax.kill()
        port.kill()


def model_gathers(port: Dict) -> int:
    """The bytes of the port's all-gathers over `model`."""
    return sum(r["bytes"] for r in port["by_shape"]
               if r["kind"] == "all-gather" and r["axis"] == "model")


def readings(jax: Dict, port: Dict) -> Dict[str, float]:
    """The ratios the tests assert on, and the totals they come from."""
    w = jax["weighted_by_kind"]
    total = sum(w.values())
    moved = w.get("all-gather", 0) + w.get("collective-permute", 0)
    return {"jax_total": total,
            "jax_unweighted": sum(jax["bytes_by_kind"].values()),
            "jax_gather_permute": moved,
            "port_total": port["total_bytes_per_device"],
            "port_model_gathers": model_gathers(port),
            "total_ratio": port["total_bytes_per_device"] / total,
            "gather_ratio": model_gathers(port) / max(moved, 1)}


def check(name: str) -> Dict[str, float]:
    """Hold the port's cell `name` against GSPMD's; returns the readings."""
    r = readings(*cells(name))
    assert r["total_ratio"] <= TOTAL_RATIO, (name, r)
    assert r["gather_ratio"] <= GATHER_RATIO, (name, r)
    return r


if __name__ == "__main__":
    for cell in list(CELLS) + list(MORE_CELLS):
        print(cell, json.dumps(readings(*cells(cell))), flush=True)
