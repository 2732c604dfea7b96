"""Checks on the card that stand behind `chip_smoke.py` phase 3b, run by
hand on an H100 (pytest does not collect this file):

    PYTHONPATH=src python tests/_sanitize_chip.py lineinfo [--out DIR]
    PYTHONPATH=src python tests/_sanitize_chip.py plants
    CUDA_LAUNCH_BLOCKING=1 PYTHONPATH=src python tests/_sanitize_chip.py \\
        decode-loop --reps 3

  lineinfo     builds the kernel library with and without `-lineinfo`,
               each twice, and compares each function's `cuobjdump -sass`
               and `-res-usage` between the builds (the dumps land in
               `--out`); then times K1-K4 (`benchmarks.kernel_profile`:
               wall and device ms) with each build in turn, `--reps`
               times. It fails if `-lineinfo` changes any function's SASS.
  plants       plants one fault a tool (`PLANTS`) in copies of the tree
               under a temporary directory and runs phase 3b in each, the
               four side by side: every copy's phase must fail, with its
               own tool among those reporting errors.
  decode-loop  phase 11's `probe_threshold` decode loop at Qwen3-1.7B's
               full width, `--reps` times (under CUDA_LAUNCH_BLOCKING=1,
               or under compute-sanitizer where it attaches).

Each prints one JSON object last and exits 1 when its check fails.
"""
import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
CU = "src/repro_torch/kernels/csrc/perforated_matmul.cu"
PY = "src/repro_torch/kernels/perforated_matmul.py"
# tool -> (file, text, the text with the fault planted); all in K4
PLANTS = {
    # one element read past w's end, reaching the result as 0 * w[K * N]
    "memcheck": (CU, "  const float f = factor[0];\n",
                 "  const float f = factor[0] * (1.f + 0.f * "
                 "w[(size_t)K * N]);\n"),
    # the barrier after a cp.async stage lands
    "racecheck": (CU, "    REPRO_SYNC();  // chunk t landed; chunk t - 1's "
                      "buffer is free\n", "    // (barrier removed)\n"),
    # a barrier in a branch divergent across warps
    "synccheck": (CU, "    if (lane == 0) n_live_s = n;\n  }\n"
                      "  REPRO_SYNC();\n",
                  "    if (lane == 0) n_live_s = n;\n    REPRO_SYNC();\n"
                  "  } else {\n    REPRO_SYNC();\n  }\n"),
    # an output buffer nobody writes, read as K4's factor
    "initcheck": (PY, "p(kept), p(live), p(factor), p(work)",
                  "p(kept), p(live), p(_build.empty((1,), torch.float32, "
                  "dev)), p(work)"),
}
PHASE = ("import sys; sys.path.insert(0, 'src'); import chip_smoke as c; "
         "from repro_torch.kernels import _build; _build.build(); "
         "_build.build(checked=True); c.phase_sanitize(c.card_line())")
TOOL_LINE = re.compile(r"^  (\w+): rc=(\S+) errors=(\S+)")
# a kernel's anonymous namespace as the compiler names it: the file's name
# between two hashes, which need not repeat from one build to the next
ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_(\w+?_cu)_[0-9a-f]+")


def _functions(dump, header, keep):
    """{function: its lines that hold `keep`} of a cuobjdump listing whose
    sections start with `header` (a file's own header lines, such as its
    `identifier`, belong to no function)."""
    out, name = {}, None
    for ln in dump.splitlines():
        if header in ln:
            name = ANON.sub(r"\1", ln.split(header, 1)[1].strip().rstrip(":"))
            out[name] = []
        elif name is not None and keep in ln:
            out[name].append(ln.strip())
    return out


def lineinfo(out_dir, reps):
    """Build the library with and without `-lineinfo`, each twice in a
    directory of its own; compare each function's SASS and resources
    between the builds; then time K1-K4 (`benchmarks.kernel_profile`)
    with each build in turn, `reps` times, in processes of their own."""
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.kernels import _build
    release = list(_build.NVCC_FLAGS)
    flag_sets = {"lineinfo": release,
                 "plain": [f for f in release if f != "-lineinfo"]}
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    sass, res = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for label in ("lineinfo", "plain", "lineinfo_again", "plain_again"):
            _build.BUILD_DIR = Path(tmp) / label
            _build.NVCC_FLAGS = flag_sets[label.split("_")[0]]
            lib = _build.build()
            for what, into, header, keep in (
                    ("-sass", sass, "Function : ", "/*"),
                    ("-res-usage", res, "Function ", "REG:")):
                text = subprocess.run([tool, what, str(lib)], check=True,
                                      capture_output=True, text=True).stdout
                (out_dir / f"{label}{what}.txt").write_text(text)
                into[label] = _functions(text, header, keep)

        def differing(a, b, of):
            return sorted(f for f in set(of[a]) | set(of[b])
                          if of[a].get(f) != of[b].get(f))

        pairs = (("lineinfo", "plain"), ("lineinfo", "lineinfo_again"),
                 ("plain", "plain_again"))
        out = {"functions": len(sass["lineinfo"]),
               "sass_differs": {f"{a} / {b}": differing(a, b, sass)
                                for a, b in pairs},
               "resources_differ": {f"{a} / {b}": {
                   f: [res[a].get(f), res[b].get(f)]
                   for f in differing(a, b, res)} for a, b in pairs}}
        times = {label: [] for label in flag_sets}
        for _ in range(reps):
            for label, flags in flag_sets.items():
                code = ("import json, sys; from pathlib import Path; "
                        "sys.path.insert(0, 'src'); "
                        "from repro_torch.kernels import _build; "
                        f"_build.BUILD_DIR = Path({str(Path(tmp) / label)!r})"
                        f"; _build.NVCC_FLAGS = {flags!r}; "
                        "from repro_torch.benchmarks import kernel_profile; "
                        "r = kernel_profile.main(); print(json.dumps({n: "
                        "[c['wall_ms'], c['device_ms']] for n, c in "
                        "r['calls'].items() if 'device_ms' in c}))")
                run = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                                     check=True, capture_output=True,
                                     text=True)
                times[label].append(json.loads(run.stdout.splitlines()[-1]))
                print(f"{label}: {times[label][-1]}", flush=True)
    out["times_ms"] = times   # kernel -> [wall, device] a run, in turn
    out["median_ms"] = {
        label: {k: [float(np.median([r[k][i] for r in rows]))
                    for i in (0, 1)] for k in rows[0]}
        for label, rows in times.items()}
    out["ok"] = not out["sass_differs"]["lineinfo / plain"]
    return out


def plants():
    runs, out = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for tool, (rel, old, new) in PLANTS.items():
            root = Path(tmp) / tool
            shutil.copytree(REPO / "src", root / "src", ignore=shutil.
                            ignore_patterns("build", "__pycache__"))
            shutil.copy(REPO / "chip_smoke.py", root)
            path = root / rel
            text = path.read_text()
            if text.count(old) != 1:
                raise SystemExit(f"{tool}: the text to plant into is not "
                                 f"in {rel} once")
            path.write_text(text.replace(old, new))
            log = open(root / "phase.log", "w")
            runs[tool] = (subprocess.Popen(
                [sys.executable, "-c", PHASE], cwd=root, stdout=log,
                stderr=subprocess.STDOUT), log, time.perf_counter())
        for tool, (proc, log, t0) in runs.items():
            try:
                rc = proc.wait(timeout=900)
            except subprocess.TimeoutExpired:
                proc.kill()
                rc = "timeout"
            log.close()
            text = (Path(tmp) / tool / "phase.log").read_text()
            errors = {m[1]: m[3] for m in map(TOOL_LINE.match,
                                              text.splitlines()) if m}
            out[tool] = dict(phase_rc=rc, errors=errors,
                             seconds=time.perf_counter() - t0)
            print(f"{tool}: phase rc {rc}, errors by tool {errors}",
                  flush=True)
    out["ok"] = all(r["phase_rc"] != 0 and r["errors"].get(tool, "0")
                    not in ("0", "None") for tool, r in out.items())
    return out


def decode_loop(reps):
    sys.path.insert(0, str(REPO / "src"))
    sys.path.insert(0, str(REPO))
    import dataclasses
    import torch
    import chip_smoke
    from repro_torch.benchmarks import qos_serving
    from repro_torch.configs import get_config
    from repro_torch.core.types import ApproxSpec, Level, TAFParams, Technique
    from repro_torch.models import build
    dev = torch.device("cuda")
    full = get_config("qwen3-1.7b")
    params = build(full, dev).init(torch.Generator(device=dev).manual_seed(0))
    cfg = dataclasses.replace(full, approx_decode=ApproxSpec(
        Technique.TAF, Level.BLOCK, taf=TAFParams(2, 4, 0.0)))
    rows = []
    for i in range(reps):
        t0 = time.perf_counter()
        th, origin, quart = chip_smoke.probe_threshold(
            build(cfg, dev), params, dev, qos_serving._THRESHOLDS)
        torch.cuda.synchronize()
        rows.append(dict(threshold=th, origin=origin, quartiles=quart,
                         seconds=time.perf_counter() - t0))
        print(f"run {i}: {rows[-1]}", flush=True)
    return dict(runs=rows, launch_blocking=os.environ.get(
        "CUDA_LAUNCH_BLOCKING"), ok=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("check", choices=("lineinfo", "plants", "decode-loop"))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default="chiprun_out/lineinfo")
    args = ap.parse_args()
    out = {"lineinfo": lambda: lineinfo(args.out, args.reps),
           "plants": plants,
           "decode-loop": lambda: decode_loop(args.reps)}[args.check]()
    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
