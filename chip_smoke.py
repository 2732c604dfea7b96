#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases (any failed check exits non-zero; nothing is wrapped so that a
failure could still exit 0):

  1. the card's name and power limit, as nvidia-smi reports them;
  2. build the CUDA kernels from src/repro_torch/kernels/csrc/;
  3. hold each kernel (K1 attention, K2 TAF matmul, K3 iACT) against its
     plain PyTorch version on the card at the app's reference geometry
     (seq 128, d 32, d_h 64, heads 2) and its full width, plus K1's
     structural/masked modes, GQA, Sq < Skv, non-causal and bf16: masks
     equal, values within atol 1e-3 (K2/K3), 1e-4 (K1 float32), 0.05 (K1
     bf16) -- the JAX package's test tolerances; K3's schedule kernel
     alone equals its plain version exactly (mask, list of computed blocks,
     src) at both IACT specs, and three K2 and K3 calls on the same inputs
     give identical outputs;
  4. the 30-spec sweep on the "cuda" substrate at the reference geometry:
     the front must equal the committed benchmarks/baselines/BENCH_ffn.json
     (n_front 4, hypervolume within 1e-4, best-under-10% approx fractions,
     host parity true);
  5. the main path at Qwen3-1.7B's widths (d 2048, 16 heads of 128, d_h
     6144, seq 4096): the app evaluates NONE and one spec per technique
     through `make_app(...).run`, with the launch counts set to 0 just
     before and read just after; every kernel must have launched, and the
     device tallies show approximated TAF tiles / iACT blocks skipped (no
     block of the app's IACT spec approximates at this width, so a second
     IACT spec takes a looser threshold taken from the data);
  6. per-kernel CUDA-event times at the main path's shapes: the kernel, its
     plain version, one PyTorch library call computing the same function
     (a yardstick the port never calls, in full float32: TF32 off for
     matmuls and cuDNN) and two bounds, the least time the card could take
     at the float32 rate and on the route the kernel takes (3xTF32 for K1
     and K4: three TF32 products per float32 operation at 495 TFLOP/s); K3
     also at the loose IACT spec; K4 at the FFN down-projection (x (4096,
     6144) @ w (6144, 2048), block_k 128, SMALL skip 2); the CUDA kernels
     one call of each kernel runs (torch.profiler, at two block shapes
     each: 1 for K1, K2 and K4, 4 for K3);
  7. the kernel-engineering path: `measure_machine` three times on the
     card (dispatch_s of each, median of 100 calls, and their median), then
     `repro_torch.benchmarks.kernel_micro` at its `ref` and `full`
     geometries, with the launch counts set to 0 just before and read just
     after: oracle parity, pipeline parity, zero kernel-library builds in
     the threshold sweep, and the autotuner on all four kernels (every
     tuned config valid and launched, never slower than the default in the
     tuner's own pass; K4 launched). Then each kernel's tuned and default
     configs are held against its plain version on the tuning operands,
     with phase 3's tolerances. The full geometry's tuning cache lands in
     chiprun_out/kernel_micro_full/.

  8. the five HPC apps (`repro_torch.apps`) at the size of the public
     benchmark each reproduces (FULL_APPS), through `make_app(...).run` on
     the card: NONE, TAF (2, 8, 0.5) at ELEMENT and BLOCK, IACT (2, 0.3,
     private tables) at ELEMENT (MiniFE: PERFO small 4 instead), each with
     its wall time (CUDA events, one warm-up, one timed run), approx
     fraction, error against the app's NONE and host reads; a TAF spec of
     each app must approximate. Then: the ELEMENT / TILE sequences run
     under `torch.cuda.set_sync_debug_mode("error")`; binomial's launch-
     bound share (torch.profiler); `run_batch` equals `run` for a TAF
     group of three thresholds; at the JAX default size every spec on the
     card equals the CPU (masks of the run_sequence apps stepped side by
     side, each differing decision printed with its margin; approx
     fraction within 0.005, QoI within rtol 1e-4, atol 1e-3); and an
     `ApproxRegion` on the "cuda" substrate over `taf_matmul_region` /
     `iact_ffn_region` at phase 5's widths launches K2 / K3 and returns
     what the substrate call returns;
  9. the port's benchmark runner (`repro_torch.benchmarks.run`) over
     fig3, fig6, fig7, fig8c, fig10c, fig11c, fig12c and pareto, with the
     full-size rows on (fig10c at 65536 x 64, fig11c at 1000 boxes, fig12c
     at 494020 x 34, k 5); each module's JAX-size rows held against the
     JAX package's rows in src/repro_torch/benchmarks/
     fig6_fig7_reference.json and figures_reference.json by the module's
     `check` (fractions within 0.005, errors within 1e-4 or by class past
     1, modeled speedups within 1%, K-Means iterations and pareto counts
     exact, hypervolumes within 1e-4 relative); any ERROR row fails. Then
     `repro_torch.quickstart` on the card (K2 must launch and equal its
     plain version), and the regression gate: phase 4's BENCH_ffn.json
     and phase 7's full-geometry BENCH_kernel.json (in chiprun_out/bench/,
     stamped with the card's nvidia-smi line) against the committed H100
     baselines in src/repro_torch/benchmarks/baselines/.

  10. this slice's paths: (a) the lane-grid form of K1-K3 at full width,
     a group of LANES knobs in one wrapper call (x and wp shared for K2,
     the exact attention output and both FFN weights for K3, q = k = v for
     K1 in masked fini mode): each lane against the plain version's lanes
     and against a single call at its knob (masks equal), the CUDA kernels
     one group call runs (torch.profiler), and CUDA-event times of the
     group call, of LANES single calls, of the plain version and of one
     PyTorch library call computing the same LANES outputs, beside the
     bound of the work this run's data needs; (b) phase 4's sweep through
     `run_batch` (jobs 4), with the counts set to 0 just before and read
     just after: it must reproduce the committed front, and every lane
     kernel must have run a group there; (c) the benchmark driver's
     `--only costmodel,ffn --predict --check-regression` against the
     committed H100 BENCH_costmodel.json (the ffn band recovering the
     committed front within 0.90, the app models' counts and Spearman
     correlations as committed).
  11. the serving slice at Qwen3-1.7B's full width (28 layers, d_model
     2048, 16 / 8 heads of 128, d_ff 6144, vocab 151936; weights from seed
     0): (a) prefill of 4 prompts of 128 tokens then 3 decode steps in
     float32 compute, each step's logits against the teacher-forced
     `hidden` within 0.02 relative (the JAX test's bound); (b)
     `repro_torch.launch.serve` in bf16, precise and with decode TAF (2, 4,
     t), batch 4, prompt 128, gen 32: prefill ms, decode tokens/s, skipped
     layer-steps (t: the smallest threshold of the qos drill's grid under
     which a precise run's per-layer RSD values fall in a tenth of the
     layer-steps, else taken from those values; at least one layer-step
     must skip); one decode step profiled in a fresh process
     (`benchmarks.serve_profile`: CUDA kernels, products, device, host and
     wall ms, idle share) without TAF, with TAF computing every layer and
     with every layer skipped, the last at 28 layers and at 2 -- a skipped
     layer must launch exactly one kernel, its delta's add; (c) a `ServingEngine` of 8 slots draining 16 requests
     (prompt 128, 8-32 new tokens, max_len 256) precise and under a
     `QosEngine` whose ladder comes from `make_decode_app` + `harness.sweep`
     at this width (tokens/s, TTFT and latency p50 / p99, knob moves,
     canary ticks, skip fraction), and with the knob pinned precise every
     canary error exactly 0.0; (d) the benchmark runner's `qos` and `obs` modules
     and the regression gate against the committed H100 BENCH_qos.json
     and BENCH_obs.json.
  12. the sharded serving data plane at the same full width, on a
     one-rank NCCL group the phase starts (`runtime.elastic.init_single`):
     (a) `ServingEngine(devices=1, shards=1)` equals phase 11's unsharded
     engines on its 16 requests token for token (and knob for knob under
     QoS); (b) `ServingEngine(devices=1, shards=4, slots=8)` drains the 16
     requests precise and under phase 11's `QosEngine` with per-shard QoS
     (tokens/s, TTFT and latency p50 / p99, skip fraction per shard, host
     reads a tick, which must equal `host_reads_per_tick` exactly); four
     per-shard knob vectors build no step and read nothing; with the knob
     pinned precise every canary error is exactly 0.0; the fault drill
     `inject(10.0, shard=3)` (at a tick where shard 3's classes are a
     strict subset of the live ones) hits only those classes' evidence,
     backs them off, and two runs give equal trajectories; one sharded
     decode step's CUDA kernels (`serve_profile --batch 8 --shards 4` in a
     fresh process); (c) `run --only qos --devices 1`: mesh (1, 1) and the
     BENCH_qos.json gate's exact fields against the baseline; (d) `pipeline_apply` with one stage against
     serial application (1e-5) and the compressed all-reduce on one rank
     against the dequantized tensor (exact), through NCCL.
  13. the model zoo's serving path at full width, one model at a time
     (weights from seed 0 on the card, each freed before the next):
     olmoe-1b-7b, zamba2-7b, rwkv6-1.6b, whisper-large-v3 (1500 frames),
     pixtral-12b (256 patch tokens), starcoder2-3b and qwen1.5-4b whole,
     deepseek-v3-671b cut in depth only (2 layers for the float32 check,
     4 for serving: one card's 80 GB) with every width kept. Each: decode
     against the teacher-forced forward in float32 (MoE at capacity 8.0)
     within 0.02; `launch.serve` in bfloat16 at batch 4, prompt 128, gen
     32 (olmoe also with expert perforation fini 0.5, 32 of 64 experts
     kept), prefill ms and decode tokens/s; the 8-slot engine draining
     phase 11's 16 requests on olmoe, zamba2, rwkv6, starcoder2, qwen1.5
     and deepseek-v3 (tokens/s, TTFT p50 / p99). The kernel launch counts
     read 0 across the phase: no kernel lies on this path.
  14. the model zoo's training half: (a) one `launch.steps.make_train_step`
     on the card and on the CPU from the same float32 masters (Qwen3-1.7B's
     widths at 2 layers, batch 2 x seq 128, TF32 off): loss within 1e-5
     relative, grad_norm within 1e-4, params within 1e-6 where AdamW moves
     them by about lr sign(g) and within 2 lr elsewhere; (b) Qwen3-1.7B as
     its config gives it (28 layers, float32 masters, bf16 compute, remat)
     trained for 12 steps at batch 8 x seq 2048 with AdamW lr 3e-4 and
     warmup-cosine (2 / 12) over `SyntheticLM`: every loss finite and the
     mean of the last 3 below step 0's; the median step wall of steps 3-12
     (CUDA events), tokens/s, peak memory and the model-FLOP share
     6 N T / (wall x 989e12), and one step profiled in a fresh process
     (`benchmarks.train_profile`: CUDA kernels, device ms, idle share);
     (c) `repro_torch.examples.train_100m` for 60 steps with checkpoints
     every 20 (the loss falls), the same run sent SIGTERM after step 40
     (exit 42, checkpoint 40 written) and resumed to 60 (the final loss
     within rtol 1e-4 of the uninterrupted run's). The kernel launch
     counts read 0 across the phase.

  15. the port's last modules on the card: (a) approxlint
     (`repro_torch.analysis.run_lint(device="cuda")`) over all four
     groups, after each masked knob of K1-K4 (K2 `rsd_threshold`, K3
     `threshold`, K1 / K4 `fraction`) is captured once in a CUDA graph with
     the knob in a device tensor and replayed at another value (each
     replay equals an eager call there: masks bit for bit, values within
     phase 3's tolerances): no rule crash, 0 findings, exactly the three
     subjects JAX's lint allowlists, and K1-K4 launched by the lint; (b)
     `launch.dryrun` and `launch.roofline` of Qwen3-1.7B's train cell at
     phase 14's batch 8 x seq 2048 and its decode cell at phase 11's batch
     4 and cache of 144 on one card: the predicted peak against phase 14's
     measured one (the train cell must fit), the roofline's bound against
     phase 14's median step and phase 11's decode device time (each
     measured time must be at least its bound), and olmoe-1b-7b
     decode_32k on the 16x16 fake mesh with its collective bytes by kind;
     (c) the driver's `roofline` and `lint` keys and the gate against the
     port's BENCH_lint.json; (d) every applicable (arch x shape x mesh)
     cell of the dry run on the card's torch, cut for a quick check (full
     width, the roofline's smallest depth variant, short shapes; an
     arch's cells a process, 8 at once, `tests/_dryrun_cells.py`): torch's
     version, each cell's status and wall, the count of ok cells, which
     must be all 64, each with its argument bytes (and a prefill's output
     bytes: its cache laid out by `cache_specs`) the rules' local shards,
     each cell and the two-layer variants of three train cells counting
     the collectives committed in `tests/_dryrun_card_collectives.json`.

K4 (perforated matmul) is held against its plain version in phase 3 at
256^3 and at full width: structural SMALL/LARGE skip 2 and INI/FINI/RANDOM
0.25, masked ini/fini/random at fractions up to one that drops every
block, rescale on and off, and no perforation; atol 1e-3 at 256^3 (the
JAX test's) and 1e-2 at full width (values of order 80: float32 sums of
6144 products taken in two orders), and the device tally of K blocks
accumulated must equal the kept (live) count.

Prints the `kernels` JSON line, then as its last line
`{"ok": true, "device": {...}}`. Writes the full report to
chiprun_out/chip_smoke.json. Exits non-zero without a CUDA device, and
when run outside a checkout (src/repro_torch missing).
"""
import collections
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")
BASELINE = os.path.join(HERE, "benchmarks", "baselines", "BENCH_ffn.json")
REPORT = os.path.join(HERE, "chiprun_out", "chip_smoke.json")
# the artifacts the regression gate reads (phase 4's BENCH_ffn.json, phase
# 7's full-geometry BENCH_kernel.json)
BENCH_DIR = os.path.join(HERE, "chiprun_out", "bench")
# phase 10's predict-mode driver run (BENCH_costmodel.json and
# BENCH_ffn_predict.json, stamped with the card's nvidia-smi line)
PREDICT_DIR = os.path.join(HERE, "chiprun_out", "bench_predict")
# phase 10: a group of LANES knobs per lane-grid call, one knob stack each
LANES = 4
LANE_KNOBS = {"taf_matmul": (0.2, 0.02, 0.5, 2.0),
              "perforated_attention": (0.5, 0.25, 0.75, 0.0)}

# H100 SXM published peaks (NVIDIA data sheet): float32 outside the tensor
# cores, dense TF32 on the tensor cores, and HBM3 bandwidth. Each kernel
# gets two bounds: its float32 operations at the float32 rate (comparable
# with earlier rows), and the bound of the route it takes (ROUTES).
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
# kernel -> (route, TF32 or float32 products per float32 operation, peak)
ROUTES = {"taf_matmul": ("float32 FMA", 1, PEAK_F32_FLOPS),
          "iact_rowfn": ("float32 FMA", 1, PEAK_F32_FLOPS),
          "perforated_attention": ("3xTF32", 3, PEAK_TF32_FLOPS),
          "perforated_matmul": ("3xTF32", 3, PEAK_TF32_FLOPS)}

REF_GEOM = dict(seq=128, d=32, d_h=64, heads=2)
FULL_GEOM = dict(seq=4096, d=2048, d_h=6144, heads=16)  # Qwen3-1.7B widths
TAF_SPEC = ("taf", 2, 4, 0.2)
IACT_SPEC = ("iact", 2, 0.05)
PERFO_SPEC = ("perfo", "fini", 0.5)
ATOL = {"taf_matmul": 1e-3, "iact_rowfn": 1e-3, "perforated_attention": 1e-4,
        "perforated_attention_bf16": 0.05, "perforated_matmul": 1e-3,
        "perforated_matmul_full": 1e-2}
APP_KERNELS = ("taf_matmul", "iact_rowfn", "perforated_attention")
# K4 at 256^3 (the JAX test's size) and at the FFN down-projection
PMM_GEOMS = (("256^3", (256, 256, 256), (64, 64, 64)),
             ("full", (4096, 6144, 2048), (128, 128, 128)))
# phase 8: each app at the size of the public benchmark it reproduces
FULL_APPS = (
    # CUDA Samples BlackScholes: OPT_N = 4,000,000 (65536 x 64 = 4,194,304)
    ("blackscholes", dict(n_elements=65536, steps=64)),
    # CUDA Samples binomialOptions: OPT_N 1024, NUM_STEPS 2048
    ("binomial_options", dict(n_elements=1024, steps=8, tree_steps=2048)),
    # Rodinia kmeans, the kdd_cup input's shape (synthetic points)
    ("kmeans", dict(n=494020, d=34, k=5)),
    # Rodinia lavaMD -boxes1d 10
    ("lavamd", dict(nx=10)),
    # miniFE 100 x 100 x 100 (about 1.03 M rows): a 1024^2 grid
    ("minife_cg", dict(n=1024, iters=60)),
)
APP_TAF = (2, 8, 0.5)
APP_IACT = (2, 0.3, 0)
APP_RTOL, APP_ATOL, APP_FRACTION_TOL = 1e-4, 1e-3, 0.005
SEQUENCE_APPS = ("blackscholes", "binomial_options", "lavamd")


class SmokeFailure(Exception):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def card_errors():
    """The card's ECC and remapped-row counters as nvidia-smi reports
    them, to tell a fault of the card from one of the program after a
    CUDA error."""
    try:
        return subprocess.run(
            ["nvidia-smi", "-q", "-d", "ECC,ROW_REMAPPER"],
            capture_output=True, text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def loose_iact_threshold(a, rows=16):
    """A distance threshold under which a good share of the iACT kernel's
    row blocks approximate on `a`: the 75th percentile, over blocks, of the
    median distance from a block's rows to the first row of the block
    before it."""
    import torch
    blocks = a.reshape(-1, rows, a.shape[1])
    d = (blocks[1:] - blocks[:-1, :1]).norm(dim=-1).median(dim=1).values
    return float(torch.quantile(d, 0.75))


def plain_call(kernel, config, arrays):
    """The plain version of `tuning.build_call(kernel, config)` (the precise
    path: thresholds 0, no perforation) on `arrays`."""
    from repro_torch.kernels import ref
    if kernel == "taf_matmul":
        return ref.taf_matmul_ref(*arrays, history_size=3, prediction_size=8,
                                  rsd_threshold=0.0, **config)[0]
    if kernel == "iact_rowfn":
        return ref.iact_rowfn_ref(*arrays, table_size=4, threshold=0.0,
                                  **config)[0]
    if kernel == "perforated_matmul":
        return ref.perforated_matmul_ref(*arrays, block_k=config["block_k"],
                                         perfo=None)
    return ref.attention_ref(*arrays)


def app_specs(name):
    """(label, spec) pairs phase 8 runs on app `name`."""
    from repro_torch.core.types import (ApproxSpec, IACTParams, Level,
                                        PerforationKind, PerforationParams,
                                        TAFParams, Technique)
    specs = [("none", ApproxSpec())] + [
        (f"taf_{lv.value}", ApproxSpec(Technique.TAF, lv,
                                       taf=TAFParams(*APP_TAF)))
        for lv in (Level.ELEMENT, Level.BLOCK)]
    if name == "minife_cg":
        specs.append(("perfo_small4", ApproxSpec(
            Technique.PERFORATION, perforation=PerforationParams(
                kind=PerforationKind.SMALL, skip=4))))
    else:
        specs.append(("iact_element", ApproxSpec(
            Technique.IACT, Level.ELEMENT, iact=IACTParams(*APP_IACT))))
    return specs


# the JAX apps' default sizes of the run_sequence apps
DEFAULT_KW = {"blackscholes": dict(n_elements=512, steps=64),
              "binomial_options": dict(n_elements=64, steps=32,
                                       tree_steps=128),
              "lavamd": dict(nx=5)}


def sequence_of(name, kw, device):
    """(invocation sequence, region fn) of a run_sequence app at `kw`."""
    import torch
    from repro_torch.apps import binomial_options, blackscholes, lavamd
    if name == "blackscholes":
        xs = blackscholes.gen_inputs(kw["n_elements"], kw["steps"])
        return torch.from_numpy(xs).to(device), blackscholes.bs_price
    if name == "binomial_options":
        xs = binomial_options.gen_inputs(kw["n_elements"], kw["steps"])
        return torch.from_numpy(xs).to(device), \
            lambda x: binomial_options.binomial_price(x, kw["tree_steps"])
    region, xs, _ = lavamd.region_setup(kw["nx"], 0, device)
    return xs, region


def lockstep(spec, xs_cpu, xs_card, fn):
    """Step `spec`'s technique over one invocation sequence on the CPU and
    on the card side by side, each on its own accurate outputs. Returns the
    decisions that differ: step, element, each side's mask and its margin
    (TAF: RSD of the element's window after the step minus the threshold;
    iACT: nearest cached distance minus the threshold)."""
    from repro_torch.core import iact, rsd, taf
    from repro_torch.core.types import Technique
    diffs, states = [], [None, None]
    for t in range(xs_cpu.shape[0]):
        seen = []
        for k, xs in enumerate((xs_cpu, xs_card)):
            y = fn(xs[t])
            if spec.technique == Technique.TAF:
                p = spec.taf
                if states[k] is None:
                    states[k] = taf.init(p, y.shape[0], tuple(y.shape[1:]),
                                         y.dtype, y.device)
                _, states[k], m = taf.step(states[k], lambda: y, p,
                                           spec.level)
                margin = rsd.rsd(states[k].window, dim=1) - p.rsd_threshold
                decided = states[k].remaining
            else:
                p = spec.iact
                if states[k] is None:
                    states[k] = iact.init(p, iact.n_tables_for(p, y.shape[0]),
                                          xs.shape[-1], tuple(y.shape[1:]),
                                          y.dtype, y.device)
                decided, _, dist = iact.read_phase(states[k], xs[t],
                                                   p.threshold)
                margin = dist - p.threshold
                _, states[k], m = iact.step(states[k], xs[t], lambda x: y, p,
                                            spec.level)
            seen.append((m.cpu(), decided.cpu(), margin.cpu()))
        (mc, dc, gc), (mg, dg, gg) = seen
        for e in ((mc != mg) | (dc != dg)).nonzero().flatten().tolist():
            diffs.append(dict(step=t, element=e, cpu=bool(mc[e]),
                              card=bool(mg[e]), margin_cpu=float(gc[e]),
                              margin_card=float(gg[e])))
    return diffs


def phase_apps(dev, s, loose):
    """Phase 8 (see the module docstring); returns its report."""
    import importlib
    import numpy as np
    import torch
    from repro_torch.apps import minife_cg
    from repro_torch.benchmarks import kernel_profile
    from repro_torch.core import ApproxRegion, hierarchy, iact, substrate, taf
    from repro_torch.core.harness import ERROR_METRICS, mape, mcr
    from repro_torch.core.types import (ApproxSpec, IACTParams, Level,
                                        PerforationKind, PerforationParams,
                                        TAFParams, Technique)
    from repro_torch.kernels import ops
    out = {"full": {}, "no_sync": {}, "run_batch": {}, "default_size": {}}
    mods = {name: importlib.import_module(f"repro_torch.apps.{name}")
            for name, _ in FULL_APPS}

    # each app at full width through make_app(...).run
    for name, kw in FULL_APPS:
        t0 = time.perf_counter()
        app = mods[name].make_app(device=dev, **kw)
        metric = ERROR_METRICS[app.error_metric]
        rows, exact = {}, None
        for label, spec in app_specs(name):
            res = app.run(spec)
            if exact is None:
                check(bool(np.isfinite(res.qoi).all()),
                      f"{name}: the exact QoI is not finite")
                exact = res.qoi
            row = dict(wall_ms=res.wall_time_s * 1e3,
                       approx_fraction=res.approx_fraction,
                       error=float(metric(exact, res.qoi)),
                       host_reads=res.extra.get("host_reads"))
            if "iters" in res.extra:
                row["iters"] = res.extra["iters"]
            rows[label] = row
            log(f"  {name} {label}: wall_ms={row['wall_ms']!r} (CUDA "
                f"events) approx_fraction={row['approx_fraction']!r} "
                f"{app.error_metric}={row['error']!r} "
                f"host_reads={row['host_reads']}"
                + (f" iters={row['iters']}" if "iters" in row else ""))
        check(rows["taf_element"]["approx_fraction"] > 0
              or rows["taf_block"]["approx_fraction"] > 0,
              f"{name}: no TAF spec approximated at full width")
        out["full"][name] = dict(args=kw, rows=rows,
                                 seconds=time.perf_counter() - t0)
        del app, exact
        torch.cuda.empty_cache()

    # the ELEMENT / TILE paths make no synchronizing call (kmeans' host
    # convergence loop reads once an iteration by design and is left out):
    # PyTorch's sync debug mode raises on one, and, as a second witness
    # (the mode does not see every synchronizing call), torch.profiler
    # must record no more CUDA synchronize calls and device-to-host copies
    # than it records around an empty window (its own)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    def under_sync_error(fn):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)

    def traced_waits(fn):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            fn()
        return collections.Counter(
            e.name for e in prof.events()
            if "Synchronize" in e.name or "DtoH" in e.name)

    own_waits = traced_waits(lambda: None)
    # positive control: the witness sees one 0-d read
    control = traced_waits(lambda: float(torch.ones((), device=dev)))
    check(bool(control - own_waits), "the profiler witness does not see a "
          f"device-to-host read ({dict(control)})")

    def no_sync(fn, witness=None):
        """fn() under the sync debug mode, then `witness` (default fn: a
        shorter run of the same path where a full one would trace too many
        launches) under the profiler too; returns (fn's value, the waits
        the profiler saw beyond its own)."""
        torch.cuda.synchronize()
        value = under_sync_error(fn)
        waits = traced_waits(lambda: under_sync_error(witness or fn))
        return value, dict(waits - own_waits)

    taf_p, iact_p = TAFParams(*APP_TAF), IACTParams(*APP_IACT)
    full_kw = dict(FULL_APPS)
    for name in SEQUENCE_APPS:
        xs, fn = sequence_of(name, full_kw[name], dev)
        # binomial's full sequence is 1.6e5 launches a run: the profiler
        # witnesses its first three invocations
        short = xs[:3] if name == "binomial_options" else xs
        for label, run in (
                ("taf_element", lambda x: taf.run_sequence(
                    taf_p, x, fn, Level.ELEMENT)),
                ("taf_tile", lambda x: taf.run_sequence(
                    taf_p, x, fn, Level.TILE)),
                ("iact_element", lambda x: iact.run_sequence(
                    iact_p, x, fn, Level.ELEMENT))):
            (_, _, frac), waits = no_sync(lambda: run(xs),
                                          lambda: run(short))
            out["no_sync"][f"{name}/{label}"] = dict(
                approx_fraction=float(frac), waits=waits)
    n, iters = full_kw["minife_cg"]["n"], full_kw["minife_cg"]["iters"]
    b = torch.from_numpy(minife_cg._gen_b(n, 0)).to(dev)
    ini = ApproxSpec(Technique.PERFORATION, perforation=PerforationParams(
        kind=PerforationKind.INI))
    for label, spec, kw in (
            ("taf_element", ApproxSpec(Technique.TAF, Level.ELEMENT,
                                       taf=taf_p), {}),
            ("perfo_ini_fraction_tensor", ini,
             dict(fraction=torch.full((), 0.25, device=dev)))):
        (_, _, frac), waits = no_sync(
            lambda: minife_cg.cg_solve(b, spec, iters, **kw))
        out["no_sync"][f"minife_cg/{label}"] = dict(
            approx_fraction=float(frac), waits=waits)
    for run, r in out["no_sync"].items():
        log(f"  {run}: no synchronizing call under sync debug mode "
            f"'error'; synchronize calls and DtoH copies traced beyond "
            f"the profiler's own {dict(own_waits)}: {r['waits']} "
            f"approx_fraction={r['approx_fraction']!r}")
        check(not r["waits"], f"{run} waited for the card: {r['waits']}")

    # binomial at full width is bound by launches: one price call's kernels
    xs, fn = sequence_of("binomial_options", full_kw["binomial_options"],
                         dev)
    x0 = xs[0]
    kernels = kernel_profile.device_kernels({"price": lambda: fn(x0)}, dev)
    call = kernel_profile.time_call(lambda: fn(x0), dev)
    device_ms = sum(r["total_ms"] for r in kernels)
    launches = sum(r["count"] for r in kernels)
    out["binomial_price_call"] = dict(
        call, device_ms=device_ms, launches=launches,
        idle=1.0 - device_ms / call["wall_ms"],
        us_per_launch=call["wall_ms"] * 1e3 / max(launches, 1))
    log(f"  binomial_price ({x0.shape[0]} options, "
        f"{full_kw['binomial_options']['tree_steps']} tree steps), one "
        f"call: {out['binomial_price_call']}")

    # run_batch equals run, spec by spec, for one TAF group
    for name, kw in FULL_APPS:
        app = mods[name].make_app(device=dev, **kw)
        specs = [ApproxSpec(Technique.TAF, Level.ELEMENT,
                            taf=TAFParams(2, 8, th)) for th in (0.1, 0.5,
                                                                1.5)]
        fracs = []
        for spec, got in zip(specs, app.run_batch(specs)):
            want = app.run(spec)
            same = (np.array_equal(got.qoi, want.qoi, equal_nan=True)
                    and abs(got.approx_fraction - want.approx_fraction)
                    <= 1e-6
                    and got.extra.get("iters") == want.extra.get("iters"))
            check(same, f"{name}: run_batch differs from run at "
                        f"{spec.taf}")
            fracs.append(got.approx_fraction)
        out["run_batch"][name] = fracs
        del app
        torch.cuda.empty_cache()
    log(f"  run_batch == run (TAF 2/8 at 0.1, 0.5, 1.5), approx "
        f"fractions: {out['run_batch']}")

    # at the JAX default size every spec on the card equals the CPU
    for name, _ in FULL_APPS:
        card, cpu = mods[name].make_app(device=dev), \
            mods[name].make_app(device="cpu")
        exact = cpu.exact().qoi
        rows = {}
        for label, spec in app_specs(name):
            rc, rg = cpu.run(spec), card.run(spec)
            frac_ok = abs(rc.approx_fraction - rg.approx_fraction) <= \
                APP_FRACTION_TOL
            if name == "kmeans":
                qoi_ok = mcr(rc.qoi, rg.qoi) <= APP_FRACTION_TOL
            elif name == "minife_cg" and not mape(exact, rc.qoi) < 1.0:
                # a blown-up solve: rounding is amplified without bound
                qoi_ok = bool(np.array_equal(np.isfinite(rc.qoi),
                                             np.isfinite(rg.qoi))
                              and not mape(exact, rg.qoi) < 1.0)
            else:
                qoi_ok = bool(np.allclose(rg.qoi, rc.qoi, rtol=APP_RTOL,
                                          atol=APP_ATOL))
            diffs = []
            if name in SEQUENCE_APPS and spec.technique in (
                    Technique.TAF, Technique.IACT):
                xs_c, fn = sequence_of(name, DEFAULT_KW[name], "cpu")
                diffs = lockstep(spec, xs_c, xs_c.to(dev), fn)
            for d_ in diffs:
                log(f"    {name} {label}: decision differs {d_}")
            rows[label] = dict(cpu_fraction=rc.approx_fraction,
                               card_fraction=rg.approx_fraction,
                               qoi_ok=qoi_ok, mask_diffs=diffs)
            log(f"  {name} {label} at the default size: approx fraction "
                f"cpu={rc.approx_fraction!r} card={rg.approx_fraction!r} "
                f"QoI agrees={qoi_ok} differing decisions={len(diffs)}")
            check(frac_ok and qoi_ok and not diffs,
                  f"{name} {label}: the card departs from the CPU at the "
                  "default size")
        out["default_size"][name] = rows

    # ApproxRegion on the "cuda" substrate launches K2 / K3 at phase 5's
    # widths and returns exactly what the substrate call returns
    seq, d = FULL_GEOM["seq"], FULL_GEOM["d"]
    taf_spec = ApproxSpec(Technique.TAF, Level.BLOCK,
                          taf=TAFParams(*TAF_SPEC[1:]))
    iact_spec = ApproxSpec(Technique.IACT, Level.BLOCK,
                           iact=IACTParams(IACT_SPEC[1], loose, 1))
    cases = (
        ("taf_matmul", taf_spec, s["x"],
         lambda xx, **kw: substrate.taf_matmul_region(
             xx, s["wp"], taf_spec, block_m=16, block_n=d,
             rsd_threshold=kw.get("rsd_threshold"))),
        ("iact_rowfn", iact_spec, s["a"],
         lambda xx, **kw: substrate.iact_ffn_region(
             xx, s["w1"], s["w2"], iact_spec, block_rows=16,
             threshold=kw.get("threshold"))))
    out["region"] = {}
    for kern, spec, x, impl in cases:
        region = ApproxRegion(spec, None, n_elements=seq, substrate="cuda",
                              cuda_impl=impl)
        before = ops.launch_counts()[kern]
        ys, frac = region.run(x)
        y1, state, m1 = region.step(None, x)
        launched = ops.launch_counts()[kern] - before
        y_direct, mask = impl(x)
        same = (torch.equal(ys, y_direct) and torch.equal(y1, y_direct)
                and torch.equal(m1, mask)
                and float(frac) == float(hierarchy.fraction(mask)))
        out["region"][kern] = dict(launches=launched, equal=same,
                                   approx_fraction=float(frac))
        log(f"  ApproxRegion({spec.technique.value}, substrate='cuda') -> "
            f"{kern}: launches={launched} approx_fraction={float(frac)!r} "
            f"equal to the substrate call={same}")
        check(launched > 0 and same, f"ApproxRegion did not run {kern} or "
                                     "departs from the substrate call")
    return out


def stamp_card(bench_dir, card):
    """Add the card's nvidia-smi line to every BENCH_*.json of `bench_dir`,
    so an artifact names the card it was taken on (and can become a
    committed baseline as it stands)."""
    for name in sorted(os.listdir(bench_dir)):
        if name.startswith("BENCH_") and name.endswith(".json"):
            path = os.path.join(bench_dir, name)
            with open(path) as f:
                doc = json.load(f)
            doc["card"] = card
            with open(path, "w") as f:
                json.dump(doc, f, indent=1)


def phase_runner(dev, card):
    """Phase 9: the port's benchmark runner on the card (fig3, fig6, fig7,
    fig8c, fig10c, fig11c, fig12c, pareto; full-size rows on), each
    module's JAX-size rows held against the JAX rows; the quickstart; then
    the regression gate over phase 4's and phase 7's artifacts against the
    committed H100 baselines. Returns the report and the gate's failures
    (the caller fails on them after writing the report)."""
    import torch
    from repro_torch import quickstart
    from repro_torch.benchmarks import run as bench_run
    from repro_torch.benchmarks import fig6_best_speedup as fig6
    from repro_torch.kernels import ops

    def rep(name, value, derived=""):
        log(f"  {name},{value},{derived}")

    keys = [k for k in bench_run.MODULES
            if k not in ("ffn", "kernel", "costmodel", "qos", "obs", "lint",
                         "roofline")]
    # (phase 10 runs costmodel, phase 11 qos and obs, phase 15 lint and
    # roofline)
    results, errors = bench_run.run_modules(keys, rep, device=dev, full=True,
                                            artifacts_dir=BENCH_DIR)
    check(not errors, f"runner modules raised: {errors}")
    refs = dict(fig6.load_reference(),
                **fig6.load_reference(fig6.FIGURES_REFERENCE))
    bad = []
    for key in keys:
        bad += bench_run.MODULES[key].check(results[key], refs)
    for b in bad:
        log(f"  departs from the JAX rows: {b}")
    check(not bad, f"{len(bad)} figure rows depart from the JAX rows")
    log(f"  {', '.join(keys)}: every JAX-size row agrees with the JAX rows")
    mem = results["fig3"]["memory"]
    log(f"  fig3: total_memory {mem['bytes']} bytes ({mem['of']})")

    log("  quickstart:")
    ops.reset_counts()
    qs = quickstart.main(device=dev)
    k2 = ops.launch_counts()["taf_matmul"]
    log(f"  quickstart K2 launches {k2}, k2_matches {qs['k2_matches']}")
    check(qs["k2_matches"] and k2 > 0,
          "quickstart: K2 did not launch or departs from its plain version")
    torch.cuda.synchronize()

    stamp_card(BENCH_DIR, card)
    # phase 4's and phase 7's artifacts against their baselines (phase 10
    # gates BENCH_costmodel.json)
    fails = [f for name in ("BENCH_ffn.json", "BENCH_kernel.json")
             for f in bench_run.check_regression(
                 BENCH_DIR, os.path.join(bench_run.BASELINES, name))]
    for f in fails:
        log(f"  regression FAIL {f}")
    if not fails:
        log(f"  regression gate OK: {os.path.relpath(BENCH_DIR, HERE)} "
            f"against {os.path.relpath(bench_run.BASELINES, HERE)}")
    full = {k: results[k]["full"] for k in ("fig10c", "fig11c", "fig12c")}
    return dict(fig6={n: {t: a[t]["best"] for t in ("taf", "iact")}
                      for n, a in results["fig6"].items()},
                fig7=results["fig7"], fig3=results["fig3"],
                fig8c=results["fig8c"], pareto=results["pareto"],
                jax_size={k: results[k]["jax_size"]
                          for k in ("fig10c", "fig11c", "fig12c")},
                full=full, quickstart=qs, quickstart_k2_launches=k2,
                gate_failures=fails)


def lane_calls(s, loose, dev):
    """Phase 10's lane groups at full width: kernel -> (group call of
    LANES knobs, single call at lane l, plain lanes), and the knob
    stacks."""
    import torch
    from repro_torch.core.types import PerforationKind, PerforationParams
    from repro_torch.kernels import ops, ref

    d = FULL_GEOM["d"]
    fini = PerforationParams(kind=PerforationKind.FINI)
    iact_knobs = (IACT_SPEC[2], loose, 0.5 * loose, 2.0 * loose)
    kn = {k: torch.tensor(v[:LANES], dtype=torch.float32, device=dev)
          for k, v in dict(LANE_KNOBS, iact_rowfn=iact_knobs).items()}
    taf_kw = dict(block_m=16, block_n=d, history_size=TAF_SPEC[1],
                  prediction_size=TAF_SPEC[2])
    iact_kw = dict(block_rows=16, table_size=IACT_SPEC[1])
    attn_kw = dict(block_q=32, block_kv=32, perfo=fini)
    q = s["q"]
    calls = {
        "taf_matmul": (
            lambda: ops.taf_matmul(s["x"], s["wp"], **taf_kw,
                                   rsd_threshold=kn["taf_matmul"]),
            lambda l_: ops.taf_matmul(s["x"], s["wp"], **taf_kw,
                                      rsd_threshold=kn["taf_matmul"][l_]),
            lambda: ref.taf_matmul_lanes_ref(
                s["x"], s["wp"], **taf_kw, rsd_threshold=kn["taf_matmul"])),
        "iact_rowfn": (
            lambda: ops.iact_rowfn(s["a"], s["w1"], s["w2"], **iact_kw,
                                   threshold=kn["iact_rowfn"]),
            lambda l_: ops.iact_rowfn(s["a"], s["w1"], s["w2"], **iact_kw,
                                      threshold=kn["iact_rowfn"][l_]),
            lambda: ref.iact_rowfn_lanes_ref(
                s["a"], s["w1"], s["w2"], **iact_kw,
                threshold=kn["iact_rowfn"])),
        "perforated_attention": (
            lambda: ops.perforated_attention(
                q, q, q, **attn_kw, fraction=kn["perforated_attention"]),
            lambda l_: ops.perforated_attention(
                q, q, q, **attn_kw,
                fraction=kn["perforated_attention"][l_]),
            lambda: ref.attention_lanes_ref(
                q, q, q, block_kv=32, perfo=fini,
                fraction=kn["perforated_attention"])),
    }
    return calls, kn


# CUDA kernels one lane-group call runs (K3: iact_union lists the union of
# the lanes' computed blocks first)
LANE_CUDA = {"taf_matmul": 1, "iact_rowfn": 5, "perforated_attention": 1}


def phase_lanes(dev, s, loose, card, serial_launches, lane_cuda, ms, note):
    """Phase 10: (a) the lane-grid kernels at full width against their
    plain versions and LANES single calls, with times; (b) the 30-spec
    sweep through run_batch; (c) the driver's predict mode and the
    cost model's gate. Returns (report, kernel rows, lane launches of (b),
    gate failures)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.benchmarks import approx_ffn_sweep
    from repro_torch.benchmarks import run as bench_run
    from repro_torch.core import perforation
    from repro_torch.core.types import PerforationKind, PerforationParams
    from repro_torch.kernels import (iact_memo, ops, perforated_attention,
                                     taf_matmul)

    seq, d, d_h = FULL_GEOM["seq"], FULL_GEOM["d"], FULL_GEOM["d_h"]
    f4 = 4
    fini = PerforationParams(kind=PerforationKind.FINI)
    q = s["q"]
    calls, kn = lane_calls(s, loose, dev)
    modules = {"taf_matmul": taf_matmul, "iact_rowfn": iact_memo,
               "perforated_attention": perforated_attention}
    rows, lane_report = [], {}
    for kern, (group, single, plain) in calls.items():
        ops.reset_counts()
        out = group()
        per_group = ops.launch_counts()[kern]
        n_lane = ops.lane_counts()[kern]
        check(per_group == 1 and n_lane == 1,
              f"{kern}: a group of {LANES} took {per_group} wrapper calls")
        want = plain()
        if kern == "perforated_attention":
            o, orf = out, want
            mask_ok = True
            kept = perforation.traced_execute_mask(
                seq // 32, fini, kn[kern][:, None])
        else:
            (o, m), (orf, mr) = out, want
            mask_ok = bool(torch.equal(m, mr))
        err = float((o.float() - orf.float()).abs().max())
        note(kern, err, ATOL[kern], mask_ok,
             f"lane grid, {LANES} lanes at full width, knobs "
             f"{[round(float(v), 6) for v in kn[kern]]}")
        same = all(torch.equal(single(l_)[0] if kern != "perforated_attention"
                               else single(l_), o[l_])
                   for l_ in range(LANES))
        if kern != "perforated_attention":
            same = same and all(torch.equal(single(l_)[1], m[l_])
                                for l_ in range(LANES))
        log(f"  {kern} lane l equals a single call at knob l: {same}")
        check(same, f"{kern}: a lane departs from the single call at its "
                    "knob")
        n_cuda = lane_cuda[kern]  # counted in phase 6 (torch.profiler)
        # the work this run's data needs, and one library call computing
        # the same LANES outputs
        if kern == "taf_matmul":
            union = int((~m).any(0).sum())
            ops_ = 2.0 * 16 * d * d * union
            bytes_ = f4 * (seq * d + d * d + LANES * seq * d)
            xb = s["x"].expand(LANES, -1, -1)
            lib = lambda: torch.matmul(xb, s["wp"])  # noqa: E731
            work = (f"{union} of {m.shape[1]} row blocks computed in some "
                    f"lane (per lane {[int((~mm).sum()) for mm in m]})")
        elif kern == "iact_rowfn":
            union = int((~m).any(0).sum())
            ops_ = union * 2.0 * 16 * d * d_h * 2
            bytes_ = f4 * (seq * d + 2 * d * d_h + LANES * seq * d)
            ab = s["a"].expand(LANES, -1, -1)
            lib = lambda: F.gelu(ab @ s["w1"], approximate="tanh") \
                @ s["w2"]  # noqa: E731
            work = (f"{union} of {m.shape[1]} blocks computed in some lane "
                    f"(per lane {[int((~mm).sum()) for mm in m]})")
        else:
            causal = torch.tril(torch.ones(seq, seq, dtype=torch.bool,
                                           device=dev))
            allowed = causal[None] & kept.repeat_interleave(32, 1)[:, None]
            pairs = int(allowed.sum()) * q.shape[1]
            ops_ = 4.0 * q.shape[3] * pairs
            bytes_ = f4 * (3 + LANES) * q.numel()
            qb = q[0].expand(LANES, -1, -1, -1)
            am = allowed[:, None]
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qb, qb, qb, attn_mask=am)
            work = f"{pairs} (query, key) pairs over {LANES} lanes"
        row = dict(
            kernel=kern, module=modules[kern], lanes=LANES,
            max_abs_err=err, ms=ms(group),
            singles_ms=ms(lambda: [single(l_) for l_ in range(LANES)]),
            plain_ms=ms(plain, repeats=3), library_ms=ms(lib),
            ops=ops_, bytes=bytes_, work=work, cuda_per_group=n_cuda)
        log(f"  {kern} [lane grid, {LANES} lanes]: ms={row['ms']!r} "
            f"{LANES} single calls ms={row['singles_ms']!r} "
            f"plain_ms={row['plain_ms']!r} library_ms={row['library_ms']!r}"
            f" CUDA kernels a group call={n_cuda} ({work})")
        rows.append(row)
        lane_report[kern] = {k: v for k, v in row.items() if k != "module"}
    torch.cuda.synchronize()

    # (b) the 30-spec sweep through run_batch: the slice's main path
    log("  phase 4's sweep through run_batch (jobs 4):")
    with open(BASELINE) as f:
        baseline = json.load(f)
    ops.reset_counts()
    summary = approx_ffn_sweep.main(
        report=lambda n, v, d_: log(f"    {n},{v},{d_}"), substrate="cuda",
        device=dev, jobs=4)
    launches, lane_launches = ops.launch_counts(), ops.lane_counts()
    bad = approx_ffn_sweep.check_front(summary, baseline)
    log(f"  batched front: n_records={summary['n_records']} "
        f"n_front={summary['front']['n_front']} "
        f"hv={summary['front']['hypervolume']!r} best approx fractions "
        + " / ".join(str(summary['best_under_10pct'][t]['approx_fraction'])
                     for t in approx_ffn_sweep.TECHNIQUES)
        + f" parity={summary['parity']} launches={launches} (serial sweep, "
        f"phase 4: {serial_launches}) lane calls={lane_launches}")
    check(not bad, f"batched sweep front departs from the committed one: "
                   f"{bad}")
    for k in APP_KERNELS:
        check(lane_launches[k] > 0,
              f"{k}: no group ran as one lane-grid call in the batched "
              "sweep")
        check(launches[k] < serial_launches[k],
              f"{k}: the batched sweep made {launches[k]} calls, the serial "
              f"one {serial_launches[k]}")

    # (c) the driver's predict mode and the cost model's regression gate
    log("  python -m repro_torch.benchmarks.run --only costmodel,ffn "
        "--predict --check-regression (in process):")
    shutil.rmtree(PREDICT_DIR, ignore_errors=True)
    gate_base = os.path.join(bench_run.BASELINES, "BENCH_costmodel.json")
    rc = bench_run.main(["--only", "costmodel,ffn", "--predict",
                         "--device", str(dev), "--artifacts", PREDICT_DIR,
                         "--check-regression", gate_base])
    stamp_card(PREDICT_DIR, card)
    with open(os.path.join(PREDICT_DIR, "BENCH_costmodel.json")) as f:
        cm = json.load(f)
    with open(os.path.join(PREDICT_DIR, "BENCH_ffn_predict.json")) as f:
        fp = json.load(f)
    log(f"  costmodel: ffn kept {cm['ffn']['kept']} dropped "
        f"{cm['ffn']['dropped']} band {cm['ffn']['band_measured']} of "
        f"{cm['ffn']['n_grid']} recovery {cm['ffn']['front_recovery']!r}; "
        f"ffn --predict recovery {fp['front_recovery']['ratio']!r}; apps "
        + json.dumps({k: [v["kept"], v["spearman"], v["bound_holds"]]
                      for k, v in cm["apps"].items()}))
    check(fp["front_recovery"]["recovered"]
          and cm["ffn"]["front_recovery"]["ratio"] >= 0.90,
          "the predicted band does not recover the committed front")
    fails = [] if rc == 0 else [f"benchmarks.run --predict exited {rc}"]
    return (dict(lanes=lane_report, batched_sweep=dict(
        summary=summary, launches=launches, lane_launches=lane_launches),
        costmodel=cm, ffn_predict=fp), rows, lane_launches, fails)


# phase 11: the serving slice at Qwen3-1.7B's full width
SERVE_DIR = os.path.join(HERE, "chiprun_out", "bench_serve")
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 128, 32
ENGINE_SLOTS, ENGINE_REQUESTS, ENGINE_MAX_LEN = 8, 16, 256
QOS_TARGETS = {"default": 0.10, "batch": 1.0}   # the qos drill's classes


def probe_threshold(model, params, dev, thresholds):
    """A decode-TAF threshold that skips layer-steps at this width: the
    smallest of `thresholds` under which a precise run's per-layer RSD
    values fall in at least a tenth of the layer-steps, else the largest
    under which any falls, else (no threshold of the grid would skip
    anything on these random weights) the 25th percentile of the RSD
    values themselves. Returns (threshold, where it came from, the RSD
    values' quartiles)."""
    import numpy as np
    import torch
    from repro_torch.qos import set_decode_threshold
    rng = np.random.RandomState(1)
    prompts = rng.randint(0, model.cfg.vocab_size,
                          (SERVE_BATCH, SERVE_PROMPT)).astype(np.int32)
    logits, cache = model.prefill(params, {
        "tokens": prompts, "max_len": SERVE_PROMPT + SERVE_GEN})
    set_decode_threshold(cache, 0.0)
    tokens = torch.argmax(logits, dim=-1).to(torch.int32)
    rsds = []
    for t in range(SERVE_GEN - 1):
        logits, cache = model.decode_step(params, cache, tokens,
                                          SERVE_PROMPT + t)
        tokens = torch.argmax(logits, dim=-1).to(torch.int32)
        win = cache["taf"]["window"].double()
        if int(cache["taf"]["filled"].min()) >= win.shape[1]:
            mu = win.mean(dim=1)
            sd = win.std(dim=1, unbiased=False)
            rsds += (sd / mu.abs().clamp(min=1e-12)).tolist()
    rsds = np.asarray(rsds)
    quart = [float(q) for q in np.percentile(rsds, (25, 50, 75))]
    frac = {th: float((rsds < th).mean()) for th in thresholds}
    enough = [th for th in thresholds if frac[th] >= 0.1]
    some = [th for th in thresholds if frac[th] > 0]
    if enough:
        return min(enough), f"grid (stable share {frac})", quart
    if some:
        return max(some), f"grid (stable share {frac})", quart
    return quart[0], f"the data: no grid threshold skips ({frac})", quart


def engine_requests(vocab):
    """ENGINE_REQUESTS seeded requests: prompts of SERVE_PROMPT tokens, 8 to
    32 new tokens, the first half in the tight "default" class."""
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.RandomState(0)
    return [Request(uid=i, prompt=rng.randint(0, vocab, SERVE_PROMPT)
                    .astype(np.int32),
                    max_new_tokens=int(rng.randint(8, 33)),
                    qos_class="default" if i < ENGINE_REQUESTS // 2
                    else "batch")
            for i in range(ENGINE_REQUESTS)]


def drain(engine, reqs):
    import torch
    from repro_torch.obs import metrics as obs_metrics
    engine.warmup()
    reads = obs_metrics.host_reads()
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    stats = engine.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(tokens_per_s=stats.tokens_out / wall, wall_s=wall,
                host_reads=obs_metrics.host_reads() - reads,
                ticks=stats.ticks, tokens_out=stats.tokens_out,
                finished=stats.finished, latency=stats.latency_summary(),
                taf_skip_fraction=stats.taf_skip_fraction,
                knob_moves=stats.knob_moves,
                canary_ticks=stats.canary_ticks), stats


def phase_serving(dev, card):
    """Phase 11: the port's serving path at Qwen3-1.7B's full width (28
    layers, seed 0). Returns the report and the regression gate's
    failures (the caller fails on them after writing the report)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import qos
    from repro_torch.benchmarks import qos_serving
    from repro_torch.benchmarks import run as bench_run
    from repro_torch.configs import get_config
    from repro_torch.core import harness
    from repro_torch.core.types import ApproxSpec, Level, TAFParams, Technique
    from repro_torch.launch import serve
    from repro_torch.models import build
    from repro_torch.serving import ServingEngine

    full = get_config("qwen3-1.7b")
    out = {"config": dict(name=full.name, n_layers=full.n_layers,
                          d_model=full.d_model, n_heads=full.n_heads,
                          n_kv_heads=full.n_kv_heads, d_ff=full.d_ff,
                          vocab=full.vocab_size,
                          params=full.param_count())}

    # (a) decode equals teacher-forced forward, float32 compute
    m32 = build(dataclasses.replace(full, compute_dtype="float32"), dev)
    p32 = m32.init(torch.Generator(device=dev).manual_seed(0))
    toks = np.random.RandomState(0).randint(
        0, full.vocab_size, (SERVE_BATCH, SERVE_PROMPT + 4)).astype(np.int32)
    _, cache = m32.prefill(p32, {"tokens": toks[:, :SERVE_PROMPT],
                                 "max_len": SERVE_PROMPT + 4})
    errs = []
    for t in range(3):
        pos = SERVE_PROMPT + t
        logits, cache = m32.decode_step(
            p32, cache, torch.as_tensor(toks[:, pos], device=dev), pos)
        h = m32.hidden(p32, {"tokens": toks[:, :pos + 2]})
        ref = h[:, pos] @ p32["head"]
        errs.append(float((logits - ref).abs().max())
                    / (float(ref.abs().max()) + 1e-6))
    log(f"  decode vs forward (float32, {full.n_layers} layers): max "
        f"relative error {max(errs):.3g} (limit 0.02)")
    check(max(errs) < 0.02, f"decode departs from forward: {errs}")
    out["decode_vs_forward"] = errs
    del m32, p32, cache, h, ref
    torch.cuda.empty_cache()

    # (b) launch.serve, precise and with decode TAF, bf16 compute
    model = build(full, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))

    def taf_cfg(th):
        return dataclasses.replace(full, approx_decode=ApproxSpec(
            Technique.TAF, Level.BLOCK, taf=TAFParams(2, 4, float(th))))

    th, origin, quart = probe_threshold(build(taf_cfg(0.0), dev), params,
                                        dev, qos_serving._THRESHOLDS)
    log(f"  TAF threshold {th:.4g} taken from {origin}; RSD quartiles of a "
        f"precise run {quart}")
    runs = {}
    for label, cfg in (("precise", full), ("taf", taf_cfg(th))):
        r = serve.run(cfg, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                      gen=SERVE_GEN, device=dev, params=params)
        check(bool(np.isfinite(r["tokens"]).all())
              and r["tokens"].shape == (SERVE_BATCH, SERVE_GEN),
              f"launch.serve {label}: tokens of the wrong shape")
        runs[label] = dict(prefill_ms=r["prefill_s"] * 1e3,
                           decode_tokens_per_s=r["tokens_per_s"],
                           skip_fraction=r["taf_skipped"]
                           / max(r["taf_total"], 1),
                           skipped=r["taf_skipped"], total=r["taf_total"])
        log(f"  launch.serve {label}: prefill {runs[label]['prefill_ms']:.3f}"
            f" ms, decode {r['tokens_per_s']:.1f} tokens/s, skipped "
            f"{r['taf_skipped']}/{r['taf_total']} layer-steps")
    check(runs["taf"]["skipped"] > 0,
          f"TAF at threshold {th} skipped no layer-step")
    out["serve"] = dict(runs, threshold=th, threshold_origin=origin,
                        rsd_quartiles=quart)

    # one decode step's CUDA kernels, precise and fully skipped, in a
    # fresh process (torch.profiler records no CUDA kernel after phase 8)
    prof_path = os.path.join(os.path.dirname(REPORT), "serve_profile.json")
    subprocess.run([sys.executable, "-m",
                    "repro_torch.benchmarks.serve_profile",
                    "--arch", full.name, "--batch", str(SERVE_BATCH),
                    "--prompt-len", str(SERVE_PROMPT), "--out", prof_path],
                   check=True, timeout=600, cwd=HERE,
                   env=dict(os.environ, PYTHONPATH=SRC),
                   stdout=subprocess.DEVNULL)
    with open(prof_path) as f:
        prof = json.load(f)
    n, n_short = prof["n_layers"], prof["short_layers"]
    for label in ("plain", "precise", "skipped", "skipped_short"):
        row = prof[label]
        log(f"  decode step {label}: {row['kernels']} CUDA kernels "
            f"({row['gemm_kernels']} products), device "
            f"{row['device_ms']:.3f} ms, host {row['host_ms']:.3f} ms, "
            f"wall {row['wall_ms']:.3f} ms, idle {row['idle']:.3f}; "
            f"kernels in each profile {row['kernel_counts']}")
    # a skipped layer runs exactly one kernel, the residual add of its
    # memoized delta: the skipped step's count is the step's fixed kernels
    # (embedding, detector step, final norm, the head's one product) plus
    # one a layer, at both layer counts
    fixed = prof["skipped_short"]["kernels"] - n_short
    log(f"  skipped step: {fixed} fixed kernels + 1 a layer "
        f"({prof['skipped']['kernels']} at {n} layers, "
        f"{prof['skipped_short']['kernels']} at {n_short})")
    counts = {k: (prof[k]["kernels"], prof[k]["gemm_kernels"])
              for k in ("plain", "precise", "skipped", "skipped_short")}
    for cond, what in (
            (prof["precise"]["gemm_kernels"] >= 7 * n,
             f"the precise step ran fewer than {7 * n} products"),
            (prof["skipped"]["gemm_kernels"] <= 1
             and prof["skipped_short"]["gemm_kernels"] <= 1,
             "a skipped step ran more than the head's product"),
            (prof["skipped"]["kernels"] == n + fixed,
             f"the skipped step ran other than {n + fixed} kernels"),
            (fixed < prof["plain"]["kernels"] / n,
             "the skipped step's fixed kernels outnumber a plain layer's")):
        check(cond, f"{what}: (kernels, products) per step {counts}, "
                    f"kernels in each profile "
                    f"{ {k: prof[k]['kernel_counts'] for k in counts} }")
    out["step_profile"] = {k: {kk: vv for kk, vv in v.items()
                               if kk != "kernel_names"}
                           if isinstance(v, dict) else v
                           for k, v in prof.items()}
    out["step_profile"]["skipped_kernel_names"] = \
        prof["skipped"]["kernel_names"]

    # (c) continuous batching: precise, then under a QosEngine whose
    # ladder comes from the calibration sweep at this width
    grid = sorted(set(qos_serving._THRESHOLDS) | {th})
    app = qos.make_decode_app(taf_cfg(th), gen=12, metric="mcr",
                              device=dev, params=params)
    recs = harness.sweep(app, qos.threshold_grid(taf_cfg(th), grid),
                         repeats=1)
    policy = qos.QosPolicy.from_records(recs, metric="mcr",
                                        use_modeled=True)
    log(f"  ladder: " + "; ".join(
        f"th={e.spec.get('thresh')} err={e.error:.3f} "
        f"modeled={e.modeled_speedup:.3f}" for e in policy.entries))
    engines = {}
    for label in ("precise", "qos"):
        if label == "precise":
            eng = ServingEngine(model, params, slots=ENGINE_SLOTS,
                                max_len=ENGINE_MAX_LEN,
                                prompt_len=SERVE_PROMPT)
        else:
            q = qos.QosEngine(policy, QOS_TARGETS, sample_fraction=0.25,
                              window=8, config=qos.ControllerConfig(
                                  min_samples=2, hold_ticks=2,
                                  fallback_hold=4))
            eng = ServingEngine(build(taf_cfg(th), dev), params,
                                slots=ENGINE_SLOTS, max_len=ENGINE_MAX_LEN,
                                prompt_len=SERVE_PROMPT, qos=q)
        reqs = engine_requests(full.vocab_size)
        row, stats = drain(eng, reqs)
        check(stats.finished == ENGINE_REQUESTS,
              f"engine {label} did not drain")
        row["outputs"] = [r.output for r in reqs]
        if label == "qos":
            row["measured_error"] = q.summary()["genuine_mean_error"]
            row["knob_actuations"] = [(m.tick, m.value, m.reason)
                                      for m in eng.knob_events]
        engines[label] = row
        lat = row["latency"]
        log(f"  engine {label}: {row['tokens_per_s']:.1f} tokens/s, TTFT "
            f"p50/p99 {lat['ttft_p50_s']:.3f}/{lat['ttft_p99_s']:.3f} s, "
            f"latency p50/p99 {lat['latency_p50_s']:.3f}/"
            f"{lat['latency_p99_s']:.3f} s, knob moves {row['knob_moves']},"
            f" canary ticks {row['canary_ticks']}, skip fraction "
            f"{row['taf_skip_fraction']:.4f}")
    # with the knob pinned precise, every canary error is exactly 0.0
    pinned = qos.QosEngine(policy, 1e-9, sample_fraction=1.0, window=8)
    eng = ServingEngine(build(taf_cfg(th), dev), params, slots=ENGINE_SLOTS,
                        max_len=ENGINE_MAX_LEN, prompt_len=SERVE_PROMPT,
                        qos=pinned)
    reqs = engine_requests(full.vocab_size)[:4]
    for r in reqs:
        r.max_new_tokens = 8
    _, stats = drain(eng, reqs)
    ms = pinned.monitor.stats()
    log(f"  pinned precise: {stats.canary_ticks} canary ticks, mean error "
        f"{ms.mean_error!r}, skipped {stats.taf_skipped}")
    check(stats.canary_ticks == stats.ticks > 0 and ms.mean_error == 0.0
          and ms.samples == stats.canary_ticks and stats.taf_skipped == 0,
          "a precise canary departed from the served step")
    engines["pinned_precise"] = dict(canary_ticks=stats.canary_ticks,
                                     mean_error=ms.mean_error)
    out["engine"] = engines
    # phase 12 serves the same model, ladder and threshold sharded
    ctx = dict(model=model, params=params, taf_cfg=taf_cfg(th),
               policy=policy, engines=engines)
    del eng
    torch.cuda.empty_cache()

    # (d) the benchmark runner's qos and obs modules and the regression gate
    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    results, errors = bench_run.run_modules(
        ["qos", "obs"], lambda n_, v_, d_="": log(f"  {n_},{v_},{d_}"),
        device=dev, artifacts_dir=SERVE_DIR)
    check(not errors, f"runner modules raised: {errors}")
    stamp_card(SERVE_DIR, card)
    fails = [f for name in ("BENCH_qos.json", "BENCH_obs.json")
             for f in bench_run.check_regression(
                 SERVE_DIR, os.path.join(bench_run.BASELINES, name))]
    for f in fails:
        log(f"  regression FAIL {f}")
    if not fails:
        log(f"  regression gate OK: {os.path.relpath(SERVE_DIR, HERE)}")
    out["runner"] = {k: {kk: vv for kk, vv in v.items() if kk != "obs"}
                     for k, v in results.items()}
    return out, fails, ctx


# phase 12: the sharded serving data plane on one NCCL rank
SHARDS, SHARD_SLOTS = 4, 8
SHARD_BENCH_DIR = os.path.join(HERE, "chiprun_out", "bench_sharded")


def engine_row(label, row, stats):
    lat = row["latency"]
    row["shard_skip_fractions"] = stats.shard_skip_fractions
    log(f"  engine {label}: {row['tokens_per_s']:.1f} tokens/s, TTFT "
        f"p50/p99 {lat['ttft_p50_s']:.3f}/{lat['ttft_p99_s']:.3f} s, "
        f"latency p50/p99 {lat['latency_p50_s']:.3f}/"
        f"{lat['latency_p99_s']:.3f} s, knob moves {row['knob_moves']}, "
        f"canary ticks {row['canary_ticks']}, skip fraction "
        f"{row['taf_skip_fraction']:.4f}, per shard "
        f"{[round(f, 4) for f in stats.shard_skip_fractions]}, host reads "
        f"a tick {row.get('host_reads_per_tick')}")
    return row


def drill_run(ctx, dev):
    """The 4-shard QoS engine under the fault drill: inject(10.0, shard=3)
    at the first tick from 8 on where shard 3's live classes are a strict
    subset of the live classes. Returns the trajectories, the injected
    counts of each class's evidence and shard 3's classes then."""
    from repro_torch import qos
    from repro_torch.models import build
    from repro_torch.serving import ServingEngine
    q = qos.QosEngine(ctx["policy"], QOS_TARGETS, sample_fraction=0.25,
                      window=8, config=qos.ControllerConfig(
                          min_samples=2, hold_ticks=2, fallback_hold=4))
    eng = ServingEngine(build(ctx["taf_cfg"], dev), ctx["params"],
                        slots=SHARD_SLOTS, max_len=ENGINE_MAX_LEN,
                        prompt_len=SERVE_PROMPT, qos=q, devices=1,
                        shards=SHARDS)
    eng.warmup()
    for r in engine_requests(ctx["model"].cfg.vocab_size):
        eng.submit(r)
    on3, at, before = None, None, {}
    for tick in range(10_000):
        # the classes of the last plan, which the drill's inject reads
        last = q._last_shard_classes
        mine, live = set(last[3]), {c for sc in last for c in sc}
        if at is None and tick >= 8 and mine and mine < live:
            q.inject(10.0, shard=3)
            on3, at = sorted(mine), tick
            before = {c: len(ctl.trajectory)
                      for c, ctl in q.controllers.items()}
        if eng.tick() == 0 and not eng.queue:
            break
    traj = {cls: [(p.step, p.index, p.event) for p in ctl.trajectory]
            for cls, ctl in q.controllers.items()}
    hit = {cls: m.injected for cls, m in q.class_monitors.items()}
    after = {cls: [e for _, _, e in t[before.get(cls, 0):]]
             for cls, t in traj.items()}
    return dict(knob_log=eng.knob_log, trajectory=traj, hit=hit, on3=on3,
                at=at, events_after=after)


def phase_sharded(dev, card, ctx):
    """Phase 12: the sharded serving data plane at Qwen3-1.7B's full width
    on a one-rank NCCL group the phase starts. Returns the report and the
    regression gate's failures."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import qos
    from repro_torch.benchmarks import run as bench_run
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import build
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.optim import compress
    from repro_torch.qos import set_decode_threshold
    from repro_torch.runtime import elastic
    from repro_torch.runtime.pipeline import pipeline_apply
    from repro_torch.serving import ServingEngine

    started = elastic.init_single(dev)
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          f"phase 12 needs a one-rank NCCL group, got "
          f"{dist.get_backend()} x {dist.get_world_size()}")
    log(f"  process group: {dist.get_backend()}, world size "
        f"{dist.get_world_size()}")
    model, params, policy = ctx["model"], ctx["params"], ctx["policy"]
    vocab = model.cfg.vocab_size
    out = {"shards": SHARDS, "slots": SHARD_SLOTS}

    def qos_engine():
        return qos.QosEngine(policy, QOS_TARGETS, sample_fraction=0.25,
                             window=8, config=qos.ControllerConfig(
                                 min_samples=2, hold_ticks=2,
                                 fallback_hold=4))

    def engine(label, shards, slots):
        if label == "precise":
            return ServingEngine(model, params, slots=slots,
                                 max_len=ENGINE_MAX_LEN,
                                 prompt_len=SERVE_PROMPT, devices=1,
                                 shards=shards)
        return ServingEngine(build(ctx["taf_cfg"], dev), params, slots=slots,
                             max_len=ENGINE_MAX_LEN, prompt_len=SERVE_PROMPT,
                             qos=qos_engine(), devices=1, shards=shards)

    # (a) one shard on the one-rank mesh equals phase 11's unsharded
    # engines token for token (and knob for knob)
    one = {}
    for label in ("precise", "qos"):
        eng = engine(label, 1, ENGINE_SLOTS)
        reqs = engine_requests(vocab)
        row, stats = drain(eng, reqs)
        same = [r.output for r in reqs] == ctx["engines"][label]["outputs"]
        knobs = [(t, v[0]) for t, v in eng.knob_log] == [
            (t, v) for t, v, _ in ctx["engines"][label].get(
                "knob_actuations", [])]
        log(f"  1 shard {label}: token streams equal to phase 11's "
            f"unsharded engine: {same}; knob log equal: {knobs}; "
            f"{row['tokens_per_s']:.1f} tokens/s")
        check(same and knobs and stats.finished == ENGINE_REQUESTS,
              f"the 1-shard {label} engine departs from the unsharded one")
        one[label] = dict(equal=same, knobs_equal=knobs,
                          tokens_per_s=row["tokens_per_s"])
    out["one_shard"] = one

    # (b) four shards, precise and under per-shard QoS
    engines = {}
    for label in ("precise", "qos"):
        eng = engine(label, SHARDS, SHARD_SLOTS)
        row, stats = drain(eng, engine_requests(vocab))
        check(stats.finished == ENGINE_REQUESTS,
              f"the {SHARDS}-shard {label} engine did not drain")
        reads = row["host_reads"] - stats.canary_ticks
        row["host_reads_per_tick"] = reads / max(stats.ticks, 1)
        check(reads == eng.host_reads_per_tick * stats.ticks,
              f"{label}: {reads} host reads in {stats.ticks} ticks, "
              f"expected {eng.host_reads_per_tick} a tick")
        if label == "qos":
            row["measured_error"] = eng.qos.summary()["genuine_mean_error"]
            row["shard_exposure"] = eng.qos.summary()["shard_exposure"]
            row["knob_actuations"] = [(m.tick, m.value, m.reason)
                                      for m in eng.knob_events]
            check(eng.qos.n_shards == SHARDS, "QoS plane not sharded")
            # four per-shard knob vectors: no step built, no host read
            builds, reads0 = steps_mod.builds(), obs_metrics.host_reads()
            for vec in ((0.3,) * 4, (0.0, 0.3, 0.0, 0.3),
                        (0.02, 0.04, 0.06, 0.1), (0.0,) * 4):
                set_decode_threshold(eng.cache, vec)
            moved = obs_metrics.host_reads() - reads0
            th = eng.cache["taf"]["threshold"][:, 0].tolist()
            log(f"  4 knob vectors: steps built {steps_mod.builds() - builds}"
                f", host reads {moved}, thresholds now {th}")
            check(steps_mod.builds() == builds and moved == 0
                  and th == [0.0] * 4,
                  "a per-shard knob move built a step or read the device")
        engines[label] = engine_row(f"{SHARDS} shards {label}", row, stats)
    out["engine"] = engines

    # with the knob pinned precise, every canary error is exactly 0.0
    pinned = qos.QosEngine(policy, 1e-9, sample_fraction=1.0, window=8)
    eng = ServingEngine(build(ctx["taf_cfg"], dev), params,
                        slots=SHARD_SLOTS, max_len=ENGINE_MAX_LEN,
                        prompt_len=SERVE_PROMPT, qos=pinned, devices=1,
                        shards=SHARDS)
    reqs = engine_requests(vocab)[:SHARD_SLOTS]
    for r in reqs:
        r.max_new_tokens = 8
    _, stats = drain(eng, reqs)
    ms = pinned.monitor.stats()
    log(f"  pinned precise, {SHARDS} shards: {stats.canary_ticks} canary "
        f"ticks, {ms.samples} shard canaries, mean error {ms.mean_error!r},"
        f" skipped {stats.taf_skipped}")
    check(stats.canary_ticks == stats.ticks > 0 and ms.mean_error == 0.0
          and ms.samples >= stats.canary_ticks and stats.taf_skipped == 0,
          "a precise canary departed from the served step (sharded)")
    out["pinned_precise"] = dict(canary_ticks=stats.canary_ticks,
                                 samples=ms.samples,
                                 mean_error=ms.mean_error)

    # the fault drill on shard 3, twice: localized and repeatable
    runs = [drill_run(ctx, dev) for _ in range(2)]
    d = runs[0]
    log(f"  drill: inject(10.0, shard=3) at tick {d['at']}, shard 3 "
        f"classes {d['on3']}, evidence hit {d['hit']}, runs equal "
        f"{runs[0] == runs[1]}")
    check(d["at"] is not None and runs[0] == runs[1]
          and d["hit"] == {c: int(c in d["on3"]) for c in d["hit"]},
          f"the per-shard drill is not localized or not repeatable: {d}")
    check(all("fallback" in d["events_after"][c] for c in d["on3"]),
          f"the drill did not back off shard 3's classes: {d}")
    out["drill"] = {k: v for k, v in d.items()
                    if k not in ("knob_log", "events_after")}

    # one sharded decode step's CUDA kernels, in a fresh process
    prof_path = os.path.join(os.path.dirname(REPORT),
                             "serve_profile_sharded.json")
    subprocess.run([sys.executable, "-m",
                    "repro_torch.benchmarks.serve_profile",
                    "--arch", model.cfg.name, "--batch", str(SHARD_SLOTS),
                    "--prompt-len", str(SERVE_PROMPT), "--shards",
                    str(SHARDS), "--out", prof_path],
                   check=True, timeout=600, cwd=HERE,
                   env=dict(os.environ, PYTHONPATH=SRC),
                   stdout=subprocess.DEVNULL)
    with open(prof_path) as f:
        prof = json.load(f)
    for label in ("plain", "sharded_plain", "precise", "sharded_precise"):
        row = prof[label]
        log(f"  decode step {label} (batch {SHARD_SLOTS}): {row['kernels']} "
            f"CUDA kernels ({row['gemm_kernels']} products), device "
            f"{row['device_ms']:.3f} ms, host {row['host_ms']:.3f} ms, wall "
            f"{row['wall_ms']:.3f} ms, idle {row['idle']:.3f}; kernels in "
            f"each profile {row['kernel_counts']}")
    # each shard runs its own decode step: about SHARDS x the kernels
    check(prof["sharded_plain"]["kernels"]
          > (SHARDS - 1) * prof["plain"]["kernels"],
          f"a sharded step did not run every shard's decode: "
          f"{prof['sharded_plain']['kernels']} kernels against "
          f"{prof['plain']['kernels']} unsharded")
    out["step_profile"] = {k: {kk: vv for kk, vv in v.items()
                               if kk != "kernel_names"}
                           if isinstance(v, dict) else v
                           for k, v in prof.items()}

    # (c) the benchmark runner with --devices 1: its geometry and the exact
    # fields against the committed baseline. The close fields are not
    # gated: a sharded engine judges each class on its own evidence
    # (`QosEngine.enable_sharding`) and, with one shard, the drill's spike
    # lands on the shared monitor only (as the JAX drill's), so its
    # fallbacks differ from the unsharded baseline's by design.
    shutil.rmtree(SHARD_BENCH_DIR, ignore_errors=True)
    results, errors = bench_run.run_modules(
        ["qos"], lambda n_, v_, d_="": log(f"  {n_},{v_},{d_}"),
        device=dev, artifacts_dir=SHARD_BENCH_DIR, devices=1)
    check(not errors, f"run --only qos --devices 1 raised: {errors}")
    stamp_card(SHARD_BENCH_DIR, card)
    doc = results["qos"]
    with open(os.path.join(bench_run.BASELINES, "BENCH_qos.json")) as f:
        base = json.load(f)
    exact = bench_run._BASELINE_CHECKS["BENCH_qos.json"]["exact"]
    fails = [f"BENCH_qos.json (--devices 1):{k}: {doc[k]!r} vs baseline "
             f"{base[k]!r}" for k in exact if doc[k] != base[k]]
    check(doc["mesh_shape"] == [1, 1],
          f"--devices 1 artifact mesh_shape {doc['mesh_shape']}")
    for f in fails:
        log(f"  regression FAIL {f}")
    if not fails:
        log(f"  --devices 1 artifact: mesh_shape [1, 1], exact fields "
            f"{list(exact)} equal the baseline's")
    out["runner"] = {k: v for k, v in doc.items() if k != "obs"}

    # (d) the collectives through the NCCL group
    mesh = elastic.make_mesh((1,), ("stage",), device=dev)
    rng = np.random.RandomState(0)
    ws = torch.tensor(rng.standard_normal((1, 16, 16)) * 0.3,
                      dtype=torch.float32, device=dev)
    x = torch.tensor(rng.standard_normal((8, 16)), dtype=torch.float32,
                     device=dev)
    piped = pipeline_apply(lambda w, h: torch.tanh(h @ w), ws, x, mesh,
                           axis="stage", n_microbatches=4)
    err = float((piped - torch.tanh(x @ ws[0])).abs().max())
    g = torch.tensor(rng.standard_normal((4096,)), dtype=torch.float32,
                     device=dev)
    q, scale = compress.quantize_tensor(g)
    mean = compress.compressed_allreduce(g)
    exact = bool(torch.equal(mean, compress.dequantize_tensor(q, scale)))
    log(f"  pipeline_apply, 1 stage on NCCL: max error {err:.3g} (limit "
        f"1e-5); compressed all-reduce on 1 rank equals the dequantized "
        f"tensor: {exact}")
    check(err < 1e-5 and exact, "the collectives disagree on NCCL")
    out["collectives"] = dict(pipeline_err=err, allreduce_exact=exact)
    if started:
        dist.destroy_process_group()
    return out, fails


# phase 13: the model zoo's serving path at full width
ZOO_BATCH, ZOO_PROMPT, ZOO_GEN = 4, 128, 32
# the float32 check: B * (prompt + 4) = 512 tokens, so an MoE forward over
# them splits into whole router groups of 512
ZOO_CHECK_PROMPT = 124
# arch -> (layers of the float32 check, layers served in bfloat16, whether
# the engine drains phase 11's 16 requests on it); None keeps the config's
ZOO = (("olmoe-1b-7b", None, None, True),
       ("zamba2-7b", None, None, True),
       ("rwkv6-1.6b", None, None, True),
       ("whisper-large-v3", None, None, False),
       ("pixtral-12b", None, None, False),
       ("starcoder2-3b", None, None, True),
       ("qwen1.5-4b", None, None, True),
       # 61 layers are 671 B parameters: 1.34 TB in bfloat16
       ("deepseek-v3-671b", 2, 4, True))


def zoo_config(arch, layers, **kw):
    """The registry's config of `arch` at `layers` layers (None: all), every
    width kept."""
    import dataclasses
    from repro_torch.configs import cut_depth, get_config
    cfg = get_config(arch)
    if layers is not None:
        cfg = cut_depth(cfg, layers)
    return dataclasses.replace(cfg, **kw)


def zoo_describe(cfg):
    desc = (f"{cfg.name} [{cfg.family}]: {cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, {cfg.n_heads} heads (kv {cfg.n_kv_heads}), "
            f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size} (padded "
            f"{cfg.padded_vocab_size})")
    if cfg.moe is not None:
        m = cfg.moe
        desc += (f", {m.n_experts} experts top-{m.experts_per_token} d_ff "
                 f"{m.d_ff_expert}, {m.n_shared_experts} shared")
        if m.n_dense_layers:
            desc += (f", {m.n_dense_layers} dense layers (d_ff "
                     f"{m.d_ff_dense or cfg.d_ff})")
    if cfg.use_mla:
        m = cfg.mla
        desc += (f", MLA ranks q {m.q_lora_rank} kv {m.kv_lora_rank} "
                 f"nope {m.qk_nope_head_dim} rope {m.qk_rope_head_dim}")
    if cfg.ssm is not None:
        desc += (f", Mamba2 state {cfg.ssm.d_state} head {cfg.ssm.head_dim}"
                 f" attn period {cfg.hybrid.attn_period}")
    if cfg.frontend in ("vision_patches", "audio_frames"):
        desc += (f", frontend {cfg.frontend} ("
                 f"{cfg.n_patch_tokens or cfg.max_source_positions} "
                 "positions)")
    return desc + f": {cfg.param_count() / 1e9:.3f} B parameters"


def zoo_check(cfg, dev):
    """Decode against the teacher-forced forward in float32 (MoE at
    capacity 8.0, where no token drops): the largest relative error of
    three steps."""
    import numpy as np
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import build
    model = build(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    s = ZOO_CHECK_PROMPT
    inputs, off = serve.frontend_batch(cfg, ZOO_BATCH, s + 4, 0)
    toks = inputs["tokens"]
    _, cache = model.prefill(params, dict(inputs, tokens=toks[:, :s],
                                          max_len=off + s + 4))
    h = model.hidden(params, inputs)
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    errs = []
    for t in range(3):
        logits, cache = model.decode_step(
            params, cache, torch.as_tensor(toks[:, s + t], device=dev),
            off + s + t)
        ref = (h[:, off + s + t] @ head).float()
        errs.append(float((logits - ref).abs().max())
                    / (float(ref.abs().max()) + 1e-6))
        check(bool(torch.isfinite(logits).all()), f"{cfg.name}: logits "
              "not finite")
    return errs


def phase_zoo(dev, card):
    """Phase 13: every family of the registry served at full width (depth
    cut only where one card's 80 GB forces it): decode against forward in
    float32, `launch.serve` in bfloat16 (olmoe also under expert
    perforation), and the engine on every family it serves (all but the
    vlm and the audio model, as in JAX)."""
    import dataclasses
    import gc
    import numpy as np
    import torch
    from repro_torch.core.types import (ApproxSpec, Level, PerforationKind,
                                        PerforationParams, Technique)
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import build, moe
    from repro_torch.serving import ServingEngine

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    out = {}
    t_phase = time.perf_counter()
    ops.reset_counts()
    for arch, check_layers, serve_layers, engine in ZOO:
        row = out[arch] = {}
        full = zoo_config(arch, None)
        for label, layers in (("float32 check", check_layers),
                              ("bfloat16 serving", serve_layers)):
            if layers is not None and layers < full.n_layers:
                cut = zoo_config(arch, layers)
                log(f"  {arch}: depth cut to {layers} of {full.n_layers} "
                    f"layers for the {label} ({cut.param_count() / 1e9:.3f}"
                    f" B of {full.param_count() / 1e9:.3f} B parameters): "
                    "one card's 80 GB holds no more; every width is kept")
                row.setdefault("cuts", {})[label] = layers
        moe_kw = {}
        if full.moe is not None:
            moe_kw = dict(moe=dataclasses.replace(zoo_config(
                arch, check_layers).moe, capacity_factor=8.0))
        c32 = zoo_config(arch, check_layers, compute_dtype="float32",
                         **moe_kw)
        log(f"  {zoo_describe(c32)} (float32, capacity 8.0)"
            if moe_kw else f"  {zoo_describe(c32)} (float32)")
        t0 = time.perf_counter()
        errs = zoo_check(c32, dev)
        free()
        row["config"] = zoo_describe(full)
        row["decode_vs_forward"] = errs
        log(f"  {arch} decode vs forward (float32, {c32.n_layers} layers): "
            f"max relative error {max(errs):.3g} (limit 0.02) "
            f"[{time.perf_counter() - t0:.1f} s, {card}]")
        check(max(errs) < 0.02, f"{arch}: decode departs from forward: "
              f"{errs}")

        cfg = zoo_config(arch, serve_layers)
        log(f"  {zoo_describe(cfg)} (bfloat16)")
        model = build(cfg, dev)
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        runs = [("precise", cfg)]
        if cfg.moe is not None and arch == "olmoe-1b-7b":
            spec = ApproxSpec(Technique.PERFORATION, Level.BLOCK,
                              perforation=PerforationParams(
                                  kind=PerforationKind.FINI, fraction=0.5))
            kept = moe.kept_experts(cfg.moe.n_experts, spec)
            log(f"  {arch} expert perforation fini 0.5 keeps "
                f"{len(kept)} of {cfg.moe.n_experts} experts: "
                f"{kept.tolist()}")
            check(len(kept) == cfg.moe.n_experts // 2,
                  f"expert perforation kept {len(kept)} experts")
            row["kept_experts"] = kept.tolist()
            runs.append(("experts perforated",
                         dataclasses.replace(cfg, approx_ffn=spec)))
        for label, rcfg in runs:
            # a short call first: the measured run times no first-call setup
            serve.run(rcfg, batch=ZOO_BATCH, prompt_len=ZOO_PROMPT, gen=2,
                      device=dev, params=params)
            r = serve.run(rcfg, batch=ZOO_BATCH, prompt_len=ZOO_PROMPT,
                          gen=ZOO_GEN, device=dev, params=params)
            check(r["tokens"].shape == (ZOO_BATCH, ZOO_GEN)
                  and bool(((r["tokens"] >= 0)
                            & (r["tokens"] < cfg.padded_vocab_size)).all()),
                  f"{arch} launch.serve {label}: bad tokens")
            row[label] = dict(prefill_ms=r["prefill_s"] * 1e3,
                              decode_tokens_per_s=r["tokens_per_s"])
            log(f"  {arch} launch.serve {label} (batch {ZOO_BATCH}, prompt "
                f"{ZOO_PROMPT}, gen {ZOO_GEN}, {cfg.n_layers} layers): "
                f"prefill {r['prefill_s'] * 1e3:.3f} ms, decode "
                f"{r['tokens_per_s']:.1f} tokens/s [{card}]")
        if engine:
            eng = ServingEngine(model, params, slots=ENGINE_SLOTS,
                                max_len=ENGINE_MAX_LEN,
                                prompt_len=SERVE_PROMPT)
            reqs = engine_requests(cfg.vocab_size)
            erow, stats = drain(eng, reqs)
            check(stats.finished == ENGINE_REQUESTS
                  and all(len(q.output) == q.max_new_tokens for q in reqs),
                  f"{arch} engine did not drain")
            lat = erow["latency"]
            row["engine"] = {k: erow[k] for k in (
                "tokens_per_s", "wall_s", "ticks", "tokens_out", "latency")}
            log(f"  {arch} engine ({ENGINE_SLOTS} slots, {ENGINE_REQUESTS} "
                f"requests): {erow['tokens_per_s']:.1f} tokens/s, TTFT "
                f"p50/p99 {lat['ttft_p50_s']:.3f}/{lat['ttft_p99_s']:.3f} s,"
                f" {erow['ticks']} ticks [{card}]")
            del eng
        del model, params
        free()
    launches = ops.launch_counts()
    out["kernel_launches"] = launches
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"  the zoo's path launched {launches} (no Pallas kernel lies on "
        f"it); phase 13 wall {out['wall_s']:.1f} s [{card}]")
    return out


# phase 14: the model zoo's training half, Qwen3-1.7B at full width
TRAIN_ARCH = "qwen3-1.7b"
# (a) float32 on the card against the CPU: the config's widths at 2 layers
TRAIN_CHECK_LAYERS, TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ = 2, 2, 128
# (b) the config as given (bf16 compute, float32 masters, remat)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_WARMUP = 8, 2048, 12, 2
TRAIN_LR = 3e-4
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core peak
# (c) the 100M example: 60 steps, checkpoints every 20, preempted at 40
TRAIN_100M_STEPS, TRAIN_100M_EVERY, TRAIN_100M_PREEMPT = 60, 20, 40


def tree_to(tree, dev):
    """A copy of a parameter tree (dicts, lists, None) on `dev`."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, dev) for v in tree]
    return tree.detach().to(dev, copy=True)


def train_parity(dev, card):
    """(a) One `make_train_step` on the card and on the CPU from the same
    float32 masters and `SyntheticLM` batch, TF32 off: loss within 1e-5
    relative, grad_norm within 1e-4, params within 1e-6 where AdamW moves
    them by about lr sign(g) (|g| > 1e-4 rms(g) and the clipped |g| above
    100 eps), within 2 lr elsewhere."""
    import dataclasses
    import torch
    from repro_torch.configs import cut_depth, get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.models import build
    from repro_torch.optim import adamw
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(cut_depth(get_config(TRAIN_ARCH),
                                        TRAIN_CHECK_LAYERS),
                              compute_dtype="float32")
    batch = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_CHECK_SEQ,
        global_batch=TRAIN_CHECK_BATCH, seed=0)).batch(0)
    cpu = torch.device("cpu")
    m_cpu = build(cfg, cpu)
    masters = {"cpu": m_cpu.masters(torch.Generator().manual_seed(0))}
    masters["card"] = tree_to(masters["cpu"], dev)
    _, _, grads = steps.loss_and_grads(m_cpu, masters["cpu"], batch)
    grads = [g.detach().double() for g in grads]
    ocfg = adamw.AdamWConfig(lr=TRAIN_LR)
    out = {}
    for label, d, model in (("cpu", cpu, m_cpu), ("card", dev,
                                                  build(cfg, dev))):
        p = masters[label]
        p, _, m = steps.make_train_step(model, ocfg)(p, adamw.init(p), batch)
        out[label] = (adamw.leaves(p), {k: float(v) for k, v in m.items()})
    (p_cpu, m_cpu_), (p_card, m_card) = out["cpu"], out["card"]
    loss_rel = abs(m_card["loss"] - m_cpu_["loss"]) / abs(m_cpu_["loss"])
    gn_rel = abs(m_card["grad_norm"] - m_cpu_["grad_norm"]) \
        / m_cpu_["grad_norm"]
    scale = min(1.0, ocfg.grad_clip / m_cpu_["grad_norm"])
    worst_signal = worst_all = 0.0
    for a, b, g in zip(p_card, p_cpu, grads):
        d = (a.detach().cpu().double() - b.detach().double()).abs()
        rms = float(torch.sqrt(torch.mean(g * g)))
        signal = (g.abs() > 1e-4 * rms) & (g.abs() * scale > 100 * ocfg.eps)
        if bool(signal.any()):
            worst_signal = max(worst_signal, float(d[signal].max()))
        worst_all = max(worst_all, float(d.max()))
    row = dict(config=zoo_describe(cfg), loss_card=m_card["loss"],
               loss_cpu=m_cpu_["loss"], loss_rel=loss_rel,
               grad_norm_rel=gn_rel, param_err_signal=worst_signal,
               param_err_all=worst_all)
    log(f"  (a) float32 train step, {zoo_describe(cfg)}, batch "
        f"{TRAIN_CHECK_BATCH} x seq {TRAIN_CHECK_SEQ}: loss card "
        f"{m_card['loss']:.7f} vs cpu {m_cpu_['loss']:.7f} (rel "
        f"{loss_rel:.3g}, limit 1e-5), grad_norm rel {gn_rel:.3g} (limit "
        f"1e-4), params max err {worst_signal:.3g} where |g| is signal "
        f"(limit 1e-6), {worst_all:.3g} anywhere (limit 2 lr = "
        f"{2 * TRAIN_LR:g}) [{card}]")
    check(loss_rel <= 1e-5, f"train step loss card vs cpu: {loss_rel}")
    check(gn_rel <= 1e-4, f"train step grad_norm card vs cpu: {gn_rel}")
    check(worst_signal <= 1e-6, f"train step params card vs cpu: "
          f"{worst_signal}")
    check(worst_all <= 2 * TRAIN_LR + 1e-6, f"train step params card vs "
          f"cpu anywhere: {worst_all}")
    return row


def train_full_width(dev, card):
    """(b) Qwen3-1.7B as its config gives it: TRAIN_STEPS steps of AdamW
    with warmup-cosine over `SyntheticLM`, each timed between CUDA events;
    then one step profiled in a fresh process (`benchmarks.train_profile`)."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.models import build
    from repro_torch.optim import adamw, schedule
    cfg = get_config(TRAIN_ARCH)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    # the parameters that enter a product: all but the embedding table
    # (the head is its own matrix here)
    n_embed = cfg.padded_vocab_size * cfg.d_model
    torch.cuda.reset_peak_memory_stats(dev)
    model = build(cfg, dev)
    masters = model.masters(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(t.numel() for t in adamw.leaves(masters))
    n_product = n_params - n_embed
    log(f"  (b) {zoo_describe(cfg)}; masters {n_params / 1e9:.3f} B "
        f"float32, compute {cfg.compute_dtype}, remat {cfg.remat}; batch "
        f"{TRAIN_BATCH} x seq {TRAIN_SEQ} = {tokens} tokens a step, AdamW "
        f"lr {TRAIN_LR} warmup-cosine ({TRAIN_WARMUP} / {TRAIN_STEPS})")
    opt = adamw.init(masters)
    step_fn = steps.make_train_step(
        model, adamw.AdamWConfig(lr=TRAIN_LR), schedule.warmup_cosine,
        dict(warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_STEPS))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH, seed=0))
    losses, walls, norms = [], [], []
    for i in range(TRAIN_STEPS):
        batch = data.batch(i)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        masters, opt, m = step_fn(masters, opt, batch)
        end.record()
        end.synchronize()
        walls.append(start.elapsed_time(end))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        log(f"    step {i:2d}: loss {losses[-1]:.4f} grad_norm "
            f"{norms[-1]:.3f} wall {walls[-1]:.1f} ms")
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    del model, masters, opt, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    med = float(np.median(walls[2:]))
    tps = tokens / (med / 1e3)
    mfu = 6 * n_product * tokens / (med / 1e3 * PEAK_BF16_FLOPS)
    first, last3 = losses[0], float(np.mean(losses[-3:]))
    log(f"  (b) steps 3-{TRAIN_STEPS}: median wall {med:.1f} ms, "
        f"{tps:.0f} tokens/s, peak memory {peak:.2f} GB of 80, model-FLOP "
        f"share {mfu:.4f} (6 N T / (wall x 989e12), N = {n_product / 1e9:.3f}"
        f" B parameters in products, the {n_embed / 1e6:.1f} M-entry "
        f"embedding left out); loss {first:.4f} -> {last3:.4f} (mean of the "
        f"last 3) [{card}]")
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(last3 < first, f"the loss did not fall: {losses}")

    prof_path = os.path.join(os.path.dirname(REPORT), "train_profile.json")
    subprocess.run([sys.executable, "-m",
                    "repro_torch.benchmarks.train_profile",
                    "--arch", TRAIN_ARCH, "--batch", str(TRAIN_BATCH),
                    "--seq-len", str(TRAIN_SEQ), "--out", prof_path],
                   check=True, timeout=900, cwd=HERE,
                   env=dict(os.environ, PYTHONPATH=SRC),
                   stdout=subprocess.DEVNULL)
    with open(prof_path) as f:
        prof = json.load(f)
    log(f"  (b) one profiled step (fresh process): {prof['kernels']} CUDA "
        f"kernels ({prof['gemm_kernels']} products, "
        f"{prof['foreach_kernels']} foreach), device "
        f"{prof['device_ms']:.1f} ms, wall {prof['wall_ms']:.1f} ms, idle "
        f"{prof['idle']:.3f}, peak {prof['peak_gb']:.2f} GB [{card}]")
    for r in prof["top"][:5]:
        log(f"      {r['device_ms']:9.1f} ms  {r['count']:6d}x  {r['name']}")
    check(prof["kernels"] > 0, "the profiler recorded no CUDA kernel")
    return dict(config=zoo_describe(cfg), tokens_per_step=tokens,
                losses=losses, grad_norms=norms, walls_ms=walls,
                median_wall_ms=med, tokens_per_s=tps, peak_gb=peak,
                n_params=n_params, n_product=n_product, mfu=mfu,
                profile=prof)


def preempting_guard(at):
    """A `launch.train` PreemptionGuard whose process receives a real
    SIGTERM at its `at`-th poll (one a step, after the step): the guard's
    own handler flags it, and the driver checkpoints and exits 42."""
    import signal
    from repro_torch.launch import train as train_mod

    class Guard(train_mod.PreemptionGuard):
        polls = 0

        @property
        def should_stop(self):
            Guard.polls += 1
            if Guard.polls == at:
                signal.raise_signal(signal.SIGTERM)
                time.sleep(0.01)   # the handler runs in this thread
            return self._flag

    return Guard


def train_driver(dev, card):
    """(c) the 100M example through `launch.train`: 60 steps with
    checkpoints every 20 (the loss must fall); the same run preempted by
    SIGTERM after step 40 (exit 42, its checkpoint written), then
    `--resume` to 60: the same final loss (rtol 1e-4)."""
    import signal
    import numpy as np
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.examples import train_100m
    from repro_torch.launch import train as train_mod
    import tempfile
    # checkpoints of 100M masters and moments: about 1 GB each, so they go
    # to a temporary directory removed with the phase
    train_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    common = ["--steps", str(TRAIN_100M_STEPS), "--ckpt-every",
              str(TRAIN_100M_EVERY), "--device", dev.type]
    run_dir = os.path.join(train_dir, "preempted")
    # the driver's guard takes SIGTERM / SIGINT: give them back after
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                                 signal.SIGINT)}
    real_guard = train_mod.PreemptionGuard
    code = None
    try:
        t0 = time.perf_counter()
        full = train_100m.main(common + ["--ckpt-dir",
                                         os.path.join(train_dir, "full")])
        t_full = time.perf_counter() - t0
        check(len(full) == TRAIN_100M_STEPS
              and np.mean(full[-5:]) < np.mean(full[:5]),
              f"train_100m: the loss did not fall: {full}")
        train_mod.PreemptionGuard = preempting_guard(TRAIN_100M_PREEMPT)
        try:
            train_100m.main(common + ["--ckpt-dir", run_dir])
        except SystemExit as e:
            code = e.code
        train_mod.PreemptionGuard = real_guard
        saved = CheckpointManager(run_dir).latest_step()
        check(code == train_mod.PREEMPTED_EXIT == 42,
              f"the preempted run exited {code}, not 42")
        check(saved is not None and saved >= TRAIN_100M_PREEMPT,
              f"the preempted run left checkpoint step {saved}")
        resumed = train_100m.main(common + ["--ckpt-dir", run_dir,
                                            "--resume"])
    finally:
        train_mod.PreemptionGuard = real_guard
        for s, h in handlers.items():
            signal.signal(s, h)
        shutil.rmtree(train_dir, ignore_errors=True)
    rel = abs(resumed[-1] - full[-1]) / abs(full[-1])
    log(f"  (c) train_100m ({train_100m.CONFIG_100M.param_count() / 1e6:.1f}"
        f" M parameters, float32): {TRAIN_100M_STEPS} steps, loss "
        f"{np.mean(full[:5]):.4f} -> {np.mean(full[-5:]):.4f} (means of 5) "
        f"in {t_full:.1f} s; SIGTERM after step {TRAIN_100M_PREEMPT}: exit "
        f"{code}, checkpoint at step {saved}; resumed {len(resumed)} steps "
        f"to a final loss {resumed[-1]:.6f} vs {full[-1]:.6f} uninterrupted "
        f"(rel {rel:.3g}, limit 1e-4) [{card}]")
    check(len(resumed) == TRAIN_100M_STEPS - saved,
          f"resumed {len(resumed)} steps from {saved}")
    check(rel <= 1e-4, f"resume departs from the uninterrupted run: {rel}")
    return dict(losses=full, wall_s=t_full, preempt_exit=code,
                preempt_step=saved, resumed_losses=resumed, final_rel=rel)


def phase_train(dev, card):
    """Phase 14: the training half: (a) float32 card-vs-CPU parity of a
    train step, (b) Qwen3-1.7B trained at full width in bf16, (c) the 100M
    example with checkpoints, preemption and resume. The kernel launch
    counts read 0 across the phase: no kernel lies on this path."""
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    ops.reset_counts()
    out, walls = {}, {}
    for key, part in (("parity", train_parity), ("full_width",
                                                  train_full_width),
                      ("driver", train_driver)):
        t = time.perf_counter()
        out[key] = part(dev, card)
        walls[key] = time.perf_counter() - t
    out["part_walls_s"] = walls
    launches = ops.launch_counts()
    out["kernel_launches"] = launches
    out["wall_s"] = time.perf_counter() - t0
    log(f"  the training path launched {launches} (no Pallas kernel lies "
        f"on it); phase 14 wall {out['wall_s']:.1f} s (a / b / c "
        f"{walls['parity']:.1f} / {walls['full_width']:.1f} / "
        f"{walls['driver']:.1f} s) [{card}]")
    check(not any(launches.values()), f"a kernel launched in phase 14: "
          f"{launches}")
    return out


# ---------------------------------------------------------------------------
# phase 15: the dry run, the roofline and approxlint on the card
# ---------------------------------------------------------------------------

TOOLS_DIR = os.path.join(HERE, "chiprun_out", "bench_tools")
# the results the `roofline` driver key reads (git-ignored)
TORCH_RESULTS = os.path.join(HERE, "results", "torch")
# the subjects JAX's run_lint allowlists on its tree (.approxlint.json)
LINT_ALLOWLISTED = ("kernels.perforated_matmul.perfo",
                    "kernels.perforated_attention.perfo",
                    "regions.perforated_loop.skip")


def tools_lint(dev, card):
    """(a) approxlint over all four groups on the card: each kernel's
    masked knob probed by CUDA-graph replay (traced), then `run_lint`
    with the launch counts set to 0 just before and read just after."""
    from repro_torch.analysis import findings, lint, rules, targets
    from repro_torch.kernels import ops
    verdicts = {}
    for t in targets.kernel_knob_targets("cuda"):
        if t.graph:
            res = rules.probe_target(t, "cuda")
            verdicts[t.subject] = res.verdict
            log(f"  (a) CUDA-graph replay {t.subject} at "
                f"{t.card_values}: {res.verdict}"
                + (f" ({res.error or res.diff_excerpt})"
                   if not res.clean else ""))
    check(all(v == "traced" for v in verdicts.values()),
          f"a masked kernel knob is not traced on the card: {verdicts}")
    allow = findings.Allowlist.load(findings.default_allowlist_path(HERE))
    ops.reset_counts()
    t0 = time.perf_counter()
    rep = lint.run_lint(allowlist=allow, device=dev)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    doc = rep.to_json()
    s = doc["summary"]
    allowed = sorted(a["finding"]["subject"] for a in doc["allowlisted"])
    log(f"  (a) run_lint(device=cuda), all groups: {s['total']} findings "
        f"({s['errors']} errors, {s['warnings']} warnings), "
        f"{s['allowlisted']} allowlisted {allowed}, rule crashes "
        f"{rep.errors}; {wall:.2f} s; kernel launches {launches} [{card}]")
    for line in rep.render_text().splitlines()[:12]:
        log(f"      {line}")
    check(not rep.errors, f"a lint rule crashed: {rep.errors}")
    check(s["total"] == s["errors"] == s["warnings"] == 0,
          f"the lint is not clean on the card: {rep.render_text()}")
    check(allowed == sorted(LINT_ALLOWLISTED),
          f"allowlisted subjects {allowed}, want {sorted(LINT_ALLOWLISTED)}")
    check(all(launches[k] > 0 for k in ops.KERNELS),
          f"the lint did not reach every kernel: {launches}")
    return dict(summary=s, allowlisted=allowed, wall_s=wall,
                launches=launches, replay=verdicts)


def tools_roofline(dev, card, report):
    """(b) the dry run and the roofline of the two cells phases 14 and 11
    measure, held against their measurements, and one 16x16 cell."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, roofline
    one = {"data": 1, "model": 1}
    train = report["train"]["full_width"]
    plain = report["serving"]["step_profile"]["plain"]
    cells = (
        ("train", ShapeConfig(f"train_b{TRAIN_BATCH}_s{TRAIN_SEQ}",
                              TRAIN_SEQ, TRAIN_BATCH, "train"),
         train["median_wall_ms"], train["peak_gb"],
         "phase 14's median step wall"),
        ("decode", ShapeConfig(f"decode_b{SERVE_BATCH}_s{SERVE_PROMPT + 16}",
                               SERVE_PROMPT + 16, SERVE_BATCH, "decode"),
         plain["device_ms"], None, "phase 11's decode step device time"),
    )
    out = {}
    for sub in ("dryrun", "roofline"):
        os.makedirs(os.path.join(TORCH_RESULTS, sub), exist_ok=True)
    for label, shape, measured_ms, peak_gb, what in cells:
        t0 = time.perf_counter()
        rec = dryrun.lower_cell(TRAIN_ARCH, shape.name, False, shape=shape,
                                mesh_shape=one, device=dev)
        roof = roofline.analyze(TRAIN_ARCH, shape.name, shape=shape,
                                record=rec)
        for sub, doc in (("dryrun", rec), ("roofline", roof)):
            with open(os.path.join(TORCH_RESULTS, sub,
                                   f"{TRAIN_ARCH}__{shape.name}.json"),
                      "w") as f:
                json.dump(doc, f, indent=1)
        bound_ms = roof["bound_s"] * 1e3
        pred_gb = rec["per_device_bytes"] / 1e9
        log(f"  (b) {TRAIN_ARCH} {shape.kind} batch {shape.global_batch} x "
            f"seq {shape.seq_len} on one card: traced in "
            f"{time.perf_counter() - t0:.1f} s, {rec['ops']} ops; predicted "
            f"peak {pred_gb:.2f} GB (arguments "
            f"{rec['memory']['argument_bytes'] / 1e9:.2f} + step "
            f"{rec['memory']['temp_bytes'] / 1e9:.2f}), fits 80 GB: "
            f"{rec['fits']}"
            + (f"; measured peak {peak_gb:.2f} GB, ratio "
               f"{pred_gb / peak_gb:.3f}" if peak_gb else ""))
        log(f"      FLOPs {rec['hlo_flops_per_device']:.4g} (tensor core "
            f"{rec['flops_by_class']['tensor_core']:.4g}, float32 "
            f"{rec['flops_by_class']['float32']:.4g}), bytes "
            f"{rec['hlo_bytes_per_device']:.4g}; compute "
            f"{roof['compute_s'] * 1e3:.3f} ms, memory "
            f"{roof['memory_s'] * 1e3:.3f} ms -> bound {bound_ms:.3f} ms "
            f"({roof['dominant']}); {what} {measured_ms:.3f} ms, "
            f"bound / measured {bound_ms / measured_ms:.3f} [{card}]")
        check(measured_ms >= bound_ms,
              f"{label}: measured {measured_ms} ms below the roofline bound "
              f"{bound_ms} ms: the count is wrong")
        if label == "train":
            check(rec["fits"], f"the train cell is predicted not to fit: "
                  f"{pred_gb} GB")
        out[label] = dict(dryrun=rec, roofline=roof, measured_ms=measured_ms,
                          measured_peak_gb=peak_gb, bound_ms=bound_ms)
    # one cell of the production 16x16 mesh, on rank 0 of a fake group of
    # 256 (a process of its own: phase 12's group is this one's default)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "olmoe-1b-7b", "--shape", "decode_32k", "--single-pod",
         "--device", "cuda"], check=True, timeout=600, cwd=HERE,
        env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
        text=True)
    rec = json.loads(proc.stdout[proc.stdout.index("{"):])
    coll = rec["collectives"]
    log(f"  (b) olmoe-1b-7b decode_32k on the 16x16 fake mesh: "
        f"{rec['status']}, {time.perf_counter() - t0:.1f} s; per device "
        f"{rec['per_device_bytes'] / 2**30:.2f} GiB, "
        f"{rec['hlo_flops_per_device']:.4g} FLOPs; collectives "
        f"{coll['counts']}, bytes by kind {coll['bytes_by_kind']}, by axis "
        f"{coll['bytes_by_axis']} over {coll['links']}")
    check(rec["status"] == "ok", f"the 16x16 cell: {rec}")
    out["olmoe_16x16"] = rec
    return out


SHORT_JOBS = 8          # dry-run cells traced at once in (d)
SHORT_TIMEOUT = 120     # seconds a cell of (d) may take
SHORT_WALL = 600        # seconds all of (d) may take


def tools_short_matrix(card):
    """(d) every applicable cell of the dry run on the card's torch, cut
    for a quick check (`launch.dryrun.short_cell`: full width, the
    roofline's smallest depth variant, short shapes) on a "cuda" mesh and
    on a "cpu" mesh, an arch's cells on one mesh in a process of their
    own, SHORT_JOBS at a time in one pool (`tests/_dryrun_cells.py`,
    which the CPU tests of the same matrix use); any FAILED or TIMEOUT
    cell on either mesh fails the phase, and so does a cell whose
    collectives (`counts`, `bytes_by_kind`, `bytes_by_axis`) differ
    between the two meshes (its differing `by_shape` rows are logged, and
    each mesh's count of DTensor's Shard-to-Shard moves), and so does an ok
    cell whose argument bytes (or, for a prefill, output bytes: the cache
    laid out by `cache_specs` and the last logits) are not the local shards
    the sharding rules give, and so does a cell, or a two-layer variant of
    three train cells (`dc.VARIANTS`, traced beside its arch's cells),
    whose cuda mesh's collectives differ from those committed in
    `tests/_dryrun_card_collectives.json` (`dc.card_differences`: the
    records the CPU tests hold their torch to, so that the file cannot go
    stale), and so does a Mamba2 cell (zamba2's) whose
    collectives gather its input projection's columns over `model`
    (`dc.projection_gathers`); those cells' bytes by kind are logged; and
    so does any cell whose collectives gather attention heads over `model`
    (`dc.head_gathers`); each family's model all-gather bytes are
    logged."""
    import torch
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import _dryrun_cells as dc
    from repro_torch.configs import get_config, list_archs
    t0 = time.perf_counter()
    meshes = dc.trace_by_arch(list_archs(), ("cuda", "cpu"), jobs=SHORT_JOBS,
                              cell_timeout=SHORT_TIMEOUT)
    wall = time.perf_counter() - t0
    # the two-layer variants are held to the committed card records below
    variants = {m: {c: r for c, r in recs.items() if len(c) == 4}
                for m, recs in meshes.items()}
    recs, cpu_recs = ({c: r for c, r in meshes[m].items() if len(c) == 3}
                      for m in ("cuda", "cpu"))
    cells = []
    for (arch, shape, multi), rec in sorted(recs.items()):
        ok = rec["status"] == "ok"
        cells.append({"arch": arch, "shape": shape,
                      "mesh": "2x16x16" if multi else "16x16",
                      "status": rec["status"],
                      "wall_s": round(rec.get("lower_s", 0)
                                      + rec.get("compile_s", 0), 1),
                      "gib": rec["per_device_bytes"] / 2 ** 30 if ok
                      else None,
                      "collective_bytes": (rec["collectives"]["bytes_by_kind"]
                                           if ok else None),
                      "error": (rec.get("error") or "")[-300:]})
    n = {}
    for c in cells:
        n[c["status"]] = n.get(c["status"], 0) + 1
    want = len(dc.cells(list_archs()))
    log(f"  (d) torch {torch.__version__}: {len(cells)} cells cut for a "
        f"quick check on a cuda and a cpu mesh, an arch and mesh a process, "
        f"{SHORT_JOBS} at a time, in {wall:.1f} s [{card}]")
    for c in cells:
        log(f"      {c['status']:7s} {c['arch']}/{c['shape']}/{c['mesh']} "
            f"{c['wall_s']:.1f} s"
            + (f" {c['error'][-160:]}" if c["status"] != "ok" else ""))
    log(f"  (d) ok {n.get('ok', 0)} of {want}: {json.dumps(n)}")
    check(n.get("ok", 0) == want == len(cells),
          f"dry-run cells that did not trace on the card: {json.dumps(n)}")
    # the cpu mesh counts the collectives the cuda mesh does, cell by cell
    cpu_bad = {dc.cell_id(c): r.get("error", "")[-300:]
               for c, r in sorted(cpu_recs.items()) if r["status"] != "ok"}
    log(f"  (d) cpu mesh: ok {len(cpu_recs) - len(cpu_bad)} of {want}")
    check(not cpu_bad and len(cpu_recs) == want,
          f"dry-run cells that did not trace on a cpu mesh: {cpu_bad}")
    differ, moves = {}, {"cuda": 0, "cpu": 0}
    for cell, rec in sorted(recs.items()):
        other = cpu_recs.get(cell, {})
        if rec["status"] != "ok" or other.get("status") != "ok":
            continue
        name = dc.cell_id(cell)
        moves["cuda"] += rec["collectives"]["shard_moves"]
        moves["cpu"] += other["collectives"]["shard_moves"]
        if rec["collectives"]["shard_moves"]:
            log(f"  (d) {name}: {rec['collectives']['shard_moves']} "
                f"Shard-to-Shard moves, collective bytes by kind "
                f"{json.dumps(rec['collectives']['bytes_by_kind'])}")
        diff = dc.mesh_differences(rec, other)
        if diff:
            differ[name] = diff
            log(f"  (d) {name} cuda vs cpu mesh: {json.dumps(diff)}")
    log(f"  (d) Shard-to-Shard moves counted as all-to-alls: cuda mesh "
        f"{moves['cuda']}, cpu mesh {moves['cpu']}; cells whose collectives "
        f"differ between the meshes: {len(differ)}")
    check(not differ, f"cells whose collectives differ between a cuda and "
          f"a cpu mesh: {sorted(differ)}")
    # every cell and two-layer variant counts the committed card records
    # (`tests/_dryrun_card_collectives.json`, which the CPU tests hold their
    # torch's counts to): the file cannot go stale without this failing
    card_recs = dc.card_records()
    with open(dc.CARD_RECORDS) as f:
        card_torch = json.load(f)["torch"]
    bad_variants = {dc.cell_id(c): r.get("error", "")[-300:]
                    for m in variants for c, r in variants[m].items()
                    if r["status"] != "ok"}
    check(not bad_variants and all(len(v) == len(dc.variants(list_archs()))
                                   for v in variants.values()),
          f"two-layer variants that did not trace: {bad_variants}")
    stale = {}
    for cell, rec in sorted({**recs, **variants["cuda"]}.items()):
        diff = dc.card_differences(rec, cell, card_recs)
        if diff:
            stale[dc.cell_id(cell)] = diff
            log(f"  (d) {dc.cell_id(cell)} vs the committed card records: "
                f"{json.dumps(diff)[:1500]}")
    log(f"  (d) cells and variants whose collectives differ from "
        f"tests/_dryrun_card_collectives.json: {len(stale)} of "
        f"{len(recs) + len(variants['cuda'])} (file: {len(card_recs)} "
        f"records, torch {card_torch})")
    check(len(card_recs) == len(recs) + len(variants["cuda"]) and not stale,
          f"cells whose collectives differ from the committed card records: "
          f"{sorted(stale)}")
    laid_out = []
    for (arch, shape, multi), rec in sorted(recs.items()):
        if rec["status"] != "ok":
            continue
        mem = rec["memory"]
        want_args = dc.argument_bytes(arch, shape, multi)
        want_out = (dc.output_bytes(arch, shape, multi)
                    if rec["kind"] == "prefill" else mem["output_bytes"])
        if (mem["argument_bytes"], mem["output_bytes"]) != (want_args,
                                                            want_out):
            laid_out.append(f"{arch}/{shape}/{multi}: arguments "
                            f"{mem['argument_bytes']} vs {want_args}, "
                            f"outputs {mem['output_bytes']} vs {want_out}")
    log(f"  (d) layouts: {n.get('ok', 0) - len(laid_out)} cells' argument "
        f"bytes (and prefill output bytes) equal to the rules' local shards")
    check(not laid_out, f"cells not laid out by the rules: {laid_out}")
    # the Mamba2 input projection taken apart by its columns: no all-gather
    # over `model` of its columns or of the scan's input made whole
    mamba, gathered = {}, []
    for (arch, shape, multi), rec in sorted(recs.items()):
        if rec["status"] != "ok" or get_config(arch).ssm is None:
            continue
        name = f"{arch}/{shape}/{'2x16x16' if multi else '16x16'}"
        mamba[name] = rec["collectives"]["bytes_by_kind"]
        log(f"  (d) {name} collective bytes by kind "
            f"{json.dumps(mamba[name])}")
        gathered += [f"{name}: {r['phase']} {r['dtype']} {r['shape']} x "
                     f"{r['count']}" for r in dc.projection_gathers(rec)]
    log(f"  (d) Mamba2 projection all-gathers over model: {len(gathered)} "
        f"in {len(mamba)} cells")
    check(mamba and not gathered,
          f"Mamba2 projection columns gathered over model: {gathered}")
    # attention heads split where the rules split them: no all-gather over
    # `model` of whole or padded heads, repeated KV heads or a q / k / v
    # projection's columns, in any cell; each family's model all-gather
    # bytes logged
    heads, model_gathers = [], {}
    for (arch, shape, multi), rec in sorted(recs.items()):
        if rec["status"] != "ok":
            continue
        name = f"{arch}/{shape}/{'2x16x16' if multi else '16x16'}"
        model_gathers[name] = sum(
            r["bytes"] for r in rec["collectives"]["by_shape"]
            if r["kind"] == "all-gather" and r["axis"] == "model")
        heads += [f"{name}: {r['phase']} {r['dtype']} {r['shape']} x "
                  f"{r['count']}" for r in dc.head_gathers(rec)]
    for arch in sorted({k.split("/")[0] for k in model_gathers}):
        log(f"  (d) {arch} model all-gather bytes: " + ", ".join(
            f"{k.split('/', 1)[1]} {v}" for k, v in model_gathers.items()
            if k.startswith(arch + "/")))
    log(f"  (d) head all-gathers over model: {len(heads)} in "
        f"{len(model_gathers)} cells")
    check(model_gathers and not heads,
          f"attention heads gathered over model: {heads}")
    check(wall <= SHORT_WALL, f"(d) took {wall:.1f} s, over {SHORT_WALL} s")
    return dict(torch=torch.__version__, counts=n, wall_s=wall,
                cells=cells, cpu_mesh_faults=cpu_bad, mesh_differences=differ,
                card_record_differences=stale,
                shard_moves=moves, layout_faults=laid_out,
                mamba2_bytes_by_kind=mamba, projection_gathers=gathered,
                model_gather_bytes=model_gathers, head_gathers=heads)


def phase_tools(dev, card, report):
    """Phase 15: (a) approxlint on the card, (b) the dry run and roofline
    against phases 14 and 11, (c) `run --only roofline,lint` and the
    BENCH_lint.json gate, (d) every applicable dry-run cell cut for a
    quick check."""
    from repro_torch.benchmarks import run as bench_run
    t0 = time.perf_counter()
    out = {"lint": tools_lint(dev, card)}
    out["roofline"] = tools_roofline(dev, card, report)
    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    results, errors = bench_run.run_modules(
        ["roofline", "lint"], lambda n_, v_, d_="": log(f"  {n_},{v_},{d_}"),
        device=dev, artifacts_dir=TOOLS_DIR)
    check(not errors, f"runner modules raised: {errors}")
    stamp_card(TOOLS_DIR, card)
    fails = bench_run.check_regression(
        TOOLS_DIR, os.path.join(bench_run.BASELINES, "BENCH_lint.json"))
    for f in fails:
        log(f"  regression FAIL {f}")
    if not fails:
        log(f"  regression gate OK: {os.path.relpath(TOOLS_DIR, HERE)}")
    out["runner_roofline"] = results["roofline"]
    out["short_matrix"] = tools_short_matrix(card)
    out["wall_s"] = time.perf_counter() - t0
    log(f"  phase 15 wall {out['wall_s']:.1f} s [{card}]")
    return out, fails


def main():
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this smoke "
                           "run needs an NVIDIA GPU")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        raise SmokeFailure(f"{SRC}/repro_torch not found: run chip_smoke.py "
                           "from the root of a checkout")
    sys.path.insert(0, SRC)
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.analysis import machine
    from repro_torch.apps import approx_ffn
    from repro_torch.benchmarks import (approx_ffn_sweep, kernel_micro,
                                        kernel_profile)
    from repro_torch.core import perforation
    from repro_torch.core.types import (ApproxSpec, IACTParams, Level,
                                        PerforationKind, PerforationParams,
                                        TAFParams, Technique)
    from repro_torch.kernels import (_build, iact_memo, ops,
                                     perforated_attention,
                                     perforated_matmul, ref, taf_matmul,
                                     tuning)
    from repro_torch.obs import timing

    # plain versions and library calls in full float32, as the kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    report = {"phases": {}}

    # -- 1. the card ----------------------------------------------------------
    card = card_line()
    log(card)
    report["card"] = card

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.build()
    report["phases"]["build_s"] = time.perf_counter() - t0
    log(f"build: {lib.name} in {report['phases']['build_s']:.1f} s")

    def ms(fn, *args, repeats=5, **kw):
        return timing.measure(fn, *args, device=dev, warmup=1,
                              repeats=repeats, **kw).seconds * 1e3

    def max_err(a, b):
        return float((a.float() - b.float()).abs().max())

    errs = {k: 0.0 for k in ops.KERNELS}
    masks_equal = {k: True for k in ops.KERNELS}

    def note(kernel, err, tol, mask_ok, what):
        errs[kernel] = max(errs[kernel], err)
        masks_equal[kernel] = masks_equal[kernel] and mask_ok
        log(f"  {kernel} [{what}] max_abs_err={err:.3g} (atol {tol}) "
            f"mask_equal={mask_ok}")
        check(err <= tol and mask_ok,
              f"{kernel} [{what}] disagrees with its plain version")

    taf_kw = dict(block_m=16, history_size=TAF_SPEC[1],
                  prediction_size=TAF_SPEC[2], rsd_threshold=TAF_SPEC[3])
    iact_kw = dict(block_rows=16, table_size=IACT_SPEC[1],
                   threshold=IACT_SPEC[2])
    fini = PerforationParams(kind=PerforationKind.FINI, fraction=0.0)
    attn_kw = dict(block_q=32, block_kv=32, perfo=fini,
                   fraction=PERFO_SPEC[2])

    # -- 3. kernels against their plain versions -----------------------------
    log("phase 3: kernels vs plain versions")
    t0 = time.perf_counter()
    full_inputs = None
    for name, geom in (("reference", REF_GEOM), ("full", FULL_GEOM)):
        s = approx_ffn.kernel_operands(**geom, device=dev)
        y, m = ops.taf_matmul(s["x"], s["wp"], block_n=geom["d"], **taf_kw)
        yr, mr = ref.taf_matmul_ref(s["x"], s["wp"], block_n=geom["d"],
                                    **taf_kw)
        note("taf_matmul", max_err(y, yr), ATOL["taf_matmul"],
             bool(torch.equal(m, mr)), f"{name} geometry")
        y, m = ops.iact_rowfn(s["a"], s["w1"], s["w2"], **iact_kw)
        yr, mr = ref.iact_rowfn_ref(s["a"], s["w1"], s["w2"], **iact_kw)
        note("iact_rowfn", max_err(y, yr), ATOL["iact_rowfn"],
             bool(torch.equal(m, mr)), f"{name} geometry")
        q = s["q"]
        o = ops.perforated_attention(q, q, q, **attn_kw)
        orf = ref.attention_ref(q, q, q, block_kv=32, perfo=fini,
                                fraction=PERFO_SPEC[2])
        note("perforated_attention", max_err(o, orf),
             ATOL["perforated_attention"], True,
             f"{name} geometry, masked fini 0.5")
        o = ops.flash_attention(q, q, q, block_q=32, block_kv=32)
        note("perforated_attention", max_err(o, ref.attention_ref(q, q, q)),
             ATOL["perforated_attention"], True, f"{name} geometry, exact")
        full_inputs = s
    # at full width no block of the app's IACT spec approximates, so hold
    # the kernel's approximate path (gather, no product) against its plain
    # version too, at a threshold taken from the data
    s = full_inputs
    loose = loose_iact_threshold(s["a"])
    kw = dict(iact_kw, threshold=loose)
    before = iact_memo.COUNTER.work()
    y, m = ops.iact_rowfn(s["a"], s["w1"], s["w2"], **kw)
    computed = iact_memo.COUNTER.work() - before
    yr, mr = ref.iact_rowfn_ref(s["a"], s["w1"], s["w2"], **kw)
    note("iact_rowfn", max_err(y, yr), ATOL["iact_rowfn"],
         bool(torch.equal(m, mr)),
         f"full geometry, threshold {loose:.4g}: {computed} of {m.numel()} "
         "blocks computed")
    check(bool(m.any()) and computed == int((~m).sum()),
          "iact_rowfn: the loose threshold approximated no block, or the "
          "kernel computed another count of blocks than its mask says")
    # K3's schedule kernel alone against its plain version, at both IACT
    # specs: mask, list of computed blocks and src exactly equal
    for thr in (IACT_SPEC[2], loose):
        got = iact_memo.schedule(s["a"], 16, IACT_SPEC[1], thr)
        want = iact_memo.schedule_plain(s["a"], 16, IACT_SPEC[1], thr)
        same = all(torch.equal(g.cpu(), w_.cpu())
                   for g, w_ in zip(got, want))
        log(f"  iact_schedule [full geometry, threshold {thr:.4g}] "
            f"{len(got[1])} of {got[0].numel()} blocks computed, "
            f"equal to schedule_plain={same}")
        check(same, f"iact_schedule at threshold {thr} differs from "
                    "schedule_plain")
    # three calls on the same inputs give identical masks and values
    repeat_calls = {
        "taf_matmul": lambda: ops.taf_matmul(
            s["x"], s["wp"], block_n=FULL_GEOM["d"], **taf_kw),
        "iact_rowfn": lambda: ops.iact_rowfn(s["a"], s["w1"], s["w2"], **kw),
    }
    for name, fn in repeat_calls.items():
        first = fn()
        same = all(all(torch.equal(a_, b_) for a_, b_ in zip(fn(), first))
                   for _ in range(2))
        log(f"  {name} [full geometry] three calls identical={same}")
        check(same, f"{name}: repeated calls on the same inputs differ")
    rng = np.random.RandomState(7)
    attn_cases = [  # (B, Hq, Hkv, Sq, Skv, D, dtype, causal, perfo, frac)
        (1, 4, 4, 256, 256, 64, torch.float32, True,
         PerforationParams(kind=PerforationKind.INI, fraction=0.25), None),
        (2, 8, 2, 128, 256, 128, torch.float32, True,
         PerforationParams(kind=PerforationKind.RANDOM, fraction=0.0), 0.3),
        (1, 8, 1, 64, 192, 32, torch.float32, True,
         PerforationParams(kind=PerforationKind.SMALL, skip=2), None),
        (1, 4, 4, 128, 256, 64, torch.float32, False, None, None),
        (1, 8, 4, 256, 256, 128, torch.bfloat16, True, None, None),
        (1, 4, 2, 128, 256, 16, torch.bfloat16, True,
         PerforationParams(kind=PerforationKind.FINI, fraction=0.0), 0.5),
    ]
    for b, hq, hkv, sq, skv, d, dt, causal, perfo, frac in attn_cases:
        q, k, v = (torch.from_numpy(rng.randn(b, h, s_, d).astype(
            np.float32)).to(dev, dt) for h, s_ in ((hq, sq), (hkv, skv),
                                                   (hkv, skv)))
        o = ops.perforated_attention(q, k, v, block_q=32, block_kv=32,
                                     perfo=perfo, fraction=frac,
                                     causal=causal)
        orf = ref.attention_ref(q, k, v, block_kv=32, perfo=perfo,
                                fraction=frac, causal=causal)
        tol = ATOL["perforated_attention_bf16" if dt == torch.bfloat16
                   else "perforated_attention"]
        mode = "exact" if perfo is None else perfo.kind.value + (
            " masked" if frac is not None else " structural")
        note("perforated_attention", max_err(o, orf), tol, True,
             f"B{b} Hq{hq} Hkv{hkv} Sq{sq} Skv{skv} D{d} {str(dt)[6:]} "
             f"causal={causal} {mode}")
    # K4 in every mode, at 256^3 and at full width
    P, K = PerforationParams, PerforationKind
    pmm_cases = [(None, None, False), (None, None, True)]
    for kind, arg in ((K.SMALL, 2), (K.LARGE, 2)):
        pmm_cases += [(P(kind=kind, skip=arg), None, r) for r in (False,
                                                                  True)]
    for kind in (K.INI, K.FINI, K.RANDOM):
        pmm_cases += [(P(kind=kind, fraction=0.25), None, r)
                      for r in (False, True)]
        pmm_cases += [(P(kind=kind), fr, r) for fr in (0.25, 0.5, 1.0)
                      for r in (False, True)]
    for label, (m_, k_, n_), (bm_, bn_, bk_) in PMM_GEOMS:
        xm = torch.from_numpy(rng.randn(m_, k_).astype(np.float32)).to(dev)
        wm = torch.from_numpy(rng.randn(k_, n_).astype(np.float32)).to(dev)
        tol = ATOL["perforated_matmul" if label == "256^3"
                   else "perforated_matmul_full"]
        nk = k_ // bk_
        for perfo, frac, rescale in pmm_cases:
            before = perforated_matmul.COUNTER.work()
            y = ops.perforated_matmul(xm, wm, block_m=bm_, block_n=bn_,
                                      block_k=bk_, perfo=perfo,
                                      fraction=frac, rescale=rescale)
            accumulated = perforated_matmul.COUNTER.work() - before
            yr = ref.perforated_matmul_ref(xm, wm, block_k=bk_, perfo=perfo,
                                           fraction=frac, rescale=rescale)
            if perfo is None:
                live = nk
            elif frac is None:
                live = len(perforation.kept_indices(nk, perfo))
            else:
                live = int(perforation.traced_execute_mask(
                    nk, perfo, frac).sum())
            mode = "none" if perfo is None else perfo.kind.value + (
                f" masked {frac}" if frac is not None else " structural")
            note("perforated_matmul", max_err(y, yr), tol,
                 accumulated == live and (live > 0 or not bool(y.any())),
                 f"{label} {mode} rescale={rescale}: {accumulated} of {nk} "
                 "K blocks accumulated")
    torch.cuda.synchronize()
    report["phases"]["kernels_s"] = time.perf_counter() - t0

    # -- 4. the 30-spec sweep at the reference geometry ----------------------
    log("phase 4: 30-spec sweep on the cuda substrate (reference geometry)")
    t0 = time.perf_counter()
    with open(BASELINE) as f:
        baseline = json.load(f)
    ops.reset_counts()
    shutil.rmtree(BENCH_DIR, ignore_errors=True)
    summary = approx_ffn_sweep.main(
        report=lambda n, v, d: log(f"  {n},{v},{d}"), substrate="cuda",
        device=dev, artifacts_dir=BENCH_DIR)
    sweep_launches = ops.launch_counts()
    bad = approx_ffn_sweep.check_front(summary, baseline)
    log(f"  front: n_records={summary['n_records']} "
        f"n_front={summary['front']['n_front']} "
        f"hv={summary['front']['hypervolume']!r} (committed "
        f"{baseline['front']['hypervolume']!r}) best approx fractions "
        + " / ".join(str(summary['best_under_10pct'][t]['approx_fraction'])
                     for t in approx_ffn_sweep.TECHNIQUES)
        + f" parity={summary['parity']} launches={sweep_launches}")
    check(not bad, f"sweep front departs from the committed one: {bad}")
    report["sweep"] = dict(summary=summary, launches=sweep_launches)
    report["phases"]["sweep_s"] = time.perf_counter() - t0

    # -- 5. the main path at full width --------------------------------------
    log("phase 5: main path at Qwen3-1.7B widths "
        + json.dumps(FULL_GEOM))
    t0 = time.perf_counter()
    app = approx_ffn.make_app(substrate="cuda", device=dev, **FULL_GEOM)
    specs = [
        ("none", ApproxSpec()),
        ("taf", ApproxSpec(Technique.TAF, Level.BLOCK,
                           taf=TAFParams(*TAF_SPEC[1:]))),
        ("iact", ApproxSpec(Technique.IACT, Level.BLOCK,
                            iact=IACTParams(IACT_SPEC[1], IACT_SPEC[2], 1))),
        ("iact_loose", ApproxSpec(Technique.IACT, Level.BLOCK,
                                  iact=IACTParams(IACT_SPEC[1], loose, 1))),
        ("perfo", ApproxSpec(Technique.PERFORATION, Level.BLOCK,
                             perforation=PerforationParams(
                                 kind=PerforationKind.FINI,
                                 fraction=PERFO_SPEC[2]))),
    ]
    n_tiles = FULL_GEOM["seq"] // 16
    main_rows = {}
    ops.reset_counts()
    exact_qoi = None
    for label, spec in specs:
        before_l, before_w = ops.launch_counts(), ops.work_counts()
        res = app.run(spec)
        after_l, after_w = ops.launch_counts(), ops.work_counts()
        dl = {k: after_l[k] - before_l[k] for k in after_l}
        dw = {k: after_w[k] - before_w[k] for k in after_w}
        check(res.qoi.shape == (FULL_GEOM["seq"], FULL_GEOM["d"])
              and bool(np.isfinite(res.qoi).all()),
              f"{label}: QoI not finite or of the wrong shape")
        if exact_qoi is None:
            exact_qoi = res.qoi
        err = float(np.mean(np.abs(exact_qoi - res.qoi) /
                            np.maximum(np.abs(exact_qoi), 1e-30)))
        row = dict(wall_ms=res.wall_time_s * 1e3,
                   approx_fraction=res.approx_fraction, mape=err,
                   launches=dl, device_tally=dw)
        if label in ("taf", "iact", "iact_loose"):
            kern = "taf_matmul" if label == "taf" else "iact_rowfn"
            calls = dl[kern]
            computed = dw[kern] / max(calls, 1)
            want = round((1.0 - res.approx_fraction) * n_tiles)
            row["computed_per_call"] = computed
            row["tiles_per_call"] = n_tiles
            check(calls > 0 and computed == want,
                  f"{label}: the kernel computed {computed} of {n_tiles} "
                  f"tiles a call, the mask says {want}")
            check(label == "iact" or res.approx_fraction > 0,
                  f"{label}: no tile or block was approximated")
        main_rows[label] = row
        log(f"  {label}: wall_ms={row['wall_ms']:.3f} (CUDA events) "
            f"approx_fraction={res.approx_fraction} mape={err:.4g} "
            f"launches={dl} computed_per_call="
            f"{row.get('computed_per_call', '-')}/"
            f"{row.get('tiles_per_call', '-')} device_tally={dw}")
    main_launches = ops.launch_counts()
    for k in APP_KERNELS:
        check(main_launches[k] > 0, f"{k} was not launched on the main path")
    report["main_path"] = dict(rows=main_rows, launches=main_launches)
    report["phases"]["main_path_s"] = time.perf_counter() - t0

    # -- 6. per-kernel times at the main path's shapes -----------------------
    log("phase 6: per-kernel CUDA-event times at full width")
    t0 = time.perf_counter()
    # the library yardsticks in full float32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"  torch.backends.cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} "
        f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    s = full_inputs
    seq, d, d_h = FULL_GEOM["seq"], FULL_GEOM["d"], FULL_GEOM["d_h"]
    f4 = 4  # bytes of a float32
    rows = []

    # K2: x (seq, d) @ wp (d, d), only the computed tiles do the product
    _, m = ops.taf_matmul(s["x"], s["wp"], block_n=d, **taf_kw)
    computed = int((~m).sum())
    ops_ = 2.0 * 16 * d * d * computed
    bytes_ = f4 * (seq * d + d * d + seq * d)
    rows.append(dict(
        kernel="taf_matmul", module=taf_matmul,
        ms=ms(ops.taf_matmul, s["x"], s["wp"], block_n=d, **taf_kw),
        plain_ms=ms(ref.taf_matmul_ref, s["x"], s["wp"], block_n=d,
                    repeats=3, **taf_kw),
        library_ms=ms(torch.matmul, s["x"], s["wp"]), ops=ops_,
        bytes=bytes_, work=f"{computed} of {m.numel()} tiles computed"))

    # K3: a (seq, d) -> gelu(a @ w1) @ w2, only computed blocks; beside it
    # the loose spec, whose skipped blocks should make it beat the exact FFN
    _, m = ops.iact_rowfn(s["a"], s["w1"], s["w2"], **iact_kw)
    computed = int((~m).sum())
    ops_ = computed * (2.0 * 16 * d * d_h * 2)
    bytes_ = f4 * (seq * d + d * d_h + d_h * d + seq * d)
    loose_kw = dict(iact_kw, threshold=loose)
    _, m_loose = ops.iact_rowfn(s["a"], s["w1"], s["w2"], **loose_kw)
    loose_computed = int((~m_loose).sum())
    rows.append(dict(
        kernel="iact_rowfn", module=iact_memo,
        ms=ms(ops.iact_rowfn, s["a"], s["w1"], s["w2"], **iact_kw),
        plain_ms=ms(ref.iact_rowfn_ref, s["a"], s["w1"], s["w2"],
                    repeats=3, **iact_kw),
        library_ms=ms(lambda a, w1, w2: F.gelu(a @ w1, approximate="tanh")
                      @ w2, s["a"], s["w1"], s["w2"]),
        ops=ops_, bytes=bytes_,
        work=f"{computed} of {m.numel()} blocks computed",
        loose=dict(threshold=loose, ms=ms(ops.iact_rowfn, s["a"], s["w1"],
                                          s["w2"], **loose_kw),
                   computed=loose_computed,
                   bound_ms=max(loose_computed * 2.0 * 16 * d * d_h * 2
                                / PEAK_F32_FLOPS, bytes_ / PEAK_BYTES)
                   * 1e3)))

    # K1: masked fini 0.5 over q = k = v (1, 16, seq, 128)
    q = s["q"]
    nkv = seq // 32
    keep = perforation.traced_execute_mask(nkv, fini, PERFO_SPEC[2],
                                           device=dev)
    allowed = torch.tril(torch.ones(seq, seq, dtype=torch.bool, device=dev))
    allowed &= keep.repeat_interleave(32)[None, :]
    pairs = int(allowed.sum()) * q.shape[0] * q.shape[1]
    ops_ = 4.0 * q.shape[3] * pairs
    bytes_ = 4 * q.numel() * f4
    rows.append(dict(
        kernel="perforated_attention", module=perforated_attention,
        ms=ms(ops.perforated_attention, q, q, q, **attn_kw),
        plain_ms=ms(ref.attention_ref, q, q, q, block_kv=32, perfo=fini,
                    fraction=PERFO_SPEC[2], repeats=3),
        library_ms=ms(F.scaled_dot_product_attention, q, q, q,
                      attn_mask=allowed),
        ops=ops_, bytes=bytes_,
        work=f"{pairs} (query, key) pairs in the causal mask and kept "
             "blocks"))

    # K4: SMALL skip 2 at the FFN down-projection; the library call is
    # torch.matmul on the kept slices, gathered outside the timed window
    _, (m_, k_, n_), (bm_, bn_, bk_) = PMM_GEOMS[1]
    xm = torch.from_numpy(rng.randn(m_, k_).astype(np.float32)).to(dev)
    wm = torch.from_numpy(rng.randn(k_, n_).astype(np.float32)).to(dev)
    small2 = PerforationParams(kind=PerforationKind.SMALL, skip=2)
    kept = perforation.kept_indices(k_ // bk_, small2)
    cols = torch.as_tensor((kept[:, None] * bk_ + np.arange(bk_)).ravel(),
                           device=dev)
    xk = xm[:, cols].contiguous()
    wk = wm[cols].contiguous()
    k_kept = int(cols.numel())
    pmm_kw = dict(block_m=bm_, block_n=bn_, block_k=bk_, perfo=small2)
    rows.append(dict(
        kernel="perforated_matmul", module=perforated_matmul,
        ms=ms(ops.perforated_matmul, xm, wm, **pmm_kw),
        plain_ms=ms(ref.perforated_matmul_ref, xm, wm, block_k=bk_,
                    perfo=small2, repeats=3),
        library_ms=ms(torch.matmul, xk, wk),
        library_full_ms=ms(torch.matmul, xm, wm),
        ops=2.0 * m_ * n_ * k_kept,
        bytes=f4 * (m_ * k_kept + k_kept * n_ + m_ * n_),
        work=f"{len(kept)} of {k_ // bk_} K blocks of {bk_} kept, "
             f"x ({m_}, {k_}) @ w ({k_}, {n_})"))
    # CUDA kernels one wrapper call runs (torch.profiler), each kernel at
    # two block shapes: the count must not depend on the blocks
    per_call = {
        "perforated_attention": [kernel_profile.launches_per_call(
            lambda bq=bq: ops.perforated_attention(
                q, q, q, **dict(attn_kw, block_q=bq)),
            perforated_attention.CUDA_KERNELS, dev) for bq in (32, 64)],
        "perforated_matmul": [kernel_profile.launches_per_call(
            lambda bm=bm: ops.perforated_matmul(
                xm, wm, **dict(pmm_kw, block_m=bm)),
            perforated_matmul.CUDA_KERNELS, dev) for bm in (64, 128)],
        "taf_matmul": [kernel_profile.launches_per_call(
            lambda bm=bm: ops.taf_matmul(s["x"], s["wp"], block_n=d,
                                         **dict(taf_kw, block_m=bm)),
            taf_matmul.CUDA_KERNELS, dev) for bm in (16, 512)],
        "iact_rowfn": [kernel_profile.launches_per_call(
            lambda br=br: ops.iact_rowfn(s["a"], s["w1"], s["w2"],
                                         **dict(iact_kw, block_rows=br)),
            iact_memo.CUDA_KERNELS, dev) for br in (16, 512)],
    }
    for r in rows:
        if r["kernel"] in per_call:
            r["launches_per_call"] = per_call[r["kernel"]]
        log(f"  {r['kernel']}: ms={r['ms']!r} plain_ms={r['plain_ms']!r} "
            f"library_ms={r['library_ms']!r} ({r['work']})"
            + (f" CUDA launches a call at two block shapes="
               f"{r['launches_per_call']}" if "launches_per_call" in r
               else "")
            + (f" loose: {r['loose']}" if "loose" in r else ""))
    want_calls = {"perforated_attention": [1, 1],
                  "perforated_matmul": [1, 1], "taf_matmul": [1, 1],
                  "iact_rowfn": [4, 4]}
    check(per_call == want_calls,
          f"CUDA launches a call: {per_call}, want {want_calls}")
    # and one lane-group call of phase 10 (K3 also runs iact_union)
    lane_cuda = {k: kernel_profile.launches_per_call(
        group, ops.KERNELS[k].LANE_CUDA_KERNELS, dev)
        for k, (group, _, _) in lane_calls(s, loose, dev)[0].items()}
    log(f"  CUDA kernels a lane-group call ({LANES} lanes) runs: "
        f"{lane_cuda}")
    check(lane_cuda == LANE_CUDA,
          f"CUDA kernels a lane-group call: {lane_cuda}, want {LANE_CUDA}")
    report["phases"]["timing_s"] = time.perf_counter() - t0

    # -- 7. the kernel-engineering path: machine profile, kernel_micro ------
    log("phase 7: measure_machine x3, kernel_micro at ref and full geometry")
    t0 = time.perf_counter()
    readings = []
    for _ in range(3):
        prof = machine.measure_machine(device=dev, register=False)
        readings.append(dict(peak_flops=prof.peak_flops, hbm_bw=prof.hbm_bw,
                             dispatch_s=prof.dispatch_s))
        log(f"  measured machine: peak_flops={prof.peak_flops!r} "
            f"hbm_bw={prof.hbm_bw!r} dispatch_s={prof.dispatch_s!r}")
    dispatch = sorted(r["dispatch_s"] for r in readings)[1]
    log(f"  dispatch_s median of 3 runs: {dispatch!r} (the h100 profile "
        f"has {machine.get_machine('cuda').dispatch_s!r})")
    report["measured_machine"] = dict(runs=readings, dispatch_s=dispatch)
    micro = {}
    ops.reset_counts()
    for geometry in ("ref", "full"):
        out_dir = os.path.join(os.path.dirname(REPORT),
                               f"kernel_micro_{geometry}")
        micro[geometry] = kernel_micro.main(
            lambda n_, v_, d_: log(f"  {n_},{v_},{d_}"), out_dir,
            geometry=geometry, device=dev)
    micro_launches = ops.launch_counts()
    log(f"  kernel_micro launches: {micro_launches}")
    for k in tuning.KERNELS:
        check(micro_launches[k] > 0,
              f"{k} was not launched on the kernel_micro path")
    for geometry, b in micro.items():
        check(all(b["oracle_match"].values()),
              f"kernel_micro {geometry}: oracle mismatch {b['oracle_match']}")
        check(all(b["pipeline_parity"].values()),
              f"kernel_micro {geometry}: pipeline parity "
              f"{b['pipeline_parity']}")
        check(b["sweep"]["recompiles"] == 0,
              f"kernel_micro {geometry}: {b['sweep']['recompiles']} "
              "kernel-library builds during the threshold sweep")
        # the tuned and default configs, each held against its plain
        # version on the tuning operands (phase 3's tolerances)
        arrays = kernel_micro.tuning_arrays(geometry, dev)
        for kern in tuning.KERNELS:
            t = b["tuning"][kern]
            why = (tuning.validate_config(kern, t["shapes"], t["tuned"])
                   or tuning.launchable(kern, t["shapes"], t["tuned"]))
            check(why is None and t["tuned_launches"] > 0
                  and t["measured"] > 0,
                  f"kernel_micro {geometry}: tuned {kern} {t['tuned']} "
                  f"invalid ({why}) or not launched")
            check(t["speedup"] >= 1.0,
                  f"kernel_micro {geometry}: tuned {kern} {t['tuned']} is "
                  f"slower than the default {t['default']} in the tuner's "
                  "own pass")
            tol = ATOL[kern if kern != "perforated_matmul" or
                       geometry == "ref" else "perforated_matmul_full"]
            for label in ("tuned", "default"):
                y = tuning.build_call(kern, t[label])(*arrays[kern])
                yr = plain_call(kern, t[label], arrays[kern])
                note(kern, max_err(y, yr), tol, True,
                     f"kernel_micro {geometry} {label} {t[label]}")
    shutil.copy(os.path.join(os.path.dirname(REPORT), "kernel_micro_full",
                             "BENCH_kernel.json"), BENCH_DIR)
    report["kernel_micro"] = dict(results=micro, launches=micro_launches)
    report["phases"]["kernel_micro_s"] = time.perf_counter() - t0

    # -- 8. the five HPC apps -------------------------------------------------
    log("phase 8: the five HPC apps at the public benchmarks' sizes")
    t0 = time.perf_counter()
    report["apps"] = phase_apps(dev, full_inputs, loose)
    report["phases"]["apps_s"] = time.perf_counter() - t0

    # -- 9. the benchmark runner, the quickstart and the regression gate ----
    log("phase 9: the benchmark runner (figures at the JAX sizes and full "
        "size), the quickstart, the regression gate")
    t0 = time.perf_counter()
    report["figures"] = phase_runner(dev, card)
    report["phases"]["runner_s"] = time.perf_counter() - t0

    # -- 10. this slice: the lane grid, the batched sweep, the cost model ---
    log(f"phase 10: the lane-grid kernels ({LANES} lanes, full width), the "
        "sweep through run_batch, the cost model's predict mode and gate")
    t0 = time.perf_counter()
    report["slice"], lane_rows, lane_launches, predict_fails = phase_lanes(
        dev, full_inputs, loose, card, sweep_launches, lane_cuda, ms, note)
    report["phases"]["lanes_s"] = time.perf_counter() - t0

    # -- 11. the serving slice at full width ---------------------------------
    log("phase 11: Qwen3-1.7B at full width: decode vs forward, "
        "launch.serve precise and with decode TAF, continuous batching "
        "precise and under QoS, the qos / obs runner modules and their gate")
    t0 = time.perf_counter()
    report["serving"], serve_fails, serve_ctx = phase_serving(dev, card)
    report["phases"]["serving_s"] = time.perf_counter() - t0

    # -- 12. the sharded serving data plane on one NCCL rank --------------
    log(f"phase 12: the sharded engine at full width on a one-rank NCCL "
        f"group: 1 shard against phase 11, {SHARDS} shards precise and "
        f"under per-shard QoS, the drill, run --devices 1, the collectives")
    t0 = time.perf_counter()
    report["sharded"], shard_fails = phase_sharded(dev, card, serve_ctx)
    del serve_ctx
    report["phases"]["sharded_s"] = time.perf_counter() - t0

    # -- 13. the model zoo's serving path at full width -------------------
    log("phase 13: the model zoo at full width: decode vs forward in "
        "float32, launch.serve in bfloat16 (olmoe also with expert "
        "perforation), the engine on every family it serves")
    t0 = time.perf_counter()
    report["zoo"] = phase_zoo(dev, card)
    report["phases"]["zoo_s"] = time.perf_counter() - t0

    # -- 14. the model zoo's training half ---------------------------------
    log("phase 14: training: a float32 step card vs CPU, Qwen3-1.7B at full "
        "width in bf16 (12 steps), the 100M example with checkpoints, "
        "preemption and resume")
    t0 = time.perf_counter()
    report["train"] = phase_train(dev, card)
    report["phases"]["train_s"] = time.perf_counter() - t0

    # -- 15. the dry run, the roofline and approxlint on the card -------
    log("phase 15: approxlint on the card (CUDA-graph replay of K1-K4's "
        "knobs), the dry run and roofline against phases 14 and 11, "
        "run --only roofline,lint and its gate, every dry-run cell cut "
        "for a quick check")
    t0 = time.perf_counter()
    report["tools"], tools_fails = phase_tools(dev, card, report)
    report["phases"]["tools_s"] = time.perf_counter() - t0

    kernels = []
    for r in rows:
        t_ops = r["ops"] / PEAK_F32_FLOPS * 1e3
        t_bytes = r["bytes"] / PEAK_BYTES * 1e3
        route, products, peak = ROUTES[r["kernel"]]
        t_route = products * r["ops"] / peak * 1e3
        kernels.append({
            "name": r["kernel"], "route": "cuda",
            "source": r["module"].SOURCE, "replaces": r["module"].REPLACES,
            "launches": (main_launches if r["kernel"] in APP_KERNELS
                         else micro_launches)[r["kernel"]],
            "max_abs_err": errs[r["kernel"]],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": r["library_ms"], "precision": route,
            "route_bound_ms": max(t_route, t_bytes),
            "route_bound_by": "operations" if t_route >= t_bytes
            else "bytes",
            "mask_equal": masks_equal[r["kernel"]],
            "ops": r["ops"], "bytes": r["bytes"], "work": r["work"],
        })
        for extra in ("library_full_ms", "launches_per_call", "loose"):
            if extra in r:
                kernels[-1][extra] = r[extra]
    for r in lane_rows:  # the lane-grid forms: a group of LANES knobs
        t_ops = r["ops"] / PEAK_F32_FLOPS * 1e3
        t_bytes = r["bytes"] / PEAK_BYTES * 1e3
        route, products, peak = ROUTES[r["kernel"]]
        t_route = products * r["ops"] / peak * 1e3
        kernels.append({
            "name": f"{r['kernel']} (lane grid, {r['lanes']} lanes)",
            "route": "cuda", "source": r["module"].SOURCE,
            "replaces": r["module"].REPLACES,
            "launches": lane_launches[r["kernel"]],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": r["library_ms"], "precision": route,
            "route_bound_ms": max(t_route, t_bytes),
            "singles_ms": r["singles_ms"], "lanes": r["lanes"],
            "cuda_kernels_per_group": r["cuda_per_group"],
            "ops": r["ops"], "bytes": r["bytes"], "work": r["work"],
        })
    report["kernels"] = kernels
    os.makedirs(os.path.dirname(REPORT), exist_ok=True)
    with open(REPORT, "w") as f:
        json.dump(report, f, indent=1, default=str)
    log(f"phases (s): {json.dumps(report['phases'])}")
    gate = (report["figures"]["gate_failures"] + predict_fails + serve_fails
            + shard_fails + tools_fails)
    check(not gate, f"regression gate: {len(gate)} check(s) failed")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
    except Exception as e:
        if "CUDA error" in str(e):
            print(f"chip_smoke: the card after a CUDA error:\n"
                  f"{card_errors()}", file=sys.stderr, flush=True)
        raise
