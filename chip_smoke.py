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
     bf16) -- the JAX package's test tolerances;
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
     (a yardstick the port never calls) and the least time the card could
     take (bound).

Prints the `kernels` JSON line, then as its last line
`{"ok": true, "device": {...}}`. Writes the full report to
chiprun_out/chip_smoke.json. Exits non-zero without a CUDA device, and
when run outside a checkout (src/repro_torch missing).
"""
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")
BASELINE = os.path.join(HERE, "benchmarks", "baselines", "BENCH_ffn.json")
REPORT = os.path.join(HERE, "chiprun_out", "chip_smoke.json")

# H100 SXM published peaks (NVIDIA data sheet): float32 outside the tensor
# cores, and HBM3 bandwidth. Used for the bound of each kernel.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

REF_GEOM = dict(seq=128, d=32, d_h=64, heads=2)
FULL_GEOM = dict(seq=4096, d=2048, d_h=6144, heads=16)  # Qwen3-1.7B widths
TAF_SPEC = ("taf", 2, 4, 0.2)
IACT_SPEC = ("iact", 2, 0.05)
PERFO_SPEC = ("perfo", "fini", 0.5)
ATOL = {"taf_matmul": 1e-3, "iact_rowfn": 1e-3, "perforated_attention": 1e-4,
        "perforated_attention_bf16": 0.05}


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


def loose_iact_threshold(a, rows=16):
    """A distance threshold under which a good share of the iACT kernel's
    row blocks approximate on `a`: the 75th percentile, over blocks, of the
    median distance from a block's rows to the first row of the block
    before it."""
    import torch
    blocks = a.reshape(-1, rows, a.shape[1])
    d = (blocks[1:] - blocks[:-1, :1]).norm(dim=-1).median(dim=1).values
    return float(torch.quantile(d, 0.75))


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
    from repro_torch.apps import approx_ffn
    from repro_torch.benchmarks import approx_ffn_sweep
    from repro_torch.core import perforation
    from repro_torch.core.types import (ApproxSpec, IACTParams, Level,
                                        PerforationKind, PerforationParams,
                                        TAFParams, Technique)
    from repro_torch.kernels import (_build, iact_memo, ops,
                                     perforated_attention, ref, taf_matmul)
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
    torch.cuda.synchronize()
    report["phases"]["kernels_s"] = time.perf_counter() - t0

    # -- 4. the 30-spec sweep at the reference geometry ----------------------
    log("phase 4: 30-spec sweep on the cuda substrate (reference geometry)")
    t0 = time.perf_counter()
    with open(BASELINE) as f:
        baseline = json.load(f)
    ops.reset_counts()
    summary = approx_ffn_sweep.main(
        report=lambda n, v, d: log(f"  {n},{v},{d}"), substrate="cuda",
        device=dev)
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
    for k, n in main_launches.items():
        check(n > 0, f"{k} was not launched on the main path")
    report["main_path"] = dict(rows=main_rows, launches=main_launches)
    report["phases"]["main_path_s"] = time.perf_counter() - t0

    # -- 6. per-kernel times at the main path's shapes -----------------------
    log("phase 6: per-kernel CUDA-event times at full width")
    t0 = time.perf_counter()
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

    # K3: a (seq, d) -> gelu(a @ w1) @ w2, only computed blocks
    _, m = ops.iact_rowfn(s["a"], s["w1"], s["w2"], **iact_kw)
    computed = int((~m).sum())
    ops_ = computed * (2.0 * 16 * d * d_h * 2)
    bytes_ = f4 * (seq * d + d * d_h + d_h * d + seq * d)
    rows.append(dict(
        kernel="iact_rowfn", module=iact_memo,
        ms=ms(ops.iact_rowfn, s["a"], s["w1"], s["w2"], **iact_kw),
        plain_ms=ms(ref.iact_rowfn_ref, s["a"], s["w1"], s["w2"],
                    repeats=3, **iact_kw),
        library_ms=ms(lambda a, w1, w2: F.gelu(a @ w1, approximate="tanh")
                      @ w2, s["a"], s["w1"], s["w2"]),
        ops=ops_, bytes=bytes_,
        work=f"{computed} of {m.numel()} blocks computed"))

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
    report["phases"]["timing_s"] = time.perf_counter() - t0

    kernels = []
    for r in rows:
        t_ops = r["ops"] / PEAK_F32_FLOPS * 1e3
        t_bytes = r["bytes"] / PEAK_BYTES * 1e3
        kernels.append({
            "name": r["kernel"], "route": "cuda",
            "source": r["module"].SOURCE, "replaces": r["module"].REPLACES,
            "launches": main_launches[r["kernel"]],
            "max_abs_err": errs[r["kernel"]],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": r["library_ms"],
            "mask_equal": masks_equal[r["kernel"]],
            "ops": r["ops"], "bytes": r["bytes"], "work": r["work"],
        })
    report["kernels"] = kernels
    os.makedirs(os.path.dirname(REPORT), exist_ok=True)
    with open(REPORT, "w") as f:
        json.dump(report, f, indent=1, default=str)
    log(f"phases (s): {json.dumps(report['phases'])}")
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
