"""Where one decode step's time goes on the card, without TAF, with TAF
computing every layer and with every layer skipped, at a config's full
width.

For any architecture of the registry (bf16 compute, weights from seed 0,
`--layers` cuts the depth and keeps every width), a batch of prompts (with
the vlm's or audio model's seeded frontend inputs, as `launch.serve`
draws them) is prefilled and one decode step is profiled by the model
without decode TAF (`plain`). Where decode TAF runs (a transformer
without MLA or MoE, e.g. Qwen3-1.7B), the step is profiled twice more: by
the TAF model with its threshold at 0 (`precise`: every layer computed,
the detector stepped) and with every layer's `remaining` counter set
(`skipped`). The skipped step is profiled once more on the first
`SHORT_LAYERS` layers alone (`skipped_short`): the two counts pin what
one skipped layer launches, `(skipped - skipped_short) / (n_layers -
SHORT_LAYERS)`, apart from the step's fixed kernels (embedding, detector
step, final norm, head). Per step:

  * `kernels`      -- the CUDA kernels the step ran (`torch.profiler`;
                      the step is profiled `PROFILES` times and the
                      profile with the most kernels is kept: on a long
                      step the profiler can lose some kernels' records);
  * `kernel_counts` -- each of those profiles' kernel counts, in order;
  * `gemm_kernels` -- those of them that are matrix products (cuBLAS
                      gemm / gemv): the head's one product at a fully
                      skipped step, none of any layer's;
  * `device_ms`    -- the sum of their device times;
  * `host_ms`      -- the step on the host clock up to its return (with
                      TAF one device read included: the step's
                      `remaining`);
  * `wall_ms`      -- the step between CUDA events (median of 5);
  * `idle`         -- 1 - device_ms / wall_ms;
  * `top`          -- the ten kernels of most device time (name, count,
                      device ms).

With `--shards S` the plain and precise steps are profiled once more
through the sharded serve step (`launch.steps.make_sharded_serve_step`, S
shards of batch / S lanes on a one-rank process group it starts):
`sharded_plain` and `sharded_precise`, S decode steps' kernels each.

    PYTHONPATH=src python -m repro_torch.benchmarks.serve_profile \\
        --arch qwen3-1.7b --batch 4 --prompt-len 128 [--shards S]
        [--layers N] [--out PATH]

Prints one JSON object. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict, Optional

import torch

from .. import device as device_mod
from ..configs import cut_depth, get_config
from ..core.types import ApproxSpec, Level, TAFParams, Technique
from ..models import build
from ..obs import timing
from ..qos import set_decode_threshold

GEMM_NAMES = ("gemm", "gemv", "Gemm", "Gemv", "nvjet")
SHORT_LAYERS = 2
PROFILES = 3


def _profile_step(step, dev) -> Dict:
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize(dev)
    with torch.profiler.profile(activities=acts) as prof:
        step()
        torch.cuda.synchronize(dev)
    kernels = gemms = 0
    device_us = 0.0
    names, rows = {}, []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = float(getattr(e, "device_time_total",
                           getattr(e, "cuda_time_total", 0.0)))
        kernels += e.count
        device_us += us
        names[e.key] = e.count
        rows.append((e.key, e.count, us / 1e3))
        if any(g in e.key for g in GEMM_NAMES):
            gemms += e.count
    rows.sort(key=lambda r: -r[2])
    return dict(kernels=kernels, gemm_kernels=gemms,
                device_ms=device_us / 1e3, kernel_names=names,
                top=[dict(name=n[:120], count=c, device_ms=ms)
                     for n, c, ms in rows[:10]])


def profile(arch: str, batch: int, prompt_len: int,
            shards: Optional[int] = None,
            layers: Optional[int] = None) -> Dict:
    from ..launch import serve
    dev = device_mod.resolve(None)
    taf = ApproxSpec(Technique.TAF, Level.BLOCK, taf=TAFParams(2, 4, 0.0))
    base = get_config(arch)
    if layers is not None:
        base = cut_depth(base, layers)
    cfg = dataclasses.replace(base, approx_decode=taf)
    with_taf = build(cfg, device=dev).taf_enabled
    params = build(base, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    inputs, prefix = serve.frontend_batch(base, batch, prompt_len, 0)
    batch_ = dict(inputs, max_len=prefix + prompt_len + 16)
    pos = prefix + prompt_len
    p = taf.taf.prediction_size

    def prefilled(c, ps):
        model = build(c, device=dev)
        logits, cache = model.prefill(ps, batch_)
        return model, cache, torch.argmax(logits, dim=-1).to(torch.int32)

    def stepper(c, ps, pre=None):
        model, cache, tokens = prefilled(c, ps)

        def step():
            if pre:
                pre(cache)
            model.decode_step(ps, cache, tokens, pos)
        return step

    def precise(cache):
        set_decode_threshold(cache, 0.0)

    def skip_all(cache):
        cache["taf"]["remaining"].fill_(p)

    steps = (("plain", stepper(base, params)),)
    if with_taf:
        short_params = dict(
            params, dense_blocks=params["dense_blocks"][:SHORT_LAYERS])
        steps += (
            ("precise", stepper(cfg, params, precise)),
            ("skipped", stepper(cfg, params, skip_all)),
            ("skipped_short", stepper(dataclasses.replace(
                cfg, n_layers=SHORT_LAYERS), short_params, skip_all)))
    started = False
    if shards:
        from ..launch import steps as steps_mod
        from ..models.lm import shard_taf_state
        from ..runtime import elastic
        started = elastic.init_single(dev)
        mesh = elastic.data_mesh_for(1, device=dev)

        def sharded(c, ps, pre=None):
            model, cache, tokens = prefilled(c, ps)
            cache = shard_taf_state(cache, shards)
            step_fn = steps_mod.make_sharded_serve_step(model, mesh, shards,
                                                        batch)

            def step():
                if pre:
                    pre(cache)
                step_fn(ps, cache, tokens, pos)
            return step

        steps += (("sharded_plain", sharded(base, params)),)
        if with_taf:
            steps += (("sharded_precise", sharded(cfg, params, precise)),)
    out = {"arch": arch, "n_layers": cfg.n_layers, "decode_taf": with_taf,
           "short_layers": SHORT_LAYERS, "batch": batch, "shards": shards,
           "prompt_len": prompt_len, "device": device_mod.name(dev)}
    for label, step in steps:
        step()                                   # warm
        rows = [_profile_step(step, dev) for _ in range(PROFILES)]
        row = max(rows, key=lambda r: r["kernels"])
        row["kernel_counts"] = [r["kernels"] for r in rows]
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        step()
        row["host_ms"] = (time.perf_counter() - t0) * 1e3
        row["wall_ms"] = timing.measure(step, device=dev, warmup=1,
                                        repeats=5).seconds * 1e3
        row["idle"] = 1.0 - row["device_ms"] / max(row["wall_ms"], 1e-9)
        out[label] = row
    if started:
        import torch.distributed as dist
        dist.destroy_process_group()
    return out


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, required=True)
    ap.add_argument("--prompt-len", type=int, required=True)
    ap.add_argument("--shards", type=int, default=None)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (widths kept)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    res = profile(args.arch, batch=args.batch, prompt_len=args.prompt_len,
                  shards=args.shards, layers=args.layers)
    text = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text, flush=True)
    return res


if __name__ == "__main__":
    main()
