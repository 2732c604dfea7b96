"""Where one decode step's time goes on the card, without TAF, with TAF
computing every layer and with every layer skipped, at a config's full
width.

For Qwen3-1.7B (28 layers, d_model 2048, bf16 compute, weights from seed
0), a batch of prompts is prefilled and one decode step is profiled three
times: by the model without decode TAF (`plain`), by the TAF model with
its threshold at 0 (`precise`: every layer computed, the detector stepped)
and with every layer's `remaining` counter set (`skipped`). The skipped
step is profiled once more on the first `SHORT_LAYERS` layers alone
(`skipped_short`): the two counts pin what one skipped layer launches,
`(skipped - skipped_short) / (n_layers - SHORT_LAYERS)`, apart from the
step's fixed kernels (embedding, detector step, final norm, head). Per
step:

  * `kernels`      -- the CUDA kernels the step ran (`torch.profiler`);
  * `gemm_kernels` -- those of them that are matrix products (cuBLAS
                      gemm / gemv): the head's one product at a fully
                      skipped step, none of any layer's;
  * `device_ms`    -- the sum of their device times;
  * `host_ms`      -- the step on the host clock up to its return (with
                      TAF one device read included: the step's
                      `remaining`);
  * `wall_ms`      -- the step between CUDA events (median of 5);
  * `idle`         -- 1 - device_ms / wall_ms.

    PYTHONPATH=src python -m repro_torch.benchmarks.serve_profile \\
        --arch qwen3-1.7b --batch 4 --prompt-len 128 [--out PATH]

Prints one JSON object. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict

import numpy as np
import torch

from .. import device as device_mod
from ..configs import get_config
from ..core.types import ApproxSpec, Level, TAFParams, Technique
from ..models import build
from ..obs import timing
from ..qos import set_decode_threshold

GEMM_NAMES = ("gemm", "gemv", "Gemm", "Gemv", "nvjet")
SHORT_LAYERS = 2


def _profile_step(step, dev) -> Dict:
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize(dev)
    with torch.profiler.profile(activities=acts) as prof:
        step()
        torch.cuda.synchronize(dev)
    kernels = gemms = 0
    device_us = 0.0
    names = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = float(getattr(e, "device_time_total",
                           getattr(e, "cuda_time_total", 0.0)))
        kernels += e.count
        device_us += us
        names[e.key] = e.count
        if any(g in e.key for g in GEMM_NAMES):
            gemms += e.count
    return dict(kernels=kernels, gemm_kernels=gemms,
                device_ms=device_us / 1e3, kernel_names=names)


def profile(arch: str, batch: int, prompt_len: int) -> Dict:
    dev = device_mod.resolve(None)
    taf = ApproxSpec(Technique.TAF, Level.BLOCK, taf=TAFParams(2, 4, 0.0))
    cfg = dataclasses.replace(get_config(arch), approx_decode=taf)
    params = build(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    prompts = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)
    batch_ = {"tokens": prompts, "max_len": prompt_len + 16}
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
            model.decode_step(ps, cache, tokens, prompt_len)
        return step

    short_params = dict(params,
                        dense_blocks=params["dense_blocks"][:SHORT_LAYERS])

    def precise(cache):
        set_decode_threshold(cache, 0.0)

    def skip_all(cache):
        cache["taf"]["remaining"].fill_(p)

    steps = (
        ("plain", stepper(get_config(arch), params)),
        ("precise", stepper(cfg, params, precise)),
        ("skipped", stepper(cfg, params, skip_all)),
        ("skipped_short", stepper(dataclasses.replace(
            cfg, n_layers=SHORT_LAYERS), short_params, skip_all)))
    out = {"arch": arch, "n_layers": cfg.n_layers,
           "short_layers": SHORT_LAYERS, "batch": batch,
           "prompt_len": prompt_len, "device": device_mod.name(dev)}
    for label, step in steps:
        step()                                   # warm
        row = _profile_step(step, dev)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        step()
        row["host_ms"] = (time.perf_counter() - t0) * 1e3
        row["wall_ms"] = timing.measure(step, device=dev, warmup=1,
                                        repeats=5).seconds * 1e3
        row["idle"] = 1.0 - row["device_ms"] / max(row["wall_ms"], 1e-9)
        out[label] = row
    return out


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, required=True)
    ap.add_argument("--prompt-len", type=int, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    res = profile(args.arch, batch=args.batch, prompt_len=args.prompt_len)
    text = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text, flush=True)
    return res


if __name__ == "__main__":
    main()
