"""Offline calibration of the decode workload, as a harness ApproxApp (port
of `repro.qos.calibrate`).

The QoS policy ladder needs an offline Pareto DB for the workload the
serving path runs: decode-time TAF at various RSD thresholds.
`make_decode_app` wraps a short, seeded greedy generation as an
`ApproxApp`, so the calibration IS a `harness.sweep` -- resumable, keyed
by workload fingerprint, and consumable by `QosPolicy.from_db` like any
other sweep database.

The model's decode threshold is a tensor in the decode cache, so every
threshold of the grid runs through the SAME prefill / decode step pair.

QoI, per `metric`: "mape" -- the stacked per-step logits; "mcr" -- the
decoded token ids (paper Eq. 2), the statistic a serving deployment
contracts on. `approx_fraction` is skipped layer-steps / layer-steps, and
`flop_fraction = 1 - approx_fraction`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence

import numpy as np
import torch

from .. import device as device_mod
from ..core.harness import AppResult, ApproxApp
from ..core.types import ApproxSpec, Level, TAFParams, Technique
from ..launch import steps as steps_mod
from ..obs import metrics as obs_metrics
from ..obs.timing import measure

SHARDED_ITEM = "ROADMAP Queue 1 item 5 (multi-GPU)"


def default_decode_cfg(arch: str = "qwen3-1.7b", *, history_size: int = 2,
                       prediction_size: int = 4,
                       rsd_threshold: float = 0.5):
    """A smoke config with decode-time TAF enabled (float32 so canary
    parity and calibration errors are deterministic)."""
    from ..configs import get_smoke_config
    return dataclasses.replace(
        get_smoke_config(arch), remat=False, compute_dtype="float32",
        approx_decode=ApproxSpec(
            Technique.TAF, Level.BLOCK,
            taf=TAFParams(history_size=history_size,
                          prediction_size=prediction_size,
                          rsd_threshold=rsd_threshold)))


def threshold_grid(cfg, thresholds: Sequence[float]) -> List[ApproxSpec]:
    """TAF specs sharing the config's structural params (history/prediction
    size shape the decode cache and MUST match) across `thresholds`."""
    t = cfg.approx_decode.taf
    return [ApproxSpec(Technique.TAF, Level.BLOCK,
                       taf=TAFParams(t.history_size, t.prediction_size,
                                     float(th)))
            for th in thresholds]


def set_decode_threshold(cache, value):
    """Set the decode-TAF threshold of every layer to `value` in place and
    return `cache` (0.0 = precise: RSD < 0 never holds). A hard precise
    fallback also cancels in-flight predictions, otherwise up to
    prediction_size more approximated layer-steps would run after the knob
    move. A tensor write: no step is rebuilt and nothing is read back. The
    per-shard form (a sequence of values) comes with the sharded engine."""
    if np.ndim(value) != 0:
        raise NotImplementedError(
            f"per-shard thresholds need a sharded TAF cache, which is not "
            f"ported yet ({SHARDED_ITEM})")
    taf = cache["taf"]
    taf["threshold"].fill_(float(value))
    if float(value) == 0.0:
        taf["remaining"].zero_()
    return cache


def decode_cost_model(cfg=None, *, batch: int = 2, gen: int = 16,
                      machine=None):
    """An `analysis.cost.AppCostModel` for the decode workload, built from
    the config's shape constants alone (no tracing, no model build).

    Per layer-step the decode does ~12*d_model^2 FLOPs per sequence, and
    one TAF decision gates each layer-step. The per-site error
    amplification is `sqrt(gen)`: per-step residuals are independently
    signed, so the first-order accumulation is a random walk."""
    from ..analysis.cost import AppCostModel, CostVector, Site
    from ..analysis.machine import get_machine

    cfg = cfg if cfg is not None else default_decode_cfg()
    d = int(getattr(cfg, "d_model", 64))
    n_layers = int(getattr(cfg, "n_layers", 2))
    flops_per_step = 12.0 * d * d * batch
    weight_bytes = 12.0 * d * d * 4.0
    region = CostVector(flops_per_step, weight_bytes)
    invocations = float(n_layers * gen)
    site = Site(region=region, invocations=invocations,
                in_dim=d, amplification=math.sqrt(gen))
    return AppCostModel(
        name="taf_decode",
        total=region * invocations,
        sites={Technique.TAF: site},
        machine=get_machine(machine),
        dispatches=float(gen))


def prescreen_thresholds(cfg, thresholds: Sequence[float], *,
                         batch: int = 2, gen: int = 16, machine=None,
                         min_speedup: float = 1.0,
                         max_error: float = None) -> List[ApproxSpec]:
    """Cost-model pre-screen for a calibration sweep: the threshold grid
    with statically hopeless rungs removed (predicted speedup below
    `min_speedup`, or predicted error bound over `max_error`)."""
    from ..analysis.cost import filter_specs

    model = decode_cost_model(cfg, batch=batch, gen=gen, machine=machine)
    kept, _ = filter_specs(model, threshold_grid(cfg, thresholds),
                           min_speedup=min_speedup, max_error=max_error,
                           context="qos.calibrate")
    return kept


def make_decode_app(cfg=None, *, batch: int = 2, prompt_len: int = 8,
                    gen: int = 16, seed: int = 0, metric: str = "mape",
                    device=None, params=None) -> ApproxApp:
    """The decode workload as an ApproxApp: run(spec) greedily generates
    `gen` tokens under spec's TAF threshold and returns the stacked logits.

    Specs must be NONE (precise) or TAF with the config's structural
    params; anything else raises. Runs on `device` (None means cuda) with
    the model's own init from `seed`, or with `params` when given (the
    parity tests pass the JAX model's weights through
    `convert.lm_params`).
    """
    from ..models import build
    if metric not in ("mape", "mcr"):
        raise ValueError(f"metric must be 'mape' or 'mcr', got {metric!r}")
    cfg = cfg if cfg is not None else default_decode_cfg()
    dev = device_mod.resolve(device)
    taf_cfg = cfg.approx_decode.taf
    model = build(cfg, device=dev)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(seed))
    rng = np.random.RandomState(seed)
    prompts = rng.randint(0, cfg.vocab_size,
                          (batch, prompt_len)).astype(np.int32)
    prefill = steps_mod.make_prefill_step(model, prompt_len + gen)
    serve = steps_mod.make_serve_step(model)

    def _threshold(spec: ApproxSpec) -> float:
        if spec.technique == Technique.NONE:
            return 0.0
        if spec.technique != Technique.TAF:
            raise ValueError(
                f"decode calibration sweeps TAF thresholds; got {spec}")
        t = spec.taf
        if (t.history_size, t.prediction_size) != (taf_cfg.history_size,
                                                   taf_cfg.prediction_size):
            raise ValueError(
                "history/prediction size are structural (they shape the "
                f"decode cache): spec has ({t.history_size}, "
                f"{t.prediction_size}), config has "
                f"({taf_cfg.history_size}, {taf_cfg.prediction_size})")
        return float(t.rsd_threshold)

    warmed = []

    def run(spec: ApproxSpec) -> AppResult:
        th = _threshold(spec)
        if not warmed:
            # first-call setup OUTSIDE the timed loop (the exact baseline
            # runs first and would otherwise absorb it), on a throwaway
            # cache: the decode step writes its cache in place
            logits, cache = prefill(params, {"tokens": prompts})
            serve(params, cache, torch.argmax(logits, dim=-1).to(
                torch.int32), prompt_len)
            warmed.append(True)
        logits, cache = prefill(params, {"tokens": prompts})
        tokens = torch.argmax(logits, dim=-1).to(torch.int32)
        set_decode_threshold(cache, th)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        outs = []
        state = {"skipped": 0, "total": 0}

        def decode_loop():
            toks, c = tokens, cache
            for t in range(gen):
                toks, logits, c = serve(params, c, toks, prompt_len + t)
                outs.append(logits)
                rem = c["taf"]["remaining"].cpu().numpy()
                obs_metrics.count_host_read()
                state["skipped"] += int((rem > 0).sum())
                state["total"] += rem.size
            return state["total"]

        # the per-step read above syncs every step, so the wall stamps
        # before the QoI is assembled on the host
        wall = measure(decode_loop, device=dev, warmup=0, repeats=1,
                       span="calibrate.decode").seconds
        skipped, total = state["skipped"], state["total"]
        qoi = torch.stack(outs).cpu().numpy()
        if metric == "mcr":
            qoi = np.argmax(qoi, axis=-1)
        frac = skipped / max(total, 1)
        return AppResult(qoi=qoi, wall_time_s=wall, approx_fraction=frac,
                         flop_fraction=max(1.0 - frac, 1e-3),
                         extra={"skipped_layer_steps": skipped,
                                "layer_steps": total})

    return ApproxApp(
        name="taf_decode", run=run, error_metric=metric,
        workload=dict(arch=getattr(cfg, "name", ""), metric=metric,
                      batch=batch, prompt_len=prompt_len, gen=gen, seed=seed,
                      hSize=taf_cfg.history_size,
                      pSize=taf_cfg.prediction_size))
