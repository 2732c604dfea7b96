"""Production-shaped training driver (port of `repro.launch.train`).

Wires together every substrate: config registry -> model (float32 masters
in the dtype JAX stores them, the forward in the compute dtype) -> train
step -> synthetic data pipeline (prefetching) -> AdamW + warmup-cosine ->
checkpoint manager (async, keep-N, resume) -> straggler monitor ->
preemption guard. The same driver trains the smoke configs on the CPU
(`--device cpu`) and the full configs on the card.

Fault tolerance: `--resume` restarts from the latest checkpoint (the data
pipeline is a pure function of step, so batches replay exactly);
SIGTERM-style preemption triggers a final checkpoint + clean exit(42).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --smoke --steps 50 --ckpt-dir /tmp/ckpt [--device cpu]

Under a process group of several ranks (`torchrun`, one rank a device)
the driver trains on the (data, model) mesh of `--model-parallel` TP
degree: masters and AdamW state are placed by `runtime.sharding`'s
`param_specs` / `opt_state_specs` as DTensors, each batch by
`launch.specs.batch_shardings`, and the step computes what the one-device
step computes. Without one it trains on its one device.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from .. import device as device_mod
from ..checkpoint import CheckpointManager
from ..configs import get_config, get_smoke_config
from ..data import DataConfig, PrefetchIterator, SyntheticLM
from ..models import build
from ..optim import adamw
from ..optim import schedule as sched
from ..runtime import sharding as shardlib
from ..runtime.straggler import PreemptionGuard, StepMonitor
from . import specs as specs_mod
from . import steps as steps_mod

PREEMPTED_EXIT = 42


def add_frontend_stub(batch, cfg, rng):
    """The stubbed frontends' inputs, drawn from `rng` as the JAX driver
    draws them: the vlm's patch embeddings, the audio model's frames."""
    if cfg.frontend == "vision_patches":
        batch["patch_embeds"] = rng.standard_normal(
            (batch["tokens"].shape[0], cfg.n_patch_tokens, cfg.d_model)
        ).astype(np.float32) * 0.02
    elif cfg.frontend == "audio_frames":
        batch["frames"] = rng.standard_normal(
            (batch["tokens"].shape[0], cfg.max_source_positions, cfg.d_model)
        ).astype(np.float32) * 0.02
    return batch


def _host(t) -> float:
    """A 0-d metric as a float (a DTensor's full value)."""
    return float(t.full_tensor() if hasattr(t, "full_tensor") else t)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def _mesh(model_parallel: int, dev):
    """The (data, model) mesh of the process group, or None on one
    process."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return None
    from ..runtime.elastic import make_mesh_for
    return make_mesh_for(model_parallel=model_parallel, device=dev)


def main(argv: Optional[list] = None) -> List[float]:
    args = _parser().parse_args(argv)
    dev = device_mod.resolve(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build(cfg, device=dev)
    mesh = _mesh(args.model_parallel, dev)

    params = model.masters(torch.Generator(device=dev).manual_seed(args.seed))
    opt_cfg = adamw.AdamWConfig(lr=args.lr)
    opt_state = adamw.init(params)
    specs = None
    if mesh is not None:
        specs = (shardlib.param_specs(mesh, params, fsdp=cfg.fsdp),
                 shardlib.opt_state_specs(mesh, opt_state, fsdp=cfg.fsdp))
        params = shardlib.place(params, mesh, specs[0])
        opt_state = adamw.AdamWState(*shardlib.place(
            list(opt_state), mesh, specs[1]))

    mgr = CheckpointManager(args.ckpt_dir, keep_n=3, async_save=True) \
        if args.ckpt_dir else None
    start_step = 0
    if args.resume and mgr and mgr.latest_step() is not None:
        (params, opt_state), start_step = mgr.restore(
            (params, opt_state), mesh=mesh, specs=specs)
        print(f"resumed from step {start_step}")

    step_fn = steps_mod.make_train_step(
        model, opt_cfg, schedule_fn=sched.warmup_cosine,
        schedule_kwargs=dict(warmup_steps=args.warmup,
                             total_steps=args.steps))

    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=args.seq_len,
                                  global_batch=args.batch, seed=args.seed))
    it = PrefetchIterator(data, start_step=start_step)
    monitor = StepMonitor()
    guard = PreemptionGuard()
    rng = np.random.RandomState(args.seed + 17)

    losses: List[float] = []
    step = start_step
    try:
        for step in range(start_step, args.steps):
            t0 = time.time()
            batch = add_frontend_stub(next(it), cfg, rng)
            if mesh is not None:
                batch = {k: torch.as_tensor(v, device=dev)
                         for k, v in batch.items()}
                batch = shardlib.place(batch, mesh, specs_mod.batch_shardings(
                    mesh, batch))
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = _host(metrics["loss"])
            losses.append(loss)
            dt = time.time() - t0
            ev = monitor.record(dt)
            if ev is not None:
                print(f"[straggler] step {step}: {ev.duration_s:.2f}s = "
                      f"{ev.slowdown:.1f}x median")
            if step % args.log_every == 0:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"gnorm {_host(metrics['grad_norm']):.3f} {dt:.2f}s",
                      flush=True)
            if mgr and (step + 1) % args.ckpt_every == 0:
                mgr.save(step + 1, (params, opt_state))
            if guard.should_stop:
                print("preemption signal: checkpoint + exit")
                if mgr:
                    mgr.save(step + 1, (params, opt_state))
                    mgr.wait()
                sys.exit(PREEMPTED_EXIT)
    finally:
        it.close()
        if mgr:
            mgr.wait()
    if mgr:
        mgr.save(args.steps, (params, opt_state))
        mgr.wait()
    first = np.mean(losses[:5]) if len(losses) >= 5 else losses[0]
    last = np.mean(losses[-5:])
    print(f"done: loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")
    return losses


if __name__ == "__main__":
    main()
