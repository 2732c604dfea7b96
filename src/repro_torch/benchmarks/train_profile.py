"""Where one train step's time goes on the card, at a config's full width.

For any architecture of the registry (its config as given: float32
masters, the compute dtype, `remat`; weights from seed 0; `--layers` cuts
the depth and keeps every width), the train step of `launch.train`
(`launch.steps.make_train_step`, AdamW at a constant learning rate) runs
two steps over `SyntheticLM` batches of `--batch` x `--seq-len`
tokens, then one step is profiled:

  * `kernels`      -- the CUDA kernels the step ran (`torch.profiler`);
  * `gemm_kernels` -- those of them that are matrix products;
  * `foreach_kernels` -- those of AdamW's `torch._foreach_*` calls;
  * `device_ms`    -- the sum of their device times;
  * `wall_ms`      -- the next step between CUDA events;
  * `idle`         -- 1 - device_ms / wall_ms;
  * `peak_gb`      -- `torch.cuda.max_memory_allocated()` over the run;
  * `top`          -- the ten kernels of most device time (name, count,
                      device ms).

    PYTHONPATH=src python -m repro_torch.benchmarks.train_profile \\
        --arch qwen3-1.7b --batch 8 --seq-len 2048 [--layers N] [--out PATH]

Prints one JSON object. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, Optional

import torch

from .. import device as device_mod
from ..configs import cut_depth, get_config
from ..data import DataConfig, SyntheticLM
from ..launch import steps as steps_mod
from ..models import build
from ..optim import adamw
from .serve_profile import _profile_step


# steps run before the profiled one (the first builds the allocator's pools)
WARM = 2


def profile(arch: str, batch: int, seq_len: int,
            layers: Optional[int] = None) -> Dict:
    dev = device_mod.resolve("cuda")
    cfg = get_config(arch)
    if layers is not None:
        cfg = cut_depth(cfg, layers)
    torch.cuda.reset_peak_memory_stats(dev)
    model = build(cfg, device=dev)
    masters = model.masters(torch.Generator(device=dev).manual_seed(0))
    opt = adamw.init(masters)
    step_fn = steps_mod.make_train_step(model, adamw.AdamWConfig())
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=seq_len, global_batch=batch,
                                  seed=0))
    state = {"i": 0}

    def step():
        step_fn(masters, opt, data.batch(state["i"]))
        state["i"] += 1

    for _ in range(WARM):
        step()
    row = _profile_step(step, dev)
    names = row.pop("kernel_names")
    # AdamW's foreach calls (the rest of it: a square and a sum a leaf)
    row["foreach_kernels"] = sum(c for n, c in names.items()
                                 if "multi_tensor_apply" in n)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    start.record()
    step()
    end.record()
    end.synchronize()
    row["wall_ms"] = start.elapsed_time(end)
    row["idle"] = 1.0 - row["device_ms"] / max(row["wall_ms"], 1e-9)
    row["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return dict(arch=arch, n_layers=cfg.n_layers, batch=batch,
                seq_len=seq_len, tokens=batch * seq_len, **row)


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, required=True)
    ap.add_argument("--seq-len", type=int, required=True)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    res = profile(args.arch, args.batch, args.seq_len, args.layers)
    text = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return res


if __name__ == "__main__":
    main()
