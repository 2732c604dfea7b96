"""Continuous-batching serving demo: many requests, few slots, TAF decode
(port of `examples/continuous_batching.py`).

Run:  PYTHONPATH=src python -m repro_torch.examples.continuous_batching
      [--device cpu]
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from .. import device as device_mod
from ..configs import get_smoke_config
from ..core.types import parse_pragma
from ..models import build
from ..serving import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)
    cfg = dataclasses.replace(
        get_smoke_config("deepseek-7b"), remat=False,
        approx_decode=parse_pragma("memo(out:2:4:5.0) level(team)"))
    model = build(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    engine = ServingEngine(model, params, slots=4, max_len=64, prompt_len=8)

    rng = np.random.RandomState(0)
    n_requests = 10
    for i in range(n_requests):
        engine.submit(Request(
            uid=i, prompt=rng.randint(0, cfg.vocab_size, 8).astype(np.int32),
            max_new_tokens=int(rng.randint(4, 24))))

    t0 = time.time()
    stats = engine.run_until_drained()
    dt = time.time() - t0
    print(f"served {stats.finished}/{n_requests} requests in {dt:.2f}s "
          f"({stats.tokens_out / dt:.1f} tok/s over {stats.ticks} ticks)")
    if stats.taf_total:
        print(f"TAF skipped {stats.taf_skip_fraction:.0%} of layer-steps "
              f"(paper's output memoization as a serving feature)")
    return stats


if __name__ == "__main__":
    main()
