"""Serving entry point: batched prefill + greedy decode loop, with decode-time
TAF as a flag (port of `repro.launch.serve`).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
      --prompt-len 128 --gen 32 --taf "memo(out:2:4:0.05)" [--device cpu]

Every architecture of the registry serves (`--arch`, any of
`configs.list_archs()`). The stubbed frontends' inputs -- the vlm's
`patch_embeds` (B, n_patch_tokens, d) and the audio model's `frames`
(B, max_source_positions, d) -- are drawn from the seed's RandomState after
the prompts, with scale 0.02, as the JAX entry point draws them. The vlm's
patch tokens sit before the prompt in its cache, so its cache holds them
too and its decode positions start after them (the JAX entry point counts
positions from the prompt alone: its decode overwrites the K/V of the
prompt's last tokens, and its cache overflows when the patches outnumber
the generated tokens).

With --taf, each transformer layer carries a TAF state machine across
decode steps (`repro_torch.models.lm`); the report prints tokens/s and the
fraction of layer-steps skipped. A skipped layer-step runs none of the
layer's compute. With --approx-ffn, the FFN runs under that spec (on an
MoE model a PERFORATION spec drops experts). Runs on cuda unless --device
cpu is given; weights come from --seed.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from .. import device as device_mod
from ..configs import get_config, get_smoke_config, list_archs
from ..core.types import parse_pragma
from ..models import build
from ..obs import metrics as obs_metrics
from . import steps as steps_mod


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def frontend_batch(cfg, batch: int, prompt_len: int, seed: int):
    """The seeded prefill inputs of `batch` prompts: {"tokens", and the
    stubbed frontend's "patch_embeds" / "frames"} (numpy), and the number
    of cache positions the frontend takes before the prompt."""
    rng = np.random.RandomState(seed)
    inputs = {"tokens": rng.randint(0, cfg.vocab_size,
                                    (batch, prompt_len)).astype(np.int32)}
    prefix = 0
    if cfg.frontend == "vision_patches":
        inputs["patch_embeds"] = (rng.standard_normal(
            (batch, cfg.n_patch_tokens, cfg.d_model)) * 0.02).astype(
                np.float32)
        prefix = cfg.n_patch_tokens
    if cfg.frontend == "audio_frames":
        inputs["frames"] = (rng.standard_normal(
            (batch, cfg.max_source_positions, cfg.d_model)) * 0.02).astype(
                np.float32)
    return inputs, prefix


def run(cfg, *, batch: int = 4, prompt_len: int = 32, gen: int = 32,
        seed: int = 0, device=None, params=None) -> Dict:
    """Prefill `batch` seeded prompts of `prompt_len` tokens and decode
    `gen` tokens greedily. Returns the tokens (batch, gen), the prefill
    and decode walls, decode tokens/s and the TAF layer-step tallies.
    `params` (the default: the model's own init from `seed`) lets a caller
    serve given weights."""
    dev = device_mod.resolve(device)
    model = build(cfg, device=dev)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(seed))
    inputs, prefix = frontend_batch(cfg, batch, prompt_len, seed)
    max_len = prefix + prompt_len + gen
    prefill = steps_mod.make_prefill_step(model, max_len)
    serve = steps_mod.make_serve_step(model)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, inputs)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    tokens = torch.argmax(logits, dim=-1).to(torch.int32)

    out = [tokens]
    skipped = total = 0
    t0 = time.perf_counter()
    for t in range(gen - 1):
        tokens, logits, cache = serve(params, cache, tokens,
                                      prefix + prompt_len + t)
        if "taf" in cache:
            rem = cache["taf"]["remaining"].cpu().numpy()
            obs_metrics.count_host_read()
            skipped += int((rem > 0).sum())
            total += rem.size
        out.append(tokens)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return {"tokens": torch.stack(out, dim=1).cpu().numpy(),
            "prefill_s": t_prefill, "decode_s": t_decode,
            "tokens_per_s": batch * (gen - 1) / max(t_decode, 1e-9),
            "taf_skipped": skipped, "taf_total": total}


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="deepseek-7b",
                    help=f"one of {list_archs()}")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--taf", default=None,
                    help='e.g. "memo(out:3:8:0.05)" -- decode-time TAF')
    ap.add_argument("--approx-ffn", default=None,
                    help='e.g. "perfo(fini:0.5)" -- the FFN\'s spec (MoE: '
                    'expert perforation)')
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.taf:
        cfg = dataclasses.replace(cfg, approx_decode=parse_pragma(args.taf))
    if args.approx_ffn:
        cfg = dataclasses.replace(cfg,
                                  approx_ffn=parse_pragma(args.approx_ffn))
    res = run(cfg, batch=args.batch, prompt_len=args.prompt_len,
              gen=args.gen, seed=args.seed, device=args.device)
    print(f"prefill: {res['prefill_s']:.3f}s  decode: {res['decode_s']:.3f}s "
          f"({res['tokens_per_s']:.1f} tok/s)")
    if args.taf and res["taf_total"]:
        print(f"TAF: {res['taf_skipped']}/{res['taf_total']} layer-steps in "
              f"stable regime "
              f"({100 * res['taf_skipped'] / res['taf_total']:.1f}% skipped)")
    print("sample:", res["tokens"][0, :16])
    return res["tokens"]


if __name__ == "__main__":
    main()
