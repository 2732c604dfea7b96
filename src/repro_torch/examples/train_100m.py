"""End-to-end driver: train a ~100M-parameter qwen3-family model on the
synthetic pipeline, with checkpointing + resume (port of
`examples/train_100m.py`).

Run:  PYTHONPATH=src python -m repro_torch.examples.train_100m
      [--steps 200] [--device cpu] [--resume]

This exercises the full production path (config -> model -> train step ->
data -> optimizer -> checkpoint -> monitor) through `launch.train`; the
same driver trains the full configs. `--resume` and `--ckpt-every` pass
through to the driver.
"""
import argparse
import os
import sys
import tempfile

from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import train as train_mod

# ~100M params: 12L x d512 x ff2048, vocab 32k
CONFIG_100M = ModelConfig(
    name="repro-100m", family="dense", n_layers=12, d_model=512,
    n_heads=8, n_kv_heads=4, d_ff=2048, vocab_size=32000, head_dim=64,
    qk_norm=True, remat=False, compute_dtype="float32")
# the registry resolves an arch to its module's CONFIG
CONFIG = CONFIG_100M


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_100m_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    # register the 100M config so the production trainer can resolve it
    # (for this call only)
    registry._MODULES["repro-100m"] = "repro_torch.examples.train_100m"
    try:
        n = CONFIG_100M.param_count()
        print(f"training {CONFIG_100M.name}: {n / 1e6:.1f}M params, "
              f"{args.steps} steps @ batch {args.batch} x seq {args.seq_len}")
        losses = train_mod.main([
            "--arch", "repro-100m", "--steps", str(args.steps),
            "--batch", str(args.batch), "--seq-len", str(args.seq_len),
            "--ckpt-dir", args.ckpt_dir,
            "--ckpt-every", str(args.ckpt_every), "--log-every", "10",
            "--device", args.device] + (["--resume"] if args.resume else []))
    finally:
        registry._MODULES.pop("repro-100m", None)
    if not args.resume:
        assert losses[-1] < losses[0], "loss must decrease"
    return losses


if __name__ == "__main__":
    main(sys.argv[1:])
