"""qwen1.5-4b [dense]: QKV bias.

40L d_model=2560 20H (GQA kv=20) d_ff=6912 vocab=151936
[hf:Qwen/Qwen1.5-0.5B; hf].
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1e6,
    norm_eps=1e-6,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256, qkv_bias=True,
        remat=False)
