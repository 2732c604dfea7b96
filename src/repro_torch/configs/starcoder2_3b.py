"""starcoder2-3b [dense]: GQA kv=2, RoPE, LayerNorm + GELU MLP.

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152 [arXiv:2402.19173; hf].
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    norm="ln",
    mlp="gelu",
    qkv_bias=True,
    rope_theta=1e5,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256, norm="ln",
        mlp="gelu", qkv_bias=True, remat=False)
