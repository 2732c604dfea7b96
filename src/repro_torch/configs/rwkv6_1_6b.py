"""rwkv6-1.6b [ssm]: Finch -- attention-free, data-dependent decay.

24L d_model=2048 d_ff=7168 vocab=65536 [arXiv:2404.05892; unverified].
O(1) state per layer => sub-quadratic, eligible for long_500k.
"""
from .base import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,            # d_model / head_dim
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    norm="ln",
    rwkv=RWKVConfig(head_dim=64, decay_lora_rank=64, chunk_size=128),
    subquadratic=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-smoke", family="ssm", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab_size=256, norm="ln",
        rwkv=RWKVConfig(head_dim=16, decay_lora_rank=8, chunk_size=8),
        subquadratic=True, remat=False)
