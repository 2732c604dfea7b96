"""olmoe-1b-7b [moe]: 64 experts top-8.

16L d_model=2048 16H (GQA kv=16) d_ff=1024(expert) vocab=50304
[arXiv:2409.02060; hf].
"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    moe=MoEConfig(n_experts=64, experts_per_token=8, d_ff_expert=1024,
                  n_shared_experts=0, n_dense_layers=0,
                  capacity_factor=1.25, router_group_size=512),
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-smoke", family="moe", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=64, vocab_size=256,
        moe=MoEConfig(n_experts=8, experts_per_token=2, d_ff_expert=64,
                      n_shared_experts=0, n_dense_layers=0,
                      router_group_size=64),
        remat=False)
