"""zamba2-7b [hybrid]: Mamba2 backbone + shared attention blocks.

81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000 ssm_state=64
[arXiv:2411.15242; unverified]. The shared attention block (single weight
set) is applied every 6th layer slot; remaining slots are Mamba2+FFN.
Sub-quadratic: eligible for long_500k (decode attention is O(S) per step and
the Mamba2 state is O(1)).
"""
from .base import HybridConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm=SSMConfig(d_state=64, expand=2, head_dim=64, conv_width=4,
                  chunk_size=256, n_groups=1),
    hybrid=HybridConfig(attn_period=6),
    subquadratic=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke", family="hybrid", n_layers=5, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
        ssm=SSMConfig(d_state=16, expand=2, head_dim=16, conv_width=4,
                      chunk_size=8, n_groups=1),
        hybrid=HybridConfig(attn_period=2), subquadratic=True, remat=False)
