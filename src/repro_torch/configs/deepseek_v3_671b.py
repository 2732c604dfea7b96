"""deepseek-v3-671b [moe]: MLA + 1 shared + 256 routed top-8 + MTP.

61L d_model=7168 128H d_ff=2048(expert) vocab=129280 [arXiv:2412.19437; hf].
First 3 layers dense (d_ff 18432). MLA latent cache: kv_lora 512 + rope 64.
bf16 params + FSDP over the data axis (671B params do not fit TP-only).
"""
from .base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=2048,
    vocab_size=129280,
    use_mla=True,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=256, experts_per_token=8, d_ff_expert=2048,
                  n_shared_experts=1, n_dense_layers=3, d_ff_dense=18432,
                  capacity_factor=1.25, router_group_size=512),
    mtp=True,
    param_dtype="bfloat16",
    fsdp=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="dsv3-smoke", family="moe", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=64, vocab_size=256, use_mla=True,
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16),
        moe=MoEConfig(n_experts=8, experts_per_token=2, d_ff_expert=64,
                      n_shared_experts=1, n_dense_layers=1, d_ff_dense=128,
                      router_group_size=64),
        mtp=True, remat=False)
