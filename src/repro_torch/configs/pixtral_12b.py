"""pixtral-12b [vlm]: pixtral-ViT frontend (STUB) + mistral-nemo backbone.

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072
[hf:mistralai/Pixtral-12B-2409; unverified]. Per the brief the ViT frontend
is a stub: input_specs() provides precomputed patch embeddings that are
prefixed to the text embeddings; seq_len = n_patch_tokens + text tokens.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    head_dim=128,
    rope_theta=1e6,
    frontend="vision_patches",
    n_patch_tokens=256,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-smoke", family="vlm", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=32,
        frontend="vision_patches", n_patch_tokens=8, remat=False)
