"""whisper-large-v3 [audio]: encoder-decoder; conv frontend STUB.

32L d_model=1280 20H (GQA kv=20) d_ff=5120 vocab=51866 [arXiv:2212.04356;
unverified]. 32 encoder + 32 decoder layers. input_specs() provides
precomputed log-mel frame embeddings (the conv1d frontend is stubbed per the
brief); decode shapes exercise the DECODER with a self-attn KV cache +
precomputed encoder memory.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    norm="ln",
    mlp="gelu",
    is_encdec=True,
    max_source_positions=1500,
    frontend="audio_frames",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", family="audio", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256, norm="ln",
        mlp="gelu", is_encdec=True, max_source_positions=16,
        frontend="audio_frames", remat=False)
