"""The port's models (port of `repro.models`): the causal LMs of every
family of the JAX registry -- dense / vlm / moe transformers with
decode-time TAF, the zamba2 hybrid, rwkv6 -- and the whisper
encoder-decoder."""
from . import (attention, blocks, common, lm, mamba2, mla, mlp, moe, rwkv6,
               whisper)
from .lm import Model, build

__all__ = ["attention", "blocks", "common", "lm", "mamba2", "mla", "mlp",
           "moe", "rwkv6", "whisper", "Model", "build"]
