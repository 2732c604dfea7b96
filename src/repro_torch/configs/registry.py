"""Architecture registry: `--arch <id>` resolution (port of
`repro.configs.registry`): the same ten architectures, each a pure-Python
copy of the JAX package's config module.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from .base import ModelConfig

_MODULES: Dict[str, str] = {
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1_6b",
    "starcoder2-3b": "repro_torch.configs.starcoder2_3b",
    "qwen3-1.7b": "repro_torch.configs.qwen3_1_7b",
    "qwen1.5-4b": "repro_torch.configs.qwen1_5_4b",
    "deepseek-7b": "repro_torch.configs.deepseek_7b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "pixtral-12b": "repro_torch.configs.pixtral_12b",
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
}


def list_archs() -> List[str]:
    return list(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list_archs()}")
    return importlib.import_module(_MODULES[arch])


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


def cut_depth(cfg: ModelConfig, layers: int) -> ModelConfig:
    """`cfg` cut to its first `layers` layers, every width kept (a cut
    that one card's memory forces); an MoE model keeps at least one MoE
    layer after its leading dense ones."""
    if layers >= cfg.n_layers:
        return cfg
    cfg = dataclasses.replace(cfg, n_layers=layers)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_dense_layers=min(cfg.moe.n_dense_layers, layers - 1)))
    return cfg
