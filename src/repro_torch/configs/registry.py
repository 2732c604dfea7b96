"""Architecture registry: `--arch <id>` resolution (port of
`repro.configs.registry`).

The port carries the dense family only: `qwen3-1.7b` and `deepseek-7b`.
The JAX registry's other architectures (MoE, MLA, hybrid, RWKV, VLM,
audio) come with the model zoo; asking for one raises an error that says
so.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from .base import ModelConfig

_MODULES: Dict[str, str] = {
    "qwen3-1.7b": "repro_torch.configs.qwen3_1_7b",
    "deepseek-7b": "repro_torch.configs.deepseek_7b",
}

# the JAX registry's architectures that the port does not carry yet
NOT_PORTED = ("zamba2-7b", "rwkv6-1.6b", "starcoder2-3b", "qwen1.5-4b",
              "deepseek-v3-671b", "olmoe-1b-7b", "pixtral-12b",
              "whisper-large-v3")
ZOO_ITEM = "ROADMAP Queue 1 item 6 (model zoo and training)"


def list_archs() -> List[str]:
    return list(_MODULES)


def _module(arch: str):
    if arch in NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet ({ZOO_ITEM}); the port "
            f"carries {list_archs()}")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list_archs()}")
    return importlib.import_module(_MODULES[arch])


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()
