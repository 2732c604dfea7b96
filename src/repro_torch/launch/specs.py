"""Shape stand-ins for every (arch x shape) cell (port of
`repro.launch.specs`): tensors on the ``meta`` device, so nothing is
allocated and nothing runs.

Shapes follow the JAX package: LM shapes are seq_len x global_batch;
decode cells take one new token against a seq_len cache; the vlm and the
audio model get their stubbed frontends' embeddings (bfloat16). The meta
tensors are built here directly (`device.resolve` takes cuda or cpu
only).
"""
from __future__ import annotations

import copy
from typing import Any, Dict, Tuple

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..models.lm import Model
from ..runtime import sharding as shardlib

META = torch.device("meta")


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    if cfg.frontend == "vision_patches":
        s_text = s - cfg.n_patch_tokens
        return {
            "tokens": _sds((b, s_text), torch.int32),
            "labels": _sds((b, s_text), torch.int32),
            "patch_embeds": _sds((b, cfg.n_patch_tokens, cfg.d_model),
                                 torch.bfloat16),
        }
    if cfg.frontend == "audio_frames":
        return {
            "tokens": _sds((b, s), torch.int32),
            "labels": _sds((b, s), torch.int32),
            "frames": _sds((b, cfg.max_source_positions, cfg.d_model),
                           torch.bfloat16),
        }
    return {"tokens": _sds((b, s), torch.int32),
            "labels": _sds((b, s), torch.int32)}


def prefill_batch_specs(cfg: ModelConfig,
                        shape: ShapeConfig) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    out: Dict[str, Any] = {}
    if cfg.frontend == "vision_patches":
        out["tokens"] = _sds((b, s - cfg.n_patch_tokens), torch.int32)
        out["patch_embeds"] = _sds((b, cfg.n_patch_tokens, cfg.d_model),
                                   torch.bfloat16)
    elif cfg.frontend == "audio_frames":
        out["tokens"] = _sds((b, s), torch.int32)
        out["frames"] = _sds((b, cfg.max_source_positions, cfg.d_model),
                             torch.bfloat16)
    else:
        out["tokens"] = _sds((b, s), torch.int32)
    return out


def decode_specs(model: Model, cfg: ModelConfig,
                 shape: ShapeConfig) -> Tuple[Any, Any]:
    """(the cache of one serve step, its tokens), on the meta device: the
    model's own `init_cache` run by a copy of it placed on meta."""
    b, s = shape.global_batch, shape.seq_len
    meta = copy.copy(model)
    meta.device = META
    return meta.init_cache(b, s), _sds((b,), torch.int32)


def batch_shardings(mesh, batch: Dict[str, Any]) -> Dict[str, Any]:
    """Each batch entry's spec on `mesh`: its leading dim over the data
    axes when it divides, else replicated (e.g. batch 1)."""
    da = shardlib.batch_spec(mesh)[0]
    size = shardlib.data_extent(mesh)

    def one(v):
        if v.shape[0] % size == 0:
            return (da,) + (None,) * (len(v.shape) - 1)
        return ()

    return {k: one(v) for k, v in batch.items()}
