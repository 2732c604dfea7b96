"""Dense FFN (gated-SiLU / GELU) with herded d_ff-block perforation
through an ApproxSpec (port of `repro.models.mlp`).

Herded FFN perforation drops hidden-dim blocks structurally (columns of
W1 / W3 and rows of W2 gathered to the kept blocks), saving real FLOPs.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.perforation import kept_indices
from ..core.types import ApproxSpec, PerforationParams, Technique
from . import common

FF_BLOCK = 128    # herded d_ff-perforation block


def init_params(generator: torch.Generator, d_model: int, d_ff: int,
                kind: str, dtype, device=None) -> Dict:
    def dense(shape):
        return common.dense_init(generator, shape, dtype=dtype, device=device)

    if kind == "gated_silu":
        return {"w_gate": dense((d_model, d_ff)), "w_up": dense((d_model, d_ff)),
                "w_down": dense((d_ff, d_model))}
    return {"w_up": dense((d_model, d_ff)), "w_down": dense((d_ff, d_model))}


@functools.lru_cache(maxsize=64)
def _keep_idx_cached(d_ff: int, params: PerforationParams,
                     device: torch.device) -> Optional[torch.Tensor]:
    nb = max(d_ff // FF_BLOCK, 1)
    kept = kept_indices(nb, params)
    if len(kept) == nb:
        return None
    idx = np.concatenate([np.arange(b * FF_BLOCK, min((b + 1) * FF_BLOCK,
                                                      d_ff))
                          for b in kept])
    return torch.as_tensor(idx, device=device)


def _keep_idx(d_ff: int, spec: Optional[ApproxSpec], device):
    """Kept hidden units under a PERFORATION spec (None: all of them),
    built once per width and spec."""
    if spec is None or spec.technique != Technique.PERFORATION:
        return None
    return _keep_idx_cached(d_ff, spec.perforation, torch.device(device))


def forward(p: Dict, cfg: ModelConfig, x: torch.Tensor, kind: str,
            approx: Optional[ApproxSpec] = None) -> torch.Tensor:
    """x: (B, S, d). Perforation (herded) shrinks the hidden dim blocks."""
    idx = _keep_idx(p["w_down"].shape[0], approx, x.device)
    if kind == "gated_silu":
        wg, wu, wd = p["w_gate"], p["w_up"], p["w_down"]
        if idx is not None:
            wg, wu = wg.index_select(1, idx), wu.index_select(1, idx)
            wd = wd.index_select(0, idx)
        h = torch.nn.functional.silu(x @ wg) * (x @ wu)
        return h @ wd
    wu, wd = p["w_up"], p["w_down"]
    if idx is not None:
        wu, wd = wu.index_select(1, idx), wd.index_select(0, idx)
    return torch.nn.functional.gelu(x @ wu, approximate="tanh") @ wd
