"""Hierarchical decision-making (paper sections 3.1.2, 3.3), port of
`repro.core.hierarchy`.

The paper implements thread/warp/block "majority-rules" voting with CUDA
``ballot`` + ``popcount``. Here the vote is a masked reduction over the
decision group, on whatever device the mask lives.

Semantics (paper): when the majority of a group's elements meet the
activation criteria, the ENTIRE group approximates; otherwise ALL elements
take the accurate path. Majority is strict, so a tie goes to the accurate
path. A group vote can force elements whose own criteria were unmet to
approximate (paper section 4, LavaMD discussion).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .types import TILE_SHAPE, Level


def grouped_majority(mask: torch.Tensor, group_size: int,
                     dim: int = -1) -> torch.Tensor:
    """Majority-rules vote within contiguous groups of `group_size` along
    `dim`: every element carries its group's decision. `group_size` must
    divide the axis length."""
    dim = dim % mask.ndim
    n = mask.shape[dim]
    if group_size <= 1:
        return mask
    if n % group_size != 0:
        raise ValueError(
            f"group_size {group_size} must divide axis length {n}")
    new_shape = (mask.shape[:dim] + (n // group_size, group_size)
                 + mask.shape[dim + 1:])
    grouped = mask.reshape(new_shape)
    votes = grouped.sum(dim=dim + 1, keepdim=True)  # ballot + popcount
    decision = votes * 2 > group_size
    return decision.expand(new_shape).reshape(mask.shape)


def block_majority(mask: torch.Tensor) -> torch.Tensor:
    """Whole-mask (block/team-level) vote: a 0-d bool tensor on the mask's
    device. Reading it on the host is what lets a caller skip the accurate
    path for real."""
    return mask.sum() * 2 > mask.numel()


def vote(mask: torch.Tensor, level: Level,
         tile_size: Optional[int] = None) -> torch.Tensor:
    """Apply the hierarchy vote for `level` to a per-element mask.

    ELEMENT: identity (paper: per-thread decisions).
    TILE:    contiguous groups of `tile_size` elements of the flattened
             mask, default 128 (`TILE_SHAPE[1]`, the JAX package's default,
             so one spec gives one result in both packages; on the GPU that
             is four warps). `tile_size=32` is the paper's 32-thread warp
             vote. A size the tile does not divide is padded with False
             (accurate) votes, so stragglers bias to accuracy.
    BLOCK:   one decision for the whole mask, broadcast back.
    """
    if level == Level.ELEMENT:
        return mask
    if level == Level.TILE:
        ts = tile_size or TILE_SHAPE[1]
        flat = mask.reshape(-1)
        pad = (-flat.numel()) % ts
        if pad:
            flat = torch.cat([flat, torch.zeros(pad, dtype=torch.bool,
                                                device=mask.device)])
            return grouped_majority(flat, ts)[:mask.numel()].reshape(
                mask.shape)
        return grouped_majority(flat, ts).reshape(mask.shape)
    if level == Level.BLOCK:
        return block_majority(mask).expand(mask.shape)
    raise ValueError(f"unknown level: {level}")


def fraction(mask: torch.Tensor) -> torch.Tensor:
    """The share of True in `mask` as a 0-d float32 tensor: the exact count
    times float32(1/n), the way XLA computes `jnp.mean` of a float32 mask,
    so both packages report the same float for the same mask."""
    return mask.sum(dtype=torch.float32) * (1.0 / max(mask.numel(), 1))


def tile_vote_2d(mask: torch.Tensor,
                 tile_shape: Tuple[int, int] = TILE_SHAPE) -> torch.Tensor:
    """2-D tile vote over the last two axes, one decision per
    (rows, cols) = `tile_shape` tile."""
    th, tw = tile_shape
    h, w = mask.shape[-2], mask.shape[-1]
    if h % th or w % tw:
        raise ValueError(f"mask {tuple(mask.shape)} not divisible by tile "
                         f"{tile_shape}")
    lead = mask.shape[:-2]
    g = mask.reshape(lead + (h // th, th, w // tw, tw))
    votes = g.sum(dim=(-3, -1), keepdim=True)
    decision = votes * 2 > (th * tw)
    return decision.expand(g.shape).reshape(mask.shape)
