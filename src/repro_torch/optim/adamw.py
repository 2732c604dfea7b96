"""AdamW over parameter trees with global-norm clipping (port of
`repro.optim.adamw`).

Moments live in float32 whatever the parameter dtype (bf16-parameter
models keep float32 optimizer state -- the standard mixed-precision
recipe). The arithmetic follows the JAX package's operation order: each
leaf's float32 sum of squares, their stacked sum and its square root;
`scale = min(1, max_norm / max(norm, 1e-12))`; `m = b1 m + (1 - b1) g`,
`v = b2 v + ((1 - b2) g) g`; `b1c = 1 - b1**step` in float32; `m / b1c`,
then `v / b2c`; `delta = mh / (sqrt(vh) + eps) + wd p`; and the new
parameter `(p_f32 - lr delta)` cast back to the parameter's dtype.

`update` works in place: parameters, moments and the step counter are
updated where they lie (under `torch.no_grad()`), the counterpart of the
JAX step donating its buffers. The step counter, the learning rate and
the bias corrections stay 0-d tensors on the parameters' device, so a step
reads nothing back to the host. The leaves go through `torch._foreach_*`
in groups of at most `GROUP_ELEMENTS` elements: a group's temporaries
(the clipped gradients, `(1 - b2) g g`, `mh`, `vh`, `wd p`) are freed
before the next group starts, and a step runs about 17 foreach calls a
group instead of about 17 kernels a leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Tuple

import torch

PyTree = Any

# leaves of one foreach group: bounds the update's temporaries (float32)
GROUP_ELEMENTS = 1 << 28


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32, 0-d
    m: PyTree
    v: PyTree


def leaves(tree: PyTree) -> List[torch.Tensor]:
    """The tensors of a tree of dicts and lists, in order (None skipped)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def tree_map(fn, tree: PyTree) -> PyTree:
    """`fn(leaf)` over a tree of dicts and lists (None stays None)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def aligned_leaves(tree: PyTree, like: PyTree) -> List[torch.Tensor]:
    """`tree`'s tensors in the order of `leaves(like)`, matched by key
    path (a dict is read by `like`'s keys, whatever its own order); a
    flat list of as many tensors as `like` has leaves is taken as it is."""
    if isinstance(tree, (list, tuple)) and not isinstance(like, (list, tuple)):
        out = list(tree)
        assert len(out) == len(leaves(like))
        return out
    if like is None:
        return []
    if isinstance(like, dict):
        return [t for k, v in like.items() for t in aligned_leaves(tree[k], v)]
    if isinstance(like, (list, tuple)):
        return [t for a, b in zip(tree, like) for t in aligned_leaves(a, b)]
    return [tree]


def init(params: PyTree) -> AdamWState:
    """Zero float32 moments shaped as `params`, step 0."""
    first = leaves(params)[0]
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        m=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params),
        v=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params))


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the sum of each leaf's float32 sum of squares."""
    sq = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    # a true division (`max_norm / t` is a reciprocal times max_norm)
    bound = torch.full_like(norm, max_norm)
    return torch.clamp(torch.div(bound, torch.clamp(norm, min=1e-12)),
                       max=1.0)


def clip_by_global_norm(grads: PyTree, max_norm: float
                        ) -> Tuple[PyTree, torch.Tensor]:
    """(grads as float32 times min(1, max_norm / norm), the norm)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), norm


def _groups(n_elements: List[int]):
    """Index ranges of consecutive leaves of at most GROUP_ELEMENTS
    elements together (a larger leaf is a group of its own)."""
    start, total = 0, 0
    for i, n in enumerate(n_elements):
        if i > start and total + n > GROUP_ELEMENTS:
            yield range(start, i)
            start, total = i, 0
        total += n
    if start < len(n_elements):
        yield range(start, len(n_elements))


@torch.no_grad()
def update(cfg: AdamWConfig, grads: PyTree, state: AdamWState,
           params: PyTree, lr_scale=1.0) -> Tuple[PyTree, AdamWState, dict]:
    """One AdamW step, in place. Returns (params, state, {"grad_norm"}):
    the same objects, updated. `grads` (a tree matched to `params` by key
    path, or a flat list in `leaves(params)` order) is read only."""
    p_all = leaves(params)
    g_all = aligned_leaves(grads, params)
    m_all, v_all = (aligned_leaves(state.m, params),
                    aligned_leaves(state.v, params))
    assert len(g_all) == len(p_all) == len(m_all) == len(v_all)
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    state.step.add_(1)
    step = state.step.float()
    b1c = 1.0 - torch.pow(torch.full_like(step, cfg.b1), step)
    b2c = 1.0 - torch.pow(torch.full_like(step, cfg.b2), step)
    lr = torch.as_tensor(lr_scale, dtype=torch.float32,
                         device=step.device) * cfg.lr
    for idx in _groups([p.numel() for p in p_all]):
        g = torch._foreach_mul([g_all[i].float() for i in idx], scale)
        m = [m_all[i] for i in idx]
        v = [v_all[i] for i in idx]
        p = [p_all[i] for i in idx]
        torch._foreach_mul_(v, cfg.b2)
        t = torch._foreach_mul(g, 1 - cfg.b2)
        torch._foreach_mul_(t, g)
        torch._foreach_add_(v, t)
        del t
        torch._foreach_mul_(m, cfg.b1)
        torch._foreach_mul_(g, 1 - cfg.b1)
        torch._foreach_add_(m, g)
        del g
        delta = torch._foreach_div(m, b1c)                  # mh
        vh = torch._foreach_div(v, b2c)
        torch._foreach_sqrt_(vh)
        torch._foreach_add_(vh, cfg.eps)
        torch._foreach_div_(delta, vh)
        del vh
        p32 = [x.float() for x in p]
        torch._foreach_add_(delta, torch._foreach_mul(p32, cfg.weight_decay))
        torch._foreach_mul_(delta, lr)
        if all(x.dtype == torch.float32 for x in p):
            torch._foreach_sub_(p, delta)
        else:
            for x, x32, d in zip(p, p32, delta):
                x.copy_(x32 - d)
    return params, state, {"grad_norm": gnorm}
