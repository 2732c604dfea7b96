"""Production mesh definitions (port of `repro.launch.mesh`).

Functions, not module-level constants: importing this module touches no
process group. Each builds its `DeviceMesh` only when the world size
matches the mesh and raises, naming the world size it needs, otherwise.
"""
from __future__ import annotations

from ..runtime.elastic import make_mesh


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16x16 = 256 devices; multi-pod adds a leading pod=2 axis (512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_debug_mesh(data: int = 2, model: int = 4, device=None):
    """Small mesh for the multi-rank tests (data x model ranks)."""
    return make_mesh((data, model), ("data", "model"), device)
