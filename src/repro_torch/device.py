"""Device selection for the port's entry points.

The rule: an entry point runs on ``cuda`` unless its caller passes
``device="cpu"``. With no GPU and no explicit ``"cpu"`` it raises; it never
falls back on its own. This plays the role of the JAX package's
`kernels.ops.ON_TPU`, except that the choice is explicit per call instead
of read from the backend.

Kernel wrappers follow the tensors they are given: a CPU tensor takes the
kernel's plain PyTorch version, a CUDA tensor launches the kernel.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DEFAULT = "cuda"

DeviceLike = Union[str, torch.device, None]


def resolve(device: DeviceLike = None) -> torch.device:
    """`device` as a `torch.device`; None means ``cuda``. Raises when a CUDA
    device is asked for and none is available."""
    dev = torch.device(DEFAULT if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev


def name(device: Optional[torch.device]) -> str:
    """Human-readable name of the device results were measured on."""
    if device is not None and device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"
