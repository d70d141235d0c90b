"""Device resolution: ``None`` means the GPU, and a missing GPU is an error."""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "check_on_device"]


def resolve_device(device=None) -> torch.device:
    """Map an entry point's ``device`` argument to a concrete ``torch.device``.

    ``None`` selects the current CUDA device and raises ``RuntimeError`` when
    there is none; it never degrades to the CPU. The CPU is used only when it
    is asked for by name (``device="cpu"``), as the unit tests do.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' explicitly to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def check_on_device(device: torch.device, **tensors) -> None:
    """Raise if any given tensor does not live on ``device``."""
    for name, x in tensors.items():
        if not isinstance(x, torch.Tensor):
            continue
        if x.device.type != device.type or (
                device.type == "cuda" and x.device.index != device.index):
            raise ValueError(f"{name} lives on {x.device}, expected {device}")
