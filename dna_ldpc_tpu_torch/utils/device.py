"""The device rule of the port's entry points: they run on the card
(``"cuda"``) unless the caller names another device, and a CUDA device
that is not there raises — nothing falls back to the CPU."""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def require_device(device=DEFAULT_DEVICE) -> torch.device:
    """``torch.device(device)``, or RuntimeError for a CUDA device on a
    machine that has none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but no CUDA device is available")
    return dev
