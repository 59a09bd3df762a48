"""The device rule of the port's entry points: they run on the card
(``"cuda"``) unless the caller names another device, and a CUDA device
that is not there raises — nothing falls back to the CPU. Also the
full-f32 matmul context the consistency transform and the k-mer
similarity product use (the JAX package's HIGHEST precision)."""

from __future__ import annotations

import contextlib

import torch

DEFAULT_DEVICE = "cuda"


def require_device(device=DEFAULT_DEVICE) -> torch.device:
    """``torch.device(device)``, or RuntimeError for a CUDA device on a
    machine that has none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but no CUDA device is available")
    return dev


@contextlib.contextmanager
def full_f32_matmul():
    """Run CUDA float32 matrix products without TF32 (restored after)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
