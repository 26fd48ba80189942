"""Device selection and synchronisation for the port's entry points."""
from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """``device`` as a torch.device; raises for a CUDA device when no card is
    present (entry points default to ``"cuda"``; CPU runs ask for it)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (the CPU runs eagerly)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
