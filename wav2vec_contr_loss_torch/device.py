"""The device an entry point of the port runs on."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device) -> torch.device:
    """torch.device(device), refusing 'cuda' when no GPU is present: the
    port runs on the GPU unless the caller passes device='cpu'."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; the port runs on "
                           "the GPU unless device='cpu' is passed")
    return dev
