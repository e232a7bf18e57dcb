"""The device an entry point of the port runs on, and full-fp32 cuDNN
convolutions on it."""

from __future__ import annotations

import contextlib

import torch

__all__ = ["resolve_device", "fp32_convs"]


def resolve_device(device) -> torch.device:
    """torch.device(device), refusing 'cuda' when no GPU is present: the
    port runs on the GPU unless the caller passes device='cpu'."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; the port runs on "
                           "the GPU unless device='cpu' is passed")
    return dev


@contextlib.contextmanager
def fp32_convs():
    """cuDNN convolutions in full fp32 (TF32 off) for the enclosed ops:
    PyTorch runs fp32 convolutions in TF32 by default
    (torch.backends.cudnn.allow_tf32), which keeps 10 mantissa bits. The
    process's setting is restored on exit, so bf16 users keep theirs."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev
