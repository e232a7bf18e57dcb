"""Compression module and clip pooling, in eval mode.

The port of wav2vec_contr_loss_tpu/models/compression.py: LeakyReLU(0.01)
then Linear(input_dim -> hidden_dim) per frame on the encoder's fp32
layer-mean, and `clip_embedding` (time-mean, then L2 norm). Dropout
belongs to training and is not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["CompressionModule", "clip_embedding"]


class CompressionModule(nn.Module):
    def __init__(self, input_dim: int = 1024, hidden_dim: int = 256):
        super().__init__()
        self.proj = nn.Linear(input_dim, hidden_dim)

    def forward(self, layer_mean: torch.Tensor) -> torch.Tensor:
        """(B, T, input_dim) K-averaged encoder features -> (B, T, hidden),
        fp32."""
        return self.proj(F.leaky_relu(layer_mean.float(), 0.01))


def clip_embedding(seq: torch.Tensor, l2_normalize: bool = True) -> torch.Tensor:
    """(B, T, H) -> (B, H): plain mean over time, then L2 norm.

    The mean includes padded frames, as the JAX package and the reference
    do; score parity depends on it."""
    z = seq.float().mean(dim=1)
    if l2_normalize:
        z = z / z.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    return z
