"""Compression module and clip pooling.

The port of wav2vec_contr_loss_tpu/models/compression.py: Dropout, then
LeakyReLU(0.01), then Linear(input_dim -> hidden_dim) per frame on the
encoder's fp32 layer-mean, and `clip_embedding` (time-mean, then L2
norm). In train mode the dropout is the port's murmur dropout with a seed
drawn from the caller's generator (the JAX module draws flax's threefry
bits, which cannot be reproduced, so only the rate carries over). In a
parallel gang the dropout mask is the global batch's, at the rank's
batch offset (its `shard`, parallel/collectives.py).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dropout import draw_seed, murmur_dropout
from ..parallel.collectives import SINGLE

__all__ = ["CompressionModule", "clip_embedding"]


class CompressionModule(nn.Module):
    shard = SINGLE

    def __init__(self, input_dim: int = 1024, hidden_dim: int = 256,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.proj = nn.Linear(input_dim, hidden_dim)

    def forward(self, layer_mean: torch.Tensor,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, T, input_dim) K-averaged encoder features -> (B, T, hidden),
        fp32. Train mode with a dropout rate needs `gen`."""
        x = layer_mean.float()
        if self.training and self.dropout_rate > 0.0:
            if gen is None:
                raise ValueError("train-mode dropout draws its seed from "
                                 "`gen`, a torch.Generator")
            x = murmur_dropout(x, draw_seed(gen), self.dropout_rate,
                               (self.shard.batch_offset(x.shape[0]), 0, 0))
        return self.proj(F.leaky_relu(x, 0.01))


def clip_embedding(seq: torch.Tensor, l2_normalize: bool = True) -> torch.Tensor:
    """(B, T, H) -> (B, H): plain mean over time, then L2 norm.

    The mean includes padded frames, as the JAX package and the reference
    do; score parity depends on it."""
    z = seq.float().mean(dim=1)
    if l2_normalize:
        z = z / z.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    return z
