"""Stage-2 binary heads, in eval mode.

The port of the heads in wav2vec_contr_loss_tpu/models/heads.py. Both
return one raw logit per clip (higher == more bonafide-like). Dropout
belongs to training and is not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["LinearBinaryHead", "SmallMLPBinaryHead", "build_head"]


class LinearBinaryHead(nn.Module):
    def __init__(self, in_dim: int):
        super().__init__()
        self.fc = nn.Linear(in_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(x)[..., 0]


class SmallMLPBinaryHead(nn.Module):
    def __init__(self, in_dim: int, hidden: int = 128):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden)
        self.fc2 = nn.Linear(hidden, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.relu(self.fc1(x)))[..., 0]


def build_head(head_type: str, in_dim: int, hidden: int = 128) -> nn.Module:
    """Keyed as the JAX `build_head`: 'linear' | 'mlp'."""
    if head_type == "linear":
        return LinearBinaryHead(in_dim)
    if head_type == "mlp":
        return SmallMLPBinaryHead(in_dim, hidden)
    raise ValueError(f"Unknown head type: {head_type}")
