"""Stage-2 binary heads.

The port of the heads in wav2vec_contr_loss_tpu/models/heads.py. Both
return one raw logit per clip (higher == more bonafide-like). The MLP
head drops units after its ReLU in train mode only, drawing its mask
from the `torch.Generator` passed to `forward` (the JAX head draws from
its 'dropout' rng); in eval mode it ignores the dropout.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["LinearBinaryHead", "SmallMLPBinaryHead", "build_head"]


class LinearBinaryHead(nn.Module):
    def __init__(self, in_dim: int):
        super().__init__()
        self.fc = nn.Linear(in_dim, 1)

    def forward(self, x: torch.Tensor,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.fc(x)[..., 0]


class SmallMLPBinaryHead(nn.Module):
    def __init__(self, in_dim: int, hidden: int = 128, dropout: float = 0.2):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden)
        self.fc2 = nn.Linear(hidden, 1)
        self.dropout = dropout

    def forward(self, x: torch.Tensor,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        h = F.relu(self.fc1(x))
        if self.training and self.dropout > 0.0:
            if gen is None:
                raise ValueError("the MLP head's train-mode dropout draws "
                                 "from an explicit generator: pass gen")
            keep = torch.rand(h.shape, generator=gen, device=gen.device)
            h = torch.where(keep.to(h.device) >= self.dropout,
                            h / (1.0 - self.dropout), 0.0)
        return self.fc2(h)[..., 0]


def build_head(head_type: str, in_dim: int, hidden: int = 128,
               dropout: float = 0.2) -> nn.Module:
    """Keyed as the JAX `build_head`: 'linear' | 'mlp'."""
    if head_type == "linear":
        return LinearBinaryHead(in_dim)
    if head_type == "mlp":
        return SmallMLPBinaryHead(in_dim, hidden, dropout)
    raise ValueError(f"Unknown head type: {head_type}")
