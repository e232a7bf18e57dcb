"""Binary cross-entropy with logits, with optional positive-class weighting.

The port of wav2vec_contr_loss_tpu/losses/bce.py: the stable softplus
form in fp32, with an optional mask for zero-padded partial batches.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["bce_logits_loss", "pos_weight_from_labels"]


def bce_logits_loss(logits: torch.Tensor, labels: torch.Tensor,
                    pos_weight: Optional[float] = None,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mean_i [ w_p * y_i * softplus(-x_i) + (1 - y_i) * softplus(x_i) ]

    `pos_weight` is a float (the neg/pos class ratio). `mask` restricts
    the mean to the valid elements, so a zero-padded partial batch gives
    exactly the mean over its real elements."""
    x = logits.float().reshape(-1)
    y = labels.float().reshape(-1)
    w_p = 1.0 if pos_weight is None else float(pos_weight)
    per_example = w_p * y * F.softplus(-x) + (1.0 - y) * F.softplus(x)
    if mask is None:
        return per_example.mean()
    m = mask.float().reshape(-1)
    return (per_example * m).sum() / m.sum().clamp_min(1.0)


def pos_weight_from_labels(labels01) -> float:
    """neg/pos class ratio for imbalance correction; 1.0 if a class is
    empty."""
    labels01 = np.asarray(labels01).astype(np.int64).ravel()
    pos = int((labels01 == 1).sum())
    neg = int((labels01 == 0).sum())
    if pos == 0 or neg == 0:
        return 1.0
    return float(neg) / float(pos)
