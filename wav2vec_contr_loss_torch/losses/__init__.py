"""Losses of the port, in plain PyTorch with autograd."""

from .bce import bce_logits_loss, pos_weight_from_labels
from .supcon import (pairwise_similarity, supcon_binary_loss,
                     supcon_multiclass_loss, uniformity_loss)

__all__ = ["bce_logits_loss", "pos_weight_from_labels", "pairwise_similarity",
           "supcon_binary_loss", "supcon_multiclass_loss",
           "uniformity_loss"]
