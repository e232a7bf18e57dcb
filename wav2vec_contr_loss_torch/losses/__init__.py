"""Losses of the port, in plain PyTorch with autograd."""

from .supcon import pairwise_similarity, supcon_binary_loss, uniformity_loss

__all__ = ["pairwise_similarity", "supcon_binary_loss", "uniformity_loss"]
