"""Supervised-contrastive losses, in plain PyTorch with autograd.

The port of wav2vec_contr_loss_tpu/losses/supcon.py (`pairwise_similarity`
:61, `uniformity_loss` :90, `supcon_binary_loss` :112,
`supcon_multiclass_loss` :189). The binary loss is also the plain
version of the fused CUDA kernel in ops/supcon.py, which computes the
same loss and its gradient in one launch. The multiclass loss is plain
XLA in the JAX package, with no Pallas kernel, and plain PyTorch here.
Everything runs in fp32.

Edge rules, as in the JAX package:
  * anchors with no positives contribute nothing,
  * mined terms need >= 1 positive and >= 1 negative,
  * if no anchor has a mined term, the mined loss falls back to the full
    loss,
  * a batch where no anchor has a positive yields 0,
  * geodesic similarity = 2 * (1 - arccos(clamp(dot)) / pi) - 1,
  * uniformity = log(mean_{i<j} exp(-t * ||zi - zj||^2) + 1e-8).
"""

from __future__ import annotations

import math

import torch

from ..config import SupConConfig

__all__ = ["pairwise_similarity", "uniformity_loss", "supcon_binary_loss",
           "supcon_multiclass_loss"]

# large-negative stand-in for -inf: keeps every logsumexp finite
_NEG = -1e30


def pairwise_similarity(z: torch.Tensor,
                        similarity: str = "cosine") -> torch.Tensor:
    """(B, D) L2-normalized embeddings -> (B, B) similarity in [-1, 1]."""
    z = z.float()
    dot = z @ z.T
    if similarity == "cosine":
        return dot
    eps = 1e-7
    theta = torch.arccos(dot.clamp(-1.0 + eps, 1.0 - eps))
    return 2.0 * (1.0 - theta / math.pi) - 1.0


def _masked_logsumexp(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Row-wise logsumexp over masked entries; rows with nothing selected
    give _NEG-ish values, never NaN."""
    masked = torch.where(mask, logits, _NEG)
    row_max = masked.max(dim=-1, keepdim=True).values.detach()
    row_max = row_max.clamp_min(-1e30)
    sums = torch.where(mask, torch.exp(logits - row_max), 0.0).sum(-1)
    return row_max[:, 0] + torch.log(sums.clamp_min(1e-38))


def uniformity_loss(z: torch.Tensor, t: float = 2.0) -> torch.Tensor:
    """Wang & Isola uniformity on the hypersphere:
    log(mean_{i<j} exp(-t * ||z_i - z_j||^2) + 1e-8)."""
    z = z.float()
    b = z.shape[0]
    if b < 2:
        return z.new_zeros(())
    sq = (z * z).sum(-1)
    sqd = (sq[:, None] + sq[None, :] - 2.0 * (z @ z.T)).clamp_min(0.0)
    upper = torch.triu(torch.ones(b, b, dtype=torch.bool, device=z.device),
                       diagonal=1)
    n_pairs = b * (b - 1) // 2
    mean_exp = torch.where(upper, torch.exp(-t * sqd), 0.0).sum() / n_pairs
    return torch.log(mean_exp + 1e-8)


def supcon_binary_loss(z: torch.Tensor, labels: torch.Tensor, alpha,
                       config: SupConConfig = SupConConfig()) -> torch.Tensor:
    """Binary SupCon with alpha-blended top-K hard-negative mining and an
    optional uniformity term:

      main = (1 - alpha) * SupCon_full + alpha * SupCon_minedTopK
      total = main + lambda_uni * L_uni(z)

    z: (B, D) L2-normalized; labels: (B,) ints; alpha: float or scalar
    tensor. Differentiable in z and alpha."""
    z = z.float()
    b = z.shape[0]
    labels = labels.reshape(-1).to(z.device)

    sim = pairwise_similarity(z, config.similarity)
    eye = torch.eye(b, dtype=torch.bool, device=z.device)
    logits = torch.where(eye, _NEG, sim / config.temperature)

    same = labels[:, None] == labels[None, :]
    pos_mask = same & ~eye
    neg_mask = ~same & ~eye
    n_pos = pos_mask.sum(-1)
    has_pos = n_pos > 0
    has_neg = neg_mask.sum(-1) > 0

    mean_pos = (torch.where(pos_mask, logits, 0.0).sum(-1)
                / n_pos.clamp_min(1))

    lse_all = _masked_logsumexp(logits, ~eye)
    num_full = has_pos.sum()
    loss_full = (torch.where(has_pos, lse_all - mean_pos, 0.0).sum()
                 / num_full.clamp_min(1))

    if b >= 2:
        k = min(config.topk_neg, b - 1)
        neg_logits = torch.where(neg_mask, logits, _NEG)
        topk_vals = torch.topk(neg_logits, k, dim=-1).values   # pads: _NEG
        combined = torch.cat([torch.where(pos_mask, logits, _NEG), topk_vals],
                             dim=-1)
        lse_mined = _masked_logsumexp(combined, combined > _NEG / 2)
        valid_mined = has_pos & has_neg
        num_mined = valid_mined.sum()
        loss_mined_avg = (torch.where(valid_mined, lse_mined - mean_pos,
                                      0.0).sum() / num_mined.clamp_min(1))
        loss_mined = torch.where(num_mined > 0, loss_mined_avg, loss_full)
    else:
        loss_mined = loss_full

    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=z.device)
    main = (1.0 - alpha) * loss_full + alpha * loss_mined
    main = torch.where(num_full > 0, main, 0.0)
    if config.uniformity_weight > 0.0 and b > 1:
        main = main + config.uniformity_weight * uniformity_loss(
            z, config.uniformity_t)
    return main


def supcon_multiclass_loss(z: torch.Tensor, labels: torch.Tensor,
                           temperature: float = 0.1) -> torch.Tensor:
    """Khosla-style multi-class SupCon over attack-id classes (bonafide =
    0), cosine only: per anchor, the log-sum-exp over every other row
    minus the mean logit of its positives, averaged over the anchors that
    have a positive; 0 when none has. The Gram is an fp32 product (the
    JAX function asks for HIGHEST precision; torch's fp32 matmul runs
    without TF32 unless a caller turns it on)."""
    z = z.float()
    b = z.shape[0]
    labels = labels.reshape(-1)
    eye = torch.eye(b, dtype=torch.bool, device=z.device)
    logits = torch.where(eye, _NEG, (z @ z.T) / temperature)
    pos_mask = (labels[:, None] == labels[None, :]) & ~eye
    n_pos = pos_mask.sum(-1)
    has_pos = n_pos > 0
    mean_pos = (torch.where(pos_mask, logits, 0.0).sum(-1)
                / n_pos.clamp_min(1))
    loss_i = _masked_logsumexp(logits, ~eye) - mean_pos
    num = has_pos.sum()
    return torch.where(num > 0,
                       torch.where(has_pos, loss_i, 0.0).sum()
                       / num.clamp_min(1), 0.0)
