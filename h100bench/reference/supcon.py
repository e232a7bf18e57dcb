"""Plain PyTorch binary SupCon with alpha-blended top-K hard-negative
mining (cosine similarity, no uniformity term), differentiated by
autograd:

  loss = (1 - alpha) * SupCon_full + alpha * SupCon_minedTopK

Anchors with no positive contribute nothing; mined terms need a
positive and a negative; with no mined term the mined loss is the full
loss; a batch where no anchor has a positive gives 0.
"""

from __future__ import annotations

import torch

_NEG = -1e30


def _masked_lse(logits, mask):
    masked = torch.where(mask, logits, _NEG)
    row_max = masked.max(dim=-1, keepdim=True).values.detach().clamp_min(_NEG)
    sums = torch.where(mask, torch.exp(logits - row_max), 0.0).sum(-1)
    return row_max[:, 0] + torch.log(sums.clamp_min(1e-38))


def supcon_binary(z: torch.Tensor, labels: torch.Tensor, alpha: float,
                  temperature: float, topk: int) -> torch.Tensor:
    b = z.shape[0]
    eye = torch.eye(b, dtype=torch.bool, device=z.device)
    logits = torch.where(eye, _NEG, (z @ z.T) / temperature)
    same = labels[:, None] == labels[None, :]
    pos, neg = same & ~eye, ~same & ~eye
    n_pos = pos.sum(-1)
    has_pos, has_neg = n_pos > 0, neg.sum(-1) > 0
    mean_pos = torch.where(pos, logits, 0.0).sum(-1) / n_pos.clamp_min(1)
    num_full = has_pos.sum()
    full = (torch.where(has_pos, _masked_lse(logits, ~eye) - mean_pos,
                        0.0).sum() / num_full.clamp_min(1))
    k = min(topk, b - 1)
    top = torch.topk(torch.where(neg, logits, _NEG), k, dim=-1).values
    comb = torch.cat([torch.where(pos, logits, _NEG), top], dim=-1)
    valid = has_pos & has_neg
    num_mined = valid.sum()
    mined = (torch.where(valid, _masked_lse(comb, comb > _NEG / 2)
                         - mean_pos, 0.0).sum() / num_mined.clamp_min(1))
    mined = torch.where(num_mined > 0, mined, full)
    main = (1.0 - alpha) * full + alpha * mined
    return torch.where(num_full > 0, main, torch.zeros_like(main))
