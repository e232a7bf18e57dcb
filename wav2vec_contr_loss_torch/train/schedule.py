"""Hard-negative-mining alpha schedule, the port's copy of
wav2vec_contr_loss_tpu/train/schedule.py.

alpha(epoch) = 0 during warmup, then a linear ramp to alpha_end over
alpha_ramp_epochs.
"""

from __future__ import annotations

__all__ = ["alpha_for_epoch"]


def alpha_for_epoch(epoch: int, warmup_epochs: int, alpha_ramp_epochs: int,
                    alpha_end: float) -> float:
    if epoch <= warmup_epochs:
        return 0.0
    t = min(1.0, (epoch - warmup_epochs) / max(1, alpha_ramp_epochs))
    return t * alpha_end
