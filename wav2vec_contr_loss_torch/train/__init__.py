"""Stage-1 training: the SupCon finetune step and epoch loop, its
optimizer, the alpha schedule and checkpoints."""

from .optim import build_optimizer, resolve_grad_bf16
from .schedule import alpha_for_epoch
from .stage1 import Stage1Trainer

__all__ = ["Stage1Trainer", "alpha_for_epoch", "build_optimizer",
           "resolve_grad_bf16"]
