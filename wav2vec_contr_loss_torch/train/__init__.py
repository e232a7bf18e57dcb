"""Training: the stage-1 SupCon finetune step and epoch loop, its
optimizer, the alpha schedule and checkpoints, the stage-2 head trainer
over extracted embeddings, and the end-to-end BCE baseline."""

from .baseline import BaselineTrainer
from .optim import build_optimizer, resolve_grad_bf16
from .schedule import alpha_for_epoch
from .stage1 import Stage1Trainer
from .stage2 import stage2_scores, train_stage2

__all__ = ["BaselineTrainer", "Stage1Trainer", "alpha_for_epoch", "build_optimizer",
           "resolve_grad_bf16", "stage2_scores", "train_stage2"]
