"""PyTorch / CUDA port of wav2vec_contr_loss_tpu for an NVIDIA H100.

It serves (`SpoofScorer`, also from a stage-1 and a stage-2
checkpoint), runs the stage-1 SupCon recipe (`Stage1Trainer`: the train
step with device RawBoost, `fit` with checkpoints and resume, fed by the
host data pipeline in `data/`) and the inference half of the main path
(`Stage1Trainer.embed_dataset` and `eval/extract.py`, the stage-2 head
trainer in `train/stage2.py`, score files and EER in `eval/`), the
end-to-end BCE baseline (`BaselineTrainer`) and stage 1 from
precomputed encoder features (`Stage1Trainer.fit_from_features`), with the
CLIs under `cli/` up to `python -m
wav2vec_contr_loss_torch.cli.run_pipeline`. It imports
torch, numpy and scipy (and triton, inside the Triton kernels' launch
functions), never JAX or the JAX package. Entry points run on the GPU
unless the caller passes device="cpu"; on CPU tensors every kernel
wrapper takes its plain PyTorch version.
"""

from .bridge import jax_params_to_torch
from .config import (LARGE_960H, XLSR_300M, BaselineConfig, Stage1Config,
                     Stage2Config,
                     SupConConfig, Wav2Vec2Config, config_from_dict,
                     feature_frame_length)
from .eval.serving import SpoofScorer, window_waveform
from .train import BaselineTrainer, Stage1Trainer, alpha_for_epoch

__all__ = ["jax_params_to_torch", "LARGE_960H", "XLSR_300M", "BaselineConfig",
           "BaselineTrainer", "Stage1Config",
           "Stage2Config", "SupConConfig", "Wav2Vec2Config",
           "config_from_dict", "feature_frame_length", "SpoofScorer",
           "window_waveform", "Stage1Trainer", "alpha_for_epoch"]
