"""PyTorch / CUDA port of wav2vec_contr_loss_tpu for an NVIDIA H100.

It imports torch and numpy (and triton, inside the Triton kernel's launch
function), never JAX or the JAX package. Entry points run on the GPU
unless the caller passes device="cpu"; on CPU tensors every kernel
wrapper takes its plain PyTorch version.
"""

from .bridge import jax_params_to_torch
from .config import (LARGE_960H, XLSR_300M, Stage2Config, Wav2Vec2Config,
                     config_from_dict, feature_frame_length)
from .eval.serving import SpoofScorer, window_waveform

__all__ = ["jax_params_to_torch", "LARGE_960H", "XLSR_300M", "Stage2Config",
           "Wav2Vec2Config", "config_from_dict", "feature_frame_length",
           "SpoofScorer", "window_waveform"]
