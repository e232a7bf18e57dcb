"""Architecture configuration of the PyTorch port.

The port keeps its own copy of the architecture fields of the JAX
package's `Wav2Vec2Config` (wav2vec_contr_loss_tpu/models/wav2vec2.py)
and of the head fields of its `Stage2Config`
(wav2vec_contr_loss_tpu/config.py), so that it never imports the JAX
package. TPU execution knobs (scan/remat/pipeline/sequence parallelism,
int8 quantization, kernel selection) have no counterpart here: the port
picks a kernel from the device a tensor lives on.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import torch

__all__ = ["Wav2Vec2Config", "Stage2Config", "XLSR_300M", "LARGE_960H",
           "feature_frame_length", "config_from_dict"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class Wav2Vec2Config:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = True
    feat_extract_norm: str = "layer"     # 'layer' (lv60/XLS-R) | 'group'
    do_stable_layer_norm: bool = True    # pre-LN (lv60/XLS-R) vs post-LN
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.0
    feat_proj_dropout: float = 0.1
    apply_spec_augment: bool = True
    mask_time_prob: float = 0.075
    mask_time_length: int = 10
    mask_time_min_masks: int = 2
    dtype: str = "bfloat16"              # compute dtype; params stay fp32

    def with_(self, **kw) -> "Wav2Vec2Config":
        return dataclasses.replace(self, **kw)

    @property
    def num_hidden_states(self) -> int:
        return self.num_layers + 1

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


@dataclass(frozen=True)
class Stage2Config:
    """The head fields of the JAX package's stage-2 config."""

    head_type: str = "linear"   # 'linear' | 'mlp'
    in_dim: int = 256           # = the compression module's output width
    hidden_dim: int = 128
    dropout: float = 0.2


# facebook/wav2vec2-xls-r-300m
XLSR_300M = Wav2Vec2Config()
# facebook/wav2vec2-large-960h, the older post-LN variant
LARGE_960H = Wav2Vec2Config(
    conv_bias=False, feat_extract_norm="group", do_stable_layer_norm=False,
    mask_time_prob=0.05,
)


def feature_frame_length(num_samples, config: Wav2Vec2Config):
    """Waveform samples -> encoder frames through the conv stride chain
    (80,000 samples -> 249 frames for the default config). Takes an int
    or an integer tensor of per-clip lengths."""
    n = num_samples
    for k, s in zip(config.conv_kernel, config.conv_stride):
        n = (n - k) // s + 1
    return n


def config_from_dict(d: dict) -> Wav2Vec2Config:
    """Read the JSON architecture dict that the JAX package writes beside
    its checkpoints (`config_to_dict`). Keys this config does not have,
    such as the TPU execution knobs, are ignored."""
    names = {f.name for f in dataclasses.fields(Wav2Vec2Config)}
    kw = {k: v for k, v in d.items() if k in names}
    for k in ("conv_dim", "conv_kernel", "conv_stride"):
        if k in kw:
            kw[k] = tuple(kw[k])
    if "dtype" in kw and kw["dtype"] not in _DTYPES:
        raise ValueError(f"unsupported compute dtype {kw['dtype']!r}; "
                         f"expected one of {sorted(_DTYPES)}")
    return Wav2Vec2Config(**kw)
