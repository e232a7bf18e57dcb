"""Architecture configuration of the PyTorch port.

The port keeps its own copy of the architecture fields of the JAX
package's `Wav2Vec2Config` (wav2vec_contr_loss_tpu/models/wav2vec2.py),
of its `Stage2Config`, `Stage1Config`, `BaselineConfig` and
`EXPERIMENT_PRESETS`
(wav2vec_contr_loss_tpu/config.py) and of its `SupConConfig`
(wav2vec_contr_loss_tpu/losses/supcon.py), so that it never imports the
JAX package. TPU execution knobs (scan/pipeline/sequence parallelism,
kernel selection) have no counterpart here: the port picks a kernel from
the device a tensor lives on. `quant` (int8 serving) is kept.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

__all__ = ["Wav2Vec2Config", "Stage1Config", "Stage2Config", "BaselineConfig",
           "SupConConfig",
           "XLSR_300M", "XLSR_2B", "LARGE_960H", "EXPERIMENT_PRESETS",
           "preset",
           "feature_frame_length", "config_from_dict", "run_tag"]

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
    # int8 transformer linears, serving only (ops/quant.py): 'none' |
    # 'w8a8' | 'w8'; the trainers keep 'none'
    quant: str = "none"

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
    """Stage-2 classifier over extracted embeddings: the fields of the
    JAX package's `Stage2Config`."""

    head_type: str = "linear"   # 'linear' | 'mlp'
    in_dim: int = 256           # = the compression module's output width
    hidden_dim: int = 128
    dropout: float = 0.2
    lr: float = 1e-4
    weight_decay: float = 1e-4
    epochs: int = 200
    batch_size: int = 64
    patience: int = 15
    seed: int = 1337

    def replace(self, **kw) -> "Stage2Config":
        return dataclasses.replace(self, **kw)

    def ckpt_config(self) -> Dict:
        """The reference's UPPERCASE reload dict of a stage-2 head."""
        return {
            "HEAD_TYPE": self.head_type,
            "IN_DIM": self.in_dim,
            "HIDDEN_DIM": self.hidden_dim,
            "DROPOUT": self.dropout,
            "LR": self.lr,
            "WEIGHT_DECAY": self.weight_decay,
            "BATCH_SIZE": self.batch_size,
            "PATIENCE": self.patience,
        }


def run_tag(model_name: str) -> str:
    """HF model id -> filesystem-safe run tag."""
    return model_name.replace("/", "__")


@dataclass(frozen=True)
class Stage1Config:
    """Stage-1 SupCon finetuning: the fields of the JAX package's
    `Stage1Config` that change values. The train step reads the model,
    loss, optimizer and RawBoost fields; `fit`, the data pipeline and the
    CLI read the clip length, `epochs`, `batch_size`, `num_samples`, the
    alpha ramp and `wire_dtype`; checkpoints record `model_name`.

    `param_sharding` ('replicated' | 'fsdp' | 'pp'),
    `pipeline_microbatches` and `sequence_parallel` say how a gang of
    several processes trains (parallel/mesh.py; the trainer's `mesh=`);
    the microbatch count is read by 'pp' alone, and sequence parallelism
    by a 'model' axis > 1 without 'pp'.

    Left out, because they only pick an XLA path or a TPU schedule:
    `attention_impl`, `conv_ln_impl`, `supcon_impl` (the port always runs
    its kernels, which compute what the 'pallas' settings compute),
    `softmax_dtype` (the attention kernels keep fp32 scores),
    `dropout_impl` (always the murmur hashes), `scan_unroll`,
    `attention_layout`, `remat_policy`, `fused_qkv` and
    `layer_mean_dtype`."""

    model_name: str = "facebook/wav2vec2-xls-r-300m"
    target_sample_rate: int = 16000
    max_duration_seconds: int = 5
    input_dim: int = 1024
    hidden_dim: int = 256
    dropout: float = 0.1

    epochs: int = 100
    batch_size: int = 32
    num_samples: Optional[int] = None
    head_lr: float = 5e-3
    enc_lr: float = 1e-5
    weight_decay: float = 3e-3
    seed: int = 1337
    finetune_encoder: bool = False
    grad_clip: float = 5.0              # on the head params only

    temperature: float = 0.2
    supcon_similarity: str = "cosine"   # 'cosine' | 'geodesic'
    uniformity_weight: float = 0.0
    uniformity_t: float = 2.0
    topk_neg: int = 15
    warmup_epochs: int = 100
    alpha_end: float = 1.0
    alpha_ramp_epochs: int = 80

    use_rawboost: bool = True
    rawboost_prob: float = 0.7
    rawboost_mode: str = "device"       # 'device' | 'host' | 'off'
    rawboost_fir_impl: str = "fft"
    rawboost_isd_mode: str = "exact"

    compute_dtype: str = "bfloat16"     # encoder compute; the loss is fp32
    wire_dtype: str = "float32"         # 'float32' | 'int16'
    remat_encoder: bool = True          # recompute encoder layers in bwd
    remat_conv: bool = False            # recompute the conv tower in bwd
    freeze_feature_extractor: bool = False
    adam_mu_dtype: str = "bfloat16"     # AdamW moment storage; math fp32
    adam_nu_dtype: str = "bfloat16"
    # 'auto' | 'float32' | 'bfloat16': under bf16 compute both give
    # bf16-rounded dW in fp32 leaves, as the JAX trainer does (optim.py)
    grad_dtype: str = "auto"
    # multi-process layouts (parallel/mesh.py)
    param_sharding: str = "replicated"  # 'replicated' | 'fsdp' | 'pp'
    pipeline_microbatches: int = 2      # GPipe, 'pp' only
    sequence_parallel: bool = False     # frames over 'model' (not 'pp')

    def replace(self, **kw) -> "Stage1Config":
        return dataclasses.replace(self, **kw)

    def ckpt_config(self) -> Dict:
        """The reference's UPPERCASE reload dict, as the JAX package
        writes it into checkpoint sidecars."""
        return {
            "MODEL_NAME": self.model_name,
            "RUN_TAG": run_tag(self.model_name),
            "INPUT_DIM": self.input_dim,
            "HIDDEN_DIM": self.hidden_dim,
            "DROPOUT": self.dropout,
            "BATCH_SIZE": self.batch_size,
            "HEAD_LR": self.head_lr,
            "ENC_LR": self.enc_lr,
            "WEIGHT_DECAY": self.weight_decay,
            "TEMPERATURE": self.temperature,
            "TOPK_NEG": self.topk_neg,
            "WARMUP_EPOCHS": self.warmup_epochs,
            "ALPHA_END": self.alpha_end,
            "ALPHA_RAMP_EPOCHS": self.alpha_ramp_epochs,
            "USE_RAWBOOST": self.use_rawboost,
            "RAWBOOST_PROB": self.rawboost_prob,
            "UNIFORMITY_WEIGHT": self.uniformity_weight,
            "UNIFORMITY_T": self.uniformity_t,
            "SUPCON_SIMILARITY": self.supcon_similarity,
            "FINETUNE_ENCODER": self.finetune_encoder,
        }

    def rawboost_params(self):
        """The RawBoostParams of this config (host and device forms)."""
        from .data.rawboost import RawBoostParams

        return RawBoostParams(
            sample_rate=self.target_sample_rate, prob=self.rawboost_prob,
            fir_impl=self.rawboost_fir_impl,
            isd_mode=self.rawboost_isd_mode)


@dataclass(frozen=True)
class BaselineConfig:
    """The end-to-end BCE baseline: the fields of the JAX package's
    `BaselineConfig` that change values. `grad_clip` clips the global
    norm of every trainable gradient (head and encoder together), as the
    reference's baseline does.

    `param_sharding` ('replicated' | 'fsdp') lays a gang's parameters
    out as in `Stage1Config`.

    Left out, because they only pick an XLA path or a TPU schedule (as in
    `Stage1Config`): `remat_policy`, `scan_unroll`, `softmax_dtype` (the
    attention kernels keep fp32 scores) and `dropout_impl` (always the
    murmur hashes)."""

    wire_dtype: str = "float32"         # 'float32' | 'int16'
    model_name: str = "facebook/wav2vec2-xls-r-300m"
    target_sample_rate: int = 16000
    max_duration_seconds: int = 5
    input_dim: int = 1024
    hidden_dim: int = 256
    dropout: float = 0.1

    epochs: int = 100
    batch_size: int = 32
    num_samples: Optional[int] = None
    head_lr: float = 5e-3
    enc_lr: float = 1e-5
    weight_decay: float = 3e-3
    seed: int = 1337
    finetune_encoder: bool = True
    grad_clip: float = 5.0              # on ALL trainable params
    patience: int = 10                  # early stop on dev EER

    use_rawboost: bool = True
    rawboost_prob: float = 0.7
    rawboost_mode: str = "device"       # 'device' | 'host' | 'off'
    use_pos_weight: bool = True

    compute_dtype: str = "bfloat16"     # the reference's AMP; no scaler
    remat_encoder: bool = True
    adam_mu_dtype: str = "bfloat16"     # AdamW moment storage; math fp32
    adam_nu_dtype: str = "bfloat16"
    # 'auto' | 'float32' | 'bfloat16': under bf16 compute both give
    # bf16-rounded dW in fp32 leaves, as the JAX trainer does (optim.py)
    grad_dtype: str = "auto"
    rawboost_fir_impl: str = "fft"
    rawboost_isd_mode: str = "exact"
    param_sharding: str = "replicated"  # 'replicated' | 'fsdp'

    def replace(self, **kw) -> "BaselineConfig":
        return dataclasses.replace(self, **kw)

    def ckpt_config(self) -> Dict:
        """The reference's UPPERCASE reload dict of a baseline run."""
        return {
            "MODEL_NAME": self.model_name,
            "RUN_TAG": run_tag(self.model_name),
            "INPUT_DIM": self.input_dim,
            "HIDDEN_DIM": self.hidden_dim,
            "DROPOUT": self.dropout,
            "BATCH_SIZE": self.batch_size,
            "HEAD_LR": self.head_lr,
            "ENC_LR": self.enc_lr,
            "WEIGHT_DECAY": self.weight_decay,
            "USE_RAWBOOST": self.use_rawboost,
            "RAWBOOST_PROB": self.rawboost_prob,
            "FINETUNE_ENCODER": self.finetune_encoder,
        }

    def rawboost_params(self):
        """The RawBoostParams of this config (host and device forms)."""
        return Stage1Config.rawboost_params(self)


@dataclass(frozen=True)
class SupConConfig:
    """Static SupCon hyperparameters; alpha is passed per step."""

    temperature: float = 0.2
    similarity: str = "cosine"  # 'cosine' | 'geodesic'
    topk_neg: int = 15
    uniformity_weight: float = 0.0
    uniformity_t: float = 2.0

    def __post_init__(self):
        if self.similarity not in ("cosine", "geodesic"):
            raise ValueError(f"Unknown similarity: {self.similarity}")


# The published sweep (finetune, bs=32, 100 epochs, warmup 100 => alpha
# == 0), a copy of the JAX package's EXPERIMENT_PRESETS.
_SWEEP = dict(finetune_encoder=True, batch_size=32, epochs=100,
              warmup_epochs=100)

EXPERIMENT_PRESETS: Dict[str, Stage1Config] = {
    "supcon": Stage1Config(**_SWEEP),
    "supcon_temp_0.05": Stage1Config(temperature=0.05, **_SWEEP),
    "supcon_temp_0.07": Stage1Config(temperature=0.07, **_SWEEP),
    "supcon_temp_0.07_batch_64": Stage1Config(
        temperature=0.07, finetune_encoder=True, batch_size=64, epochs=100,
        warmup_epochs=100,
    ),
    "supcon_temp_0.1": Stage1Config(temperature=0.1, **_SWEEP),
    "supcon_temp_0.6": Stage1Config(temperature=0.6, **_SWEEP),
    "supcon_geodesic": Stage1Config(supcon_similarity="geodesic", **_SWEEP),
    "supcon_geodesic_temp_0.05": Stage1Config(
        supcon_similarity="geodesic", temperature=0.05, **_SWEEP),
    "supcon_geodesic_temp_0.07": Stage1Config(
        supcon_similarity="geodesic", temperature=0.07, **_SWEEP),
    "supcon_geodesic_temp_0.1": Stage1Config(
        supcon_similarity="geodesic", temperature=0.1, **_SWEEP),
    "supcon_geodesic_temp_0.6": Stage1Config(
        supcon_similarity="geodesic", temperature=0.6, **_SWEEP),
    "supcon_uniformity": Stage1Config(uniformity_weight=0.2, **_SWEEP),
    "supcon_uniformity_weight_0.01": Stage1Config(uniformity_weight=0.01,
                                                  **_SWEEP),
    "supcon_uniformity_weight_0.05": Stage1Config(uniformity_weight=0.05,
                                                  **_SWEEP),
    "supcon_uniformity_weight_0.1": Stage1Config(uniformity_weight=0.1,
                                                 **_SWEEP),
    "supcon_uniformity_weight_0.6": Stage1Config(uniformity_weight=0.6,
                                                 **_SWEEP),
}


def preset(name: str) -> Stage1Config:
    if name not in EXPERIMENT_PRESETS:
        raise KeyError(
            f"unknown experiment preset {name!r}; "
            f"known: {sorted(EXPERIMENT_PRESETS)}"
        )
    return EXPERIMENT_PRESETS[name]


# facebook/wav2vec2-xls-r-300m
XLSR_300M = Wav2Vec2Config()
# facebook/wav2vec2-xls-r-2b: 48 layers of 1920, 16 heads of 120, the
# 300M's extractor and everything else
XLSR_2B = Wav2Vec2Config(hidden_size=1920, num_layers=48, num_heads=16,
                         intermediate_size=7680)
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
    if kw.get("quant", "none") not in ("none", "w8a8", "w8"):
        raise ValueError(f"unsupported quant {kw['quant']!r}; expected "
                         f"'none', 'w8a8' or 'w8'")
    return Wav2Vec2Config(**kw)
