"""The port's encoder weights -> a HuggingFace Wav2Vec2 snapshot.

The port's copy of wav2vec_contr_loss_tpu/models/export_hf.py, with no
`transformers` and no `safetensors`: `save_hf_checkpoint` writes
`config.json` and `model.safetensors` (the port's own writer) that
`transformers.Wav2Vec2Model.from_pretrained` loads. The port's state dict
already has HF names, so the export selects keys and re-decomposes the
positional conv into the weight-norm pair: g = ||w|| over dims 0 and 1,
v = w. An all-zero (out, in) slice gets a
unit v there (g stays 0), so a reader's g·v/||v|| gives 0, not 0/0.

`weight_g`/`weight_v` is the layout torch's old `weight_norm` writes;
torch's parametrized `weight_norm` and transformers both load it.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping

import numpy as np
import torch

from ..config import Wav2Vec2Config
from .hf_convert import POS_CONV

__all__ = ["hf_config_from", "pos_conv_weight_norm", "export_hf_state_dict",
           "write_safetensors", "save_hf_checkpoint"]


def hf_config_from(config: Wav2Vec2Config) -> Dict:
    """The port's config -> an HF `config.json` dict (the inverse of
    hf_convert.config_from_hf)."""
    return {
        "model_type": "wav2vec2",
        "architectures": ["Wav2Vec2Model"],
        "hidden_size": config.hidden_size,
        "num_hidden_layers": config.num_layers,
        "num_attention_heads": config.num_heads,
        "intermediate_size": config.intermediate_size,
        "conv_dim": list(config.conv_dim),
        "conv_kernel": list(config.conv_kernel),
        "conv_stride": list(config.conv_stride),
        "num_feat_extract_layers": len(config.conv_dim),
        "conv_bias": config.conv_bias,
        "feat_extract_norm": config.feat_extract_norm,
        "do_stable_layer_norm": config.do_stable_layer_norm,
        "num_conv_pos_embeddings": config.num_conv_pos_embeddings,
        "num_conv_pos_embedding_groups": config.num_conv_pos_embedding_groups,
        "layer_norm_eps": config.layer_norm_eps,
        "hidden_dropout": config.hidden_dropout,
        "attention_dropout": config.attention_dropout,
        "activation_dropout": config.activation_dropout,
        "feat_proj_dropout": config.feat_proj_dropout,
        "apply_spec_augment": config.apply_spec_augment,
        "mask_time_prob": config.mask_time_prob,
        "mask_time_length": config.mask_time_length,
        "mask_time_min_masks": config.mask_time_min_masks,
        "layerdrop": 0.0,
    }


def pos_conv_weight_norm(w: np.ndarray):
    """(out, in/groups, k) kernel -> (g, v), g of shape (1, 1, k).

    g is summed over the C-ordered kernel, the layout a reader finds in
    the file, so a reader's ||v|| is g to the bit and its g·v/||v|| is
    within one ulp of w (the JAX exporter sums over a transposed view,
    which can put g an ulp off and the round trip three ulps)."""
    w = np.ascontiguousarray(w, dtype=np.float32)
    g = np.sqrt((w ** 2).sum(axis=(0, 1), keepdims=True))
    zero_k = (g == 0.0)[0, 0]
    v = w
    if zero_k.any():
        v = w.copy()
        v[0, 0, zero_k] = 1.0
    return g, v


def export_hf_state_dict(config: Wav2Vec2Config,
                         state_dict: Mapping[str, torch.Tensor]
                         ) -> Dict[str, np.ndarray]:
    """The port encoder's state dict -> an HF `Wav2Vec2Model` state dict
    (float32 numpy, bare-model names), the positional conv as
    `weight_g`/`weight_v`."""
    from .hf_convert import encoder_keys

    want = encoder_keys(config)
    missing = [k for k in want if k not in state_dict]
    if missing:
        raise KeyError(f"encoder state dict lacks {missing[:8]}")
    sd = {}
    for k in want:
        x = state_dict[k].detach().cpu().float().numpy()
        if k == f"{POS_CONV}.weight":
            sd[f"{POS_CONV}.weight_g"], sd[f"{POS_CONV}.weight_v"] = \
                pos_conv_weight_norm(x)
        else:
            sd[k] = np.array(x, dtype=np.float32)
    return sd


def write_safetensors(path: str, tensors: Mapping[str, np.ndarray]) -> None:
    """Write float32 arrays as a `.safetensors` file: the 8-byte
    little-endian header length, the JSON header padded to 8 bytes, then
    the raw little-endian data."""
    header, offset, blobs = {"__metadata__": {"format": "pt"}}, 0, []
    for name, x in tensors.items():
        a = np.ascontiguousarray(x, dtype="<f4")
        header[name] = {"dtype": "F32", "shape": list(a.shape),
                        "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
        blobs.append(a)
    h = json.dumps(header, separators=(",", ":")).encode()
    h += b" " * (-len(h) % 8)
    with open(path, "wb") as f:
        f.write(len(h).to_bytes(8, "little"))
        f.write(h)
        for a in blobs:
            f.write(a.tobytes())


def save_hf_checkpoint(out_dir: str, config: Wav2Vec2Config,
                       state_dict: Mapping[str, torch.Tensor]) -> str:
    """Write an HF snapshot directory (config.json + model.safetensors)
    that `transformers.Wav2Vec2Model.from_pretrained(out_dir)` loads."""
    sd = export_hf_state_dict(config, state_dict)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(hf_config_from(config), f, indent=2)
    write_safetensors(os.path.join(out_dir, "model.safetensors"), sd)
    return out_dir
