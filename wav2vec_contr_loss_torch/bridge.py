"""JAX parameter trees -> state dicts of the port's modules.

The JAX package keeps flax parameter trees; the port keeps PyTorch
modules whose parameter names follow HuggingFace's `Wav2Vec2Model`. This
module is the port's own copy of the mapping that the JAX package's
HF exporter implements (wav2vec_contr_loss_tpu/models/export_hf.py), and
takes the trees as nested dicts of numpy arrays, so nothing here needs
JAX:

  * Dense kernels transpose (in, out) -> (out, in),
  * conv kernels transpose (k, in, out) -> (out, in, k),
  * the scan-stacked `layers/layer/*` leaves are unstacked along their
    leading layer axis,
  * a fused `qkv_proj` is split into q/k/v,
  * the positional conv becomes a plain `weight` (the flax tree holds
    the materialized kernel; the port has no weight norm).

Compression `proj` and the stage-2 head Dense layers map the same way.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .config import Wav2Vec2Config

__all__ = ["jax_params_to_torch"]

Tree = Mapping[str, object]


def _t(x) -> torch.Tensor:
    # always copy: leaves can be read-only buffers, which from_numpy refuses
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _dense(sd: Dict, prefix: str, tree: Tree) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(tree["kernel"]).T)
    sd[f"{prefix}.bias"] = _t(tree["bias"])


def _norm(sd: Dict, prefix: str, tree: Tree) -> None:
    sd[f"{prefix}.weight"] = _t(tree["scale"])
    sd[f"{prefix}.bias"] = _t(tree["bias"])


def _conv(kernel) -> torch.Tensor:
    return _t(np.asarray(kernel).transpose(2, 1, 0))


def _layer(tree: Tree, i: int) -> Dict:
    return {k: _layer(v, i) if isinstance(v, Mapping) else np.asarray(v)[i]
            for k, v in tree.items()}


def encoder_state_dict(cfg: Wav2Vec2Config, p: Tree) -> Dict[str, torch.Tensor]:
    """flax `Wav2Vec2Encoder` params -> port `Wav2Vec2Encoder` state dict."""
    sd: Dict[str, torch.Tensor] = {}
    fe = p["feature_extractor"]
    for i in range(len(cfg.conv_dim)):
        pre = f"feature_extractor.conv_layers.{i}"
        sd[f"{pre}.conv.weight"] = _conv(fe[f"conv{i}"]["kernel"])
        if cfg.conv_bias:
            sd[f"{pre}.conv.bias"] = _t(fe[f"conv{i}"]["bias"])
        if cfg.feat_extract_norm == "layer":
            _norm(sd, f"{pre}.layer_norm", fe[f"norm{i}"]["LayerNorm_0"])
    if cfg.feat_extract_norm == "group":
        _norm(sd, "feature_extractor.conv_layers.0.layer_norm",
              fe["group_norm"])

    _norm(sd, "feature_projection.layer_norm",
          p["feature_projection"]["layer_norm"])
    _dense(sd, "feature_projection.projection",
           p["feature_projection"]["projection"])
    if "masked_spec_embed" in p:
        sd["masked_spec_embed"] = _t(p["masked_spec_embed"])
    sd["encoder.pos_conv_embed.conv.weight"] = _conv(
        p["pos_conv_embed"]["conv"]["kernel"])
    sd["encoder.pos_conv_embed.conv.bias"] = _t(
        p["pos_conv_embed"]["conv"]["bias"])
    _norm(sd, "encoder.layer_norm", p["encoder_layer_norm"])

    for i in range(cfg.num_layers):
        li = _layer(p["layers"]["layer"], i)
        pre = f"encoder.layers.{i}"
        att = li["attention"]
        if "qkv_proj" in att:
            k3 = att["qkv_proj"]["kernel"]          # (in, 3*D)
            b3 = att["qkv_proj"]["bias"]
            d = k3.shape[1] // 3
            for j, n in enumerate(("q_proj", "k_proj", "v_proj")):
                _dense(sd, f"{pre}.attention.{n}",
                       {"kernel": k3[:, j * d:(j + 1) * d],
                        "bias": b3[j * d:(j + 1) * d]})
        else:
            for n in ("q_proj", "k_proj", "v_proj"):
                _dense(sd, f"{pre}.attention.{n}", att[n])
        _dense(sd, f"{pre}.attention.out_proj", att["out_proj"])
        for n in ("intermediate_dense", "output_dense"):
            _dense(sd, f"{pre}.feed_forward.{n}", li["feed_forward"][n])
        _norm(sd, f"{pre}.layer_norm", li["layer_norm"])
        _norm(sd, f"{pre}.final_layer_norm", li["final_layer_norm"])
    return sd


def jax_params_to_torch(cfg: Wav2Vec2Config, enc_params: Tree,
                        comp_params: Tree, head_params: Tree
                        ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Nested dicts of numpy arrays shaped as the JAX trees (encoder,
    `CompressionModule`, stage-2 head) -> {'encoder', 'compression',
    'head'} state dicts for the port's modules, fp32 on the CPU."""
    comp: Dict[str, torch.Tensor] = {}
    _dense(comp, "proj", comp_params["proj"])
    head: Dict[str, torch.Tensor] = {}
    for name, tree in head_params.items():
        _dense(head, name, tree)
    return {"encoder": encoder_state_dict(cfg, enc_params),
            "compression": comp, "head": head}
