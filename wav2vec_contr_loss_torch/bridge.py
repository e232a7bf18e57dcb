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
`random_jax_trees` makes seeded random trees in that layout.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .config import Wav2Vec2Config

__all__ = ["jax_params_to_torch", "head_state_dict", "dense_state_dict",
           "random_jax_trees", "random_dense"]

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


def random_jax_trees(cfg: Wav2Vec2Config, comp_dim: int = 256,
                     head_type: str = "linear", head_hidden: int = 128,
                     seed: int = 0):
    """Seeded numpy (encoder, compression, head) trees in the JAX
    package's layout: flax names, Dense kernels (in, out), conv kernels
    (k, in/groups, out), transformer leaves stacked on a leading layer
    axis. Kernels have std 1/sqrt(fan_in) (flax's lecun scale); the head
    has unit scale so logits are O(1). A random init for the CLI and the
    smoke run, without JAX."""
    rng = np.random.default_rng(seed)

    def normal(shape, std):
        return (rng.standard_normal(shape, dtype=np.float32)
                * np.float32(std))

    def dense(n_in, n_out, lead=(), std=None):
        return {"kernel": normal(lead + (n_in, n_out),
                                 std or n_in ** -0.5),
                "bias": normal(lead + (n_out,), 0.02)}

    def norm(n, lead=()):
        return {"scale": 1.0 + normal(lead + (n,), 0.02),
                "bias": normal(lead + (n,), 0.02)}

    fe = {}
    cin = 1
    for i, (dim, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
        fe[f"conv{i}"] = {"kernel": normal((k, cin, dim), (k * cin) ** -0.5)}
        if cfg.conv_bias:
            fe[f"conv{i}"]["bias"] = normal((dim,), 0.02)
        if cfg.feat_extract_norm == "layer":
            fe[f"norm{i}"] = {"LayerNorm_0": norm(dim)}
        cin = dim
    if cfg.feat_extract_norm == "group":
        fe["group_norm"] = norm(cfg.conv_dim[0])

    d, L = cfg.hidden_size, (cfg.num_layers,)
    k, g = cfg.num_conv_pos_embeddings, cfg.num_conv_pos_embedding_groups
    enc = {
        "feature_extractor": fe,
        "feature_projection": {"layer_norm": norm(cfg.conv_dim[-1]),
                               "projection": dense(cfg.conv_dim[-1], d)},
        "pos_conv_embed": {"conv": {
            "kernel": normal((k, d // g, d), (k * d // g) ** -0.5),
            "bias": normal((d,), 0.02)}},
        "encoder_layer_norm": norm(d),
        "layers": {"layer": {
            "attention": {n: dense(d, d, L) for n in
                          ("q_proj", "k_proj", "v_proj", "out_proj")},
            "feed_forward": {
                "intermediate_dense": dense(d, cfg.intermediate_size, L),
                "output_dense": dense(cfg.intermediate_size, d, L)},
            "layer_norm": norm(d, L),
            "final_layer_norm": norm(d, L),
        }},
    }
    if cfg.apply_spec_augment:
        enc["masked_spec_embed"] = rng.uniform(
            0, 1, (d,)).astype(np.float32)
    comp = {"proj": dense(d, comp_dim)}
    if head_type == "linear":
        head = {"fc": dense(comp_dim, 1, std=1.0)}
    else:
        head = {"fc1": dense(comp_dim, head_hidden),
                "fc2": dense(head_hidden, 1, std=1.0)}
    return enc, comp, head


def dense_state_dict(tree: Tree) -> Dict[str, torch.Tensor]:
    """A flax Dense tree ('kernel' (in, out), 'bias') -> an nn.Linear
    state dict, such as the baseline's classifier."""
    sd: Dict[str, torch.Tensor] = {}
    _dense(sd, "", tree)
    return {k[1:]: v for k, v in sd.items()}


def random_dense(n_in: int, n_out: int, seed: int = 0):
    """A seeded numpy Dense(n_in -> n_out) tree in flax's default init:
    kernel std 1/sqrt(n_in) (lecun scale), zero bias. The baseline's
    classifier, and a head over precomputed features."""
    rng = np.random.default_rng(seed)
    return {"kernel": (rng.standard_normal((n_in, n_out), dtype=np.float32)
                       * np.float32(n_in ** -0.5)),
            "bias": np.zeros(n_out, np.float32)}


def head_state_dict(head_params: Tree) -> Dict[str, torch.Tensor]:
    """A stage-2 head tree ('fc', or 'fc1' and 'fc2') -> the port head's
    state dict."""
    head: Dict[str, torch.Tensor] = {}
    for name, tree in head_params.items():
        _dense(head, name, tree)
    return head


def jax_params_to_torch(cfg: Wav2Vec2Config, enc_params: Tree,
                        comp_params: Tree, head_params: Tree
                        ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Nested dicts of numpy arrays shaped as the JAX trees (encoder,
    `CompressionModule`, stage-2 head) -> {'encoder', 'compression',
    'head'} state dicts for the port's modules, fp32 on the CPU."""
    comp: Dict[str, torch.Tensor] = {}
    _dense(comp, "proj", comp_params["proj"])
    return {"encoder": encoder_state_dict(cfg, enc_params),
            "compression": comp, "head": head_state_dict(head_params)}
