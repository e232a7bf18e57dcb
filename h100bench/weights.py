"""Seeded random weights, made on the device in a few large draws.

Names and shapes follow HuggingFace `Wav2Vec2Model` for the encoder,
`compression.proj.*` for the compression Linear and `head.fc.*` for the
linear stage-2 head, worked out from a configuration file alone. Each
class of leaf is one draw from one `torch.Generator` on the device,
split into views: linear weights and biases N(0, 0.02); LayerNorm and
GroupNorm scales 1 + N(0, 0.02) and shifts N(0, 0.02); each conv weight
N(0, sqrt(2 / fan_in)) (HuggingFace's Kaiming init; the positional conv
2 / sqrt(fan_in)); the head N(0, 1) so that logits are of order one.
The same seed gives the same weights.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Leaf = Tuple[str, Tuple[int, ...], str]


def leaves(cfg: Dict, compression_dim: int = 256) -> List[Leaf]:
    """(name, shape, init class) of every parameter, in a fixed order."""
    out: List[Leaf] = []
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    cins = [1] + list(cfg["conv_dim"][:-1])
    for i, (cin, cout, k) in enumerate(zip(cins, cfg["conv_dim"],
                                           cfg["conv_kernel"])):
        pre = f"feature_extractor.conv_layers.{i}"
        out.append((f"{pre}.conv.weight", (cout, cin, k), "conv"))
        if cfg["conv_bias"]:
            out.append((f"{pre}.conv.bias", (cout,), "shift"))
        if cfg["feat_extract_norm"] == "layer" or i == 0:
            out.append((f"{pre}.layer_norm.weight", (cout,), "scale"))
            out.append((f"{pre}.layer_norm.bias", (cout,), "shift"))
    c = cfg["conv_dim"][-1]
    out += [("feature_projection.layer_norm.weight", (c,), "scale"),
            ("feature_projection.layer_norm.bias", (c,), "shift"),
            ("feature_projection.projection.weight", (d, c), "linear"),
            ("feature_projection.projection.bias", (d,), "shift"),
            ("masked_spec_embed", (d,), "shift")]
    k, g = cfg["num_conv_pos_embeddings"], cfg["num_conv_pos_embedding_groups"]
    out += [("encoder.pos_conv_embed.conv.weight", (d, d // g, k), "posconv"),
            ("encoder.pos_conv_embed.conv.bias", (d,), "shift"),
            ("encoder.layer_norm.weight", (d,), "scale"),
            ("encoder.layer_norm.bias", (d,), "shift")]
    for i in range(cfg["num_hidden_layers"]):
        pre = f"encoder.layers.{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out += [(f"{pre}.attention.{name}.weight", (d, d), "linear"),
                    (f"{pre}.attention.{name}.bias", (d,), "shift")]
        out += [(f"{pre}.feed_forward.intermediate_dense.weight", (f, d),
                 "linear"),
                (f"{pre}.feed_forward.intermediate_dense.bias", (f,), "shift"),
                (f"{pre}.feed_forward.output_dense.weight", (d, f), "linear"),
                (f"{pre}.feed_forward.output_dense.bias", (d,), "shift")]
        for ln in ("layer_norm", "final_layer_norm"):
            out += [(f"{pre}.{ln}.weight", (d,), "scale"),
                    (f"{pre}.{ln}.bias", (d,), "shift")]
    out += [("compression.proj.weight", (compression_dim, d), "linear"),
            ("compression.proj.bias", (compression_dim,), "shift"),
            ("head.fc.weight", (1, compression_dim), "head"),
            ("head.fc.bias", (1,), "head")]
    return out


def make(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: fp32 tensor on `device`} of every leaf, from `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    spec = leaves(cfg)
    out: Dict[str, torch.Tensor] = {}
    for kind in ("linear", "shift", "scale", "conv", "posconv", "head"):
        group = [(n, s) for n, s, k in spec if k == kind]
        sizes = [math.prod(s) for _, s in group]
        flat = torch.randn(sum(sizes), generator=gen, device=device)
        if kind in ("linear", "shift", "scale"):
            flat.mul_(0.02)
        if kind == "scale":
            flat.add_(1.0)
        for (name, shape), part in zip(group, flat.split(sizes)):
            if kind in ("conv", "posconv"):
                fan_in = math.prod(shape[1:])
                part.mul_(math.sqrt(2.0 / fan_in) if kind == "conv"
                          else 2.0 / math.sqrt(fan_in))
            out[name] = part.view(shape)
    return {n: out[n] for n, _, _ in spec}


def split(flat: Dict[str, torch.Tensor]) -> Dict[str, Dict[str, torch.Tensor]]:
    """Flat names -> the program's {'encoder', 'compression', 'head'}
    state dicts."""
    parts: Dict[str, Dict[str, torch.Tensor]] = {
        "encoder": {}, "compression": {}, "head": {}}
    for name, t in flat.items():
        top, _, rest = name.partition(".")
        if top in ("compression", "head"):
            parts[top][rest] = t
        else:
            parts["encoder"][name] = t
    return parts
