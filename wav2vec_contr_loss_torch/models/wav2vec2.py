"""Wav2Vec2 encoder in eval mode, in PyTorch.

The port of wav2vec_contr_loss_tpu/models/wav2vec2.py (`Wav2Vec2Encoder`
with deterministic=True): strided-conv feature extractor -> feature
projection -> convolutional positional embedding -> transformer stack,
returning the mean over all K = num_layers + 1 hidden states.

Numerics follow the JAX code. Parameters stay fp32 and are cast to the
compute dtype at use, as flax `Dense(dtype=bf16)` does. LayerNorm
statistics are fp32 everywhere; GELU is exact erf; the layer-mean
accumulates in fp32. The sequence length of a clip is its count of
nonzero samples pushed through the conv stride chain; padded frames are
zeroed and get an fp32 -1e30 key bias (not -inf, so a clip with no valid
frame attends uniformly instead of producing NaN).

The two Pallas kernels of the JAX encoder have Hopper counterparts here:
the conv extractor's LayerNorm+GELU (`ops/conv_ln.py`, 'layer' variant,
one launch per conv) and the attention core (`ops/attention.py`, one
launch per layer). SpecAugment, dropout, remat and the parallel layouts
belong to training and are not ported.

Parameter names follow HuggingFace's `Wav2Vec2Model`; `bridge.py` maps
the JAX trees onto them.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import Wav2Vec2Config, feature_frame_length
from ..ops.attention import fused_attention
from ..ops.conv_ln import fused_ln_gelu

__all__ = ["Wav2Vec2Encoder"]


def _linear(m: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, m.weight.to(x.dtype), m.bias.to(x.dtype))


def _conv(m: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    bias = None if m.bias is None else m.bias.to(x.dtype)
    return F.conv1d(x, m.weight.to(x.dtype), bias, m.stride, m.padding,
                    groups=m.groups)


def _layer_norm(m: nn.LayerNorm, x: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm in fp32 (stats and affine), output cast to `dtype`."""
    return F.layer_norm(x.float(), m.normalized_shape, m.weight, m.bias,
                        m.eps).to(dtype)


class _ConvLayer(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, s: int, bias: bool,
                 norm: Optional[str], eps: float):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, k, s, bias=bias)
        if norm == "layer":
            self.layer_norm = nn.LayerNorm(cout, eps=eps)
        elif norm == "group":
            self.layer_norm = nn.GroupNorm(cout, cout, eps=eps)


class FeatureExtractor(nn.Module):
    """7 strided 1-D convs: (B, T_samples) -> (B, T_frames, 512).

    'layer' (XLS-R): LayerNorm+GELU after every conv, through the fused
    kernel. 'group' (large-960h): GroupNorm(C groups) after conv0 only,
    GELU after every conv, in plain torch as XLA ran it."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.cfg = cfg
        if cfg.feat_extract_norm not in ("layer", "group"):
            raise ValueError(f"feat_extract_norm {cfg.feat_extract_norm!r}")
        cins = (1,) + tuple(cfg.conv_dim[:-1])
        self.conv_layers = nn.ModuleList(
            _ConvLayer(cin, cout, k, s, cfg.conv_bias,
                       "layer" if cfg.feat_extract_norm == "layer"
                       else ("group" if i == 0 else None),
                       cfg.layer_norm_eps)
            for i, (cin, cout, k, s) in enumerate(
                zip(cins, cfg.conv_dim, cfg.conv_kernel, cfg.conv_stride)))

    def forward(self, waveforms: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = waveforms[:, None, :].to(cfg.torch_dtype)       # (B, 1, T)
        for i, layer in enumerate(self.conv_layers):
            x = _conv(layer.conv, x)                        # (B, C, T')
            if cfg.feat_extract_norm == "layer":
                # the kernel normalizes rows of (B*T', C); torch's conv
                # output is (B, C, T'), so one transposing copy per conv
                ln = layer.layer_norm
                y = fused_ln_gelu(x.transpose(1, 2).contiguous(), ln.weight,
                                  ln.bias, ln.eps, True)
                x = y.transpose(1, 2)
                continue
            if i == 0:
                gn = layer.layer_norm
                x = F.group_norm(x.float(), gn.num_groups, gn.weight,
                                 gn.bias, gn.eps).to(cfg.torch_dtype)
            x = F.gelu(x)
        return x.transpose(1, 2)                            # (B, T', C)


class FeatureProjection(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.cfg = cfg
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1], eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _layer_norm(self.layer_norm, x, self.cfg.torch_dtype)
        return _linear(self.projection, x)


class PositionalConvEmbedding(nn.Module):
    """Grouped conv (kernel 128, 16 groups), padding k//2, the last frame
    trimmed for an even kernel, then GELU."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        k = cfg.num_conv_pos_embeddings
        self.conv = nn.Conv1d(cfg.hidden_size, cfg.hidden_size, k,
                              padding=k // 2,
                              groups=cfg.num_conv_pos_embedding_groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # (B, T, D)
        y = _conv(self.conv, x.transpose(1, 2))
        if self.conv.kernel_size[0] % 2 == 0:
            y = y[:, :, :-1]
        return F.gelu(y).transpose(1, 2)


class SelfAttention(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        d = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def forward(self, x: torch.Tensor, key_bias: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        h = self.num_heads
        hd = d // h
        # q is scaled before the kernel, in the compute dtype, as in JAX
        q = _linear(self.q_proj, x) * (hd ** -0.5)
        k = _linear(self.k_proj, x)
        v = _linear(self.v_proj, x)

        def heads(a: torch.Tensor) -> torch.Tensor:
            return a.view(b, t, h, hd).transpose(1, 2).contiguous()

        out = fused_attention(heads(q), heads(k), heads(v), key_bias, 0, 0.0, h)
        return _linear(self.out_proj, out.transpose(1, 2).reshape(b, t, d))


class FeedForward(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.intermediate_dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.output_dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _linear(self.output_dense,
                       F.gelu(_linear(self.intermediate_dense, x)))


class EncoderLayer(nn.Module):
    """One transformer block; `do_stable_layer_norm` picks pre-LN (XLS-R)
    or post-LN (large-960h). LN input and output are in the compute dtype."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.pre_ln = cfg.do_stable_layer_norm
        self.dtype = cfg.torch_dtype
        self.attention = SelfAttention(cfg)
        self.feed_forward = FeedForward(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size,
                                             eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, key_bias: torch.Tensor) -> torch.Tensor:
        if self.pre_ln:
            x = x + self.attention(_layer_norm(self.layer_norm, x, self.dtype),
                                   key_bias)
            return x + self.feed_forward(
                _layer_norm(self.final_layer_norm, x, self.dtype))
        x = _layer_norm(self.layer_norm, x + self.attention(x, key_bias),
                        self.dtype)
        x = x + self.feed_forward(x)
        return _layer_norm(self.final_layer_norm, x, self.dtype)


class TransformerStack(nn.Module):
    """Holds the positional conv, the encoder LayerNorm and the layers
    under HF's `encoder.*` names."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.pos_conv_embed = PositionalConvEmbedding(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(EncoderLayer(cfg)
                                    for _ in range(cfg.num_layers))


class Wav2Vec2Encoder(nn.Module):
    """Full encoder in eval mode. `forward` returns a dict:

      layer_mean:  (B, T', D) fp32 mean of all K = num_layers+1 hidden
                   states (pre-LN: the last one after the encoder LN),
      last_hidden: (B, T', D) final hidden state, compute dtype,
      frame_mask:  (B, T') bool validity mask in frame space,
      all_hidden:  (K, B, T', D) fp32, only with return_all_hidden_states.
    """

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = FeatureExtractor(cfg)
        self.feature_projection = FeatureProjection(cfg)
        if cfg.apply_spec_augment:
            # training-only (SpecAugment); kept so checkpoints round-trip
            self.masked_spec_embed = nn.Parameter(torch.empty(cfg.hidden_size))
        self.encoder = TransformerStack(cfg)

    def forward(self, waveforms: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                return_all_hidden_states: bool = False
                ) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        dt = cfg.torch_dtype
        if attention_mask is None:
            attention_mask = waveforms != 0.0
        features = self.feature_extractor(waveforms)
        t_frames = features.shape[1]

        lengths = feature_frame_length(attention_mask.to(torch.int64).sum(-1),
                                       cfg)
        frame_idx = torch.arange(t_frames, device=features.device)
        frame_mask = frame_idx[None, :] < lengths[:, None]   # (B, T')

        hidden = self.feature_projection(features)
        hidden = hidden * frame_mask[:, :, None].to(hidden.dtype)
        key_bias = torch.where(frame_mask, 0.0, -1e30).to(torch.float32)

        stack = self.encoder
        hidden = hidden + stack.pos_conv_embed(hidden)
        if not cfg.do_stable_layer_norm:
            hidden = _layer_norm(stack.layer_norm, hidden, dt)

        acc = hidden.float()
        ys = []
        h = hidden
        for layer in stack.layers:
            h = layer(h, key_bias)
            acc = acc + h.float()
            if return_all_hidden_states:
                ys.append(h)

        if cfg.do_stable_layer_norm:
            final = _layer_norm(stack.layer_norm, h, torch.float32)
            # hidden-state list = [h0, out_0..out_{L-2}, LN(out_{L-1})]
            acc = acc - h.float() + final
            last_hidden = final.to(dt)
        else:
            last_hidden = h

        out = {"layer_mean": acc / cfg.num_hidden_states,
               "last_hidden": last_hidden, "frame_mask": frame_mask}
        if return_all_hidden_states:
            if cfg.do_stable_layer_norm:
                ys[-1] = last_hidden
            out["all_hidden"] = torch.stack(
                [hidden.float()] + [y.float() for y in ys])
        return out
