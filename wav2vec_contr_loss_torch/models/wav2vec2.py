"""Wav2Vec2 encoder, in PyTorch.

The port of wav2vec_contr_loss_tpu/models/wav2vec2.py (`Wav2Vec2Encoder`):
strided-conv feature extractor -> feature projection -> convolutional
positional embedding -> transformer stack, returning the mean over all
K = num_layers + 1 hidden states. `self.training` stands in for JAX's
`deterministic=False`.

Numerics follow the JAX code. Parameters stay fp32 and are cast to the
compute dtype at use, as flax `Dense(dtype=bf16)` does. Under fp32
compute on the card every product is full fp32: cuBLAS keeps PyTorch's
default (no TF32 matmuls), and the convs run cuDNN with TF32 off in the
forward and the backward (`_Fp32Conv`), whatever the process's
`torch.backends.cudnn.allow_tf32`. LayerNorm
statistics are fp32 everywhere; GELU is exact erf; the layer-mean
accumulates in fp32. The sequence length of a clip is its count of
nonzero samples pushed through the conv stride chain; padded frames are
zeroed and get an fp32 -1e30 key bias (not -inf, so a clip with no valid
frame attends uniformly instead of producing NaN).

The two Pallas kernels of the JAX encoder have Hopper counterparts here,
forward and backward: the conv extractor's LayerNorm+GELU
(`ops/conv_ln.py`, 'layer' variant, one launch per conv) and the
attention core with its dropout (`ops/attention.py`, one launch per
layer). The positional conv, which JAX leaves to XLA, runs hand-written
kernels on the card in bf16 at the group widths they are built for
(`ops/pos_conv.py`: XLS-R 2B's 120, 1B's 80).

With `cfg.quant` 'w8a8' or 'w8' (serving only) the six linears of each
layer are `ops.quant.QuantLinear`s under the same state-dict names, as
the JAX `_linear` factory (wav2vec2.py:265-276) builds `QuantDense`s;
their int8 state comes from `quantize_encoder_state_dict`.

Train mode (finetuning) takes a `torch.Generator` and draws every random
number from it before the layers run: one murmur dropout seed for each
dropout site (feature projection, the encoder input, and per layer the
attention probabilities, the attention output, the FFN activation and
the FFN output, as at the JAX call sites) and the SpecAugment uniforms.
So `remat` (`torch.utils.checkpoint` around each layer) and `remat_conv`
(around the conv tower) recompute the same masks; they change the
schedule, not the values. `freeze_feature_extractor` runs the conv tower
without gradients (the JAX `stop_gradient`).

In a parallel gang (parallel/mesh.py `apply_layout`) each module holds
the gang's `Shard`: its batch is the data rank's slice of the global
batch, and under tensor parallelism its attention and FFN linears hold
Megatron's column (q, k, v, intermediate_dense) or row (out_proj,
output_dense) slices as plain parameters, their widths and head counts
read from the local weights, with `copy_to_model` before the column
linears and `reduce_from_model` after the row ones (the row bias is
added after the sum). Every random draw is made in global coordinates
and sliced: the SpecAugment uniforms for the global batch, the murmur
dropouts at the rank's batch offset (and, for the activation dropout on
a column-parallel FFN, its feature offset), the attention dropout from
the seed of the rank's first (batch, head) with the global head count as
the seed stride. So a gang computes what one process at the global batch
computes.

With `sequence_parallel` (the counterpart of JAX wav2vec2.py:617-660 and
`sp_constrain`) the residual stream is frame-sharded over 'model' after
the encoder-input dropout; the positional conv (kernel 128) reads every
frame, so it runs before. The frames are padded to a multiple of
n_model with masked frames (zeroed, key bias -1e30; a clip with no valid
frame then attends uniformly over the padded frames too). LayerNorm,
dropout (at global frame offsets) and the residual run on local frames;
the frames are all-gathered before the column-parallel q/k/v and FFN-in
linears and reduce-scattered after the row-parallel ones, and the
stack's outputs are gathered and the padding cut off before they leave
the encoder. The layers' replicated parameters (LayerNorms, row biases)
then hold each rank's frames' share of their gradient, which the layout
sums over 'model' (parallel/mesh.py). At n_model = 1 it changes nothing.

Under `param_sharding='pp'` (a Shard with `pipeline_microbatches`) the
layer loop is `parallel.pipeline.gpipe_stack` over the 'model' axis's
stages: each layer keeps its global index's dropout seeds, and each
microbatch draws at its global rows (its layers run with a Shard whose
batch offset is the microbatch's first row). So a pipe computes what
one process computes, dropout included, where JAX's pipe draws a
schedule of its own. After the pipe every stage applies the final
LayerNorm. `return_all_hidden_states` is refused under 'pp', as in JAX.

Parameter names follow HuggingFace's `Wav2Vec2Model`; `bridge.py` maps
the JAX trees onto them.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import Wav2Vec2Config, feature_frame_length
from ..device import fp32_convs
from ..ops.attention import fused_attention
from ..ops.conv_ln import fused_ln_gelu
from ..ops.dropout import draw_seed, murmur_dropout
from ..ops.pos_conv import pos_conv, routed
from ..ops.quant import QuantLinear
from ..parallel.collectives import (SINGLE, Shard, copy_to_model,
                                    gather_frames, reduce_from_model,
                                    scatter_frames, split_frames)
from ..parallel.pipeline import gpipe_stack

__all__ = ["Wav2Vec2Encoder", "time_mask_spans", "max_mask_spans"]

# per-layer dropout sites, in the order their seeds are drawn
_LAYER_SITES = ("attention", "attention_out", "activation", "ffn_out")


def _drop(x: torch.Tensor, seeds: Optional[Dict[str, int]], site: str,
          rate: float, shard: Shard = SINGLE, feature_offset: int = 0,
          frame_offset: int = 0) -> torch.Tensor:
    """Murmur dropout at `site` when its seed was drawn (train mode), over
    the global (B, T, F) tensor: x sits at the shard's batch offset, at
    `frame_offset` on the frame axis and at `feature_offset` on the last
    axis."""
    if seeds is None or seeds.get(site) is None:
        return x
    offsets = ((shard.batch_offset(x.shape[0]), frame_offset)
               + (0,) * (x.dim() - 3) + (feature_offset,))
    return murmur_dropout(x, seeds[site], rate, offsets)


def _sequence_parallel(shard: Shard) -> bool:
    return shard.sequence_parallel and shard.n_model > 1


def _local_frames(x: torch.Tensor, shard: Shard) -> int:
    """The global frame of x's first frame (frame-sharded x under
    sequence parallelism, else 0)."""
    return shard.model_rank * x.shape[1] if _sequence_parallel(shard) else 0


def _column_input(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    """The input of a column-parallel linear: x itself (one process),
    `copy_to_model` (tensor parallelism), or every rank's frames gathered
    (sequence parallelism)."""
    if _sequence_parallel(shard):
        return gather_frames(x, shard, reduce_grad=True)
    return copy_to_model(x, shard)


def max_mask_spans(t_frames: int, cfg: Wav2Vec2Config) -> int:
    """Static bound on the SpecAugment spans per clip."""
    return max(cfg.mask_time_min_masks,
               int(cfg.mask_time_prob * t_frames / cfg.mask_time_length) + 1)


def time_mask_spans(lengths: torch.Tensor, t_frames: int,
                    cfg: Wav2Vec2Config, eps: torch.Tensor,
                    u: torch.Tensor) -> torch.Tensor:
    """SpecAugment time mask (B, T') bool, the port of `_time_mask_spans`
    (wav2vec2.py:206-250) with its uniforms passed in: eps (B,) and
    u (B, max_mask_spans(t_frames, cfg)), both fp32 in [0, 1).

      num_spans = max(int(p * len / L + eps), min_masks), capped so the
      spans fit; starts drawn without replacement from [0, len - L] by
      sequential insertion."""
    L, p = cfg.mask_time_length, cfg.mask_time_prob
    max_spans = max_mask_spans(t_frames, cfg)
    flen = lengths.to(torch.float32)
    num = torch.floor(p * flen / L + eps).to(torch.int64)
    num = num.clamp_min(cfg.mask_time_min_masks)
    num = torch.minimum(num, lengths // L)
    num = torch.minimum(num, (lengths - (L - 1)).clamp_min(0))

    hi = (lengths - L + 1).clamp_min(1).to(torch.float32)
    chosen = []
    for i in range(max_spans):
        x = torch.floor(u[:, i] * (hi - i).clamp_min(1.0)).to(torch.int64)
        if chosen:
            prev = torch.sort(torch.stack(chosen, dim=1), dim=1).values
            for j in range(i):
                x = x + (x >= prev[:, j]).to(torch.int64)
        chosen.append(x)
    starts = torch.stack(chosen, dim=1)                        # (B, S)
    active = (torch.arange(max_spans, device=lengths.device)[None, :]
              < num[:, None])
    fr = torch.arange(t_frames, device=lengths.device)[None, None, :]
    spans = (fr >= starts[:, :, None]) & (fr < (starts + L)[:, :, None])
    return (spans & active[:, :, None]).any(dim=1)


def _linear(m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    if isinstance(m, QuantLinear):
        return m(x)
    return F.linear(x, m.weight.to(x.dtype), m.bias.to(x.dtype))


def _row_linear(m: nn.Module, x: torch.Tensor, shard: Shard) -> torch.Tensor:
    """A row-parallel linear: the partial products summed over 'model'
    (reduce-scattered to this rank's frames under sequence parallelism),
    then the (replicated) bias; `_linear` without a 'model' axis."""
    if shard.n_model == 1:
        return _linear(m, x)
    y = F.linear(x, m.weight.to(x.dtype))
    y = (scatter_frames(y, shard) if _sequence_parallel(shard)
         else reduce_from_model(y, shard))
    return y + m.bias.to(x.dtype)


def _transformer_linear(cfg: Wav2Vec2Config, din: int, dout: int
                        ) -> nn.Module:
    """A transformer linear: `nn.Linear` with fp32 parameters, or the
    int8 `QuantLinear` when cfg.quant != 'none'."""
    if cfg.quant != "none":
        return QuantLinear(din, dout, cfg.quant, cfg.torch_dtype)
    return nn.Linear(din, dout)


class _Fp32Conv(torch.autograd.Function):
    """F.conv1d with cuDNN in full fp32, forward and backward: autograd's
    convolution backward reads the TF32 setting when it runs, so a scope
    around the forward alone would leave the gradients in TF32."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding, groups):
        ctx.save_for_backward(x, weight)
        ctx.conv = (stride, padding, groups, bias is not None)
        with fp32_convs():
            return F.conv1d(x, weight, bias, stride, padding, groups=groups)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        stride, padding, groups, has_bias = ctx.conv
        need = ctx.needs_input_grad
        with fp32_convs():
            dx, dw, db = torch.ops.aten.convolution_backward(
                g, x, weight, [weight.shape[0]] if has_bias else None,
                list(stride), list(padding), [1], False, [0], groups,
                [need[0], need[1], has_bias and need[2]])
        return dx, dw, db, None, None, None


def _conv(m: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu" and x.dtype == torch.bfloat16:
        # oneDNN's bf16 grouped conv on the CPU is wrong at 8 channels a
        # group (the tiny test encoder's positional conv: errors of 5 on
        # outputs of 4); the fp32 conv of the bf16 values, rounded once
        return _conv(m, x.float()).to(torch.bfloat16)
    bias = None if m.bias is None else m.bias.to(x.dtype)
    if x.device.type == "cuda" and x.dtype == torch.float32:
        # fp32 compute means fp32 convs: cuDNN would take them in TF32
        return _Fp32Conv.apply(x, m.weight, bias, m.stride, m.padding,
                               m.groups)
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
    shard = SINGLE

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.cfg = cfg
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1], eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)

    def forward(self, x: torch.Tensor,
                seeds: Optional[Dict[str, int]] = None) -> torch.Tensor:
        x = _layer_norm(self.layer_norm, x, self.cfg.torch_dtype)
        return _drop(_linear(self.projection, x), seeds, "feat_proj",
                     self.cfg.feat_proj_dropout, self.shard)


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
        trim = self.conv.kernel_size[0] % 2 == 0
        if routed(x, self.conv.in_channels // self.conv.groups):
            # trimmed as (B, T', D): the gradient comes back in that
            # layout, the one the kernels read
            y = pos_conv(x, self.conv.weight, self.conv.bias,
                         self.conv.padding[0], self.conv.groups)
            return F.gelu(y[:, :-1] if trim else y)
        y = _conv(self.conv, x.transpose(1, 2))
        if trim:
            y = y[:, :, :-1]
        return F.gelu(y).transpose(1, 2)


class SelfAttention(nn.Module):
    shard = SINGLE

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        d = cfg.hidden_size
        self.rate = cfg.attention_dropout
        self.num_heads = cfg.num_heads
        self.head_dim = d // cfg.num_heads
        self.q_proj = _transformer_linear(cfg, d, d)
        self.k_proj = _transformer_linear(cfg, d, d)
        self.v_proj = _transformer_linear(cfg, d, d)
        self.out_proj = _transformer_linear(cfg, d, d)

    def forward(self, x: torch.Tensor, key_bias: torch.Tensor,
                seed: Optional[int] = None,
                shard: Optional[Shard] = None) -> torch.Tensor:
        sh = shard or self.shard
        x = _column_input(x, sh)
        b, t, _ = x.shape
        hd = self.head_dim
        # q is scaled before the kernel, in the compute dtype, as in JAX
        q = _linear(self.q_proj, x) * (hd ** -0.5)
        k = _linear(self.k_proj, x)
        v = _linear(self.v_proj, x)
        d = q.shape[-1]        # this rank's heads under tensor parallelism
        h = d // hd

        # (B, H, T, hd) views of the (B, T, H, hd) projections: the CUDA
        # kernels take them by strides and write out in the same layout,
        # so neither direction copies around the kernel on the card
        def heads(a: torch.Tensor) -> torch.Tensor:
            return a.view(b, t, h, hd).transpose(1, 2)

        rate = 0.0 if seed is None else self.rate
        # the seed of this rank's first (batch, head) of the global
        # (B, H) grid; the kernels step it by H a batch row
        first = sh.batch_offset(b) * self.num_heads + sh.model_rank * h
        out = fused_attention(heads(q), heads(k), heads(v), key_bias,
                              (seed or 0) + first, rate, h,
                              seed_stride=self.num_heads)
        return _row_linear(self.out_proj,
                           out.transpose(1, 2).reshape(b, t, d), sh)


class FeedForward(nn.Module):
    shard = SINGLE

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.cfg = cfg
        self.intermediate_dense = _transformer_linear(
            cfg, cfg.hidden_size, cfg.intermediate_size)
        self.output_dense = _transformer_linear(
            cfg, cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor,
                seeds: Optional[Dict[str, int]] = None,
                shard: Optional[Shard] = None) -> torch.Tensor:
        sh = shard or self.shard
        frame0 = _local_frames(x, sh)
        x = F.gelu(_linear(self.intermediate_dense, _column_input(x, sh)))
        x = _drop(x, seeds, "activation", self.cfg.activation_dropout, sh,
                  sh.model_rank * x.shape[-1])
        return _drop(_row_linear(self.output_dense, x, sh), seeds, "ffn_out",
                     self.cfg.hidden_dropout, sh, frame_offset=frame0)


class EncoderLayer(nn.Module):
    """One transformer block; `do_stable_layer_norm` picks pre-LN (XLS-R)
    or post-LN (large-960h). LN input and output are in the compute dtype."""

    shard = SINGLE

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.hidden_dropout = cfg.hidden_dropout
        self.pre_ln = cfg.do_stable_layer_norm
        self.dtype = cfg.torch_dtype
        self.attention = SelfAttention(cfg)
        self.feed_forward = FeedForward(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size,
                                             eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, key_bias: torch.Tensor,
                seeds: Optional[Dict[str, int]] = None,
                shard: Optional[Shard] = None) -> torch.Tensor:
        """`seeds` holds a dropout seed per site of `_LAYER_SITES` in
        train mode, None in eval mode. `shard` (the module's when None)
        places x in the global batch: a pipeline passes each microbatch's
        (an argument, so a remat recompute draws the same masks)."""
        sh = shard or self.shard
        attn_seed = None if seeds is None else seeds.get("attention")
        frame0 = _local_frames(x, sh)

        def attend(y):
            return _drop(self.attention(y, key_bias, attn_seed, sh), seeds,
                         "attention_out", self.hidden_dropout, sh,
                         frame_offset=frame0)

        if self.pre_ln:
            x = x + attend(_layer_norm(self.layer_norm, x, self.dtype))
            return x + self.feed_forward(
                _layer_norm(self.final_layer_norm, x, self.dtype), seeds, sh)
        x = _layer_norm(self.layer_norm, x + attend(x), self.dtype)
        x = x + self.feed_forward(x, seeds, sh)
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
    """Full encoder. `forward` returns a dict:

      layer_mean:  (B, T', D) fp32 mean of all K = num_layers+1 hidden
                   states (pre-LN: the last one after the encoder LN),
      last_hidden: (B, T', D) final hidden state, compute dtype,
      frame_mask:  (B, T') bool validity mask in frame space,
      all_hidden:  (K, B, T', D) fp32, only with return_all_hidden_states.

    In train mode `forward` needs `gen`, the generator every dropout seed
    and SpecAugment uniform is drawn from. `remat`, `remat_conv` and
    `freeze_feature_extractor` are the trainer's knobs of the same names.
    """

    shard = SINGLE

    def __init__(self, cfg: Wav2Vec2Config, *, remat: bool = False,
                 remat_conv: bool = False,
                 freeze_feature_extractor: bool = False):
        super().__init__()
        self.cfg = cfg
        self.remat = remat
        self.remat_conv = remat_conv
        self.freeze_feature_extractor = freeze_feature_extractor
        self.feature_extractor = FeatureExtractor(cfg)
        self.feature_projection = FeatureProjection(cfg)
        if cfg.apply_spec_augment:
            self.masked_spec_embed = nn.Parameter(torch.empty(cfg.hidden_size))
        self.encoder = TransformerStack(cfg)

    def _draw(self, gen: torch.Generator, batch: int, t_frames: int):
        """Every random number of one train-mode forward, in a fixed
        order: (global seeds, per-layer seeds, SpecAugment uniforms of
        the global batch, then this rank's rows of them)."""
        cfg = self.cfg

        def seed(rate):
            return draw_seed(gen) if rate > 0.0 else None

        glob = {"feat_proj": seed(cfg.feat_proj_dropout),
                "encoder_in": seed(cfg.hidden_dropout)}
        rates = {"attention": cfg.attention_dropout,
                 "attention_out": cfg.hidden_dropout,
                 "activation": cfg.activation_dropout,
                 "ffn_out": cfg.hidden_dropout}
        layers = [{site: seed(rates[site]) for site in _LAYER_SITES}
                  for _ in range(cfg.num_layers)]
        spans = None
        if cfg.apply_spec_augment and cfg.mask_time_prob > 0:
            n = batch * self.shard.n_data
            rows = slice(self.shard.batch_offset(batch),
                         self.shard.batch_offset(batch) + batch)
            spans = (torch.rand(n, generator=gen)[rows],
                     torch.rand(n, max_mask_spans(t_frames, cfg),
                                generator=gen)[rows])
        return glob, layers, spans

    def _features(self, waveforms: torch.Tensor) -> torch.Tensor:
        if self.training and self.freeze_feature_extractor:
            with torch.no_grad():   # the JAX stop_gradient
                return self.feature_extractor(waveforms)
        if (self.training and self.remat_conv
                and torch.is_grad_enabled()):
            return checkpoint(self.feature_extractor, waveforms,
                              use_reentrant=False)
        return self.feature_extractor(waveforms)

    def forward(self, waveforms: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                return_all_hidden_states: bool = False,
                gen: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        dt = cfg.torch_dtype
        if attention_mask is None:
            attention_mask = waveforms != 0.0
        features = self._features(waveforms)
        t_frames = features.shape[1]
        if self.training:
            if gen is None:
                raise ValueError("train mode draws its dropout seeds from "
                                 "`gen`, a torch.Generator")
            glob, layer_seeds, spans = self._draw(gen, features.shape[0],
                                                  t_frames)
        else:
            glob, layer_seeds, spans = None, [None] * cfg.num_layers, None

        lengths = feature_frame_length(attention_mask.to(torch.int64).sum(-1),
                                       cfg)
        frame_idx = torch.arange(t_frames, device=features.device)
        frame_mask = frame_idx[None, :] < lengths[:, None]   # (B, T')

        hidden = self.feature_projection(features, glob)
        if spans is not None:
            # non-blocking: a train step makes no host-device sync
            eps, u = (a.to(features.device, non_blocking=True)
                      for a in spans)
            span = time_mask_spans(lengths, t_frames, cfg, eps, u) & frame_mask
            hidden = torch.where(span[:, :, None],
                                 self.masked_spec_embed.to(hidden.dtype),
                                 hidden)
        hidden = hidden * frame_mask[:, :, None].to(hidden.dtype)
        key_bias = torch.where(frame_mask, 0.0, -1e30).to(torch.float32)

        stack = self.encoder
        hidden = hidden + stack.pos_conv_embed(hidden)
        if not cfg.do_stable_layer_norm:
            hidden = _layer_norm(stack.layer_norm, hidden, dt)
        hidden = _drop(hidden, glob, "encoder_in", cfg.hidden_dropout,
                       self.shard)

        sh = self.shard
        pipelined = sh.pipeline_microbatches > 0 and sh.n_model > 1
        if pipelined and return_all_hidden_states:
            raise ValueError(
                "return_all_hidden_states is unsupported with "
                "param_sharding='pp' (the full (K, B, T, D) stack would "
                "have to ride the pipe)")
        first = hidden
        if _sequence_parallel(sh):
            pad = -t_frames % sh.n_model
            hidden = split_frames(F.pad(hidden, (0, 0, 0, pad)), sh)
            key_bias = F.pad(key_bias, (0, pad), value=-1e30)

        remat = self.training and self.remat and torch.is_grad_enabled()

        def run(i, h, kb, layer_shard=None):
            args = (h, kb, layer_seeds[i], layer_shard)
            if remat:
                return checkpoint(stack.layers[i], *args, use_reentrant=False)
            return stack.layers[i](*args)

        acc = hidden.float()
        ys = []
        if pipelined:
            h, layer_sum = gpipe_stack(
                lambda i, h, c, m: run(i, h, c[0], _microbatch(sh, m)),
                cfg.num_layers, copy_to_model(hidden, sh), (key_bias,), sh,
                sh.pipeline_microbatches)
            acc = acc + layer_sum
        else:
            h = hidden
            for i in range(cfg.num_layers):
                h = run(i, h, key_bias)
                acc = acc + h.float()
                if return_all_hidden_states:
                    ys.append(h)
        if _sequence_parallel(sh):
            def whole(y):
                return gather_frames(y, sh, reduce_grad=False)[:, :t_frames]
            h, acc, ys = whole(h), whole(acc), [whole(y) for y in ys]

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
                [first.float()] + [y.float() for y in ys])
        return out


def _microbatch(shard: Shard, m: int) -> Shard:
    """The Shard of a pipeline's layers on microbatch m of this data
    rank's rows: no 'model' axis, and the batch offset of the
    microbatch's first global row."""
    n = shard.pipeline_microbatches
    return Shard(data_rank=shard.data_rank * n + m, n_data=shard.n_data * n)
