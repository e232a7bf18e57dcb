"""Plain PyTorch reference of the Wav2Vec2 encoder and the compression
module, in fp32 with TF32 off.

It follows the published Wav2Vec2 description (HuggingFace
`Wav2Vec2Model`, parameter names included) and the project's training
recipe: murmur-hash dropout masks, SpecAugment time masks drawn from the
caller's uniforms, and the K = layers + 1 hidden-state mean that the
compression module reads. It imports nothing of the program under test:
the hashes and the SpecAugment span rule are its own copies, so that the
masks the program derived from a seed are derived here again.

Departures from HuggingFace, each also in the program: a padded key gets
an fp32 bias of -1e30 (not -inf); the positional conv is one plain weight
(no weight norm); the sequence length of a clip is its count of nonzero
samples pushed through the conv stride chain.

`Precision` rounds the operands of every matrix product and convolution:
identity for the reference; for a control that stands in a lower
precision than the configuration states, TF32 (10 mantissa bits) or
float8 (e4m3, one scale a tensor).

With grad enabled each encoder layer runs under non-reentrant
`torch.utils.checkpoint`: autograd keeps a layer's input and recomputes
its activations in the backward, one layer at a time, so a 48-layer
encoder fits on one card. Every mask is a hash of a seed and the
SpecAugment spans come from the caller's uniforms, so the recompute draws
what the forward drew and no number changes.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

_M32 = 0xFFFFFFFF
_AXIS_MULTS = (2654435761, 2246822519, 3266489917, 668265263, 374761393,
               2554388019, 2869860233, 179424673)
_NEG = -1e30


# ---------------------------------------------------------------- precision
def _to_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32's 10 mantissa bits, to nearest, ties to even."""
    bits = x.view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & -0x2000
    return bits.view(torch.float32)


def _to_fp8(x: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 at a per-tensor scale (amax -> 448)."""
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = amax / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


_ROUND = {"tf32": _to_tf32, "fp8": _to_fp8}


class _RoundTrip(torch.autograd.Function):
    """x rounded by `fn`; the gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x, fn):
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class Precision:
    """'fp32': operands as they are; 'tf32' or 'fp8': each operand
    of a product or a convolution rounded to that precision first, with a
    straight-through gradient. (Under 'tf32' `train.run_steps` also runs
    the card's products in TF32, so that the backward's operands round
    too.)"""

    def __init__(self, name: str = "fp32"):
        if name != "fp32" and name not in _ROUND:
            raise ValueError(f"precision must be 'fp32' or one of "
                             f"{sorted(_ROUND)}; got {name!r}")
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "fp32":
            return x
        return _RoundTrip.apply(x, _ROUND[self.name])


FP32 = Precision("fp32")


@contextlib.contextmanager
def tf32(on: bool):
    """The card's fp32 products and convolutions in TF32 (`on`) or in full
    fp32."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


# ------------------------------------------------------------------ hashes
def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _fmix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _threshold(rate: float) -> int:
    return min(int(rate * (2 ** 32)), 2 ** 32 - 1)


def murmur_keep(shape, seed: int, rate: float, device) -> torch.Tensor:
    """Bool keep mask of the murmur3-finalizer dropout over a tensor of
    `shape`: one odd multiplier an axis, a unit axis skipped."""
    h = torch.full((1,) * len(shape),
                   ((seed & _M32) * 0x9E3779B9 + 0x85EBCA6B) & _M32,
                   dtype=torch.int64, device=device)
    for axis, dim in enumerate(shape):
        if dim == 1:
            continue
        view = [1] * len(shape)
        view[axis] = dim
        iota = torch.arange(dim, dtype=torch.int64, device=device).view(view)
        h = h ^ _mul32(iota, _AXIS_MULTS[axis % len(_AXIS_MULTS)])
    return _fmix(h.expand(tuple(shape))) >= _threshold(rate)


def dropout(x: torch.Tensor, seed: Optional[int], rate: float) -> torch.Tensor:
    if seed is None or rate <= 0.0:
        return x
    keep = murmur_keep(x.shape, seed, rate, x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def attention_keep_scale(batch: int, heads: int, t: int, seed: int,
                         rate: float, device) -> torch.Tensor:
    """(B, H, T, T) fp32: 1/(1-rate) where the hash of (query, key, seed +
    b*H + h) reaches the threshold, else 0."""
    r = _mul32(torch.arange(t, dtype=torch.int64, device=device), 2654435761)
    c = _mul32(torch.arange(t, dtype=torch.int64, device=device), 0x9E3779B9)
    bh = (seed + (torch.arange(batch, dtype=torch.int64, device=device)
                  * heads)[:, None]
          + torch.arange(heads, dtype=torch.int64, device=device)[None, :]
          ).reshape(-1) & _M32
    s = (_mul32(bh, 2246822519) + 0x85EBCA6B) & _M32
    keep = _fmix((r[:, None] ^ c[None, :])[None] ^ s[:, None, None]) \
        >= _threshold(rate)
    return torch.where(keep, 1.0 / (1.0 - rate), 0.0).to(
        torch.float32).view(batch, heads, t, t)


# ------------------------------------------------------------- SpecAugment
def max_mask_spans(t_frames: int, cfg: Dict) -> int:
    return max(cfg["mask_time_min_masks"],
               int(cfg["mask_time_prob"] * t_frames
                   / cfg["mask_time_length"]) + 1)


def time_mask(lengths: torch.Tensor, t_frames: int, cfg: Dict,
              eps: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """(B, T') bool SpecAugment time mask: max(int(p len / L + eps),
    min_masks) spans of L frames (capped so they fit), their starts drawn
    from u without replacement by sequential insertion."""
    L, p = cfg["mask_time_length"], cfg["mask_time_prob"]
    n_max = max_mask_spans(t_frames, cfg)
    num = torch.floor(p * lengths.to(torch.float32) / L + eps).to(torch.int64)
    num = num.clamp_min(cfg["mask_time_min_masks"])
    num = torch.minimum(num, lengths // L)
    num = torch.minimum(num, (lengths - (L - 1)).clamp_min(0))
    hi = (lengths - L + 1).clamp_min(1).to(torch.float32)
    starts: List[torch.Tensor] = []
    for i in range(n_max):
        x = torch.floor(u[:, i] * (hi - i).clamp_min(1.0)).to(torch.int64)
        if starts:
            prev = torch.sort(torch.stack(starts, dim=1), dim=1).values
            for j in range(i):
                x = x + (x >= prev[:, j]).to(torch.int64)
        starts.append(x)
    st = torch.stack(starts, dim=1)
    active = torch.arange(n_max, device=lengths.device)[None, :] < num[:, None]
    fr = torch.arange(t_frames, device=lengths.device)[None, None, :]
    spans = (fr >= st[:, :, None]) & (fr < (st + L)[:, :, None])
    return (spans & active[:, :, None]).any(dim=1)


def frame_lengths(n_samples: torch.Tensor, cfg: Dict) -> torch.Tensor:
    n = n_samples
    for k, s in zip(cfg["conv_kernel"], cfg["conv_stride"]):
        n = (n - k) // s + 1
    return n


# ------------------------------------------------------------------ layers
def _linear(x, w, b, prec: Precision):
    return F.linear(prec(x), prec(w), b)


def _conv(x, w, b, prec: Precision, **kw):
    return F.conv1d(prec(x), prec(w), b, **kw)


def _ln(x, p: Dict, name: str, eps: float):
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}.weight"],
                        p[f"{name}.bias"], eps)


def feature_extractor(p: Dict, waves: torch.Tensor, cfg: Dict,
                      prec: Precision) -> torch.Tensor:
    """(B, T) -> (B, T', C)."""
    x = waves[:, None, :]
    eps = cfg["layer_norm_eps"]
    for i, (k, s) in enumerate(zip(cfg["conv_kernel"], cfg["conv_stride"])):
        pre = f"feature_extractor.conv_layers.{i}"
        x = _conv(x, p[f"{pre}.conv.weight"], p.get(f"{pre}.conv.bias"),
                  prec, stride=s)
        if cfg["feat_extract_norm"] == "layer":
            x = _ln(x.transpose(1, 2), p, f"{pre}.layer_norm", eps
                    ).transpose(1, 2)
        elif i == 0:
            x = F.group_norm(x, x.shape[1], p[f"{pre}.layer_norm.weight"],
                             p[f"{pre}.layer_norm.bias"], eps)
        x = F.gelu(x)
    return x.transpose(1, 2)


def attention(p: Dict, pre: str, x: torch.Tensor, key_bias: torch.Tensor,
              seed: Optional[int], rate: float, heads: int,
              prec: Precision) -> torch.Tensor:
    b, t, d = x.shape
    hd = d // heads

    def proj(name):
        return _linear(x, p[f"{pre}.{name}.weight"], p[f"{pre}.{name}.bias"],
                       prec).view(b, t, heads, hd).transpose(1, 2)

    q = proj("q_proj") * hd ** -0.5
    k, v = proj("k_proj"), proj("v_proj")
    logits = torch.matmul(prec(q), prec(k).transpose(-1, -2))
    probs = torch.softmax(logits + key_bias[:, None, None, :], dim=-1)
    if seed is not None and rate > 0.0:
        probs = probs * attention_keep_scale(b, heads, t, seed, rate,
                                             x.device)
    out = torch.matmul(prec(probs), prec(v)).transpose(1, 2).reshape(b, t, d)
    return _linear(out, p[f"{pre}.out_proj.weight"],
                   p[f"{pre}.out_proj.bias"], prec)


def encoder_layer(p: Dict, i: int, x: torch.Tensor, key_bias: torch.Tensor,
                  seeds: Optional[Dict], cfg: Dict,
                  prec: Precision) -> torch.Tensor:
    pre = f"encoder.layers.{i}"
    eps = cfg["layer_norm_eps"]
    s = seeds or {}
    hid = cfg["hidden_dropout"]

    def attend(y):
        a = attention(p, f"{pre}.attention", y, key_bias, s.get("attention"),
                      cfg["attention_dropout"], cfg["num_attention_heads"],
                      prec)
        return dropout(a, s.get("attention_out"), hid)

    def ffn(y):
        ff = f"{pre}.feed_forward"
        y = F.gelu(_linear(y, p[f"{ff}.intermediate_dense.weight"],
                           p[f"{ff}.intermediate_dense.bias"], prec))
        y = dropout(y, s.get("activation"), cfg["activation_dropout"])
        y = _linear(y, p[f"{ff}.output_dense.weight"],
                    p[f"{ff}.output_dense.bias"], prec)
        return dropout(y, s.get("ffn_out"), hid)

    if cfg["do_stable_layer_norm"]:
        x = x + attend(_ln(x, p, f"{pre}.layer_norm", eps))
        return x + ffn(_ln(x, p, f"{pre}.final_layer_norm", eps))
    x = _ln(x + attend(x), p, f"{pre}.layer_norm", eps)
    return _ln(x + ffn(x), p, f"{pre}.final_layer_norm", eps)


def encoder_layer_mean(p: Dict, waves: torch.Tensor, cfg: Dict,
                       draws: Optional[Dict] = None,
                       prec: Precision = FP32) -> torch.Tensor:
    """(B, T) fp32 waves -> (B, T', D) mean of the K = layers + 1 hidden
    states. `draws` (train mode): {'feat_proj', 'encoder_in': seeds,
    'layers': [per-layer seed dicts], 'spans': (eps, u) or None}."""
    eps = cfg["layer_norm_eps"]
    feats = feature_extractor(p, waves, cfg, prec)
    b, t, _ = feats.shape
    lengths = frame_lengths((waves != 0.0).to(torch.int64).sum(-1), cfg)
    frame_mask = torch.arange(t, device=waves.device)[None, :] < lengths[:, None]

    g = draws or {}
    hid = cfg["hidden_dropout"]
    x = _ln(feats, p, "feature_projection.layer_norm", eps)
    x = _linear(x, p["feature_projection.projection.weight"],
                p["feature_projection.projection.bias"], prec)
    x = dropout(x, g.get("feat_proj"), cfg["feat_proj_dropout"])
    if g.get("spans") is not None:
        e, u = (a.to(waves.device) for a in g["spans"])
        span = time_mask(lengths, t, cfg, e, u) & frame_mask
        x = torch.where(span[:, :, None], p["masked_spec_embed"], x)
    x = x * frame_mask[:, :, None].to(x.dtype)
    key_bias = torch.where(frame_mask, 0.0, _NEG).to(torch.float32)

    k = cfg["num_conv_pos_embeddings"]
    pos = _conv(x.transpose(1, 2), p["encoder.pos_conv_embed.conv.weight"],
                p["encoder.pos_conv_embed.conv.bias"], prec, padding=k // 2,
                groups=cfg["num_conv_pos_embedding_groups"])
    if k % 2 == 0:
        pos = pos[:, :, :-1]
    x = x + F.gelu(pos).transpose(1, 2)
    if not cfg["do_stable_layer_norm"]:
        x = _ln(x, p, "encoder.layer_norm", eps)
    x = dropout(x, g.get("encoder_in"), hid)

    layers = g.get("layers") or [None] * cfg["num_hidden_layers"]
    acc = x
    for i in range(cfg["num_hidden_layers"]):
        args = (p, i, x, key_bias, layers[i], cfg, prec)
        x = (checkpoint(encoder_layer, *args, use_reentrant=False)
             if torch.is_grad_enabled() else encoder_layer(*args))
        acc = acc + x
    if cfg["do_stable_layer_norm"]:
        acc = acc - x + _ln(x, p, "encoder.layer_norm", eps)
    return acc / (cfg["num_hidden_layers"] + 1)


def clip_embedding(p: Dict, layer_mean: torch.Tensor,
                   seed: Optional[int] = None, rate: float = 0.0,
                   prec: Precision = FP32) -> torch.Tensor:
    """Compression (dropout, LeakyReLU 0.01, Linear) per frame, the mean
    over frames, then the L2 norm: (B, T', D) -> (B, H)."""
    x = dropout(layer_mean, seed, rate)
    seq = _linear(F.leaky_relu(x, 0.01), p["compression.proj.weight"],
                  p["compression.proj.bias"], prec)
    z = seq.mean(dim=1)
    return z / z.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def conv_out_frames(n: int, cfg: Dict) -> int:
    return int(frame_lengths(torch.tensor(n), cfg))


__all__ = ["Precision", "FP32", "tf32", "dropout", "murmur_keep",
           "attention_keep_scale", "time_mask", "max_mask_spans",
           "frame_lengths", "encoder_layer_mean", "clip_embedding",
           "conv_out_frames"]
