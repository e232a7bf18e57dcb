"""int8 linears for serving: weight-only ('w8') and weights and
activations ('w8a8').

The port of wav2vec_contr_loss_tpu/ops/quant.py (`QuantDense` :51,
`_quantize_dense` :92, `quantize_encoder_params` :107). The six
transformer linears of each layer (`QUANT_TARGETS`, in the port's HF
names; the port has no fused qkv) carry almost all of the encoder's
weight bytes. Their fp32 weights are quantized per output channel,
symmetric, to int8 with an fp32 scale; the conv tower, the feature
projection, the positional conv and every LayerNorm stay fp32.

- 'w8a8': each token's activations are quantized on the fly to int8
  with a per-token scale, the product runs int8 x int8 -> int32 through
  `torch._int_mm` (cuBLASLt's int8 GEMM on the card, H100 1,979 TOPS
  dense against 989 TFLOP/s bf16) and is rescaled in fp32. This is the
  plain large product the JAX package leaves to XLA's `dot_general`,
  not a Pallas kernel, so it goes to the library.
- 'w8': the int8 weight is cast to the compute dtype and multiplied with
  fp32 accumulation (cuBLAS); the weight read is int8.

Serving only: rounding has no gradient, `QuantLinear` refuses tensors
that require grad and the trainers refuse `quant != 'none'`. Quantized
state dicts come only from `quantize_encoder_state_dict` at bind time,
so checkpoints always hold fp32.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
from torch import nn

__all__ = ["QUANT_TARGETS", "QUANT_MODES", "QuantLinear", "quantize_linear",
           "quantize_encoder_state_dict"]

# the encoder's linears that are quantized, by module name
QUANT_TARGETS = frozenset({
    "q_proj", "k_proj", "v_proj", "out_proj",
    "intermediate_dense", "output_dense",
})
QUANT_MODES = ("none", "w8a8", "w8")


def quantize_linear(weight: torch.Tensor, bias: torch.Tensor
                    ) -> Dict[str, torch.Tensor]:
    """An `nn.Linear`'s (out, in) weight and (out,) bias -> {'weight':
    int8 (out, in), 'scale': fp32 (out,), 'bias': fp32 (out,)}: the scale
    of each output channel is max |w| over the inputs (at least 1e-30)
    / 127, the weight round(w / scale) clipped to +-127."""
    w = weight.detach().float()
    scale = w.abs().amax(dim=-1).clamp_min(1e-30) / 127.0
    wq = torch.clamp(torch.round(w / scale[:, None]), -127, 127)
    return {"weight": wq.to(torch.int8), "scale": scale,
            "bias": bias.detach().float()}


def quantize_encoder_state_dict(sd: Mapping[str, torch.Tensor]
                                ) -> Dict[str, torch.Tensor]:
    """An fp32 encoder state dict -> the state dict of the same encoder
    with `quant != 'none'`: exactly the `QUANT_TARGETS` linears are
    quantized (their `.weight` becomes int8, a `.scale` is added); every
    other tensor passes through unchanged."""
    out = {}
    for key, value in sd.items():
        prefix, _, leaf = key.rpartition(".")
        if prefix.rpartition(".")[2] not in QUANT_TARGETS:
            out[key] = value
        elif leaf == "weight":
            out.update({f"{prefix}.{k}": v for k, v in quantize_linear(
                value, sd[f"{prefix}.bias"]).items()})
        elif leaf != "bias":
            raise KeyError(f"unexpected tensor {key!r} in a linear")
    return out


def _check_int_mm(m: int, k: int, n: int) -> None:
    """What cuBLASLt's int8 product through `torch._int_mm` takes on the
    card: more than 16 rows, inner and outer sizes multiples of 8."""
    if m <= 16 or k % 8 or n % 8:
        raise ValueError(
            f"the int8 product (w8a8) on the card takes more than 16 rows "
            f"and inner and outer sizes that are multiples of 8; got "
            f"({m} x {k}) @ ({k} x {n})")


class QuantLinear(nn.Module):
    """`nn.Linear` over an int8 weight with a per-output-channel scale;
    buffers `weight` int8 (out, in), `scale` fp32 (out,), `bias` fp32
    (out,), under the names of the `nn.Linear` it replaces (plus
    `scale`). The output is in `dtype`, the compute dtype."""

    def __init__(self, in_features: int, out_features: int, mode: str,
                 dtype: torch.dtype):
        super().__init__()
        if mode not in ("w8a8", "w8"):
            raise ValueError(f"unknown quant mode {mode!r}")
        self.mode = mode
        self.dtype = dtype
        self.register_buffer("weight", torch.zeros(
            out_features, in_features, dtype=torch.int8))
        self.register_buffer("scale", torch.ones(out_features))
        self.register_buffer("bias", torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.requires_grad and torch.is_grad_enabled():
            raise ValueError("QuantLinear is inference only: its rounding "
                             "has no gradient")
        lead, k = x.shape[:-1], x.shape[-1]
        x2 = x.reshape(-1, k)
        if self.mode == "w8a8":
            xf = x2.float()
            # dynamic symmetric per-token activation scale
            sx = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
            xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
            if x.device.type == "cuda":
                _check_int_mm(xq.shape[0], k, self.weight.shape[0])
            acc = torch._int_mm(xq, self.weight.t())
            y = acc.float() * (sx * self.scale)
        else:
            # fp32 accumulation inside the product; its output is in the
            # compute dtype before the scale
            y = torch.matmul(x2.to(self.dtype),
                             self.weight.to(self.dtype).t()).float()
            y = y * self.scale
        return (y + self.bias).to(self.dtype).reshape(*lead, -1)
