"""Peaks of one H100 SXM and the operations and bytes of the work, from
shapes alone.

Peaks are NVIDIA's published dense rates at the full 700 W: a card set
to a lower power limit runs below them, so every share is printed beside
the card's limit. A kernel's least time is the larger of its bytes over
the HBM rate and its operations over the rate of the units it runs on;
each input byte is counted read once and each output byte written once.
The kernel counts are those the project's kernel table uses, with E the
bytes of an element of the kernel's I/O (2 at bfloat16, 4 at float32):

  attention forward   bytes 4 B H T D E + B T * 4 (q, k, v read, out
                      written; the fp32 key bias), 4 B H T^2 D operations;
  attention backward  bytes 7 B H T D E + B T * 4 (q, k, v and dout
                      read, dq, dk and dv written; the bias), 10 B H T^2 D
                      operations;
  LN+GELU forward     bytes 2 N E + 2 C * 4, 16 N fp32 operations;
  LN+GELU backward    bytes 3 N E + 4 C * 4, 30 N fp32 operations,

with N = rows * C. Attention's products run on the bf16 tensor cores at
bfloat16; at float32 they cost the lesser of three TF32 products each
(3xTF32, what the fp32 kernels run) and one pass on FFMA. The model's
operations count each multiply-add of a product or a convolution as two;
a training step is three forwards (forward, and the backward's two
products a layer), recomputation not counted.
"""

from __future__ import annotations

from typing import Dict

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
TF32_FLOP_PER_S = 494.7e12
FP32_FLOP_PER_S = 67e12
ELEMENT_BYTES = {"bfloat16": 2, "float32": 4}


def least_seconds(nbytes: float, flops: float, flop_rate: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / flop_rate)


def _attention(b: int, h: int, t: int, d: int, tensors: int, flops: float,
               dtype: str) -> float:
    nbytes = tensors * b * h * t * d * ELEMENT_BYTES[dtype] + b * t * 4
    if dtype == "float32":
        return min(least_seconds(nbytes, 3 * flops, TF32_FLOP_PER_S),
                   least_seconds(nbytes, flops, FP32_FLOP_PER_S))
    return least_seconds(nbytes, flops, BF16_FLOP_PER_S)


def attention_fwd(b: int, h: int, t: int, d: int,
                  dtype: str = "bfloat16") -> float:
    return _attention(b, h, t, d, 4, 4 * b * h * t * t * d, dtype)


def attention_bwd(b: int, h: int, t: int, d: int,
                  dtype: str = "bfloat16") -> float:
    return _attention(b, h, t, d, 7, 5 * 2 * b * h * t * t * d, dtype)


def ln_gelu_fwd(rows: int, c: int, dtype: str = "bfloat16") -> float:
    n = rows * c
    return least_seconds(2 * n * ELEMENT_BYTES[dtype] + 2 * c * 4, 16 * n,
                         FP32_FLOP_PER_S)


def ln_gelu_bwd(rows: int, c: int, dtype: str = "bfloat16") -> float:
    n = rows * c
    return least_seconds(3 * n * ELEMENT_BYTES[dtype] + 4 * c * 4, 30 * n,
                         FP32_FLOP_PER_S)


def conv_lengths(cfg: Dict, samples: int):
    """Output frames of each extractor conv for a clip of `samples`."""
    out, n = [], samples
    for k, s in zip(cfg["conv_kernel"], cfg["conv_stride"]):
        n = (n - k) // s + 1
        out.append(n)
    return out


def forward_flops(cfg: Dict, samples: int,
                  compression_dim: int = 256) -> Dict[str, float]:
    """Operations of one clip's forward, by part."""
    lens = conv_lengths(cfg, samples)
    cins = [1] + list(cfg["conv_dim"][:-1])
    conv = sum(2.0 * ci * co * k * n for ci, co, k, n in
               zip(cins, cfg["conv_dim"], cfg["conv_kernel"], lens))
    t, d, f = lens[-1], cfg["hidden_size"], cfg["intermediate_size"]
    pos = 2.0 * t * d * (d // cfg["num_conv_pos_embedding_groups"]) \
        * cfg["num_conv_pos_embeddings"]
    layer = 2.0 * t * (4 * d * d + 2 * d * f) + 4.0 * t * t * d
    proj = 2.0 * t * cfg["conv_dim"][-1] * d + 2.0 * t * d * compression_dim
    return {"conv": conv, "pos_conv": pos,
            "layers": layer * cfg["num_hidden_layers"], "projections": proj}


def clip_forward_flops(cfg: Dict, samples: int) -> float:
    return sum(forward_flops(cfg, samples).values())


def train_step_flops(cfg: Dict, samples: int, batch: int) -> float:
    return 3.0 * batch * clip_forward_flops(cfg, samples)


def ln_gelu_rows(cfg: Dict, samples: int, batch: int):
    """Rows (batch * frames) of each conv's LayerNorm+GELU."""
    return [batch * n for n in conv_lengths(cfg, samples)]
