"""Fused masked-softmax self-attention with murmur dropout, forward and
backward.

Replaces the Pallas kernels of wav2vec_contr_loss_tpu/ops/attention_pallas.py
(`fused_attention`, a custom VJP: `_fwd` -> `_fwd_kernel` and `_bwd` ->
`_bwd_kernel`). The Hopper kernels are CUDA C++ on wgmma and TMA, tiled
by 64 query or key rows, with no bound on T:

  * csrc/attention_fwd.cu: a block per (query tile, head, batch
    element), K/V tiles streamed by TMA, scores and softmax in registers,
    p normalized exactly before dropout and its bf16 rounding, as in
    Pallas. When the inputs need gradients it also writes the backward's
    residuals: the row statistics (max, log of the sum of exp) and
    out_exact, the output with p not rounded to bf16.
  * csrc/attention_bwd.cu: a dq kernel per query tile (which also takes
    D = rowsum(g * out_exact)) and a dk/dv kernel per key tile, both
    recomputing p from the row statistics and the mask from the seed; no
    atomics, so the backward is deterministic.

Both take head dim 64 (both model presets) and bf16 tensors given by
strides (the head dim contiguous, the other strides multiples of 8
elements, 16-byte aligned), so the (B, T, H, 64) view of a projection
output goes in without a copy; the outputs take the layout of q.

`fused_attention` picks its path by whether a gradient is needed:

  * q, k or v needs one: `FusedAttention` on the card (a
    `torch.autograd.Function` whose residuals are q, k, v, bias,
    out_exact, the row statistics and the seed; attention_pallas.py:176
    keeps q, k, v, bias and the seed), `fused_attention_plain` under
    autograd on the CPU;
  * none does (serving, extraction, a frozen encoder): the custom op
    `w2v_torch::attention_fwd`, which launches the forward kernel without
    residuals on the card and runs the plain version on the CPU, its
    output in q's layout either way. A custom op is what `torch.export`
    traces through (its fake gives the output's shape and strides) and
    what a serving artifact calls, so an exported scorer runs the same
    kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ._build import check
from .dropout import attention_dropout_mask, threshold

__all__ = ["fused_attention", "fused_attention_plain", "FusedAttention",
           "attention_fwd", "launches", "bwd_launches"]

# kernel launches through `fused_attention` (forward) and its backward
# (one per backward call, which runs the dq and the dk/dv kernel); read
# and reset by callers
launches = 0
bwd_launches = 0

_TILE = 64        # rows of the kernels' query and key tiles
_D = 64           # the head dim the kernels take


def fused_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: torch.Tensor, seed: int = 0,
                          rate: float = 0.0,
                          seed_stride: Optional[int] = None) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: fp32 logits and softmax, the
    dropout mask of `attention_dropout_mask` applied to the fp32 p, p
    rounded to q's dtype before p . v, fp32 accumulation, output in q's
    dtype. q/k/v: (B, H, T, D); bias: (B, T) fp32; seed_stride as for
    `fused_attention`."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    logits = logits + bias.float()[:, None, None, :]
    p = torch.softmax(logits, dim=-1)
    if rate > 0.0:
        b, h, t, _ = q.shape
        p = p * attention_dropout_mask(b, h, t, seed, rate, q.device,
                                       seed_stride)
    return torch.matmul(p.to(q.dtype).float(), v.float()).to(q.dtype)


_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    from ._build import load

    lib = load("attention_fwd")
    lib.attention_fwd.argtypes = ([_P] * 7 + [_P] * 4 + [_I] * 4
                                  + [ctypes.c_uint] * 3
                                  + [ctypes.c_float, _P])
    lib.attention_fwd.restype = _I
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    from ._build import load

    lib = load("attention_bwd")
    lib.attention_bwd.argtypes = ([_P] * 12 + [_P] * 8 + [_I] * 4
                                  + [ctypes.c_uint] * 3
                                  + [ctypes.c_float, _P])
    lib.attention_bwd.restype = _I
    return lib


def _check(q, k, v, bias) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, H, T, D) shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, t, _ = q.shape
    if bias.shape != (b, t) or bias.dtype != torch.float32:
        raise ValueError(f"bias must be float32 of shape {(b, t)}; got "
                         f"{bias.dtype} {tuple(bias.shape)}")
    devs = {x.device for x in (q, k, v, bias)}
    if len(devs) != 1:
        raise ValueError(f"q, k, v and bias must be on one device; got {devs}")


def _tma_ok(x: torch.Tensor) -> bool:
    """What a TMA tensor map over x takes: the head dim contiguous, the
    other strides positive multiples of 8 elements (16 bytes) below
    2^39 elements, a 16-byte aligned base."""
    sb, sh, st, sd = x.stride()
    return (sd == 1 and x.data_ptr() % 16 == 0
            and all(s > 0 and s % 8 == 0 and s < 2 ** 39
                    for s in (sb, sh, st)))


def _check_cuda(tensors, d: int) -> None:
    if any(x.dtype != torch.bfloat16 for x in tensors):
        raise ValueError("the CUDA attention kernels take bfloat16 q, k, v, g")
    if d != _D:
        raise ValueError(f"the CUDA attention kernels take head dim {_D}; "
                         f"got {d}")
    if not all(_tma_ok(x) for x in tensors):
        raise ValueError(
            "the CUDA attention kernels take tensors whose head dim is "
            "contiguous, whose other strides are positive multiples of 8 "
            "elements, and whose data is 16-byte aligned; got strides "
            f"{[x.stride() for x in tensors]}")


def _strides(x: torch.Tensor):
    return (ctypes.c_longlong * 3)(*x.stride()[:3])


def _dropout_args(seed: int, rate: float, seed_stride: int):
    """(seed as uint32, seed stride, threshold, scale) for the kernels;
    threshold 0 means no dropout."""
    if rate <= 0.0:
        return 0, seed_stride, 0, 1.0
    return (seed & 0xFFFFFFFF, seed_stride, threshold(rate),
            1.0 / (1.0 - rate))


def _padded_rows(t: int) -> int:
    return -(-t // _TILE) * _TILE


def _launch_fwd(q, k, v, bias, seed, rate, seed_stride,
                with_residuals: bool):
    """-> (out, out_exact, stats): out in q's layout; with
    `with_residuals` (else None) what the backward reads: out_exact, the
    output with p not rounded to bf16 (in bf16, out's layout), and stats,
    the fp32 (B, H, Tp, 2) row max and log of the row sum of exp."""
    global launches
    b, h, t, d = q.shape
    _check_cuda((q, k, v), d)
    if not bias.is_contiguous():
        raise ValueError("the CUDA attention kernel takes a contiguous bias")
    lib = _lib()
    out = torch.empty_like(q)
    out_exact = torch.empty_like(out) if with_residuals else None
    stats = (torch.empty(b, h, _padded_rows(t), 2, dtype=torch.float32,
                         device=q.device) if with_residuals else None)
    ss = [_strides(x) for x in (q, k, v, out)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(),
            None if out_exact is None else out_exact.data_ptr(),
            None if stats is None else stats.data_ptr(),
            *(ctypes.addressof(s) for s in ss), b, h, t, d,
            *_dropout_args(seed, rate, seed_stride), stream)
    check(lib, "attention_fwd", err)
    launches += 1
    return out, out_exact, stats


def _launch_bwd(q, k, v, g, out_exact, bias, stats, seed, rate,
                seed_stride):
    global bwd_launches
    b, h, t, d = q.shape
    if not _tma_ok(g):
        g = g.contiguous()   # e.g. an expanded (stride 0) cotangent
    _check_cuda((q, k, v, g), d)
    lib = _bwd_lib()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    tp = _padded_rows(t)
    dbuf = torch.empty(b, h, tp, dtype=torch.float32, device=q.device)
    # the dq kernel's dropout mask words for the dk/dv kernel
    keep = (torch.empty(b * h * (tp // _TILE) ** 2 * 128, dtype=torch.int32,
                        device=q.device) if rate > 0.0 else None)
    ss = [_strides(x) for x in (q, k, v, g, out_exact, dq, dk, dv)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            out_exact.data_ptr(), bias.data_ptr(), stats.data_ptr(),
            dbuf.data_ptr(), None if keep is None else keep.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *(ctypes.addressof(s) for s in ss), b, h, t, d,
            *_dropout_args(seed, rate, seed_stride), stream)
    check(lib, "attention_bwd", err)
    bwd_launches += 1
    return dq, dk, dv


class FusedAttention(torch.autograd.Function):
    """Forward and backward through the CUDA kernels; the residuals are
    q, k, v, bias, the output with p unrounded, the fp32 row statistics
    and the seed, so no probability is stored."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seed: int, rate: float,
                seed_stride: int):
        out, out_exact, stats = _launch_fwd(q, k, v, bias, seed, rate,
                                            seed_stride,
                                            any(ctx.needs_input_grad[:3]))
        ctx.save_for_backward(q, k, v, bias, out_exact, stats)
        ctx.seed, ctx.rate, ctx.seed_stride = seed, rate, seed_stride
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, out_exact, stats = ctx.saved_tensors
        dq, dk, dv = _launch_bwd(q, k, v, g, out_exact, bias, stats,
                                 ctx.seed, ctx.rate, ctx.seed_stride)
        return dq, dk, dv, None, None, None, None


@torch.library.custom_op("w2v_torch::attention_fwd", mutates_args=())
def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: torch.Tensor, seed: int, rate: float,
                  seed_stride: int) -> torch.Tensor:
    """The attention forward with no gradient, in q's layout: the kernel
    (no residuals) for CUDA tensors, the plain version for CPU ones."""
    if q.device.type == "cuda":
        return _launch_fwd(q, k, v, bias, seed, rate, seed_stride, False)[0]
    return torch.empty_like(q).copy_(
        fused_attention_plain(q, k, v, bias, seed, rate, seed_stride))


@attention_fwd.register_fake
def _attention_fwd_fake(q, k, v, bias, seed, rate, seed_stride):
    return torch.empty_like(q)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor, seed: int = 0, rate: float = 0.0,
                    heads: int = 1,
                    seed_stride: Optional[int] = None) -> torch.Tensor:
    """q, k, v: (B, H, T, D), any strides the kernels take (see
    `_check_cuda`; e.g. the (B, H, T, D) view of a (B, T, H, D) tensor);
    bias: (B, T) fp32 additive key mask (-1e30 masked); seed: the dropout
    seed (a Python int; the mask of (b, h) uses seed + b*S + h, S =
    `seed_stride`, H when None: a shard of a gang's (B', H') attention at
    batch b0 and head h0 passes seed + b0*H' + h0 and S = H'); rate:
    attention-probability dropout. -> (B, H, T, D), in q's layout on the
    card. q must arrive pre-scaled (1/sqrt(D)). Same contract as the JAX
    `fused_attention`; `heads` must equal H. Differentiable in q, k and
    v; without a gradient it is the op `w2v_torch::attention_fwd`."""
    _check(q, k, v, bias)
    if heads != q.shape[1]:
        raise ValueError(f"heads={heads} but q has {q.shape[1]} heads")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1); got {rate}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    stride = heads if seed_stride is None else int(seed_stride)
    if not (torch.is_grad_enabled()
            and (q.requires_grad or k.requires_grad or v.requires_grad)):
        return attention_fwd(q, k, v, bias, int(seed), float(rate), stride)
    if q.device.type == "cpu":
        return fused_attention_plain(q, k, v, bias, seed, rate, stride)
    return FusedAttention.apply(q, k, v, bias, int(seed), float(rate),
                                stride)
