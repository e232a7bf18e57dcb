"""Fused masked-softmax self-attention with murmur dropout, forward and
backward.

Replaces the Pallas kernels of wav2vec_contr_loss_tpu/ops/attention_pallas.py
(`fused_attention`, a custom VJP: `_fwd` -> `_fwd_kernel` and `_bwd` ->
`_bwd_kernel`). The Hopper kernels are CUDA C++:

  * csrc/attention_fwd.cu: one block per (head, batch element) at the
    training and serving length, K and V staged once in shared memory,
    both products on the tensor cores, the fp32 scores and softmax never
    leaving the SM; dropout multiplies the normalized p by the murmur mask
    right before its bf16 rounding. At (B=8, H=16, T=249, D=64) it is
    bound by its 16.3 MB of q/k/v/out traffic (4.9 us on an H100).
  * csrc/attention_bwd.cu: one block per (head, batch element) that owns
    all of dq, dk and dv for the pair (no atomics), recomputing p and the
    mask from q, k, the bias and the seed. At (32, 16, 249, 64) it moves
    114 MB (34 us).

Both take head dim 64 (both model presets); the forward keeps all keys in
shared memory up to T = 512, the backward all of q/k/v/g up to T = 256 (a
5 s clip gives 249).

`fused_attention` launches the kernels for CUDA tensors, through
`FusedAttention` (a `torch.autograd.Function` whose residuals are q, k,
v, bias and the seed, as at attention_pallas.py:176), and takes
`fused_attention_plain`, differentiated by autograd, only for tensors on
the CPU.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import check
from .dropout import attention_dropout_mask, threshold

__all__ = ["fused_attention", "fused_attention_plain", "FusedAttention",
           "launches", "bwd_launches"]

# kernel launches through `fused_attention` (forward) and its backward;
# read and reset by callers
launches = 0
bwd_launches = 0

_MAX_T = 512      # keys the forward keeps in shared memory (kMaxT there)
_MAX_T_BWD = 256  # rows the backward keeps in shared memory (kMaxT there)


def fused_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: torch.Tensor, seed: int = 0,
                          rate: float = 0.0) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: fp32 logits and softmax, the
    dropout mask of `attention_dropout_mask` applied to the fp32 p, p
    rounded to q's dtype before p . v, fp32 accumulation, output in q's
    dtype. q/k/v: (B, H, T, D); bias: (B, T) fp32."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    logits = logits + bias.float()[:, None, None, :]
    p = torch.softmax(logits, dim=-1)
    if rate > 0.0:
        b, h, t, _ = q.shape
        p = p * attention_dropout_mask(b, h, t, seed, rate, q.device)
    return torch.matmul(p.to(q.dtype).float(), v.float()).to(q.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    from ._build import load

    lib = load("attention_fwd")
    lib.attention_fwd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                                  + [ctypes.c_uint, ctypes.c_uint,
                                     ctypes.c_float, ctypes.c_void_p])
    lib.attention_fwd.restype = ctypes.c_int
    lib.attention_fwd_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.attention_fwd_smem_bytes.restype = ctypes.c_longlong
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    from ._build import load

    lib = load("attention_bwd")
    lib.attention_bwd.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                                  + [ctypes.c_uint, ctypes.c_uint,
                                     ctypes.c_float, ctypes.c_void_p])
    lib.attention_bwd.restype = ctypes.c_int
    lib.attention_bwd_smem_bytes.argtypes = [ctypes.c_int]
    lib.attention_bwd_smem_bytes.restype = ctypes.c_longlong
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


def _check_cuda(tensors, t: int, d: int, max_t: int) -> None:
    if any(x.dtype != torch.bfloat16 for x in tensors):
        raise ValueError("the CUDA attention kernels take bfloat16 q, k, v, g")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("the CUDA attention kernels take contiguous tensors")
    if d != 64 or t > max_t:
        raise ValueError(f"the CUDA attention kernel takes head dim 64 and "
                         f"T <= {max_t}; got D={d}, T={t}")
    if any(x.data_ptr() % 16 for x in tensors):
        raise ValueError("the CUDA attention kernels take 16-byte aligned "
                         "tensors")


def _dropout_args(seed: int, rate: float):
    """(seed as uint32, threshold, scale) for the kernels; threshold 0
    means no dropout."""
    if rate <= 0.0:
        return 0, 0, 1.0
    return seed & 0xFFFFFFFF, threshold(rate), 1.0 / (1.0 - rate)


def _smem_check(smem: int, device, t: int) -> None:
    limit = torch.cuda.get_device_properties(device).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"T={t} needs {smem} B of shared memory per block; "
                         f"this card allows {limit} B")


def _launch_fwd(q, k, v, bias, seed, rate) -> torch.Tensor:
    global launches
    b, h, t, d = q.shape
    _check_cuda((q, k, v), t, d, _MAX_T)
    if not bias.is_contiguous():
        raise ValueError("the CUDA attention kernel takes a contiguous bias")
    lib = _lib()
    _smem_check(lib.attention_fwd_smem_bytes(t, d), q.device, t)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                bias.data_ptr(), out.data_ptr(), b, h, t, d,
                                *_dropout_args(seed, rate), stream)
    check(lib, "attention_fwd", err)
    launches += 1
    return out


def _launch_bwd(q, k, v, g, bias, seed, rate):
    global bwd_launches
    b, h, t, d = q.shape
    _check_cuda((q, k, v, g), t, d, _MAX_T_BWD)
    lib = _bwd_lib()
    _smem_check(lib.attention_bwd_smem_bytes(t), q.device, t)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.attention_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                g.data_ptr(), bias.data_ptr(), dq.data_ptr(),
                                dk.data_ptr(), dv.data_ptr(), b, h, t, d,
                                *_dropout_args(seed, rate), stream)
    check(lib, "attention_bwd", err)
    bwd_launches += 1
    return dq, dk, dv


class FusedAttention(torch.autograd.Function):
    """Forward and backward through the CUDA kernels; the residuals are
    q, k, v, bias and the seed, so no probability is stored."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seed: int, rate: float):
        ctx.save_for_backward(q, k, v, bias)
        ctx.seed, ctx.rate = seed, rate
        return _launch_fwd(q, k, v, bias, seed, rate)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv = _launch_bwd(q, k, v, g.contiguous(), bias, ctx.seed,
                                 ctx.rate)
        return dq, dk, dv, None, None, None


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor, seed: int = 0, rate: float = 0.0,
                    heads: int = 1) -> torch.Tensor:
    """q, k, v: (B, H, T, D); bias: (B, T) fp32 additive key mask (-1e30
    masked); seed: the dropout seed (a Python int; the mask of (b, h)
    uses seed + b*H + h); rate: attention-probability dropout.
    -> (B, H, T, D). q must arrive pre-scaled (1/sqrt(D)). Same contract
    as the JAX `fused_attention`; `heads` must equal H. Differentiable in
    q, k and v."""
    _check(q, k, v, bias)
    if heads != q.shape[1]:
        raise ValueError(f"heads={heads} but q has {q.shape[1]} heads")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1); got {rate}")
    if q.device.type == "cpu":
        return fused_attention_plain(q, k, v, bias, seed, rate)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return FusedAttention.apply(q, k, v, bias, int(seed), float(rate))
