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

Both take head dims 64 (XLS-R 300M, large-960h), 80 (XLS-R 1B) and 120
(XLS-R 2B), one template instantiated for each: a row of 80 or 120 is
two 64-column tiles in shared memory, the columns past the row TMA's
zeros, so q . k^T at 120 runs over 128 columns with no copy of q, k or v
in device memory. They take bf16 tensors given by strides (the head dim
contiguous, the other strides multiples of 8 elements, 16-byte
aligned), so the (B, T, H, D) view of a projection output goes in
without a copy; the outputs take the layout of q. The dropout mask does
not depend on D.

fp32 q, k, v (and g) go to fp32 counterparts of both, which compute what
the plain version computes in fp32, nothing rounded to bf16 (JAX's
default XLA attention under fp32 compute; the Pallas kernel rounds q, k,
v and p to bf16 even under fp32 I/O). The tensor cores take fp32 only as
TF32, so both run 3xTF32 (csrc/f32_tiles.cuh): each operand split into
hi = tf32(x) and lo = tf32(x - hi), each product lo.hi + hi.lo + hi.hi
in fp32, about as accurate as an fp32 product. Tiles land by TMA.

  * csrc/attention_fwd_f32.cu: a block per (query tile, head, batch
    element), one pass with an online softmax over the key tiles (the
    scores by wgmma, p . v by mma.sync), the same row statistics; it
    writes no out_exact, since in fp32 that is the output itself.
  * csrc/attention_bwd_f32.cu: the same dq and dk/dv kernels, no atomics.

They take head dim 64 only and tensors whose head dim is contiguous and
whose other strides are multiples of 4 elements (16-byte aligned). Any
other dtype, or q, k, v (and g) of mixed dtypes, is refused on the card;
the fp32 kernels count in the same `launches` and `bwd_launches`.

`fused_attention` is a `w2v.attention` range under a profiler: the
forward and a remat recompute; the backward's launches come from
autograd, outside it.

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

import collections
import ctypes
import functools
from typing import Optional

import torch

from ..utils.timing import span
from ._build import check
from .dropout import attention_dropout_mask, threshold

__all__ = ["fused_attention", "fused_attention_plain", "FusedAttention",
           "attention_fwd", "launches", "bwd_launches", "head_dim_launches",
           "head_dim_bwd_launches", "HEAD_DIMS"]

# kernel launches through `fused_attention` (forward) and its backward
# (one per backward call, which runs the dq and the dk/dv kernel); read
# and reset by callers
launches = 0
bwd_launches = 0
# the same launches by head dim, {head dim: launches}; read and cleared
# by callers
head_dim_launches: collections.Counter = collections.Counter()
head_dim_bwd_launches: collections.Counter = collections.Counter()

_TILE = 64        # rows of the kernels' query and key tiles
# the head dims each kernel pair takes, by dtype
HEAD_DIMS = {torch.bfloat16: (64, 80, 120), torch.float32: (64,)}


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
def _lib_f32() -> ctypes.CDLL:
    from ._build import load

    lib = load("attention_fwd_f32")
    lib.attention_fwd_f32.argtypes = ([_P] * 6 + [_P] * 4 + [_I] * 4
                                      + [ctypes.c_uint] * 3
                                      + [ctypes.c_float, _P])
    lib.attention_fwd_f32.restype = _I
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


@functools.cache
def _bwd_lib_f32() -> ctypes.CDLL:
    from ._build import load

    lib = load("attention_bwd_f32")
    lib.attention_bwd_f32.argtypes = ([_P] * 11 + [_P] * 8 + [_I] * 4
                                      + [ctypes.c_uint] * 3
                                      + [ctypes.c_float, _P])
    lib.attention_bwd_f32.restype = _I
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


def _f32_ok(x: torch.Tensor) -> bool:
    """What an fp32 TMA tensor map over x takes: the head dim contiguous,
    the other strides positive multiples of 4 elements (16 bytes) below
    2^38 elements, a 16-byte aligned base."""
    sb, sh, st, sd = x.stride()
    return (sd == 1 and x.data_ptr() % 16 == 0
            and all(s > 0 and s % 4 == 0 and s < 2 ** 38
                    for s in (sb, sh, st)))


_LAYOUT_OK = {torch.bfloat16: _tma_ok, torch.float32: _f32_ok}


def _check_cuda(tensors, d: int) -> torch.dtype:
    """Refuse what neither kernel pair takes. -> the common dtype, which
    picks the pair: bfloat16 the bf16 kernels, float32 the 3xTF32 ones."""
    dtypes = {x.dtype for x in tensors}
    if len(dtypes) != 1 or not dtypes <= set(_LAYOUT_OK):
        raise ValueError("the CUDA attention kernels take q, k, v, g all "
                         "bfloat16 or all float32; got "
                         f"{[x.dtype for x in tensors]}")
    dtype = dtypes.pop()
    if d not in HEAD_DIMS[dtype]:
        raise ValueError(
            "the CUDA attention kernels take head dims "
            f"{list(HEAD_DIMS[torch.bfloat16])} in bfloat16 and "
            f"{list(HEAD_DIMS[torch.float32])} in float32; got {d} in "
            f"{str(dtype).removeprefix('torch.')}")
    if not all(_LAYOUT_OK[dtype](x) for x in tensors):
        mult = 8 if dtype == torch.bfloat16 else 4
        raise ValueError(
            "the CUDA attention kernels take tensors whose head dim is "
            f"contiguous, whose other strides are positive multiples of "
            f"{mult} elements, and whose data is 16-byte aligned; got "
            f"strides {[x.stride() for x in tensors]}")
    return dtype


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
    output with p not rounded to bf16 (in bf16, out's layout; in fp32 out
    itself), and stats, the fp32 (B, H, Tp, 2) row max and log of the row
    sum of exp."""
    global launches
    b, h, t, d = q.shape
    f32 = _check_cuda((q, k, v), d) == torch.float32
    if not bias.is_contiguous():
        raise ValueError("the CUDA attention kernel takes a contiguous bias")
    out = torch.empty_like(q)
    out_exact = (None if not with_residuals
                 else out if f32 else torch.empty_like(out))
    stats = (torch.empty(b, h, _padded_rows(t), 2, dtype=torch.float32,
                         device=q.device) if with_residuals else None)
    ss = [_strides(x) for x in (q, k, v, out)]
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr()]
    if not f32:
        ptrs.append(None if out_exact is None else out_exact.data_ptr())
    ptrs.append(None if stats is None else stats.data_ptr())
    lib, name = ((_lib_f32(), "attention_fwd_f32") if f32
                 else (_lib(), "attention_fwd"))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, name)(
            *ptrs, *(ctypes.addressof(s) for s in ss), b, h, t, d,
            *_dropout_args(seed, rate, seed_stride), stream)
    check(lib, name, err)
    launches += 1
    head_dim_launches[d] += 1
    return out, out_exact, stats


def _launch_bwd(q, k, v, g, out_exact, bias, stats, seed, rate,
                seed_stride):
    global bwd_launches
    b, h, t, d = q.shape
    if g.dtype in _LAYOUT_OK and not _LAYOUT_OK[g.dtype](g):
        g = g.contiguous()   # e.g. an expanded (stride 0) cotangent
    if _check_cuda((q, k, v, g), d) == torch.float32:
        return _launch_bwd_f32(q, k, v, g, out_exact, bias, stats, seed,
                               rate, seed_stride)
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
    head_dim_bwd_launches[d] += 1
    return dq, dk, dv


def _launch_bwd_f32(q, k, v, g, out, bias, stats, seed, rate, seed_stride):
    """The fp32 backward: `out` is the forward's output (its out_exact)."""
    global bwd_launches
    b, h, t, d = q.shape
    lib = _bwd_lib_f32()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dbuf = torch.empty(b, h, _padded_rows(t), dtype=torch.float32,
                       device=q.device)
    ss = [_strides(x) for x in (q, k, v, g, out, dq, dk, dv)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.attention_bwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            out.data_ptr(), bias.data_ptr(), stats.data_ptr(),
            dbuf.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *(ctypes.addressof(s) for s in ss), b, h, t, d,
            *_dropout_args(seed, rate, seed_stride), stream)
    check(lib, "attention_bwd_f32", err)
    bwd_launches += 1
    head_dim_bwd_launches[d] += 1
    return dq, dk, dv


class FusedAttention(torch.autograd.Function):
    """Forward and backward through the CUDA kernels of q's dtype (bf16
    or fp32); the residuals are q, k, v, bias, the output with p
    unrounded (in fp32 the output itself), the fp32 row statistics and
    the seed, so no probability is stored."""

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
    of q's dtype (no residuals) for CUDA tensors, the plain version for
    CPU ones."""
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
    """q, k, v: (B, H, T, D), all bf16 or all fp32 on the card, any
    strides the kernels take (see `_check_cuda`; e.g. the (B, H, T, D)
    view of a (B, T, H, D) tensor);
    bias: (B, T) fp32 additive key mask (-1e30 masked); seed: the dropout
    seed (a Python int; the mask of (b, h) uses seed + b*S + h, S =
    `seed_stride`, H when None: a shard of a gang's (B', H') attention at
    batch b0 and head h0 passes seed + b0*H' + h0 and S = H'); rate:
    attention-probability dropout. -> (B, H, T, D), in q's layout on the
    card. q must arrive pre-scaled (1/sqrt(D)). Same contract as the JAX
    `fused_attention`; `heads` must equal H. Differentiable in q, k and
    v; without a gradient it is the op `w2v_torch::attention_fwd`. Under
    a profiler it is a `w2v.attention` range."""
    _check(q, k, v, bias)
    if heads != q.shape[1]:
        raise ValueError(f"heads={heads} but q has {q.shape[1]} heads")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1); got {rate}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    stride = heads if seed_stride is None else int(seed_stride)
    with span("w2v.attention"):
        if not (torch.is_grad_enabled()
                and (q.requires_grad or k.requires_grad or v.requires_grad)):
            return attention_fwd(q, k, v, bias, int(seed), float(rate),
                                 stride)
        if q.device.type == "cpu":
            return fused_attention_plain(q, k, v, bias, seed, rate, stride)
        return FusedAttention.apply(q, k, v, bias, int(seed), float(rate),
                                    stride)
