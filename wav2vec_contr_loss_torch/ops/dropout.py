"""Counter-based (murmur3 finalizer) dropout, bit-identical to the JAX
package's hashes for a given integer seed.

Two hashes, as in the JAX package:

  * `murmur_bits` / `murmur_dropout`: the port of
    wav2vec_contr_loss_tpu/ops/fast_dropout.py, one odd multiplier per
    axis over the whole tensor. The encoder's hidden, feature-projection
    and activation dropouts use it.
  * `attention_dropout_mask`: the port of `_random_bits` /
    `_dropout_mask` / `_head_seed` of
    wav2vec_contr_loss_tpu/ops/attention_pallas.py, over (query, key) with
    the per-(batch, head) seed `seed + b*H + h`. The attention kernels
    (csrc/dropout_mask.cuh) compute the same bits in registers; this is
    their plain version.

Both hashes see a tensor's coordinates only through per-axis index
terms, so the mask of a shard is the slice of the global mask: a rank of
a parallel gang passes the offsets of its slice (`murmur_bits`
`offsets`; for attention, the seed of its first (batch, head) and the
global head count as `seed_stride`) and draws exactly what one process
at the global batch draws.

torch on the CPU has no uint32 `>>`, `>=` or `arange`, so the hash runs in
int64 with every product reduced modulo 2^32 (`_mul32` splits the
multiplier so no intermediate leaves int64). The seed is a Python int,
drawn by the caller from its `torch.Generator`; JAX's threefry draw of
that seed (fast_dropout.py:67) is not reproduced.

`murmur_dropout` goes through one autograd Function, `MurmurDropout`,
on every device. On a CUDA tensor (bf16 or fp32) its forward and its
backward each launch csrc/murmur_dropout.cu, which hashes, compares and
scales in one pass over the tensor; the backward runs it on the incoming
gradient, recomputing the mask from the seed, and saves nothing. Any
other dtype is refused on the card. On any other device the forward is
the plain version, `murmur_dropout_plain` (the int64 hash above and
`torch.where(keep, x / (1 - rate), 0)`), and the backward applies its
saved mask as autograd of that expression would. The kernel's output and
gradient equal the plain version's on the same CUDA tensor bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import numpy as np
import torch

from ..utils.timing import span
from ._build import check

__all__ = ["murmur_bits", "murmur_dropout", "murmur_dropout_plain",
           "MurmurDropout", "attention_dropout_mask", "threshold",
           "draw_seed", "launches", "bwd_launches"]

# kernel launches through `murmur_dropout` on the card (forward, the remat
# recompute included) and its backward; read and reset by callers
launches = 0
bwd_launches = 0

_M32 = 0xFFFFFFFF
# distinct odd multipliers per axis (fast_dropout.py:42)
_AXIS_MULTS = (2654435761, 2246822519, 3266489917, 668265263, 374761393,
               2554388019, 2869860233, 179424673)


def threshold(rate: float) -> int:
    """Keep an element when its bits are >= this (attention_pallas.py:74)."""
    return min(int(rate * (2 ** 32)), 2 ** 32 - 1)


def draw_seed(gen: torch.Generator) -> int:
    """One dropout seed in [0, 2^31 - 1), as the JAX code draws it."""
    return int(torch.randint(0, 2 ** 31 - 1, (), generator=gen))


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a constant c."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _fmix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def murmur_bits(shape: Sequence[int], seed: int, device=None,
                offsets: Optional[Sequence[int]] = None) -> torch.Tensor:
    """int64 tensor of uint32 values, indexed by element coordinates and
    seed; equal to fast_dropout.murmur_bits(shape, seed). With `offsets`
    (one per axis) the coordinates start there: the bits of the slice
    at those offsets of a larger tensor."""
    shape = tuple(shape)
    offsets = tuple(offsets) if offsets is not None else (0,) * len(shape)
    if len(offsets) != len(shape):
        raise ValueError(f"{len(offsets)} offsets for a {len(shape)}-d shape")
    h = torch.full((1,) * len(shape),
                   ((seed & _M32) * 0x9E3779B9 + 0x85EBCA6B) & _M32,
                   dtype=torch.int64, device=device)
    for axis, (dim, off) in enumerate(zip(shape, offsets)):
        if dim == 1 and off == 0:   # the JAX hash skips a unit axis
            continue
        view = [1] * len(shape)
        view[axis] = dim
        iota = torch.arange(off, off + dim, dtype=torch.int64,
                            device=device).view(view)
        h = h ^ _mul32(iota, _AXIS_MULTS[axis % len(_AXIS_MULTS)])
    return _fmix(h.expand(shape))


def _keep(x: torch.Tensor, seed: int, rate: float,
          offsets: Optional[Sequence[int]]) -> torch.Tensor:
    return murmur_bits(x.shape, seed, x.device, offsets) >= threshold(rate)


def _apply(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def murmur_dropout_plain(x: torch.Tensor, seed: int, rate: float,
                         offsets: Optional[Sequence[int]] = None
                         ) -> torch.Tensor:
    """The kernel's function in PyTorch: x / (1 - rate) where the bits of
    an element reach the rate's threshold, else 0."""
    return _apply(x, _keep(x, seed, rate, offsets), rate)


_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
_MAX_DIMS = 8     # the kernel's: 7 leading axes and the innermost


@functools.cache
def _lib() -> ctypes.CDLL:
    from ._build import load

    lib = load("murmur_dropout")
    lib.murmur_dropout.argtypes = [_P, _P, _I, _I, _P, _P, _U, _U,
                                   ctypes.c_float, _P]
    lib.murmur_dropout.restype = _I
    return lib


@functools.cache
def _scale(rate: float) -> float:
    """The fp32 reciprocal of 1 - rate: the multiplier by which PyTorch's
    CUDA division of a tensor by that Python scalar scales."""
    return float(np.float32(1.0) / np.float32(1.0 - rate))


def _launch(x: torch.Tensor, seed: int, rate: float,
            offsets: Optional[Sequence[int]]) -> torch.Tensor:
    """csrc/murmur_dropout.cu over x (made contiguous), into a new
    contiguous tensor."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("the CUDA murmur dropout kernel takes bfloat16 or "
                         f"float32; got {x.dtype}")
    if x.dim() > _MAX_DIMS:
        raise ValueError(f"the CUDA murmur dropout kernel takes at most "
                         f"{_MAX_DIMS} axes; got {x.dim()}")
    offsets = tuple(offsets) if offsets is not None else (0,) * x.dim()
    if len(offsets) != x.dim():
        raise ValueError(f"{len(offsets)} offsets for a {x.dim()}-d shape")
    x = x.contiguous()
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    if x.numel() == 0:
        return out
    # a 0-d tensor as one element of a 1-d one: no axis term either way
    shape, offsets = (tuple(x.shape), offsets) if x.dim() else ((1,), (0,))
    n = len(shape)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.murmur_dropout(
            x.data_ptr(), out.data_ptr(), int(x.dtype == torch.float32), n,
            (ctypes.c_longlong * n)(*shape),
            (ctypes.c_longlong * n)(*offsets), seed & _M32,
            threshold(rate), _scale(rate), stream)
    check(lib, "murmur_dropout", err)
    return out


class MurmurDropout(torch.autograd.Function):
    """Murmur dropout and its gradient, the forward applied to the
    incoming gradient: the kernel on a CUDA tensor (the mask recomputed
    from the seed, nothing saved), the plain version elsewhere (its mask
    saved, as autograd of the plain expression saves it)."""

    @staticmethod
    def forward(ctx, x, seed: int, rate: float, offsets):
        global launches
        ctx.seed, ctx.rate, ctx.offsets = seed, rate, offsets
        if x.is_cuda:
            out = _launch(x, seed, rate, offsets)
            launches += 1
            return out
        keep = _keep(x, seed, rate, offsets)
        ctx.save_for_backward(keep)
        return _apply(x, keep, rate)

    @staticmethod
    def backward(ctx, g):
        global bwd_launches
        if g.is_cuda:
            dx = _launch(g, ctx.seed, ctx.rate, ctx.offsets)
            bwd_launches += 1
        else:
            keep, = ctx.saved_tensors
            # WhereBackward0, then DivBackward0
            dx = torch.where(keep, g, torch.zeros_like(g)) / (1.0 - ctx.rate)
        return dx, None, None, None


def murmur_dropout(x: torch.Tensor, seed: int, rate: float,
                   offsets: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Inverted dropout with counter-based bits: x / (1 - rate) where the
    bits of an element reach the rate's threshold, else 0. `offsets`:
    where x sits in the tensor the mask is defined over (murmur_bits).
    On the card one kernel launch (bf16 or fp32), and one in the
    backward. Under a profiler it is a `w2v.dropout` range."""
    if rate <= 0.0:
        return x
    with span("w2v.dropout"):
        return MurmurDropout.apply(
            x, int(seed), float(rate),
            None if offsets is None else tuple(int(o) for o in offsets))


def attention_dropout_mask(batch: int, heads: int, t: int, seed: int,
                           rate: float, device=None,
                           seed_stride: Optional[int] = None
                           ) -> torch.Tensor:
    """(B, H, T, T) fp32 mask of the attention kernels: 1/(1-rate) where
    the murmur hash of (query, key, seed + b*S + h) reaches the threshold,
    else 0 (attention_pallas.py:54-81). S, `seed_stride`, is H by
    default; a shard of a (B', H') mask at batch b0 and head h0 passes
    seed + b0*H' + h0 and S = H'."""
    r = _mul32(torch.arange(t, dtype=torch.int64, device=device), 2654435761)
    c = _mul32(torch.arange(t, dtype=torch.int64, device=device), 0x9E3779B9)
    stride = heads if seed_stride is None else seed_stride
    bh = (seed + (torch.arange(batch, dtype=torch.int64,
                               device=device) * stride)[:, None]
          + torch.arange(heads, dtype=torch.int64, device=device)[None, :]
          ).reshape(-1) & _M32
    s = (_mul32(bh, 2246822519) + 0x85EBCA6B) & _M32
    h = (r[:, None] ^ c[None, :])[None] ^ s[:, None, None]
    keep = _fmix(h) >= threshold(rate)
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32)
    return torch.where(keep, scale.to(device), 0.0).view(batch, heads, t, t)
