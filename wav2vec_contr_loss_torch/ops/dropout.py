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
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..utils.timing import span

__all__ = ["murmur_bits", "murmur_dropout", "attention_dropout_mask",
           "threshold", "draw_seed"]

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


def murmur_dropout(x: torch.Tensor, seed: int, rate: float,
                   offsets: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Inverted dropout with counter-based bits: x / (1 - rate) where the
    bits of an element reach the rate's threshold, else 0. `offsets`:
    where x sits in the tensor the mask is defined over (murmur_bits).
    Under a profiler it is a `w2v.dropout` range."""
    if rate <= 0.0:
        return x
    with span("w2v.dropout"):
        keep = (murmur_bits(x.shape, seed, x.device, offsets)
                >= threshold(rate))
        return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


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
