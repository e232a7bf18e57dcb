"""Fused LayerNorm (+ exact GELU) over the channels of the conv extractor,
forward and backward.

Replaces the Pallas kernels of wav2vec_contr_loss_tpu/ops/conv_ln_pallas.py
(`fused_ln_gelu`, a custom VJP: `_fwd` -> `_fwd_kernel` and `_bwd` ->
`_bwd_kernel`). The Hopper kernels are Triton, row-wise reductions over
C=512 with elementwise epilogues, fp32 statistics, no tensor-core work:

  * forward: one program per block of rows; reads x once and writes y
    once, so it is bound by bytes: the 7 launches of one serving batch
    (8 clips of 5 s, 253,944 rows of 512 bf16) move 520 MB, 155 us at
    3.35 TB/s.
  * backward: recomputes the row statistics from x, writes dx, and sums
    dscale/dbias over all rows deterministically in two passes (no
    atomics): each program adds its rows into its own partial-sum row
    of a `torch.empty` buffer, then a second small kernel adds the
    partial rows in a fixed order. The Pallas grid carried that sum
    across its sequential steps (conv_ln_pallas.py:74-113); Hopper runs
    blocks in no order. Its select-before-stats of the tail rows
    (:83-87) is the row mask. It reads x and dy and writes dx: at the
    first conv of a training batch (32 x 15999 rows) 1.57 GB, 0.47 ms.

`fused_ln_gelu` launches the kernels for CUDA tensors, through
`FusedLnGelu` (a `torch.autograd.Function`), and takes
`fused_ln_gelu_plain`, differentiated by autograd, only for tensors on
the CPU.
"""

from __future__ import annotations

import functools
import os

import torch
import torch.nn.functional as F

__all__ = ["fused_ln_gelu", "fused_ln_gelu_plain", "FusedLnGelu",
           "launches", "bwd_launches"]

# kernel launches through `fused_ln_gelu` (forward) and its backward
# (one per backward, counting its two kernels as one); read and reset by
# callers
launches = 0
bwd_launches = 0

_BLOCK_ROWS = 8
_BWD_ITERS = 32      # row blocks per backward program: 256 rows each


def fused_ln_gelu_plain(x: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, eps: float = 1e-5,
                        gelu: bool = True) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: fp32 statistics, biased
    variance, rsqrt(var + eps), scale and bias, then exact-erf GELU;
    output in x's dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(-1, keepdim=True)
    h = xc * torch.rsqrt(var + eps) * scale.float() + bias.float()
    if gelu:
        h = F.gelu(h)
    return h.to(x.dtype)


# triton.language, bound by `_kernel` at first launch: this module imports
# without triton, and the kernel body reads `tl` as a module global
tl = None


def _ln_gelu_fwd(x_ptr, s_ptr, b_ptr, y_ptr, n_rows, n_cols, eps,
                 GELU: tl.constexpr, BLOCK_R: tl.constexpr,
                 BLOCK_C: tl.constexpr):
    """One program normalizes BLOCK_R rows of n_cols channels; the tail
    block masks the rows past n_rows."""
    rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
    cols = tl.arange(0, BLOCK_C)
    cmask = cols < n_cols
    mask = (rows < n_rows)[:, None] & cmask[None, :]
    offs = rows.to(tl.int64)[:, None] * n_cols + cols[None, :]
    x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    mean = tl.sum(x, axis=1) / n_cols
    xc = tl.where(mask, x - mean[:, None], 0.0)
    var = tl.sum(xc * xc, axis=1) / n_cols
    rstd = 1.0 / tl.sqrt(var + eps)
    s = tl.load(s_ptr + cols, mask=cmask, other=0.0)
    b = tl.load(b_ptr + cols, mask=cmask, other=0.0)
    h = xc * rstd[:, None] * s[None, :] + b[None, :]
    if GELU:
        h = 0.5 * h * (1.0 + tl.erf(h * 0.7071067811865476))
    tl.store(y_ptr + offs, h.to(y_ptr.dtype.element_ty), mask=mask)


def _ln_gelu_bwd(x_ptr, dy_ptr, s_ptr, b_ptr, dx_ptr, part_ptr, n_rows,
                 n_cols, eps, GELU: tl.constexpr, BLOCK_R: tl.constexpr,
                 BLOCK_C: tl.constexpr, ITERS: tl.constexpr):
    """One program takes ITERS blocks of BLOCK_R rows: recomputes the
    statistics, writes dx, and writes its sums of dh*xhat and dh into
    row 2*pid and 2*pid + 1 of the partial-sum buffer."""
    pid = tl.program_id(0)
    cols = tl.arange(0, BLOCK_C)
    cmask = cols < n_cols
    s = tl.load(s_ptr + cols, mask=cmask, other=0.0)
    b = tl.load(b_ptr + cols, mask=cmask, other=0.0)
    acc_s = tl.zeros((BLOCK_C,), tl.float32)
    acc_b = tl.zeros((BLOCK_C,), tl.float32)
    for it in range(ITERS):
        rows = (pid * ITERS + it) * BLOCK_R + tl.arange(0, BLOCK_R)
        mask = (rows < n_rows)[:, None] & cmask[None, :]
        offs = rows.to(tl.int64)[:, None] * n_cols + cols[None, :]
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        dy = tl.load(dy_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        mean = tl.sum(x, axis=1) / n_cols
        xc = tl.where(mask, x - mean[:, None], 0.0)
        var = tl.sum(xc * xc, axis=1) / n_cols
        rstd = 1.0 / tl.sqrt(var + eps)
        xhat = xc * rstd[:, None]
        if GELU:
            h = xhat * s[None, :] + b[None, :]
            phi = 0.5 * (1.0 + tl.erf(h * 0.7071067811865476))
            dh = dy * (phi + h * 0.3989422804014327 * tl.exp(-0.5 * h * h))
        else:
            dh = dy
        dh = tl.where(mask, dh, 0.0)
        dxhat = dh * s[None, :]
        m1 = tl.sum(dxhat, axis=1) / n_cols
        m2 = tl.sum(dxhat * xhat, axis=1) / n_cols
        dx = rstd[:, None] * (dxhat - m1[:, None] - xhat * m2[:, None])
        tl.store(dx_ptr + offs, dx.to(dx_ptr.dtype.element_ty), mask=mask)
        acc_s += tl.sum(dh * xhat, axis=0)
        acc_b += tl.sum(dh, axis=0)
    base = part_ptr + pid.to(tl.int64) * 2 * n_cols
    tl.store(base + cols, acc_s, mask=cmask)
    tl.store(base + n_cols + cols, acc_b, mask=cmask)


def _sum_partials(part_ptr, ds_ptr, db_ptr, n_parts, n_cols,
                  BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr):
    """Adds the partial rows of BLOCK_C columns in a fixed order:
    dscale from the even rows, dbias from the odd ones."""
    cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = cols < n_cols
    acc_s = tl.zeros((BLOCK_C,), tl.float32)
    acc_b = tl.zeros((BLOCK_C,), tl.float32)
    for p0 in range(0, n_parts, BLOCK_P):
        parts = p0 + tl.arange(0, BLOCK_P)
        mask = (parts < n_parts)[:, None] & cmask[None, :]
        offs = parts.to(tl.int64)[:, None] * 2 * n_cols + cols[None, :]
        acc_s += tl.sum(tl.load(part_ptr + offs, mask=mask, other=0.0), 0)
        acc_b += tl.sum(tl.load(part_ptr + offs + n_cols, mask=mask,
                                other=0.0), 0)
    tl.store(ds_ptr + cols, acc_s, mask=cmask)
    tl.store(db_ptr + cols, acc_b, mask=cmask)


@functools.cache
def _kernels():
    global tl
    from ._build import BUILD_DIR

    # Triton's compiled kernels go beside the nvcc builds, in the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    import triton
    import triton.language as tl

    return (triton, triton.jit(_ln_gelu_fwd), triton.jit(_ln_gelu_bwd),
            triton.jit(_sum_partials))


def _check_cuda(x, scale, bias) -> None:
    if x.dtype != torch.bfloat16:
        raise ValueError("the Triton LN+GELU kernel takes bfloat16 x")
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise ValueError("scale and bias must be float32")
    if not (x.is_contiguous() and scale.is_contiguous()
            and bias.is_contiguous()):
        raise ValueError("the Triton LN+GELU kernel takes contiguous tensors")


def _launch(x, scale, bias, eps, gelu) -> torch.Tensor:
    global launches
    _check_cuda(x, scale, bias)
    triton, kernel, _, _ = _kernels()
    c = x.shape[-1]
    n = x.numel() // c
    y = torch.empty_like(x)
    if n:
        with torch.cuda.device(x.device):
            kernel[(triton.cdiv(n, _BLOCK_ROWS),)](
                x, scale, bias, y, n, c, eps, GELU=gelu,
                BLOCK_R=_BLOCK_ROWS, BLOCK_C=triton.next_power_of_2(c),
                num_warps=4)
        launches += 1
    return y


def _launch_bwd(x, dy, scale, bias, eps, gelu):
    global bwd_launches
    _check_cuda(x, scale, bias)
    if dy.dtype != x.dtype or dy.shape != x.shape or not dy.is_contiguous():
        raise ValueError("dy must be a contiguous tensor of x's dtype and "
                         "shape")
    triton, _, kernel, reduce = _kernels()
    c = x.shape[-1]
    n = x.numel() // c
    dx = torch.empty_like(x)
    dscale = torch.zeros_like(scale)
    dbias = torch.zeros_like(bias)
    if n:
        n_parts = triton.cdiv(n, _BLOCK_ROWS * _BWD_ITERS)
        part = torch.empty(n_parts, 2, c, dtype=torch.float32,
                           device=x.device)
        block_c = triton.next_power_of_2(c)
        with torch.cuda.device(x.device):
            kernel[(n_parts,)](x, dy, scale, bias, dx, part, n, c, eps,
                               GELU=gelu, BLOCK_R=_BLOCK_ROWS,
                               BLOCK_C=block_c, ITERS=_BWD_ITERS, num_warps=4)
            reduce[(triton.cdiv(c, 128),)](part, dscale, dbias, n_parts, c,
                                           BLOCK_P=32, BLOCK_C=128,
                                           num_warps=4)
        bwd_launches += 1
    return dx, dscale, dbias


class FusedLnGelu(torch.autograd.Function):
    """Forward and backward through the Triton kernels; the residuals are
    x, scale and bias (the statistics are recomputed)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps: float, gelu: bool):
        ctx.save_for_backward(x, scale, bias)
        ctx.eps, ctx.gelu = eps, gelu
        return _launch(x, scale, bias, eps, gelu)

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias = ctx.saved_tensors
        dx, dscale, dbias = _launch_bwd(x, dy.contiguous(), scale, bias,
                                        ctx.eps, ctx.gelu)
        return dx, dscale, dbias, None, None


def fused_ln_gelu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-5, gelu: bool = True) -> torch.Tensor:
    """gelu(LayerNorm(x) * scale + bias) over the last dim of (..., C).
    x in the compute dtype; scale/bias (C,) fp32. gelu=False gives plain
    LN. Same contract as the JAX `fused_ln_gelu`; differentiable in x,
    scale and bias."""
    c = x.shape[-1]
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"scale and bias must have shape {(c,)}; got "
                         f"{tuple(scale.shape)}, {tuple(bias.shape)}")
    devs = {x.device, scale.device, bias.device}
    if len(devs) != 1:
        raise ValueError(f"x, scale and bias must be on one device; got {devs}")
    if x.device.type == "cpu":
        return fused_ln_gelu_plain(x, scale, bias, eps, gelu)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return FusedLnGelu.apply(x, scale, bias, float(eps), bool(gelu))
