"""Fused LayerNorm (+ exact GELU) over the channels of the conv extractor,
forward and backward.

Replaces the Pallas kernels of wav2vec_contr_loss_tpu/ops/conv_ln_pallas.py
(`fused_ln_gelu`, a custom VJP: `_fwd` -> `_fwd_kernel` and `_bwd` ->
`_bwd_kernel`). Row-wise reductions over C=512 with elementwise
epilogues, fp32 statistics, no tensor-core work, both bound by bytes:

  * forward, Triton: one program per block of rows; reads x once and
    writes y once: the 7 launches of one serving batch (8 clips of 5 s,
    253,944 rows of 512 bf16) move 520 MB, 155 us at 3.35 TB/s.
  * backward, CUDA C++ (csrc/ln_gelu_bwd.cu): recomputes the row
    statistics from x, writes dx, and sums dscale/dbias over all rows
    deterministically in two kernels (no atomics): a persistent grid of
    blocks, each a fixed range of rows streamed through a ring of bulk
    copies, one warp a row, the column sums kept in registers and
    written as one partial row pair a block; then a small kernel adds
    the partial rows in block order. The Pallas grid carried that sum
    across its sequential steps (conv_ln_pallas.py:74-113); Hopper runs
    blocks in no order. The rows past n are never loaded, which is the
    Pallas kernel's select-before-stats of the tail rows (:83-87). It
    reads x and dy and writes dx: at the first conv of a training batch
    (32 x 15999 rows) 1.57 GB, 0.47 ms.

Both take x (and dy) all bfloat16 or all float32, scale and bias in
float32, and compute in fp32 either way; the I/O follows x. The Triton
forward is one kernel for both dtypes (the store casts to y's type); the
CUDA backward is a template over the element type with one entry point
each (`ln_gelu_bwd`, `ln_gelu_bwd_f32`): an fp32 stage holds half the
bf16 rows, so the ring and the occupancy stay those of bf16, and the
first conv of a training batch reads and writes 3.15 GB, 0.94 ms. Any
other dtype, or x and dy of different dtypes, is refused on the card.

`fused_ln_gelu` picks its path by whether a gradient is needed: where
x, scale or bias needs one, `FusedLnGelu` (a `torch.autograd.Function`)
on the card and `fused_ln_gelu_plain` under autograd on the CPU; where
none does, the custom op `w2v_torch::ln_gelu_fwd` (the forward kernel on
the card, the plain version on the CPU), which `torch.export` traces
through and a serving artifact calls.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch
import torch.nn.functional as F

from ._build import check

__all__ = ["fused_ln_gelu", "fused_ln_gelu_plain", "FusedLnGelu",
           "ln_gelu_fwd", "launches", "bwd_launches"]

# kernel launches through `fused_ln_gelu` (forward) and its backward
# (one per backward, counting its two kernels as one); read and reset by
# callers
launches = 0
bwd_launches = 0

_BLOCK_ROWS = 8


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


@functools.cache
def _kernels():
    global tl
    from ._build import BUILD_DIR

    # Triton's compiled kernels go beside the nvcc builds, in the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    import triton
    import triton.language as tl

    return triton, triton.jit(_ln_gelu_fwd)


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    from ._build import load

    return _bind_bwd(load("ln_gelu_bwd"))


# the backward's entry points (grid, kernels) for each element type
_BWD_ENTRIES = {torch.bfloat16: ("ln_gelu_bwd_grid", "ln_gelu_bwd"),
                torch.float32: ("ln_gelu_bwd_grid_f32", "ln_gelu_bwd_f32")}


def _bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    for grid, bwd in _BWD_ENTRIES.values():
        getattr(lib, grid).argtypes = [ctypes.c_int, ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_int)]
        getattr(lib, grid).restype = ctypes.c_int
        getattr(lib, bwd).argtypes = ([ctypes.c_void_p] * 8
                                      + [ctypes.c_int, ctypes.c_int,
                                         ctypes.c_float, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_void_p])
        getattr(lib, bwd).restype = ctypes.c_int
    return lib


def _check_cuda(x, scale, bias) -> None:
    if x.dtype not in _BWD_ENTRIES:
        raise ValueError(f"the LN+GELU kernels take bfloat16 or float32 x; "
                         f"got {x.dtype}")
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise ValueError("scale and bias must be float32")
    if not (x.is_contiguous() and scale.is_contiguous()
            and bias.is_contiguous()):
        raise ValueError("the LN+GELU kernels take contiguous tensors")


def _launch(x, scale, bias, eps, gelu) -> torch.Tensor:
    global launches
    _check_cuda(x, scale, bias)
    triton, kernel = _kernels()
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


def _check_bwd(x, dy) -> None:
    """What the CUDA backward takes beyond `_check_cuda`: C a multiple of
    256 up to 1024, dy like x, rows 16-byte aligned for the bulk copies."""
    c = x.shape[-1]
    if c % 256 or not 256 <= c <= 1024:
        raise ValueError(f"the CUDA LN+GELU backward takes C in (256, 512, "
                         f"768, 1024); got C={c}")
    if dy.dtype != x.dtype or dy.shape != x.shape or not dy.is_contiguous():
        raise ValueError("dy must be a contiguous tensor of x's dtype and "
                         "shape")
    if x.data_ptr() % 16 or dy.data_ptr() % 16:
        raise ValueError("x and dy must be 16-byte aligned")


def _launch_bwd(x, dy, scale, bias, eps, gelu):
    global bwd_launches
    _check_cuda(x, scale, bias)
    _check_bwd(x, dy)
    lib = _bwd_lib()
    grid_fn, bwd_fn = _BWD_ENTRIES[x.dtype]
    c = x.shape[-1]
    n = x.numel() // c
    dx = torch.empty_like(x)
    dscale = torch.zeros_like(scale)
    dbias = torch.zeros_like(bias)
    if n:
        with torch.cuda.device(x.device):
            grid = ctypes.c_int(0)
            check(lib, grid_fn,
                  getattr(lib, grid_fn)(n, c, ctypes.byref(grid)))
            part = torch.empty(grid.value, 2, c, dtype=torch.float32,
                               device=x.device)
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = getattr(lib, bwd_fn)(
                x.data_ptr(), dy.data_ptr(), scale.data_ptr(),
                bias.data_ptr(), dx.data_ptr(), part.data_ptr(),
                dscale.data_ptr(), dbias.data_ptr(), n, c, eps, int(gelu),
                grid.value, stream)
        check(lib, bwd_fn, err)
        bwd_launches += 1
    return dx, dscale, dbias


class FusedLnGelu(torch.autograd.Function):
    """Forward through the Triton kernel, backward through the CUDA one;
    the residuals are x, scale and bias (the statistics are recomputed)."""

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


@torch.library.custom_op("w2v_torch::ln_gelu_fwd", mutates_args=())
def ln_gelu_fwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float, gelu: bool) -> torch.Tensor:
    """The LN+GELU forward with no gradient, contiguous: the Triton kernel
    for CUDA tensors, the plain version for CPU ones."""
    if x.device.type == "cuda":
        return _launch(x, scale, bias, eps, gelu)
    return fused_ln_gelu_plain(x, scale, bias, eps, gelu).contiguous()


@ln_gelu_fwd.register_fake
def _ln_gelu_fwd_fake(x, scale, bias, eps, gelu):
    return x.new_empty(x.shape)


def fused_ln_gelu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-5, gelu: bool = True) -> torch.Tensor:
    """gelu(LayerNorm(x) * scale + bias) over the last dim of (..., C).
    x in the compute dtype (bf16 or fp32 on the card); scale/bias (C,)
    fp32. gelu=False gives plain
    LN. Same contract as the JAX `fused_ln_gelu`; differentiable in x,
    scale and bias; without a gradient it is the op
    `w2v_torch::ln_gelu_fwd`."""
    c = x.shape[-1]
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"scale and bias must have shape {(c,)}; got "
                         f"{tuple(scale.shape)}, {tuple(bias.shape)}")
    devs = {x.device, scale.device, bias.device}
    if len(devs) != 1:
        raise ValueError(f"x, scale and bias must be on one device; got {devs}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if not (torch.is_grad_enabled() and (
            x.requires_grad or scale.requires_grad or bias.requires_grad)):
        return ln_gelu_fwd(x, scale, bias, float(eps), bool(gelu))
    if x.device.type == "cpu":
        return fused_ln_gelu_plain(x, scale, bias, eps, gelu)
    return FusedLnGelu.apply(x, scale, bias, float(eps), bool(gelu))
