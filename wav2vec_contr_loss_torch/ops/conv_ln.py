"""Fused LayerNorm (+ exact GELU) over the channels of the conv extractor.

Replaces the forward Pallas kernel of
wav2vec_contr_loss_tpu/ops/conv_ln_pallas.py (`fused_ln_gelu` -> `_fwd`
-> `_fwd_kernel`). The Hopper kernel is Triton: a row-wise reduction over
C=512 with an elementwise epilogue, one program per block of rows, fp32
statistics, no tensor-core work. It reads x once and writes y once, so it
is bound by bytes: the 7 launches of one serving batch (8 clips of 5 s,
253,944 rows of 512 bf16) move 520 MB, 155 us at 3.35 TB/s.

`fused_ln_gelu` launches the kernel for CUDA tensors and takes
`fused_ln_gelu_plain` only for tensors on the CPU.
"""

from __future__ import annotations

import functools
import os

import torch
import torch.nn.functional as F

__all__ = ["fused_ln_gelu", "fused_ln_gelu_plain", "launches"]

# kernel launches through `fused_ln_gelu`; read and reset by callers
launches = 0

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
def _kernel():
    global tl
    from ._build import BUILD_DIR

    # Triton's compiled kernels go beside the nvcc builds, in the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    import triton
    import triton.language as tl

    return triton, triton.jit(_ln_gelu_fwd)


def _launch(x, scale, bias, eps, gelu) -> torch.Tensor:
    global launches
    if x.dtype != torch.bfloat16:
        raise ValueError("the Triton LN+GELU kernel takes bfloat16 x")
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise ValueError("scale and bias must be float32")
    if not (x.is_contiguous() and scale.is_contiguous()
            and bias.is_contiguous()):
        raise ValueError("the Triton LN+GELU kernel takes contiguous tensors")
    triton, kernel = _kernel()
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


def fused_ln_gelu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-5, gelu: bool = True) -> torch.Tensor:
    """gelu(LayerNorm(x) * scale + bias) over the last dim of (..., C).
    x in the compute dtype; scale/bias (C,) fp32. gelu=False gives plain
    LN. Same contract as the JAX `fused_ln_gelu`."""
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
    return _launch(x, scale, bias, eps, gelu)
