"""The encoder's positional conv (a grouped conv1d at stride 1: kernel
128, 16 groups) at the group widths the kernels are built for (XLS-R
2B's 120, 1B's 80), forward and backward.

`pos_conv(x, weight, bias, padding, groups)` takes x (B, T, D) and returns
y (B, T', D), T' = T + 2 padding - K + 1, through one autograd Function,
`_GroupConv`. On a CUDA tensor (bf16) its forward launches
csrc/pos_conv.cu `pos_conv_fwd`, an implicit GEMM on wgmma at the groups'
own width; its backward launches the same kernel for the input gradient
(the output gradient against each group's weight transposed and flipped
in time, padded K - 1 - padding, read so by the kernel) and
`pos_conv_wgrad` for the weight gradient, fp32 straight to the
parameter; the bias gradient is PyTorch's fp32 sum of the output
gradient. The kernel takes the weight tap-major, (G, K, C/8, C, 8) in
bf16 (`tap_major`, one copy a call), and the weight gradient its two
operands chunk-major, (B, D/8, T, 8) (`chunk_major`). There is no
fallback on the card: a width, dtype or shape the kernels do not take
raises. Elsewhere (the CPU) the Function runs the plain version, the
same arithmetic in PyTorch: bf16 inputs and weight, products summed in
fp32, one rounding of each output to x's dtype, the input gradient as
that forward conv of the flipped weight, the weight and bias gradients in
fp32.

The JAX package leaves this conv to XLA (wav2vec_contr_loss_tpu/models/
wav2vec2.py, `feature_group_count`): no Pallas kernel is replaced.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from ..device import fp32_convs
from ._build import check

__all__ = ["pos_conv", "pos_conv_plain", "routed", "check_launch",
           "tap_major", "chunk_major", "launches", "bwd_launches",
           "WIDTHS", "MAX_TAPS"]

# csrc/pos_conv.cu launches: `pos_conv_fwd` (the forward and the input
# gradient) and `pos_conv_wgrad`; read and reset by callers
launches = 0
bwd_launches = 0

# group widths the kernels are built for; cuDNN runs a bf16 grouped conv
# on the tensor cores where each group is a multiple of 64 channels wide,
# and on SIMT kernels at 120 and 80
WIDTHS = (80, 120)
MAX_TAPS = 129             # kernel sizes up to this


def routed(x: torch.Tensor, width: int) -> bool:
    """Whether the positional conv of x, groups `width` channels wide,
    takes this module: a bf16 tensor on the card, at a width in WIDTHS."""
    return (x.device.type == "cuda" and x.dtype == torch.bfloat16
            and width in WIDTHS)


def tap_major(weight: torch.Tensor, groups: int,
              dtype: torch.dtype) -> torch.Tensor:
    """The (D, C, K) weight in `dtype` as the kernel reads it, tap-major
    (G, K, C/8, C, 8): [g, k, i // 8, o, i % 8] = weight[g C + o, i, k]."""
    d, c, k = weight.shape
    view = weight.view(groups, c, c // 8, 8, k).permute(0, 4, 2, 1, 3)
    return torch.empty(view.shape, dtype=dtype,
                       device=weight.device).copy_(view)


def chunk_major(a: torch.Tensor) -> torch.Tensor:
    """(B, T, D) as (B, D/8, T, 8): columns of 8 channels over the frames,
    the weight-gradient kernel's operand layout."""
    b, t, d = a.shape
    return a.view(b, t, d // 8, 8).transpose(1, 2).contiguous()


def pos_conv_plain(x: torch.Tensor, weight: torch.Tensor,
                   bias: Optional[torch.Tensor], padding: int,
                   groups: int) -> torch.Tensor:
    """The kernel's forward in PyTorch, (B, T, D) -> (B, T', D): x and the
    weight and bias rounded to x's dtype, products summed in fp32 (full
    fp32 on the card too, never TF32), each output rounded once."""
    w = weight.to(x.dtype).float()
    b = None if bias is None else bias.to(x.dtype).float()
    with fp32_convs():
        y = F.conv1d(x.transpose(1, 2).float(), w, b, 1, padding,
                     groups=groups)
    return y.to(x.dtype).transpose(1, 2)


def _flipped(weight: torch.Tensor, groups: int) -> torch.Tensor:
    """Each group's weight transposed and flipped in time: the weight of
    the input gradient as a forward conv."""
    d, c, k = weight.shape
    return (weight.reshape(groups, c, c, k).transpose(1, 2).flip(-1)
            .reshape(d, c, k))


def _weight_grad_plain(gy: torch.Tensor, x: torch.Tensor,
                       weight: torch.Tensor, padding: int,
                       groups: int) -> torch.Tensor:
    """dW in fp32 from (B, T', D) gy and (B, T, D) x."""
    with fp32_convs():
        _, dw, _ = torch.ops.aten.convolution_backward(
            gy.transpose(1, 2).float(), x.transpose(1, 2).float(),
            weight.float(), None, [1], [padding], [1], False, [0], groups,
            [False, True, False])
    return dw


_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    from ._build import load

    lib = load("pos_conv")
    lib.pos_conv_fwd.argtypes = [_P, _P, _P, _P] + [_I] * 8 + [_P]
    lib.pos_conv_fwd.restype = _I
    lib.pos_conv_wgrad.argtypes = [_P, _P, _P] + [_I] * 7 + [_P]
    lib.pos_conv_wgrad.restype = _I
    return lib


def check_launch(x: torch.Tensor, d: int, width: int, k: int,
                 t_out: int) -> None:
    """Raise on what the kernels do not take: x (B, T, d) bf16, groups of
    a width in WIDTHS, k <= MAX_TAPS, at least one output frame."""
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the positional conv kernels take bfloat16; got "
                         f"{x.dtype}")
    if x.dim() != 3 or x.shape[2] != d:
        raise ValueError(f"the positional conv takes x (B, T, {d}); got "
                         f"{tuple(x.shape)}")
    if width not in WIDTHS:
        raise ValueError(f"the positional conv kernels take groups of "
                         f"{WIDTHS} channels; got {width}")
    if not 0 < k <= MAX_TAPS:
        raise ValueError(f"the positional conv kernels take kernels of up "
                         f"to {MAX_TAPS} taps; got {k}")
    if t_out < 1:
        raise ValueError(f"no output frame: {x.shape[1]} frames, kernel {k}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _conv(x: torch.Tensor, wt: torch.Tensor, bias: Optional[torch.Tensor],
          pad: int, groups: int, dx: bool) -> torch.Tensor:
    """`pos_conv_fwd` of x (B, T, D) into a new (B, T', D) tensor."""
    b, t, d = x.shape
    k = wt.shape[1]
    t_out = t + 2 * pad - k + 1
    check_launch(x, d, d // groups, k, t_out)
    x = x.contiguous()
    y = torch.empty(b, t_out, d, dtype=x.dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.pos_conv_fwd(
            x.data_ptr(), wt.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(), b, t,
            t_out, d, d // groups, k, pad, int(dx), _stream(x))
    check(lib, "pos_conv_fwd", err)
    return y


def _weight_grad(gy: torch.Tensor, x: torch.Tensor, k: int, pad: int,
                 groups: int) -> torch.Tensor:
    """`pos_conv_wgrad`: fp32 (D, C, K) from gy (B, T', D), x (B, T, D)."""
    b, t, d = x.shape
    check_launch(x, d, d // groups, k, gy.shape[1])
    check_launch(gy, d, d // groups, k, gy.shape[1])
    gc, xc = chunk_major(gy), chunk_major(x)
    dw = torch.empty(d, d // groups, k, dtype=torch.float32,
                     device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.pos_conv_wgrad(gc.data_ptr(), xc.data_ptr(), dw.data_ptr(),
                                 b, t, gy.shape[1], d, d // groups, k, pad,
                                 _stream(x))
    check(lib, "pos_conv_wgrad", err)
    return dw


class _GroupConv(torch.autograd.Function):
    """The grouped conv of x (B, T, D) into (B, T', D), the input gradient
    a forward conv of the output gradient against the flipped weight:
    csrc/pos_conv.cu on a CUDA tensor, the plain version elsewhere."""

    @staticmethod
    def forward(ctx, x, weight, bias, padding, groups):
        global launches
        ctx.conv = (padding, groups, weight.shape[2], weight.dtype,
                    None if bias is None else bias.dtype)
        if not x.is_cuda:
            ctx.save_for_backward(x, weight)
            return pos_conv_plain(x, weight, bias, padding, groups)
        wt = tap_major(weight, groups, x.dtype)
        y = _conv(x, wt, None if bias is None else bias.to(x.dtype),
                  padding, groups, dx=False)
        launches += 1
        ctx.save_for_backward(x, wt)
        return y

    @staticmethod
    def backward(ctx, gy):
        global launches, bwd_launches
        x, w = ctx.saved_tensors
        padding, groups, k, w_dtype, b_dtype = ctx.conv
        need = ctx.needs_input_grad
        dx = dw = db = None
        if b_dtype is not None and need[2]:
            db = gy.sum((0, 1), dtype=torch.float32).to(b_dtype)
        if not gy.is_cuda:
            if need[0]:
                dx = pos_conv_plain(gy, _flipped(w, groups), None,
                                    k - 1 - padding, groups)
            if need[1]:
                dw = _weight_grad_plain(gy, x, w, padding,
                                        groups).to(w_dtype)
            return dx, dw, db, None, None
        gy = gy.contiguous()
        if need[0]:
            dx = _conv(gy, w, None, k - 1 - padding, groups, dx=True)
            launches += 1
        if need[1]:
            dw = _weight_grad(gy, x, k, padding, groups).to(w_dtype)
            bwd_launches += 1
        return dx, dw, db, None, None


def pos_conv(x: torch.Tensor, weight: torch.Tensor,
             bias: Optional[torch.Tensor], padding: int,
             groups: int) -> torch.Tensor:
    """The grouped conv (stride 1) of x (B, T, D) with the (D, D/groups,
    K) weight, as (B, T', D). On the card one `pos_conv_fwd` launch, and in
    the backward one more and one `pos_conv_wgrad`."""
    return _GroupConv.apply(x, weight, bias, padding, groups)
