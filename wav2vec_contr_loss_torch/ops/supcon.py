"""Fused binary SupCon loss with its analytic gradient.

Replaces the Pallas kernel of wav2vec_contr_loss_tpu/ops/supcon_pallas.py
(`supcon_binary_loss_pallas` -> `_run_kernel` -> `_kernel`, a custom VJP).
The Hopper kernels are CUDA C++ in csrc/supcon.cu, two launches: a row
kernel (the Gram stripe of a block of anchors, the similarity, cosine or
geodesic with `acosf`, both masked log-sum-exps, the iterative top-k and
the per-row terms) and a dz kernel (the loss, the alpha blend with the
degenerate rules, the uniformity term, dL/dz and dL/dalpha). At the
training shape (B=32, D=256) they move 64 KB and are bound by their own
launch latency; their fp32 products bound them from B of about 1,000 on.
The kernels take B up to `supcon_max_batch()` (4,096, set by the row
kernel's shared memory) and D up to 1,024 (the wrapper pads D to a
multiple of 4 with zero columns); on CUDA tensors the wrapper raises
above that. Scratch (the (B, B) Gram matrix, the row terms, the top-k
selection as bits) comes from `torch.empty`.

The wrapper makes no host-device synchronisation: a Python alpha reaches
the kernel through `torch.full` on the device, not a blocking copy.

`supcon_binary_loss_fused` launches the kernels for CUDA tensors, through
`FusedSupCon` (a `torch.autograd.Function` whose backward scales the
stored dz and dL/dalpha by the cotangent, as at supcon_pallas.py:227-237),
and takes the plain `losses.supcon.supcon_binary_loss`, differentiated
by autograd, only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..config import SupConConfig
from ..losses.supcon import supcon_binary_loss
from ._build import check

__all__ = ["supcon_binary_loss_fused", "FusedSupCon", "launches"]

# kernel launches through `supcon_binary_loss_fused` (one per call,
# counting its two kernels as one); read and reset by callers
launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    from ._build import load

    lib = load("supcon")
    lib.supcon_fwd.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 2
                               + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_float, ctypes.c_float,
                                  ctypes.c_void_p])
    lib.supcon_fwd.restype = ctypes.c_int
    for name in ("supcon_max_batch", "supcon_max_dim", "supcon_row_terms"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    return lib


def _padded(z: torch.Tensor) -> torch.Tensor:
    """z with zero columns up to a multiple of 4 (they change no dot
    product or norm), contiguous and 16-byte aligned for float4 loads."""
    if z.shape[1] % 4:
        z = torch.nn.functional.pad(z, (0, -z.shape[1] % 4))
    z = z.contiguous()
    return z if z.data_ptr() % 16 == 0 else z.clone()


def _launch(z, labels, alpha, cfg: SupConConfig):
    global launches
    b, d = z.shape
    lib = _lib()
    max_b, max_d = lib.supcon_max_batch(), lib.supcon_max_dim()
    if b > max_b or d > max_d:
        raise ValueError(f"the CUDA SupCon kernels take B <= {max_b} and D "
                         f"<= {max_d}; got B={b}, D={d}")
    z = _padded(z.float())
    labels = labels.to(device=z.device, dtype=torch.int64).contiguous()
    alpha = alpha.to(dtype=torch.float32).reshape(1)
    loss = torch.empty((), dtype=torch.float32, device=z.device)
    dalpha = torch.empty((), dtype=torch.float32, device=z.device)
    dz = torch.empty_like(z)
    gram = torch.empty(b, b, dtype=torch.float32, device=z.device)
    terms = torch.empty(lib.supcon_row_terms(), b, dtype=torch.float32,
                        device=z.device)
    sel = torch.empty(b, -(-b // 32), dtype=torch.int32, device=z.device)
    k = max(1, min(cfg.topk_neg, b - 1))
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        err = lib.supcon_fwd(
            z.data_ptr(), labels.data_ptr(), alpha.data_ptr(),
            loss.data_ptr(), dz.data_ptr(), dalpha.data_ptr(),
            gram.data_ptr(), terms.data_ptr(), sel.data_ptr(), b, z.shape[1],
            1.0 / cfg.temperature, k, int(cfg.similarity == "geodesic"),
            cfg.uniformity_weight, cfg.uniformity_t, stream)
    check(lib, "supcon", err)
    launches += 1
    return loss, dz[:, :d], dalpha


class FusedSupCon(torch.autograd.Function):
    """Forward runs the kernels, which also compute dL/dz and dL/dalpha;
    the backward only scales them by the cotangent."""

    @staticmethod
    def forward(ctx, z, labels, alpha, cfg: SupConConfig):
        loss, dz, dalpha = _launch(z, labels, alpha, cfg)
        ctx.save_for_backward(dz, dalpha)
        ctx.z_dtype, ctx.alpha_shape = z.dtype, alpha.shape
        return loss

    @staticmethod
    def backward(ctx, g):
        dz, dalpha = ctx.saved_tensors
        want_z, _, want_alpha, _ = ctx.needs_input_grad
        return ((g * dz).to(ctx.z_dtype) if want_z else None, None,
                (g * dalpha).reshape(ctx.alpha_shape) if want_alpha else None,
                None)


def _alpha_on(alpha, device: torch.device) -> torch.Tensor:
    """alpha as a scalar fp32 tensor on `device` without a blocking copy:
    a Python number is filled in on the device, a tensor is taken as it
    is (moved only if it lies elsewhere)."""
    if isinstance(alpha, torch.Tensor):
        return alpha.to(device=device, dtype=torch.float32)
    return torch.full((), float(alpha), dtype=torch.float32, device=device)


def supcon_binary_loss_fused(z: torch.Tensor, labels: torch.Tensor, alpha,
                             config: SupConConfig = SupConConfig()
                             ) -> torch.Tensor:
    """Same contract as `losses.supcon.supcon_binary_loss`: z (B, D)
    L2-normalized, labels (B,) ints, alpha a float or scalar tensor;
    differentiable in z and alpha."""
    if z.dim() != 2 or labels.reshape(-1).shape[0] != z.shape[0]:
        raise ValueError(f"z must be (B, D) with B labels; got "
                         f"{tuple(z.shape)} and {tuple(labels.shape)}")
    if z.device.type == "cpu":
        return supcon_binary_loss(z, labels, alpha, config)
    if z.device.type != "cuda":
        raise ValueError(f"unsupported device {z.device}")
    return FusedSupCon.apply(z, labels.reshape(-1), _alpha_on(alpha, z.device),
                             config)
