"""Fused binary SupCon loss with its analytic gradient.

Replaces the Pallas kernel of wav2vec_contr_loss_tpu/ops/supcon_pallas.py
(`supcon_binary_loss_pallas` -> `_run_kernel` -> `_kernel`, a custom VJP).
The Hopper kernel is CUDA C++ in csrc/supcon.cu: one block computes the
Gram matrix, the similarity (cosine, or geodesic with `acosf`), both
masked log-sum-exps, the iterative top-k, the alpha blend with the
degenerate rules, the uniformity term, dL/dz and dL/dalpha in one launch.
At the training shape (B=32, D=256) it moves 64 KB and is bound by its
own launch latency. It takes B <= 128 (its (B, B) matrices live in shared
memory); on CUDA tensors the wrapper raises above that.

`supcon_binary_loss_fused` launches the kernel for CUDA tensors, through
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

# kernel launches through `supcon_binary_loss_fused`; read and reset by
# callers
launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    from ._build import load

    lib = load("supcon")
    lib.supcon_fwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                               + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_float, ctypes.c_float,
                                  ctypes.c_void_p])
    lib.supcon_fwd.restype = ctypes.c_int
    lib.supcon_max_batch.argtypes = []
    lib.supcon_max_batch.restype = ctypes.c_int
    return lib


def _launch(z, labels, alpha, cfg: SupConConfig):
    global launches
    b, d = z.shape
    lib = _lib()
    if b > lib.supcon_max_batch():
        raise ValueError(f"the CUDA SupCon kernel takes B <= "
                         f"{lib.supcon_max_batch()}; got B={b}")
    z = z.float().contiguous()
    labels = labels.to(device=z.device, dtype=torch.int32).contiguous()
    alpha = alpha.to(device=z.device, dtype=torch.float32).reshape(1)
    loss = torch.empty((), dtype=torch.float32, device=z.device)
    dalpha = torch.empty((), dtype=torch.float32, device=z.device)
    dz = torch.empty_like(z)
    k = max(1, min(cfg.topk_neg, b - 1))
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        err = lib.supcon_fwd(
            z.data_ptr(), labels.data_ptr(), alpha.data_ptr(),
            loss.data_ptr(), dz.data_ptr(), dalpha.data_ptr(), b, d,
            1.0 / cfg.temperature, k, int(cfg.similarity == "geodesic"),
            cfg.uniformity_weight, cfg.uniformity_t, stream)
    check(lib, "supcon", err)
    launches += 1
    return loss, dz, dalpha


class FusedSupCon(torch.autograd.Function):
    """Forward runs the kernel, which also computes dL/dz and dL/dalpha;
    the backward only scales them by the cotangent."""

    @staticmethod
    def forward(ctx, z, labels, alpha, cfg: SupConConfig):
        loss, dz, dalpha = _launch(z, labels, alpha, cfg)
        ctx.save_for_backward(dz, dalpha)
        ctx.z_dtype = z.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        dz, dalpha = ctx.saved_tensors
        return (g * dz).to(ctx.z_dtype), None, g * dalpha, None


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
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=z.device)
    return FusedSupCon.apply(z, labels.reshape(-1), alpha, config)
