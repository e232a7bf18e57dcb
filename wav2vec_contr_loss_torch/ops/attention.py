"""Fused masked-softmax self-attention (forward).

Replaces the Pallas kernel of wav2vec_contr_loss_tpu/ops/attention_pallas.py
(`fused_attention` -> `_fwd` -> `_fwd_kernel`) on the serving path. The
Hopper kernel is CUDA C++ in csrc/attention_fwd.cu: one block per (head,
batch element) at the serving length, K and V staged once in shared
memory, both products on the tensor cores, the fp32 scores and softmax
never leaving the SM. At the serving shape (B=8, H=16, T=249, D=64) it is
bound by its 16.3 MB of q/k/v/out traffic (4.9 us on an H100 at
3.35 TB/s); its products need 2.0 GFLOP. It takes head dim 64 (both
model presets) and keeps all keys in shared memory, so T <= 512 (a 5 s
clip gives 249).

`fused_attention` launches the kernel for CUDA tensors and takes
`fused_attention_plain` only for tensors on the CPU. Dropout (rate > 0)
belongs to training and is not ported yet.
"""

from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["fused_attention", "fused_attention_plain", "launches"]

# kernel launches through `fused_attention`; read and reset by callers
launches = 0

_MAX_T = 512  # keys the kernel keeps in shared memory (kMaxT in the source)


def fused_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: fp32 logits and softmax, the
    probabilities rounded to q's dtype before p . v, fp32 accumulation,
    output in q's dtype. q/k/v: (B, H, T, D); bias: (B, T) fp32."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    logits = logits + bias.float()[:, None, None, :]
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    from ._build import load

    lib = load("attention_fwd")
    lib.attention_fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    lib.attention_fwd.restype = ctypes.c_int
    lib.attention_fwd_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.attention_fwd_smem_bytes.restype = ctypes.c_longlong
    lib.w2v_cuda_error_string.argtypes = [ctypes.c_int]
    lib.w2v_cuda_error_string.restype = ctypes.c_char_p
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


def _launch(q, k, v, bias) -> torch.Tensor:
    global launches
    b, h, t, d = q.shape
    if any(x.dtype != torch.bfloat16 for x in (q, k, v)):
        raise ValueError("the CUDA attention kernel takes bfloat16 q, k, v")
    if not all(x.is_contiguous() for x in (q, k, v, bias)):
        raise ValueError("the CUDA attention kernel takes contiguous tensors")
    if d != 64 or t > _MAX_T:
        raise ValueError(f"the CUDA attention kernel takes head dim 64 and "
                         f"T <= {_MAX_T}; got D={d}, T={t}")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("the CUDA attention kernel takes 16-byte aligned "
                         "q, k, v")
    lib = _lib()
    smem = lib.attention_fwd_smem_bytes(t, d)
    limit = torch.cuda.get_device_properties(q.device).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"T={t}, D={d} needs {smem} B of shared memory per "
                         f"block; this card allows {limit} B")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                bias.data_ptr(), out.data_ptr(), b, h, t, d,
                                stream)
    if err != 0:
        raise RuntimeError("attention_fwd launch failed: "
                           + lib.w2v_cuda_error_string(err).decode())
    launches += 1
    return out


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor, seed: int = 0, rate: float = 0.0,
                    heads: int = 1) -> torch.Tensor:
    """q, k, v: (B, H, T, D); bias: (B, T) fp32 additive key mask (-1e30
    masked). -> (B, H, T, D). q must arrive pre-scaled (1/sqrt(D)).
    Same contract as the JAX `fused_attention`; `heads` must equal H.
    `seed` only matters for dropout, which this port does not have yet."""
    if rate > 0.0:
        raise NotImplementedError(
            "attention dropout (rate > 0) comes with the training port")
    _check(q, k, v, bias)
    if heads != q.shape[1]:
        raise ValueError(f"heads={heads} but q has {q.shape[1]} heads")
    if q.device.type == "cpu":
        return fused_attention_plain(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(q, k, v, bias)
