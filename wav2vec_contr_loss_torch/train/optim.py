"""Grouped AdamW of the stage-1 and baseline trainers.

The port of `build_optimizer` and `_param_groups`
(wav2vec_contr_loss_tpu/train/stage1.py:66,124), of the baseline's
optimizer (wav2vec_contr_loss_tpu/train/baseline.py:124-144) and of the
storage-dtype Adam core (wav2vec_contr_loss_tpu/ops/adam_bf16nu.py):

  * stage 1, 'head' (the compression module): global-norm clip at
    `grad_clip` on the head's gradients only, then AdamW at `head_lr`;
    'encoder' (when finetuning): AdamW at `enc_lr`; 'frozen' (the conv
    feature extractor under freeze_feature_extractor): no update, no
    weight decay, no state, as optax.set_to_zero;
  * the baseline: one global-norm clip at `grad_clip` over the gradients
    of every group, head and encoder together (optax.chain of
    clip_by_global_norm and multi_transform), then AdamW per group.

A clip scales the gradients by min(1, clip / norm), the norm in fp32 over
the fp32 gradients; the scale stays on the device (no host sync) and is
applied to each gradient as its parameter is updated.

Both moments are stored in `adam_mu_dtype` / `adam_nu_dtype` and the
moment and step math runs in fp32; with fp32 storage it is optax.adamw's
arithmetic. Parameters and moments are updated in place (the JAX package
builds new trees), which keeps one copy of each on the card.

The update is `adamw`: on CUDA tensors csrc/adamw.cu, one pass over a
group's parameters, gradients and moments in as many launches as
`launch_tables` cuts the group into (a parameter that got no gradient
reads zeros, and no zeros are made); on CPU tensors `adamw_plain`, the
same arithmetic as eager operations a parameter, which the kernel equals
bit for bit on the same CUDA tensors.

In a parallel gang (parallel/mesh.py) a parameter may be an FSDP2
DTensor or a tensor-parallel slice: the update runs on the local shard
(`to_local()`), with moments of the shard's shape, and a clip's global
norm adds the squared norms of sharded gradients over the process group
their shards are spread across (`norm_groups`, one small all-reduce a
group, no host sync). Under 'pp' the encoder group holds the stage's own
layers and, for every other stage's, the empty placeholders that
parallel/mesh.py leaves in their place (moments of no elements, an
update of nothing), so every rank lists the same parameters in one
order; a norm over the group sums its squares over the stages.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops._build import check

__all__ = ["resolve_grad_bf16", "global_norm", "clip_scale", "adamw",
           "adamw_plain", "launch_tables", "kernel_limits", "AdamWGroup",
           "GroupedAdamW", "build_optimizer", "build_baseline_optimizer",
           "launches", "tensors"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_MOMENT_DTYPES = {torch.bfloat16, torch.float32}

# csrc/adamw.cu launches through `adamw`, and the tensors they updated;
# read and reset by callers
launches = 0
tensors = 0


def resolve_grad_bf16(cfg) -> bool:
    """The `grad_dtype` knob ('auto' | 'float32' | 'bfloat16'): 'auto' is
    bf16 weight gradients exactly when compute_dtype is 'bfloat16'. Under
    bf16 compute the weight-gradient products of the bf16 linears give
    bf16-rounded values, which land in the fp32 leaves of the fp32
    master weights (cast to bf16 at use), whatever this says: the JAX
    trainer's bf16 `nn.Dense` rounds its dW product to bf16 before the
    cast's transpose takes it to fp32, so 'float32' and 'bfloat16' give
    the same step there too. The optimizer's math is fp32 either way.
    The trainer refuses 'bfloat16' with fp32 compute."""
    gd = getattr(cfg, "grad_dtype", "auto")
    if gd not in ("auto", "float32", "bfloat16"):
        raise ValueError(f"grad_dtype must be 'auto', 'float32' or "
                         f"'bfloat16'; got {gd!r}")
    if gd == "auto":
        return cfg.compute_dtype == "bfloat16"
    return gd == "bfloat16"


def _local(t: torch.Tensor) -> torch.Tensor:
    """The local shard of an FSDP2 DTensor, else the tensor."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def global_norm(grads: List[torch.Tensor],
                groups: Optional[List] = None) -> torch.Tensor:
    """The global L2 norm of `grads`, a 0-d fp32 tensor on their device,
    computed without a host sync. `groups[i]` is the process group over
    which the shards of grads[i] are spread (None: a whole, replicated
    gradient): each group's squared norms are summed over its ranks."""
    if groups is None or all(g is None for g in groups):
        return torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
    import torch.distributed as dist

    total = None
    for group in dict.fromkeys(groups):   # first-seen order
        part = torch.stack(torch._foreach_norm(
            [g for g, k in zip(grads, groups) if k is group])
        ).square().sum()
        if group is not None:
            dist.all_reduce(part, group=group)
        total = part if total is None else total + part
    return total.sqrt()


def clip_scale(grads: List[torch.Tensor], clip: float,
               groups: Optional[List] = None) -> torch.Tensor:
    """optax.clip_by_global_norm as a factor: 1 where the global norm of
    `grads` (`global_norm`, over `groups`) is below `clip`, else
    clip / norm; a 0-d fp32 tensor, computed without a host sync."""
    norm = global_norm(grads, groups)
    return torch.where(norm < clip, torch.ones_like(norm), clip / norm)


def _bias_corrections(b1: float, b2: float, count: int) -> Tuple[float, float]:
    """1 - b1^count and 1 - b2^count, the powers taken in fp32 (optax's)."""
    f32 = torch.float32
    return (float(1 - torch.tensor(b1, dtype=f32) ** count),
            float(1 - torch.tensor(b2, dtype=f32) ** count))


def adamw_plain(params: Sequence[torch.Tensor],
                grads: Sequence[Optional[torch.Tensor]],
                mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor], *,
                lr: float, weight_decay: float, b1: float, b2: float,
                eps: float, count: int,
                scale: Optional[torch.Tensor] = None) -> None:
    """Step `count` of AdamW on each (parameter, gradient, moments) in
    place, as eager operations a parameter: the kernel's plain version.
    A None gradient reads as zeros; `scale` multiplies every gradient."""
    bc1, bc2 = _bias_corrections(b1, b2, count)
    for p, g, m, v in zip(params, grads, mu, nu):
        g = torch.zeros_like(p) if g is None else g.float()
        if scale is not None:
            g = g * scale
        m32 = m.float().mul_(b1).add_(g, alpha=1 - b1)
        v32 = v.float().mul_(b2).addcmul_(g, g, value=1 - b2)
        upd = (m32 / bc1) / ((v32 / bc2).sqrt_().add_(eps))
        upd.add_(p, alpha=weight_decay).mul_(-lr)
        p.add_(upd)
        m.copy_(m32)
        v.copy_(v32)


def launch_tables(numels: Sequence[int], capacity: int, chunk: int
                  ) -> List[Tuple[List[int], List[int], int]]:
    """The kernel's launches over tensors of `numels` elements: for each,
    (indices of its tensors, the first block of each, its block count),
    a block taking `chunk` elements of one tensor and a launch at most
    `capacity` tensors. Empty tensors are in none."""
    tables, idx, firsts, blocks = [], [], [], 0
    for i, n in enumerate(numels):
        if n == 0:
            continue
        if len(idx) == capacity:
            tables.append((idx, firsts, blocks))
            idx, firsts, blocks = [], [], 0
        idx.append(i)
        firsts.append(blocks)
        blocks += -(-n // chunk)
    if idx:
        tables.append((idx, firsts, blocks))
    return tables


_P = ctypes.c_void_p


@functools.cache
def _lib() -> Tuple[ctypes.CDLL, int, int]:
    """(csrc/adamw.cu's library, tensors a launch, elements a block)."""
    from ..ops._build import load

    lib = load("adamw")
    lib.adamw_limits.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    lib.adamw_limits.restype = None
    lib.adamw.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P,
                          _P, _P, _P, _P, ctypes.c_uint, _P, _P, _P]
    lib.adamw.restype = ctypes.c_int
    capacity, chunk = ctypes.c_int(), ctypes.c_int()
    lib.adamw_limits(ctypes.byref(capacity), ctypes.byref(chunk))
    return lib, capacity.value, chunk.value


def kernel_limits() -> Tuple[int, int]:
    """csrc/adamw.cu's tensors a launch and elements a block (builds the
    kernel if needed)."""
    return _lib()[1:]


def _f32(x: float) -> float:
    return float(np.float32(x))


def _dense(t: torch.Tensor) -> bool:
    """Whether t's elements fill one block of memory from its first, with
    no gap or overlap, its axes in any order (a transposed weight)."""
    if t.is_contiguous():
        return True
    step = 1
    for stride, size in sorted((st, sz) for st, sz in zip(t.stride(), t.shape)
                               if sz != 1):
        if stride != step:
            return False
        step *= size
    return True


def _check_cuda(params, grads, mu, nu) -> None:
    """Raise unless every tensor is on the parameters' CUDA device, the
    parameters and gradients fp32, each moment list of one dtype, bf16
    or fp32, each parameter one dense block of memory, and its gradient
    and moments of its shape and strides: the kernel runs over the four
    blocks element by element."""
    dev = params[0].device
    present = [g for g in grads if g is not None]
    for what, ts, takes in (("parameter", params, {torch.float32}),
                            ("gradient", present, {torch.float32}),
                            ("first moment", mu, _MOMENT_DTYPES),
                            ("second moment", nu, _MOMENT_DTYPES)):
        dtypes = {t.dtype for t in ts}
        if not dtypes <= takes or len(dtypes) > 1:
            raise ValueError(
                f"the CUDA AdamW kernel takes each {what} of a group in one "
                f"dtype of {sorted(str(d) for d in takes)}; got "
                f"{sorted(str(d) for d in dtypes)}")
        if any(t.device != dev for t in ts):
            raise ValueError(f"the CUDA AdamW kernel takes tensors on one "
                             f"device, the parameters' {dev}; got a {what} "
                             f"elsewhere")
    for p, g, m, v in zip(params, grads, mu, nu):
        if not _dense(p):
            raise ValueError(f"the CUDA AdamW kernel takes parameters that "
                             f"are one dense block of memory; got strides "
                             f"{p.stride()} for {tuple(p.shape)}")
        layout = (p.shape, p.stride())
        for what, t in (("gradient", g), ("moment", m), ("moment", v)):
            if t is not None and (t.shape, t.stride()) != layout:
                raise ValueError(
                    f"the CUDA AdamW kernel takes a {what} in its "
                    f"parameter's shape and strides {layout}; got "
                    f"{(t.shape, t.stride())}")


def _adamw_cuda(params, grads, mu, nu, *, lr, weight_decay, b1, b2, eps,
                count, scale) -> None:
    """csrc/adamw.cu over the group, table by table, on the current
    stream."""
    global launches, tensors
    _check_cuda(params, grads, mu, nu)
    dev = params[0].device
    if scale is not None:
        if (scale.dtype != torch.float32 or scale.numel() != 1
                or scale.device != dev):
            raise ValueError("the CUDA AdamW kernel takes a clip scale of one "
                             f"fp32 element on {dev}; got {scale.dtype} "
                             f"{tuple(scale.shape)} on {scale.device}")
    lib, capacity, chunk = _lib()
    bc1, bc2 = _bias_corrections(b1, b2, count)
    one = np.float32(1.0)
    scalars = (ctypes.c_float * 9)(
        _f32(b1), _f32(1 - b1), _f32(b2), _f32(1 - b2),
        float(one / np.float32(bc1)), float(one / np.float32(bc2)),
        _f32(eps), _f32(weight_decay), _f32(-lr))
    mu_f32 = int(mu[0].dtype == torch.float32)
    nu_f32 = int(nu[0].dtype == torch.float32)
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        numels = [p.numel() for p in params]
        for idx, firsts, blocks in launch_tables(numels, capacity, chunk):
            k = len(idx)
            arrays = [(_P * k)(*[ptr(ts[i]) for i in idx])
                      for ts in (params, grads, mu, nu)]
            err = lib.adamw(
                mu_f32, nu_f32, k, *arrays,
                (ctypes.c_longlong * k)(*[numels[i] for i in idx]),
                (ctypes.c_uint * k)(*firsts), blocks, ptr(scale), scalars,
                stream)
            check(lib, "adamw", err)
            launches += 1
            tensors += k


def adamw(params: Sequence[torch.Tensor],
          grads: Sequence[Optional[torch.Tensor]],
          mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor], *,
          lr: float, weight_decay: float, b1: float, b2: float, eps: float,
          count: int, scale: Optional[torch.Tensor] = None) -> None:
    """Step `count` of AdamW on each (parameter, gradient, moments) in
    place: csrc/adamw.cu on CUDA tensors (fp32 parameters and gradients,
    bf16 or fp32 moments, each parameter one dense block of memory and
    its gradient and moments in its layout; anything else raises), the plain
    version on CPU tensors. A None gradient reads as zeros; `scale`, a
    0-d fp32 tensor, multiplies every gradient."""
    if not params:
        return
    devices = {p.device.type for p in params}
    if devices == {"cpu"}:
        adamw_plain(params, grads, mu, nu, lr=lr, weight_decay=weight_decay,
                    b1=b1, b2=b2, eps=eps, count=count, scale=scale)
    elif devices == {"cuda"}:
        _adamw_cuda(params, grads, mu, nu, lr=lr, weight_decay=weight_decay,
                    b1=b1, b2=b2, eps=eps, count=count, scale=scale)
    else:
        raise ValueError(f"AdamW runs on CPU tensors (plain) or CUDA tensors "
                         f"(the kernel), one kind a group; got "
                         f"{sorted(devices)}")


class AdamWGroup:
    """One optax.adamw over a list of parameters, optionally behind a
    global-norm clip of their gradients."""

    def __init__(self, params: List[torch.nn.Parameter], lr: float,
                 weight_decay: float, mu_dtype: torch.dtype,
                 nu_dtype: torch.dtype, clip: Optional[float] = None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 norm_groups: Optional[List] = None):
        self.params = list(params)
        self.lr, self.weight_decay, self.clip = lr, weight_decay, clip
        self.b1, self.b2, self.eps = b1, b2, eps
        self.norm_groups = (list(norm_groups) if norm_groups is not None
                            else [None] * len(self.params))
        self.mu = [torch.zeros_like(_local(p), dtype=mu_dtype)
                   for p in self.params]
        self.nu = [torch.zeros_like(_local(p), dtype=nu_dtype)
                   for p in self.params]
        self.count = 0

    def grads(self) -> List[Optional[torch.Tensor]]:
        """The gradients (local shards), None for a parameter that got
        none."""
        return [None if p.grad is None else _local(p.grad)
                for p in self.params]

    def norm_inputs(self) -> List[torch.Tensor]:
        """The fp32 gradients a clip's norm reads: an empty tensor for a
        parameter that got none (its norm is 0, as of zeros)."""
        return [_local(p).new_zeros(0) if g is None else g.float()
                for p, g in zip(self.params, self.grads())]

    @torch.no_grad()
    def step(self, scale: Optional[torch.Tensor] = None) -> None:
        """One update. `scale` comes from a clip that spans more than this
        group (GroupedAdamW); otherwise the group applies its own clip,
        if it has one."""
        if scale is None and self.clip is not None and self.params:
            scale = clip_scale(self.norm_inputs(), self.clip,
                               self.norm_groups)
        self.count += 1
        adamw([_local(p) for p in self.params], self.grads(), self.mu,
              self.nu, lr=self.lr, weight_decay=self.weight_decay,
              b1=self.b1, b2=self.b2, eps=self.eps, count=self.count,
              scale=scale)


def _release(groups: List[AdamWGroup]) -> None:
    for grp in groups:
        grp.params, grp.mu, grp.nu, grp.norm_groups = [], [], [], []


class GroupedAdamW:
    """The optax.multi_transform of the JAX trainer over named groups;
    parameters in no group take no update."""

    def __init__(self, groups: Dict[str, AdamWGroup],
                 clip: Optional[float] = None):
        self.groups = groups
        self.clip = clip   # over the gradients of every group
        # a group is a part of its optimizer: one still referenced once the
        # optimizer is gone (a caller's loop variable) keeps none of its
        # parameters, gradients or moments alive
        weakref.finalize(self, _release, list(groups.values()))

    def parameters(self) -> List[torch.nn.Parameter]:
        return [p for grp in self.groups.values() for p in grp.params]

    def zero_grad(self) -> None:
        for grp in self.groups.values():
            for p in grp.params:
                p.grad = None

    def step(self) -> None:
        scale = None
        if self.clip is not None:
            groups = list(self.groups.values())
            scale = clip_scale(
                [g for grp in groups for g in grp.norm_inputs()], self.clip,
                [k for grp in groups for k in grp.norm_groups])
        for grp in self.groups.values():
            grp.step(scale)

    def state_dict(self) -> Dict[str, Dict]:
        """Each group's stored moments (in their storage dtype) and step
        count; the tensors are the live buffers, not copies."""
        return {name: {"mu": list(grp.mu), "nu": list(grp.nu),
                       "count": grp.count}
                for name, grp in self.groups.items()}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Dict]) -> None:
        if set(state) != set(self.groups):
            raise ValueError(f"optimizer groups {sorted(state)} do not "
                             f"match {sorted(self.groups)}")
        pairs = []   # every check before the first copy
        for name, grp in self.groups.items():
            s = state[name]
            if len(s["mu"]) != len(grp.mu) or len(s["nu"]) != len(grp.nu):
                raise ValueError(f"group {name!r}: {len(s['mu'])} moments "
                                 f"for {len(grp.mu)} parameters")
            for dst, src in zip(grp.mu + grp.nu, list(s["mu"]) + list(s["nu"])):
                if src.shape != dst.shape or src.dtype != dst.dtype:
                    raise ValueError(
                        f"group {name!r}: a stored moment of {src.dtype} "
                        f"{tuple(src.shape)} for {dst.dtype} "
                        f"{tuple(dst.shape)} (another adam_*_dtype?)")
                pairs.append((dst, src))
        for dst, src in pairs:
            dst.copy_(src)
        for name, grp in self.groups.items():
            grp.count = int(state[name]["count"])


def _norm_groups(params, norm_group):
    return None if norm_group is None else [norm_group(p) for p in params]


def build_optimizer(cfg, head: List[torch.nn.Parameter],
                    encoder: List[torch.nn.Parameter],
                    norm_group=None) -> GroupedAdamW:
    """Head clipped at cfg.grad_clip + AdamW(head_lr); encoder
    AdamW(enc_lr) when it trains; shared weight decay. Frozen parameters
    are in neither list. `norm_group(p)`: the process group of a sharded
    parameter's shards (a gang's Layout), None in one process."""
    mu = _DTYPES[cfg.adam_mu_dtype]
    nu = _DTYPES[cfg.adam_nu_dtype]
    groups = {"head": AdamWGroup(head, cfg.head_lr, cfg.weight_decay, mu, nu,
                                 clip=cfg.grad_clip,
                                 norm_groups=_norm_groups(head, norm_group))}
    if encoder:
        groups["encoder"] = AdamWGroup(
            encoder, cfg.enc_lr, cfg.weight_decay, mu, nu,
            norm_groups=_norm_groups(encoder, norm_group))
    return GroupedAdamW(groups)


def build_baseline_optimizer(cfg, head: List[torch.nn.Parameter],
                             encoder: List[torch.nn.Parameter],
                             norm_group=None) -> GroupedAdamW:
    """The baseline's optimizer: one clip at cfg.grad_clip over head and
    encoder gradients together, then AdamW(head_lr) on the head
    (compression and classifier) and AdamW(enc_lr) on the encoder when
    it trains; shared weight decay; `norm_group` as for
    `build_optimizer`."""
    mu = _DTYPES[cfg.adam_mu_dtype]
    nu = _DTYPES[cfg.adam_nu_dtype]
    groups = {"head": AdamWGroup(head, cfg.head_lr, cfg.weight_decay, mu, nu,
                                 norm_groups=_norm_groups(head, norm_group))}
    if encoder:
        groups["encoder"] = AdamWGroup(
            encoder, cfg.enc_lr, cfg.weight_decay, mu, nu,
            norm_groups=_norm_groups(encoder, norm_group))
    return GroupedAdamW(groups, clip=cfg.grad_clip)
