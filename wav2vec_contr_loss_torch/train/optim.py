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
arithmetic. Parameters, moments and gradients are updated in place (the
JAX package builds new trees), which keeps one copy of each on the card.

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

import weakref
from typing import Dict, List, Optional

import torch

__all__ = ["resolve_grad_bf16", "global_norm", "clip_scale", "AdamWGroup", "GroupedAdamW",
           "build_optimizer", "build_baseline_optimizer"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


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

    def gradients(self) -> List[torch.Tensor]:
        """fp32 gradients (local shards), zeros for a parameter that got
        none."""
        return [torch.zeros_like(_local(p)) if p.grad is None
                else _local(p.grad).float() for p in self.params]

    @torch.no_grad()
    def step(self, grads: Optional[List[torch.Tensor]] = None,
             scale: Optional[torch.Tensor] = None) -> None:
        """One update. `grads` and `scale` come from a clip that spans
        more than this group (GroupedAdamW); otherwise the group reads
        its parameters' gradients and applies its own clip."""
        if grads is None:
            grads = self.gradients()
            if self.clip is not None and grads:
                scale = clip_scale(grads, self.clip, self.norm_groups)
        self.count += 1
        f32 = torch.float32
        bc1 = float(1 - torch.tensor(self.b1, dtype=f32) ** self.count)
        bc2 = float(1 - torch.tensor(self.b2, dtype=f32) ** self.count)
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            p = _local(p)
            if scale is not None:
                g = g * scale
            m32 = mu.float().mul_(self.b1).add_(g, alpha=1 - self.b1)
            v32 = nu.float().mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            upd = (m32 / bc1) / ((v32 / bc2).sqrt_().add_(self.eps))
            upd.add_(p, alpha=self.weight_decay).mul_(-self.lr)
            p.add_(upd)
            mu.copy_(m32)
            nu.copy_(v32)


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
        if self.clip is None:
            for grp in self.groups.values():
                grp.step()
            return
        grads = {name: grp.gradients() for name, grp in self.groups.items()}
        scale = clip_scale([g for gs in grads.values() for g in gs],
                           self.clip,
                           [k for grp in self.groups.values()
                            for k in grp.norm_groups])
        for name, grp in self.groups.items():
            grp.step(grads[name], scale)

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
