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
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

__all__ = ["resolve_grad_bf16", "clip_scale", "AdamWGroup", "GroupedAdamW",
           "build_optimizer", "build_baseline_optimizer"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def resolve_grad_bf16(cfg) -> bool:
    """The `grad_dtype` knob ('auto' | 'float32' | 'bfloat16'): 'auto' is
    bf16 weight gradients exactly when compute_dtype is 'bfloat16'. Under
    bf16 compute the port's transformer weight gradients come out of bf16
    matrix products, which is what this asks for; the optimizer takes
    them into fp32 math either way. The trainer refuses the two settings
    the port does not compute: 'bfloat16' with fp32 compute, and
    'float32' with bf16 compute (the JAX trainer's fp32 dW there)."""
    gd = getattr(cfg, "grad_dtype", "auto")
    if gd not in ("auto", "float32", "bfloat16"):
        raise ValueError(f"grad_dtype must be 'auto', 'float32' or "
                         f"'bfloat16'; got {gd!r}")
    if gd == "auto":
        return cfg.compute_dtype == "bfloat16"
    return gd == "bfloat16"


def clip_scale(grads: List[torch.Tensor], clip: float) -> torch.Tensor:
    """optax.clip_by_global_norm as a factor: 1 where the global norm of
    `grads` is below `clip`, else clip / norm; a 0-d fp32 tensor on the
    gradients' device, computed without a host sync."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    return torch.where(norm < clip, torch.ones_like(norm), clip / norm)


class AdamWGroup:
    """One optax.adamw over a list of parameters, optionally behind a
    global-norm clip of their gradients."""

    def __init__(self, params: List[torch.nn.Parameter], lr: float,
                 weight_decay: float, mu_dtype: torch.dtype,
                 nu_dtype: torch.dtype, clip: Optional[float] = None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.weight_decay, self.clip = lr, weight_decay, clip
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p, dtype=mu_dtype) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=nu_dtype) for p in self.params]
        self.count = 0

    def gradients(self) -> List[torch.Tensor]:
        """fp32 gradients, zeros for a parameter that got none."""
        return [torch.zeros_like(p) if p.grad is None else p.grad.float()
                for p in self.params]

    @torch.no_grad()
    def step(self, grads: Optional[List[torch.Tensor]] = None,
             scale: Optional[torch.Tensor] = None) -> None:
        """One update. `grads` and `scale` come from a clip that spans
        more than this group (GroupedAdamW); otherwise the group reads
        its parameters' gradients and applies its own clip."""
        if grads is None:
            grads = self.gradients()
            if self.clip is not None and grads:
                scale = clip_scale(grads, self.clip)
        self.count += 1
        f32 = torch.float32
        bc1 = float(1 - torch.tensor(self.b1, dtype=f32) ** self.count)
        bc2 = float(1 - torch.tensor(self.b2, dtype=f32) ** self.count)
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            if scale is not None:
                g = g * scale
            m32 = mu.float().mul_(self.b1).add_(g, alpha=1 - self.b1)
            v32 = nu.float().mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            upd = (m32 / bc1) / ((v32 / bc2).sqrt_().add_(self.eps))
            upd.add_(p, alpha=self.weight_decay).mul_(-self.lr)
            p.add_(upd)
            mu.copy_(m32)
            nu.copy_(v32)


class GroupedAdamW:
    """The optax.multi_transform of the JAX trainer over named groups;
    parameters in no group take no update."""

    def __init__(self, groups: Dict[str, AdamWGroup],
                 clip: Optional[float] = None):
        self.groups = groups
        self.clip = clip   # over the gradients of every group

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
                           self.clip)
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


def build_optimizer(cfg, head: List[torch.nn.Parameter],
                    encoder: List[torch.nn.Parameter]) -> GroupedAdamW:
    """Head clipped at cfg.grad_clip + AdamW(head_lr); encoder
    AdamW(enc_lr) when it trains; shared weight decay. Frozen parameters
    are in neither list."""
    mu = _DTYPES[cfg.adam_mu_dtype]
    nu = _DTYPES[cfg.adam_nu_dtype]
    groups = {"head": AdamWGroup(head, cfg.head_lr, cfg.weight_decay, mu, nu,
                                 clip=cfg.grad_clip)}
    if encoder:
        groups["encoder"] = AdamWGroup(encoder, cfg.enc_lr, cfg.weight_decay,
                                       mu, nu)
    return GroupedAdamW(groups)


def build_baseline_optimizer(cfg, head: List[torch.nn.Parameter],
                             encoder: List[torch.nn.Parameter]
                             ) -> GroupedAdamW:
    """The baseline's optimizer: one clip at cfg.grad_clip over head and
    encoder gradients together, then AdamW(head_lr) on the head
    (compression and classifier) and AdamW(enc_lr) on the encoder when
    it trains; shared weight decay."""
    mu = _DTYPES[cfg.adam_mu_dtype]
    nu = _DTYPES[cfg.adam_nu_dtype]
    groups = {"head": AdamWGroup(head, cfg.head_lr, cfg.weight_decay, mu, nu)}
    if encoder:
        groups["encoder"] = AdamWGroup(encoder, cfg.enc_lr, cfg.weight_decay,
                                       mu, nu)
    return GroupedAdamW(groups, clip=cfg.grad_clip)
