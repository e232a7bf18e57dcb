"""The reference's first training steps of stage-1 SupCon finetuning.

From the initial weights and the step's batch it computes, in plain
PyTorch (fp32, TF32 off, or a control at a lower precision), what one
step of the recipe does: RawBoost on the batch, the encoder in train
mode (murmur dropout, SpecAugment; one layer at a time, see
`model.encoder_layer_mean`), compression with its dropout, the clip
embedding, binary SupCon, the gradients of every parameter, a
global-norm clip of the head's (compression's) gradients, and AdamW per
group (head and encoder learning rates, shared weight decay, fp32
moments). The first gradient it reports is rounded as the recipe's
first moment keeps it (`_as_first_moment`).

Every random number is derived again from the recipe's seed, in the
order the recipe draws them each step: the RawBoost seed (its numbers
then come from a generator on the device seeded with it), the dropout
seeds of the feature projection and the encoder input, four seeds a
layer (attention, attention output, activation, FFN output; a site at
rate 0 draws none), the SpecAugment uniforms, and the compression's
dropout seed.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from . import model, rawboost, supcon


def _draw_seed(gen: torch.Generator) -> int:
    return int(torch.randint(0, 2 ** 31 - 1, (), generator=gen))


def step_draws(gen: torch.Generator, cfg: Dict, recipe: Dict, batch: int,
               t_frames: int) -> Dict:
    """One step's draws from the CPU generator, in the recipe's order."""
    out = {"rawboost": int(torch.randint(0, 2 ** 62, (), generator=gen))
           if recipe["use_rawboost"] else None}

    def seed(rate):
        return _draw_seed(gen) if rate > 0.0 else None

    out["feat_proj"] = seed(cfg["feat_proj_dropout"])
    out["encoder_in"] = seed(cfg["hidden_dropout"])
    rates = (cfg["attention_dropout"], cfg["hidden_dropout"],
             cfg["activation_dropout"], cfg["hidden_dropout"])
    out["layers"] = [dict(zip(("attention", "attention_out", "activation",
                               "ffn_out"), (seed(r) for r in rates)))
                     for _ in range(cfg["num_hidden_layers"])]
    out["spans"] = None
    if cfg["apply_spec_augment"] and cfg["mask_time_prob"] > 0:
        out["spans"] = (torch.rand(batch, generator=gen),
                        torch.rand(batch, model.max_mask_spans(t_frames, cfg),
                                   generator=gen))
    out["compression"] = seed(recipe["dropout"])
    return out


class _AdamW:
    def __init__(self, params: List[torch.Tensor], lr: float, wd: float,
                 b1: float, b2: float, eps: float):
        self.params, self.lr, self.wd = params, lr, wd
        self.b1, self.b2, self.eps = b1, b2, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.n = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        self.n += 1
        bc1, bc2 = 1 - self.b1 ** self.n, 1 - self.b2 ** self.n
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            upd = (m / bc1) / ((v / bc2).sqrt() + self.eps) + self.wd * p
            p.sub_(self.lr * upd)


def _as_first_moment(g: torch.Tensor, recipe: Dict) -> torch.Tensor:
    """g as the recipe's optimizer keeps it after step 1: (1 - b1) g in the
    first moment's dtype (`adam_mu_dtype`), read back over (1 - b1). The
    program's first gradient is read from that moment, so both sides
    round alike and a gap is one of the gradients, not of the rounding."""
    c = 1 - recipe["b1"]
    return (g * c).to(getattr(torch, recipe["adam_mu_dtype"])).float() / c


def run_steps(params: Dict[str, torch.Tensor], cfg: Dict, recipe: Dict,
              seed: int, batches: Sequence, steps: int = 3,
              precision: str = "fp32",
              fault: Optional[str] = None) -> Dict:
    """`params`: flat HF-named fp32 tensors (encoder names bare,
    'compression.*'), trained in place. `batches`: (waves (B, T) fp32,
    labels (B,)) on the params' device. `precision`: a `model.Precision`
    name. `fault`: None, or 'half_batch'
    (the loss over the first half of the batch alone, a planted fault).
    -> {'loss': [per step], 'first': {name: step 1's gradient as the
    optimizer takes it and keeps it in its first moment}, 'grad': {name: its norm}, 'update': {name: norm
    of the change after `steps` steps}}."""
    prec = model.Precision(precision)
    names = list(params)
    head = [n for n in names if n.startswith("compression.")]
    enc = [n for n in names if n not in head]
    init = {n: params[n].detach().clone() for n in names}
    for p in params.values():
        p.requires_grad_(True)
    betas = (recipe["b1"], recipe["b2"], recipe["eps"])
    opt_head = _AdamW([params[n] for n in head], recipe["head_lr"],
                      recipe["weight_decay"], *betas)
    opt_enc = _AdamW([params[n] for n in enc], recipe["enc_lr"],
                     recipe["weight_decay"], *betas)
    gen = torch.Generator().manual_seed(seed)
    losses, first = [], None
    with model.tf32(precision == "tf32"):
        for i in range(steps):
            waves, labels = batches[i]
            b, t = waves.shape
            t_frames = model.conv_out_frames(t, cfg)
            d = step_draws(gen, cfg, recipe, b, t_frames)
            if d["rawboost"] is not None:
                g = torch.Generator(device=waves.device).manual_seed(
                    d["rawboost"])
                waves = rawboost.rawboost(waves, rawboost.draws(g, b, t),
                                          recipe["rawboost_prob"])
            lm = model.encoder_layer_mean(params, waves, cfg, d, prec)
            z = model.clip_embedding(params, lm, d["compression"],
                                     recipe["dropout"], prec)
            if fault == "half_batch":
                z, labels = z[: b // 2], labels[: b // 2]
            elif fault is not None:
                raise ValueError(f"unknown fault {fault!r}")
            loss = supcon.supcon_binary(z, labels, recipe["alpha"],
                                        recipe["temperature"],
                                        recipe["topk_neg"])
            grads = torch.autograd.grad(loss, [params[n] for n in names],
                                        allow_unused=True)
            grads = {n: torch.zeros_like(params[n]) if g is None else g
                     for n, g in zip(names, grads)}
            hn = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(grads[n]) for n in head]))
            scale = torch.where(hn < recipe["grad_clip"], 1.0,
                                recipe["grad_clip"] / hn)
            hg = [grads[n] * scale for n in head]
            if first is None:
                first = dict(zip(head, (g.detach() for g in hg)))
                first.update({n: grads[n].detach() for n in enc})
                first = {n: _as_first_moment(g, recipe)
                         for n, g in first.items()}
            opt_head.step(hg)
            opt_enc.step([grads[n] for n in enc])
            losses.append(float(loss.detach()))
            del lm, z, loss, grads, hg
    update = {n: float(torch.linalg.vector_norm(params[n].detach() - init[n]))
              for n in names}
    return {"loss": losses, "update": update, "first": first,
            "grad": {n: float(torch.linalg.vector_norm(g))
                     for n, g in first.items()}}
