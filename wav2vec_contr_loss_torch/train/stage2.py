"""Stage-2: binary classifier over precomputed clip embeddings.

The port of wav2vec_contr_loss_tpu/train/stage2.py: a linear or small-MLP
head trained with the masked BCE and the train split's pos_weight under
AdamW (optax's `adamw` defaults: b1 0.9, b2 0.999, eps 1e-8), per-epoch
dev accuracy / AUC / EER, early stopping on the dev EER with patience
(dev loss where the EER is undefined), and the best head saved with its
config. The shuffle order comes from `np.random.default_rng(cfg.seed)`,
as in the JAX trainer, so both see the same batches.

Embeddings are small ((N, 256) fp32): each epoch's batches go to the
device at once, the steps run as plain PyTorch steps there, and their
losses are read once an epoch. The stage-2 head has no Pallas kernel in
the JAX package and none here: it is `nn.Linear` on cuBLAS.
"""

from __future__ import annotations

import sys
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..config import Stage2Config
from ..device import resolve_device
from ..eval.metrics import binary_classification_metrics
from ..losses import bce_logits_loss, pos_weight_from_labels
from ..models.heads import build_head
from . import checkpoint as ckpt

__all__ = ["train_stage2", "stage2_scores", "load_stage2_head",
           "STAGE2_BEST"]

STAGE2_BEST = "stage2_binary_head_best"


def _batchify(x: np.ndarray, y: np.ndarray, batch_size: int, rng=None):
    """-> (steps, B, ...) stacks, shuffled when `rng` is given (train).
    The final partial batch is zero-padded and masked in both paths, so
    no clip is dropped (the reference's drop_last=False)."""
    n = x.shape[0]
    batch_size = min(batch_size, n)  # tiny datasets: shrink, don't starve
    if rng is not None:
        order = rng.permutation(n)
        x, y = x[order], y[order]
    steps = -(-n // batch_size)
    pad = steps * batch_size - n
    xp = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
    yp = np.concatenate([y, np.zeros(pad, y.dtype)])
    mask = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    return (
        xp.reshape(steps, batch_size, -1),
        yp.reshape(steps, batch_size),
        mask.reshape(steps, batch_size),
    )


def _build(cfg: Stage2Config, device: torch.device,
           state: Optional[Mapping[str, torch.Tensor]] = None
           ) -> torch.nn.Module:
    """The head on `device`: from `state`, else a seeded default init
    (the global generator forked, so the caller's stream is untouched)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)
        head = build_head(cfg.head_type, cfg.in_dim, cfg.hidden_dim,
                          cfg.dropout)
    if state is not None:
        head.load_state_dict(state, strict=True)
    return head.to(device)


def _to(device: torch.device, *arrays: np.ndarray):
    return [torch.from_numpy(a).to(device) for a in arrays]


def train_stage2(cfg: Stage2Config, train_embs: np.ndarray,
                 train_labels: np.ndarray, dev_embs: np.ndarray,
                 dev_labels: np.ndarray, save_dir: Optional[str] = None,
                 log_fn=print,
                 init_state: Optional[Mapping[str, torch.Tensor]] = None,
                 device="cuda") -> Tuple[Dict[str, torch.Tensor], Dict]:
    """-> (best head state dict on the CPU, history). Early stop on dev
    EER with patience cfg.patience.

    `init_state` starts the head from a state dict (for example a JAX
    head bridged by `bridge.head_state_dict`); the default is a seeded
    init. History holds per-epoch 'train_loss', 'dev_loss', 'dev_eer',
    'dev_acc' and 'step_losses' (one array of step losses an epoch)."""
    device = resolve_device(device)
    if train_embs.shape[1] != cfg.in_dim:
        raise ValueError(f"embeddings are {train_embs.shape[1]} wide but "
                         f"cfg.in_dim is {cfg.in_dim}")
    head = _build(cfg, device, init_state)
    # the head's dropout draws its masks on the device from this stream
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    pos_weight = pos_weight_from_labels(train_labels)
    opt = torch.optim.AdamW(head.parameters(), lr=cfg.lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=cfg.weight_decay)

    np_rng = np.random.default_rng(cfg.seed)
    best_eer, best_dev_loss = float("inf"), float("inf")
    best = {k: v.detach().cpu().clone() for k, v in head.state_dict().items()}
    epochs_no_improve = 0
    history = {"train_loss": [], "dev_loss": [], "dev_eer": [],
               "dev_acc": [], "step_losses": []}

    dev_x, dev_y, dev_mask = _batchify(dev_embs.astype(np.float32),
                                       dev_labels.astype(np.float32),
                                       cfg.batch_size)
    keep = dev_mask.reshape(-1)
    labels = dev_y.reshape(-1)[keep]
    dev_xt = torch.from_numpy(dev_x.reshape(-1, dev_x.shape[-1])[keep]
                              ).to(device)
    dev_yt = torch.from_numpy(labels).to(device)

    for epoch in range(1, cfg.epochs + 1):
        xs, ys, ms = _to(device, *_batchify(train_embs.astype(np.float32),
                                            train_labels.astype(np.float32),
                                            cfg.batch_size, np_rng))
        head.train()
        losses = []
        for x, y, m in zip(xs, ys, ms):
            loss = bce_logits_loss(head(x, gen=gen), y, pos_weight, mask=m)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        step_losses = torch.stack(losses)
        # sample-weighted epoch mean, as the reference accumulates it
        counts = ms.sum(dim=1).float()
        epoch_loss = (step_losses * counts).sum() / counts.sum()

        head.eval()
        with torch.no_grad():
            logits_t = head(dev_xt)
            dev_loss_t = bce_logits_loss(logits_t, dev_yt, pos_weight)
        # the epoch's one read of the device
        host = torch.cat([epoch_loss[None], dev_loss_t[None], step_losses,
                          logits_t]).cpu().numpy()
        train_loss, dev_loss = float(host[0]), float(host[1])
        history["step_losses"].append(host[2:2 + len(losses)])
        logits = host[2 + len(losses):]
        probs = 1.0 / (1.0 + np.exp(-logits))
        dev_acc, dev_auc, dev_eer = binary_classification_metrics(labels, probs)

        history["train_loss"].append(train_loss)
        history["dev_loss"].append(dev_loss)
        history["dev_eer"].append(dev_eer)
        history["dev_acc"].append(dev_acc)
        msg = (f"[epoch {epoch:03d}] train_loss={train_loss:.4f} | "
               f"dev_loss={dev_loss:.4f} | dev_acc={dev_acc * 100:.2f}%")
        msg += (f" | dev_auc={dev_auc:.4f}" if dev_auc is not None
                else " | dev_auc=N/A")
        msg += (f" | dev_eer={dev_eer * 100:.2f}%" if dev_eer is not None
                else " | dev_eer=N/A")
        log_fn(msg)

        improved = (dev_eer < best_eer if dev_eer is not None
                    else dev_loss < best_dev_loss)
        if improved:
            epochs_no_improve = 0
            if dev_eer is not None:
                best_eer = dev_eer
            best_dev_loss = min(best_dev_loss, dev_loss)
            best = {k: v.detach().cpu().clone()
                    for k, v in head.state_dict().items()}
            if save_dir is not None:
                ckpt.save_checkpoint(
                    save_dir, STAGE2_BEST, best, cfg.ckpt_config(),
                    {"epoch": epoch, "dev_eer": dev_eer, "dev_acc": dev_acc,
                     "dev_auc": dev_auc, "dev_loss": dev_loss})
        else:
            epochs_no_improve += 1
            if epochs_no_improve >= cfg.patience:
                log_fn(f"[EARLY STOP] patience {cfg.patience} reached "
                       f"(best EER={best_eer * 100:.2f}%)")
                break

    return best, history


@torch.no_grad()
def stage2_scores(cfg: Stage2Config, state: Mapping[str, torch.Tensor],
                  embs: np.ndarray, batch_size: int = 4096,
                  device="cuda") -> np.ndarray:
    """Raw logits (higher == more bonafide-like) of the head with
    `state` over (N, in_dim) embeddings, in eval mode."""
    device = resolve_device(device)
    head = _build(cfg, device, state).eval()
    out = [head(torch.from_numpy(np.asarray(embs[s:s + batch_size],
                                            np.float32)).to(device))
           for s in range(0, embs.shape[0], batch_size)]
    if not out:
        return np.zeros(0, np.float32)
    return torch.cat(out).cpu().numpy()


def load_stage2_head(ckpt_dir: str, name: str = STAGE2_BEST
                     ) -> Tuple[Stage2Config, Dict[str, torch.Tensor]]:
    """-> (Stage2Config, head state dict) of a stage-2 checkpoint, the
    config read from its sidecar's UPPERCASE dict."""
    state, sidecar = ckpt.restore_checkpoint(ckpt_dir, name)
    c = sidecar["config"]
    cfg = Stage2Config(
        head_type=c.get("HEAD_TYPE", "linear"),
        in_dim=int(c.get("IN_DIM", 256)),
        hidden_dim=int(c.get("HIDDEN_DIM", 128)),
        dropout=float(c.get("DROPOUT", 0.2)),
    )
    # stderr: stdout may be a machine-readable stream
    print(f"Loaded Stage-2 head: type={cfg.head_type}, in_dim={cfg.in_dim}, "
          f"hidden_dim={cfg.hidden_dim}, dropout={cfg.dropout}",
          file=sys.stderr)
    return cfg, state
