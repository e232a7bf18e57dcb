"""End-to-end BCE baseline trainer.

The port of `BaselineTrainer` of wav2vec_contr_loss_tpu/train/baseline.py
(:50-452). One step runs, on one device:

  waveforms -> device RawBoost (ops/rawboost.py, when
  rawboost_mode='device') -> Wav2Vec2 encoder (train mode when
  finetuning: dropout, SpecAugment, remat; its attention and LN+GELU
  kernels forward and backward) -> compression (dropout whenever
  training, also with a frozen encoder) -> time-mean (no L2) ->
  Linear(hidden_dim, 1) -> BCE with pos_weight (losses/bce.py) ->
  backward -> one global-norm clip over every trainable gradient -> AdamW
  per group (train/optim.py `build_baseline_optimizer`).

No SupCon runs: the gradient that reaches the encoder kernels comes from
the BCE head. `fit` scores the natural-distribution dev set every epoch
(sigmoid, the exact threshold sweep EER, accuracy at the threshold),
keeps `baseline_best` by dev EER and `baseline_latest` every epoch, stops
after `patience` epochs without a better EER, and on a preemption request
saves the full state mid-epoch with its batch cursor, best EER and
patience count. As in `Stage1Trainer`, every random number (dropout
seeds, SpecAugment uniforms, each step's RawBoost seed) comes from one
CPU `torch.Generator` seeded with cfg.seed, where the JAX trainer splits
a threefry key; a resumed run continues bit for bit.

`mesh=` makes the trainer one rank of a gang, as `Stage1Trainer`'s
(JAX baseline.py:245-287): `cfg.param_sharding` 'replicated' or 'fsdp',
tensor parallelism on a 'model' axis > 1, this rank's rows of each
global batch, every draw made for the global batch. 'pp' is refused: the
JAX `BaselineTrainer` has no pipeline layout (baseline.py:146-160). The BCE is a mean
over equal local batches, so the gradients averaged over 'data' are the
global batch's; the step's loss is averaged over 'data' too, and the dev
EER is computed on every rank from logits gathered over 'data'
(`fetch_global`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import BaselineConfig, Wav2Vec2Config, config_from_dict
from ..data.pipeline import (Batch, BatchPipeline, prefetch_to_device,
                             stream_through_device)
from ..device import resolve_device
from ..eval.metrics import eer_threshold_sweep
from ..losses.bce import bce_logits_loss
from ..models.compression import CompressionModule, clip_embedding
from ..models.wav2vec2 import Wav2Vec2Encoder
from ..parallel.collectives import SINGLE, gather_rows
from ..parallel.mesh import apply_layout
from . import checkpoint as ckpt
from .core import (EpochEnd, check_config, device_rawboost, fit_epochs,
                   load_fp32, load_states, module_states, norm_group_fn,
                   optimizer_state, to_device, wire_batch)
from .optim import build_baseline_optimizer

__all__ = ["BaselineTrainer", "BASELINE_NO_PP"]

BEST, LATEST = "baseline_best", "baseline_latest"
BASELINE_NO_PP = ("the baseline has no pipeline layout: the JAX "
                  "BaselineTrainer lays its parameters out 'replicated' or "
                  "'fsdp' (baseline.py:146-160); param_sharding='pp' is "
                  "stage 1's")


class BaselineTrainer:
    """`weights` holds the 'encoder', 'compression' and 'classifier'
    (`weight` (1, hidden_dim), `bias` (1,)) state dicts; the trainer
    trains copies of them on `device`. `pos_weight` (the neg/pos ratio of
    the train labels) weights the positive class when
    cfg.use_pos_weight. `mesh`: one rank of a gang (module docstring)."""

    def __init__(self, cfg: BaselineConfig, enc_config: Wav2Vec2Config,
                 weights: Mapping[str, Mapping[str, torch.Tensor]],
                 device="cuda", pos_weight: float = 1.0, mesh=None):
        check_config(cfg, enc_config)
        if cfg.param_sharding == "pp":
            raise ValueError(BASELINE_NO_PP)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.enc_config = enc_config.with_(dtype=cfg.compute_dtype)
        with torch.device("meta"):
            self.encoder = Wav2Vec2Encoder(self.enc_config,
                                           remat=cfg.remat_encoder)
            self.compression = CompressionModule(cfg.input_dim, cfg.hidden_dim,
                                                 cfg.dropout)
            self.classifier = nn.Linear(cfg.hidden_dim, 1)
        for name in ("encoder", "compression", "classifier"):
            load_fp32(getattr(self, name), weights[name], self.device)
        self.encoder.requires_grad_(cfg.finetune_encoder)
        self._parts = {"encoder": self.encoder,
                       "compression": self.compression,
                       "classifier": self.classifier}
        self.layout = (None if mesh is None else
                       apply_layout(self._parts, mesh, cfg.param_sharding))
        self.optimizer = build_baseline_optimizer(
            cfg, list(self.compression.parameters())
            + list(self.classifier.parameters()),
            list(self.encoder.parameters()) if cfg.finetune_encoder else [],
            norm_group_fn(self.layout, self._parts))
        self.pos_weight = pos_weight if cfg.use_pos_weight else None
        self.rawboost_params = cfg.rawboost_params()
        self.gen = torch.Generator().manual_seed(cfg.seed)
        self._rawboost_gen = (
            torch.Generator(device=self.device)
            if cfg.use_rawboost and cfg.rawboost_mode == "device" else None)
        self.step = 0

    # -------------------------------------------------------------- steps
    def _logits(self, waves: torch.Tensor, train: bool) -> torch.Tensor:
        """waveforms -> (B,) logits. The encoder trains only when
        finetuning; the compression dropout runs whenever `train`."""
        enc_train = train and self.cfg.finetune_encoder
        self.encoder.train(enc_train)
        self.compression.train(train)
        with torch.set_grad_enabled(enc_train):
            layer_mean = self.encoder(
                waves, waves != 0.0,
                gen=self.gen if enc_train else None)["layer_mean"]
        seq = self.compression(layer_mean, gen=self.gen if train else None)
        pooled = clip_embedding(seq, l2_normalize=False)
        return self.classifier(pooled)[..., 0]

    @property
    def shard(self):
        return SINGLE if self.layout is None else self.layout.shard

    def train_step(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        """One BCE step on `batch` ({'waveforms': (B, T) float32 or int16
        wire, 'labels': (B,) 0/1}; in a gang, this rank's slice of the
        global batch). -> {'loss': scalar tensor on the device, averaged
        over 'data' in a gang} (no host sync)."""
        b = to_device(batch, self.device, ("waveforms", "labels"))
        waves = b["waveforms"]
        if self._rawboost_gen is not None:
            waves = device_rawboost(waves, self.gen, self._rawboost_gen,
                                    self.cfg.rawboost_prob,
                                    self.rawboost_params, self.shard)
        loss = bce_logits_loss(self._logits(waves, train=True), b["labels"],
                               self.pos_weight)
        self.optimizer.zero_grad()
        loss.backward()
        loss = loss.detach()
        if self.layout is not None:
            self.layout.average_gradients(self.optimizer.parameters())
            loss = gather_rows(loss[None], self.shard).mean()
        self.optimizer.step()
        self.step += 1
        return {"loss": loss}

    @torch.no_grad()
    def logits_step(self, waves) -> torch.Tensor:
        """(B, T) waveforms (float32 or int16 wire) -> (B,) eval-mode
        logits on the device."""
        b = to_device({"waveforms": waves}, self.device, ("waveforms",))
        return self._logits(b["waveforms"], train=False)

    # --------------------------------------------------------------- data
    def _put(self, b: Batch) -> Dict[str, torch.Tensor]:
        """Pinned wire tensors; in a gang, this rank's rows."""
        return wire_batch(b, self.cfg, self.device,
                          self.layout and self.layout.shard)

    def _scored_batches(self, pipe: BatchPipeline
                        ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """(valid-row logits, valid-row labels) per sequential batch, with
        decode, compute and the copy back overlapped; in a gang each rank
        scores its rows and the logits are gathered over 'data'."""
        def logits(waves):
            return gather_rows(self.logits_step(waves), self.shard)

        for lg, b in stream_through_device(
                pipe.sequential(), lambda b: self._put(b)["waveforms"],
                logits):
            yield lg[b.valid], b.labels[b.valid]

    def score_dataset(self, pipe: BatchPipeline
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """-> ((N,) logits, (N,) labels) over `pipe`'s dataset in order,
        for CM score files."""
        logits, labels = zip(*self._scored_batches(pipe))
        return np.concatenate(logits), np.concatenate(labels)

    def evaluate_dev(self, dev_pipe: BatchPipeline
                     ) -> Tuple[float, float, float]:
        """-> (dev EER, threshold, accuracy at the threshold) over the
        natural-distribution dev set, on sigmoid scores."""
        logits, labels = self.score_dataset(dev_pipe)
        scores = 1.0 / (1.0 + np.exp(-logits))
        eer, thresh = eer_threshold_sweep(labels, scores)
        acc = float(((scores >= thresh).astype(int) == labels).mean())
        return eer, thresh, acc

    # ---------------------------------------------------------------- fit
    def fit(self, train_pipe: BatchPipeline, dev_pipe: BatchPipeline,
            save_dir: Optional[str] = None, log_fn=print, preemption=None,
            start_epoch: int = 1, skip_steps: int = 0,
            best_eer: float = float("inf"),
            epochs_no_improve: int = 0) -> Dict:
        """Epoch loop with the dev EER, patience and early stop
        (train/core.py `fit_epochs`).
        -> history {'train_loss', 'dev_eer', 'dev_acc'} (one entry an
        epoch), plus 'preempted': True after a stop.

        `preemption` (anything with `requested(step)`) is polled after
        every step; on a request the full state is saved to
        'baseline_latest' with its `batches_done` cursor, `best_eer` and
        `epochs_no_improve`, and fit returns. `skip_steps` resumes the
        first epoch past that cursor; `best_eer` and `epochs_no_improve`
        carry the best dev EER and the patience count across resumes, and
        a resume that has already reached the patience is a no-op."""
        def end_epoch(epoch, train_loss, n_run, seconds):
            dev_eer, thresh, dev_acc = self.evaluate_dev(dev_pipe)
            log_fn(f"[epoch {epoch:03d}] train_loss={train_loss:.4f} | "
                   f"dev_eer={dev_eer * 100:.2f}% | dev_acc="
                   f"{dev_acc * 100:.2f}% | thresh={thresh:.4f}")
            return EpochEnd(dev_eer, {"train_loss": train_loss,
                                      "dev_eer": dev_eer, "dev_acc": dev_acc},
                            {"dev_eer": dev_eer, "dev_acc": dev_acc},
                            f"[epoch {epoch:03d}] new best dev EER="
                            f"{dev_eer * 100:.2f}%")

        def cursor(name, best, stale):
            # 'baseline_best' carries no resume cursor, as JAX's
            return ({"best_eer": best, "epochs_no_improve": stale}
                    if name == LATEST else {})

        return fit_epochs(
            self, ("train_loss", "dev_eer", "dev_acc"),
            lambda epoch, skip: prefetch_to_device(
                train_pipe.train_epoch(epoch, skip=skip), self._put, depth=2),
            lambda batch, epoch: self.train_step(batch)["loss"], end_epoch,
            save_dir=save_dir, log_fn=log_fn, names=(LATEST, BEST),
            cursor=cursor, start_epoch=start_epoch, skip_steps=skip_steps,
            best=best_eer, stale=epochs_no_improve, patience=self.cfg.patience,
            show_best=lambda best: f"best EER={best * 100:.2f}%",
            preemption=preemption)

    # -------------------------------------------------------------- state
    def state_dict(self) -> Dict:
        """The full train state; its tensors are the live ones. In a
        gang: full tensors gathered from the shards (collective)."""
        return {**module_states(self.layout, self._parts),
                "optimizer": optimizer_state(self.layout, self.optimizer,
                                             self._parts),
                "step": self.step, "gen": self.gen.get_state()}

    def load_state_dict(self, state: Mapping) -> None:
        """Load a full train state (in a gang, each rank its shards)."""
        load_states(self.layout, self.optimizer, self._parts, state)
        self.step = int(state["step"])
        self.gen.set_state(state["gen"])

    def _sidecar_extra(self) -> Dict:
        return {"enc_config": dataclasses.asdict(self.enc_config),
                "baseline_config": dataclasses.asdict(self.cfg)}

    def restore(self, save_dir: str, name: str = BEST) -> Dict:
        """Load the full train state of <save_dir>/<name> into this
        trainer. -> the checkpoint's sidecar."""
        state, sidecar = ckpt.restore_checkpoint(save_dir, name)
        self.load_state_dict(state)
        return sidecar

    @classmethod
    def from_checkpoint(cls, save_dir: str, name: str = BEST,
                        device="cuda", mesh=None,
                        param_sharding: Optional[str] = None
                        ) -> "BaselineTrainer":
        """Rebuild the trainer and its state from a checkpoint directory
        alone; a JAX sidecar's extra fields (the XLA-path and TPU knobs)
        are dropped. On `mesh`, each rank its shards, in
        `param_sharding` (the sidecar's when None)."""
        state, sidecar = ckpt.restore_checkpoint(save_dir, name)
        extra = sidecar["extra"]
        names = {f.name for f in dataclasses.fields(BaselineConfig)}
        cfg = BaselineConfig(**{k: v for k, v in
                                extra["baseline_config"].items()
                                if k in names})
        if cfg.param_sharding == "pp":
            # the JAX BaselineTrainer lays out fsdp and replicates the rest
            cfg = cfg.replace(param_sharding="replicated")
        if param_sharding is not None:
            cfg = cfg.replace(param_sharding=param_sharding)
        trainer = cls(cfg, config_from_dict(extra["enc_config"]),
                      {k: state[k] for k in ("encoder", "compression",
                                             "classifier")}, device=device,
                      mesh=mesh)
        trainer.load_state_dict(state)
        return trainer
