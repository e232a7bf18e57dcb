"""Stage-1 training: SupCon finetuning of the encoder.

The port of `Stage1Trainer` of wav2vec_contr_loss_tpu/train/stage1.py:
`train_step` (:355-404), `eval_step` (:406-410), `embed_step` with their
shared `_embed` and `_loss` (:296-333), the epoch loop `fit` (:453-616),
the head-only loop over precomputed encoder features `fit_from_features`
(:618-700), the extraction pass `embed_dataset` (:703-724) and the
checkpoint reload `restore` / `from_checkpoint` (:727-768). One step
runs, on one device:

  waveforms -> device RawBoost (ops/rawboost.py, when
  rawboost_mode='device') -> Wav2Vec2 encoder (train mode: dropout,
  SpecAugment; its LayerNorm+GELU and attention kernels forward and
  backward) -> compression (dropout) -> time-mean + L2 -> fused SupCon
  kernel (loss, dL/dz, dL/dalpha) -> backward -> grouped AdamW
  (train/optim.py).

`loss_mode='multiclass'` trains on the attack-id classes with the plain
multi-class SupCon (losses/supcon.py) at `multiclass_temperature`
instead of the binary kernel. `from_features=True` builds no encoder and
needs no encoder weights: the batches carry (B, T, F) layer-mean
features, and only the compression module trains.

With `finetune_encoder=False` the encoder runs in eval mode without
gradients, outside the differentiated part, as the JAX step hoists it.
Every random number (dropout seeds, SpecAugment uniforms, each step's
RawBoost seed) comes from one CPU `torch.Generator` seeded with
`cfg.seed`; RawBoost's own numbers are drawn on the trainer's device from
a generator seeded with that step's seed. The trainer holds its state
(parameters, optimizer, step, generator) and `state_dict` /
`load_state_dict` move all of it, so a resumed run continues bit for bit.

`mesh=` (parallel/mesh.py `make_mesh`) makes the trainer one rank of a
gang (the port of JAX `Stage1Trainer(mesh=...)`, stage1.py:161-286 and
:421-448): `cfg.param_sharding` 'replicated' or 'fsdp', tensor
parallelism when the mesh's 'model' axis is > 1 (with
`cfg.sequence_parallel`, the frames too), or 'pp', GPipe stages over
that axis with `cfg.pipeline_microbatches` microbatches, as JAX takes
pipeline_stages from the mesh (stage1.py:189-200) (`apply_layout`). Every
rank seeds its generators alike and draws for the global batch, keeping
its slice; each rank's batch is its data rank's rows of the global batch
(`_device_batches` slices, `train_step` takes the slice). The clip
embeddings are gathered over 'data' and every rank computes the binary
SupCon kernel (or the multiclass loss) on the global batch, so the loss,
the dev loss and every decision `fit` takes from them are the same bits
on every rank; the gradients are averaged over 'data' (FSDP2 reduces
the layers' itself). `state_dict` gathers the shards into full HF-named
tensors (collective) and `load_state_dict` takes full tensors, so a
checkpoint is layout-free. In a gang `embed_dataset` decodes and embeds
each rank's rows of every padded batch and gathers the embeddings in
corpus order, and `fit_from_features` trains the replicated head
data-parallel on each rank's rows of the global balanced batches, the
loss on the gathered embeddings as in `fit`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from ..config import (Stage1Config, SupConConfig, Wav2Vec2Config,
                      config_from_dict)
from ..data.pipeline import (Batch, BatchPipeline, prefetch_to_device,
                             stream_through_device)
from ..device import resolve_device
from ..models.compression import CompressionModule, clip_embedding
from ..models.wav2vec2 import Wav2Vec2Encoder
from ..parallel.collectives import SINGLE, Shard, gather_rows
from ..parallel.mesh import apply_layout, local_batch
from ..data.sampler import BalancedBatchSampler
from ..losses.supcon import supcon_multiclass_loss
from ..ops.supcon import supcon_binary_loss_fused
from ..utils.timing import span, start_profile, stop_profile
from . import checkpoint as ckpt
from .core import (EpochEnd, check_config, device_rawboost, fit_epochs,
                   load_fp32, load_states, module_states, norm_group_fn,
                   optimizer_state, pinned, to_device, wire_batch)
from .optim import build_optimizer
from .schedule import alpha_for_epoch

__all__ = ["Stage1Trainer"]


class Stage1Trainer:
    """`weights` holds the 'encoder' and 'compression' state dicts, as
    `bridge.jax_params_to_torch` returns them (a 'head' entry is
    ignored; a `from_features` trainer needs no 'encoder'); the trainer
    trains copies of them on `device`. `mesh`: one rank of a gang
    (module docstring); None, the single-process trainer."""

    def __init__(self, cfg: Stage1Config, enc_config: Wav2Vec2Config,
                 weights: Mapping[str, Mapping[str, torch.Tensor]],
                 device="cuda", loss_mode: str = "binary",
                 from_features: bool = False,
                 multiclass_temperature: float = 0.1, mesh=None):
        check_config(cfg, enc_config)
        if loss_mode not in ("binary", "multiclass"):
            raise ValueError(f"loss_mode must be 'binary' or 'multiclass'; "
                             f"got {loss_mode!r}")
        self.cfg = cfg
        self.loss_mode = loss_mode
        self.from_features = from_features
        self.multiclass_temperature = multiclass_temperature
        self.device = resolve_device(device)
        self.enc_config = enc_config.with_(dtype=cfg.compute_dtype)
        with torch.device("meta"):
            self.compression = CompressionModule(cfg.input_dim, cfg.hidden_dim,
                                                 cfg.dropout)
            self.encoder = None if from_features else Wav2Vec2Encoder(
                self.enc_config, remat=cfg.remat_encoder,
                remat_conv=cfg.remat_conv,
                freeze_feature_extractor=cfg.freeze_feature_extractor)
        load_fp32(self.compression, weights["compression"], self.device)
        if self.encoder is not None:
            load_fp32(self.encoder, weights["encoder"], self.device)
            # the 'frozen' group of the JAX trainer: no gradient, no update
            fx = set(self.encoder.feature_extractor.parameters())
            for p in self.encoder.parameters():
                p.requires_grad_(cfg.finetune_encoder and not (
                    cfg.freeze_feature_extractor and p in fx))
        self.layout = None
        if mesh is not None:
            self.layout = apply_layout(
                {"encoder": self.encoder, "compression": self.compression},
                mesh, cfg.param_sharding, cfg.sequence_parallel,
                cfg.pipeline_microbatches)
        self._parts = {"encoder": self.encoder,
                       "compression": self.compression}
        self.optimizer = build_optimizer(
            cfg, list(self.compression.parameters()),
            [] if self.encoder is None else
            [p for p in self.encoder.parameters() if p.requires_grad],
            norm_group_fn(self.layout, self._parts))
        self.supcon_cfg = SupConConfig(
            temperature=cfg.temperature, similarity=cfg.supcon_similarity,
            topk_neg=cfg.topk_neg, uniformity_weight=cfg.uniformity_weight,
            uniformity_t=cfg.uniformity_t)
        self.rawboost_params = cfg.rawboost_params()
        self.gen = torch.Generator().manual_seed(cfg.seed)
        # RawBoost's numbers, drawn on the device; reseeded every step
        self._rawboost_gen = (
            torch.Generator(device=self.device)
            if cfg.use_rawboost and cfg.rawboost_mode == "device"
            and not from_features else None)
        self.step = 0

    # ------------------------------------------------------------ helpers
    def _batch(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        """The batch's 'waveforms' (or 'features'), 'labels' and
        'multi_labels' on the trainer's device (_to_device)."""
        return to_device(batch, self.device)

    def _embed(self, b: Mapping[str, torch.Tensor],
               train: bool) -> torch.Tensor:
        """A device batch's waveforms (or (B, T, F) features) -> (B, D)
        L2-normalized clip embeddings. The encoder trains only when
        finetuning; a frozen one stays in eval mode."""
        self.compression.train(train)
        if self.from_features:
            layer_mean = b["features"]
        else:
            waves = b["waveforms"]
            enc_train = train and self.cfg.finetune_encoder
            self.encoder.train(enc_train)
            with torch.set_grad_enabled(enc_train):
                layer_mean = self.encoder(
                    waves, waves != 0.0,
                    gen=self.gen if enc_train else None)["layer_mean"]
        seq = self.compression(layer_mean, gen=self.gen if train else None)
        return clip_embedding(seq)

    def _loss(self, z: torch.Tensor, b: Mapping[str, torch.Tensor],
              alpha) -> torch.Tensor:
        """The loss of the global batch: in a gang, z and the labels
        gathered over 'data' (differentiably for z)."""
        if self.layout is not None:
            sh = self.layout.shard
            z = gather_rows(z, sh)
            b = {k: gather_rows(b[k], sh) for k in ("labels", "multi_labels")
                 if k in b}
        if self.loss_mode == "multiclass":
            return supcon_multiclass_loss(z, b["multi_labels"],
                                          self.multiclass_temperature)
        return supcon_binary_loss_fused(z, b["labels"], alpha,
                                        self.supcon_cfg)

    # -------------------------------------------------------------- steps
    @property
    def shard(self) -> Shard:
        return SINGLE if self.layout is None else self.layout.shard

    def train_step(self, batch: Mapping, alpha) -> Dict[str, torch.Tensor]:
        """One SupCon step on `batch` ({'waveforms': (B, T) float32 or
        int16 wire, or 'features': (B, T, F) for a from_features trainer;
        'labels': (B,) ints; 'multi_labels' for the multiclass loss} at
        mining weight `alpha`; in a gang, this rank's slice of the global
        batch, as `local_batch` cuts it). -> {'loss': scalar tensor on
        the device, the global batch's} (no host sync). Under a profiler
        the step and its phases are `w2v.*` ranges (utils/timing.py)."""
        with span("w2v.step"):
            with span("w2v.batch"):
                b = self._batch(batch)
            if self._rawboost_gen is not None:
                with span("w2v.rawboost"):
                    b["waveforms"] = device_rawboost(
                        b["waveforms"], self.gen, self._rawboost_gen,
                        self.cfg.rawboost_prob, self.rawboost_params,
                        self.shard)
            with span("w2v.forward"):
                z = self._embed(b, train=True)
            with span("w2v.loss"):
                loss = self._loss(z, b, alpha)
            # the gradients are cleared before the backward, so that they
            # stay readable after the step: two optimizer ranges a step
            with span("w2v.optimizer"):
                self.optimizer.zero_grad()
            with span("w2v.backward"):
                loss.backward()
            with span("w2v.optimizer"):
                if self.layout is not None:
                    self.layout.average_gradients(self.optimizer.parameters())
                self.optimizer.step()
            self.step += 1
            return {"loss": loss.detach()}

    @torch.no_grad()
    def eval_step(self, batch: Mapping) -> torch.Tensor:
        """Dev loss: eval mode, no RawBoost, alpha = 0 (as the JAX eval
        step)."""
        b = self._batch(batch)
        return self._loss(self._embed(b, train=False), b, 0.0)

    @torch.no_grad()
    def embed_step(self, batch: Mapping) -> torch.Tensor:
        """(B, D) clip embeddings in eval mode."""
        return self._embed(self._batch(batch), train=False)

    # -------------------------------------------------------------- state
    def state_dict(self) -> Dict:
        """The full train state; its tensors are the live ones. A
        from_features trainer has no 'encoder'. In a gang: full tensors
        gathered from the shards (collective: every rank calls it)."""
        return {**module_states(self.layout, self._parts),
                "optimizer": optimizer_state(self.layout, self.optimizer,
                                             self._parts),
                "step": self.step, "gen": self.gen.get_state()}

    def load_state_dict(self, state: Mapping) -> None:
        """Load a full train state (in a gang, each rank its shards)."""
        load_states(self.layout, self.optimizer, self._parts, state)
        self.step = int(state["step"])
        self.gen.set_state(state["gen"])

    # --------------------------------------------------------------- data
    def _put(self, b: Batch) -> Dict[str, torch.Tensor]:
        """A host batch as tensors in the wire dtype, pinned on the card
        (run in the prefetch thread); in a gang, this rank's rows of the
        global batch."""
        return wire_batch(b, self.cfg, self.device,
                          self.layout and self.layout.shard,
                          ("multi_labels",))

    def _device_batches(self, batches: Iterator[Batch]) -> Iterator[Dict]:
        """Prefetch two batches ahead: the producer thread decodes and, on
        the card, pins the host arrays; `train_step` copies them with
        non_blocking=True from this thread, on the stream it computes on."""
        return prefetch_to_device(batches, self._put, depth=2)

    # --------------------------------------------------------- extraction
    def embed_dataset(self, pipe: BatchPipeline
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Eval-mode forward over `pipe`'s dataset in order -> ((N, D)
        float32 embeddings, (N,) labels) of its valid rows. The batches
        ride the int16 wire when cfg.wire_dtype says so; decode, compute
        and the copy back overlap (stream_through_device). In a gang
        (collective) each rank decodes and embeds its data rank's rows of
        every padded batch, and every rank gets the gathered result."""
        sh = self.shard

        def put(b: Batch) -> Dict[str, torch.Tensor]:
            return wire_batch(b, self.cfg, self.device, keys=("valid",))

        def embed(b: Dict[str, torch.Tensor]):
            z = self.embed_step(b)
            rows = (b[k].to(self.device, non_blocking=True)
                    for k in ("labels", "valid"))
            return tuple(gather_rows(x, sh) for x in (z, *rows))

        zs, ys = [], []
        for (z, labels, valid), _ in stream_through_device(
                pipe.sequential(part=(sh.data_rank, sh.n_data)), put, embed):
            zs.append(z[valid.astype(bool)])
            ys.append(labels[valid.astype(bool)])
        return np.concatenate(zs), np.concatenate(ys).astype(np.int32)

    # ---------------------------------------------------------------- fit
    def _alpha(self, epoch: int) -> float:
        cfg = self.cfg
        return alpha_for_epoch(epoch, cfg.warmup_epochs,
                               cfg.alpha_ramp_epochs, cfg.alpha_end)

    def _dev_loss(self, batches: Iterator[Mapping]) -> float:
        """The mean eval loss over `batches` (NaN without any)."""
        dev = [self.eval_step(b) for b in batches]
        return (float(np.mean(torch.stack(dev).tolist())) if dev
                else float("nan"))

    def fit(self, train_pipe: BatchPipeline,
            dev_pipe: Optional[BatchPipeline] = None,
            save_dir: Optional[str] = None, start_epoch: int = 1,
            log_fn=print, metrics_logger=None, preemption=None,
            skip_steps: int = 0, best_dev: float = float("inf"),
            profile_dir: Optional[str] = None) -> Dict:
        """Epoch loop with the alpha ramp and best-by-dev-loss checkpoints
        (train/core.py `fit_epochs`: 'latest' every epoch, 'best' on a new
        best dev loss, NaN never, or an alias of 'latest' without a dev
        pipe; on a `preemption` request, 'latest' with its `batches_done`
        cursor). -> history {'train_loss', 'dev_loss', 'alpha',
        'clips_per_sec'} (one entry an epoch), plus 'preempted': True
        after a stop.

        `skip_steps` resumes the first epoch past that cursor (the
        pipeline replays the batch and host-RawBoost stream), and
        `best_dev` carries the best dev loss across resumes. In a gang
        every rank runs it in lockstep on the global batch's losses.
        `metrics_logger` (anything with `.log(epoch, dict)`) receives the
        epoch's scalars; `profile_dir` a torch.profiler trace
        (`train_steps_2-5.json`) of the first epoch's steps 2-5 of this
        call."""
        if dev_pipe is not None and dev_pipe.rawboost is not None:
            raise ValueError("dev pipeline must not apply RawBoost")
        trace = _TraceWindow(profile_dir, self.device, log_fn)

        def step(batch, epoch):
            return trace.step(
                lambda: self.train_step(batch, self._alpha(epoch))["loss"])

        def end_epoch(epoch, train_loss, n_run, seconds):
            trace.stop()   # the epoch ended inside the window
            dev_loss = (float("nan") if dev_pipe is None else
                        self._dev_loss(self._device_batches(
                            dev_pipe.train_epoch(epoch))))
            alpha = self._alpha(epoch)
            cps = (n_run * self.cfg.batch_size / seconds
                   if n_run and seconds > 0 else 0.0)
            log_fn(f"[epoch {epoch:03d}] train_loss={train_loss:.4f} | "
                   f"dev_loss={dev_loss:.4f} | alpha={alpha:.3f} | "
                   f"clips/s={cps:.1f}")
            row = {"train_loss": train_loss, "dev_loss": dev_loss,
                   "alpha": alpha, "clips_per_sec": cps}
            if metrics_logger is not None:
                metrics_logger.log(epoch, dict(row))
            return EpochEnd(dev_loss, row,
                            {"train_loss": train_loss, "dev_loss": dev_loss},
                            f"[epoch {epoch:03d}] new best "
                            f"dev_loss={dev_loss:.4f}")

        history = fit_epochs(
            self, ("train_loss", "dev_loss", "alpha", "clips_per_sec"),
            lambda epoch, skip: self._device_batches(
                train_pipe.train_epoch(epoch, skip=skip)),
            step, end_epoch, save_dir=save_dir, log_fn=log_fn,
            has_dev=dev_pipe is not None,
            cursor=lambda name, best, stale: {"best_dev": best},
            start_epoch=start_epoch, skip_steps=skip_steps, best=best_dev,
            preemption=preemption)
        trace.stop()   # preempted inside the window
        return history

    # ------------------------------------------------ from features
    def _feature_batches(self, features: np.ndarray, labels: np.ndarray,
                         multi: Optional[np.ndarray],
                         batches: Iterator[np.ndarray]) -> Iterator[Dict]:
        """Balanced rows gathered from the (N, F, T) features (a memmap
        stays on disk) and pinned in the prefetch thread, then copied to
        the trainer's device non-blocking and turned into (B, T, F)
        there. In a gang, this data rank's rows of each global batch."""
        def put(idx):
            if self.layout is not None:
                idx = local_batch({"idx": idx}, self.layout.shard)["idx"]
            return pinned({
                "features": np.asarray(features[idx], np.float32),
                "labels": np.asarray(labels[idx]).astype(np.int64),
                "multi_labels": np.asarray(
                    (multi if multi is not None else labels)[idx]
                ).astype(np.int64)}, self.device)
        for batch in prefetch_to_device(batches, put, depth=2):
            b = to_device(batch, self.device)
            b["features"] = b["features"].transpose(1, 2)   # (B, T, F)
            yield b

    def fit_from_features(self, features: np.ndarray, labels: np.ndarray,
                          dev_features: Optional[np.ndarray] = None,
                          dev_labels: Optional[np.ndarray] = None,
                          multi_labels: Optional[np.ndarray] = None,
                          save_dir: Optional[str] = None,
                          log_fn=print) -> Dict:
        """Head-only training on precomputed encoder features, (N, F, T)
        as `extract_encoder_features` writes them (possibly memmapped),
        with (N,) binary labels and, for the multiclass loss, (N,)
        attack-id `multi_labels` (the binary labels otherwise; the dev
        set is scored with its binary labels, as the JAX loop does).
        Balanced batches (seed cfg.seed; dev seed + 1), the alpha ramp,
        one dev loss an epoch, 'latest' every epoch and 'best' on a new
        best dev loss ('best' an alias of 'latest' without a dev set;
        train/core.py `fit_epochs`).
        -> history {'train_loss', 'dev_loss', 'alpha'}.

        The rows of a batch are gathered on the host in the (N, F, T)
        layout and transposed to (B, T, F) on the trainer's device, after
        the copy. In a gang every rank samples the same global batches
        and takes its data rank's rows; the loss is the global batch's
        (`_loss`) and the head's gradients are averaged over 'data'."""
        if not self.from_features:
            raise ValueError("fit_from_features needs a trainer built with "
                             "from_features=True")
        cfg = self.cfg
        sampler = BalancedBatchSampler(labels, cfg.batch_size, seed=cfg.seed)
        dev_sampler = (BalancedBatchSampler(dev_labels, cfg.batch_size,
                                            seed=cfg.seed + 1)
                       if dev_labels is not None else None)

        def end_epoch(epoch, train_loss, n_run, seconds):
            dev_loss = (float("nan") if dev_sampler is None else
                        self._dev_loss(self._feature_batches(
                            dev_features, dev_labels, None,
                            dev_sampler.epoch_batches(epoch))))
            alpha = self._alpha(epoch)
            log_fn(f"[epoch {epoch:03d}] train_loss={train_loss:.4f} | "
                   f"dev_loss={dev_loss:.4f} | alpha={alpha:.3f}")
            return EpochEnd(dev_loss, {"train_loss": train_loss,
                                       "dev_loss": dev_loss, "alpha": alpha},
                            {"train_loss": train_loss, "dev_loss": dev_loss})

        return fit_epochs(
            self, ("train_loss", "dev_loss", "alpha"),
            lambda epoch, skip: self._feature_batches(
                features, labels, multi_labels, sampler.epoch_batches(epoch)),
            lambda batch, epoch: self.train_step(
                batch, self._alpha(epoch))["loss"],
            end_epoch, save_dir=save_dir, log_fn=log_fn,
            has_dev=dev_sampler is not None)

    # ------------------------------------------------------------ restore
    def _sidecar_extra(self) -> Dict:
        return {"enc_config": dataclasses.asdict(self.enc_config),
                "stage1_config": dataclasses.asdict(self.cfg),
                "loss_mode": self.loss_mode,
                "from_features": self.from_features}

    def restore(self, save_dir: str, name: str = "best") -> Dict:
        """Load the full train state of <save_dir>/<name> into this
        trainer. -> the checkpoint's sidecar."""
        state, sidecar = ckpt.restore_checkpoint(save_dir, name)
        self.load_state_dict(state)
        return sidecar

    @classmethod
    def from_checkpoint(cls, save_dir: str, name: str = "best",
                        device="cuda", mesh=None,
                        param_sharding: Optional[str] = None
                        ) -> "Stage1Trainer":
        """Rebuild the trainer and its state from a checkpoint directory
        alone: the configs from the sidecar, the rest from the state; on
        `mesh`, each rank its shards (a checkpoint is layout-free), in
        `param_sharding` (the sidecar's when None)."""
        state, sidecar = ckpt.restore_checkpoint(save_dir, name)
        extra = sidecar["extra"]
        # a JAX sidecar also carries the fields the port leaves out
        # (config.py: the XLA-path and TPU knobs)
        names = {f.name for f in dataclasses.fields(Stage1Config)}
        cfg = Stage1Config(**{k: v for k, v in extra["stage1_config"].items()
                              if k in names})
        if param_sharding is not None:
            cfg = cfg.replace(param_sharding=param_sharding)
        trainer = cls(cfg, config_from_dict(extra["enc_config"]),
                      {k: state[k] for k in ("encoder", "compression")
                       if k in state}, device=device,
                      loss_mode=extra.get("loss_mode", "binary"),
                      from_features=extra.get("from_features", False),
                      mesh=mesh)
        trainer.load_state_dict(state)
        return trainer


class _TraceWindow:
    """`fit`'s profiler window: steps 2-5 of the call, closed early where
    the first epoch ends; the trace goes to train_steps_2-5.json."""

    def __init__(self, profile_dir: Optional[str], device: torch.device,
                 log_fn):
        self.path = profile_dir and os.path.join(profile_dir,
                                                 "train_steps_2-5.json")
        self.device, self.log_fn = device, log_fn
        self.prof, self.last, self.n = None, None, 0

    def step(self, run):
        if self.path and self.n == 1:
            self.last.item()   # step 1 stays out of the trace
            self.prof = start_profile(self.device)
        self.last = run()
        self.n += 1
        if self.n == 5:
            self.stop()
        return self.last

    def stop(self) -> None:
        if self.prof is not None:
            self.log_fn(stop_profile(self.prof, self.path, self.last))
        self.prof, self.path = None, None
