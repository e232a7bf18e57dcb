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
import time
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
from ..ops.rawboost import RawBoostDraws, rawboost_batch, rawboost_draws
from ..parallel.collectives import SINGLE, Shard, gather_rows
from ..parallel.mesh import (PARAM_SHARDINGS, apply_layout, check_layout,
                             local_batch)
from ..data.sampler import BalancedBatchSampler
from ..losses.supcon import supcon_multiclass_loss
from ..ops.supcon import supcon_binary_loss_fused
from ..ops.wire import dequantize_wire, quantize_wire
from ..utils.timing import span, start_profile, stop_profile
from . import checkpoint as ckpt
from .optim import build_optimizer, resolve_grad_bf16
from .schedule import alpha_for_epoch

__all__ = ["Stage1Trainer"]


def check_config(cfg, enc_config: Wav2Vec2Config) -> None:
    """Refuse the settings the port does not compute (a Stage1Config or
    a BaselineConfig, and the encoder's config)."""
    if enc_config.quant != "none":
        raise ValueError(f"quant={enc_config.quant!r} is serving only "
                         f"(int8 rounding has no gradient); the trainers "
                         f"take quant='none'")
    if resolve_grad_bf16(cfg) and cfg.compute_dtype != "bfloat16":
        raise ValueError(
            "grad_dtype='bfloat16' requires compute_dtype='bfloat16' "
            "(with fp32 compute, bf16 weight gradients would change "
            "what the step computes)")
    if cfg.rawboost_mode not in ("device", "host", "off"):
        raise ValueError(f"rawboost_mode must be 'device', 'host' or "
                         f"'off'; got {cfg.rawboost_mode!r}")
    if cfg.wire_dtype not in ("float32", "int16"):
        raise ValueError(f"wire_dtype must be 'float32' or 'int16'; got "
                         f"{cfg.wire_dtype!r}")
    if cfg.param_sharding not in PARAM_SHARDINGS:
        raise ValueError(f"param_sharding must be one of {PARAM_SHARDINGS}; "
                         f"got {cfg.param_sharding!r}")
    check_layout(pipeline=cfg.param_sharding == "pp",
                 sequence_parallel=getattr(cfg, "sequence_parallel", False),
                 microbatches=getattr(cfg, "pipeline_microbatches", 1),
                 batch=cfg.batch_size)


def _to_device(batch: Mapping, device: torch.device,
               keys=("waveforms", "labels", "multi_labels", "features")
               ) -> Dict[str, torch.Tensor]:
    """Host or device arrays -> tensors on `device` (a non-blocking copy
    from pinned host memory); int16 wire waveforms are dequantized there
    (dewire)."""
    out = {}
    for key in keys:
        if key in batch:
            x = batch[key]
            x = torch.from_numpy(np.asarray(x)) if not isinstance(
                x, torch.Tensor) else x
            out[key] = x.to(device, non_blocking=True)
    if "waveforms" in out:
        out["waveforms"] = dequantize_wire(out["waveforms"])
    return out


def _pinned(arrays: Mapping[str, np.ndarray], device: torch.device
            ) -> Dict[str, torch.Tensor]:
    """Host arrays as tensors, pinned when `device` is the card (so the
    step's copy is non-blocking)."""
    out = {k: torch.from_numpy(np.ascontiguousarray(v))
           for k, v in arrays.items()}
    if device.type == "cuda":
        return {k: v.pin_memory() for k, v in out.items()}
    return out


def _device_rawboost(waves: torch.Tensor, gen: torch.Generator,
                     device_gen: torch.Generator, prob: float,
                     params, shard: Shard = SINGLE) -> torch.Tensor:
    """In-step device RawBoost: a seed from the trainer's CPU generator
    seeds the device generator, which draws the numbers of the global
    batch; a gang's rank keeps its rows of every draw."""
    seed = int(torch.randint(0, 2 ** 62, (), generator=gen))
    device_gen.manual_seed(seed)
    b, t = waves.shape
    draws = rawboost_draws(device_gen, b * shard.n_data, t, params)
    if shard.n_data > 1:
        rows = slice(shard.batch_offset(b), shard.batch_offset(b) + b)
        draws = RawBoostDraws(**{f.name: getattr(draws, f.name)[rows]
                                 for f in dataclasses.fields(draws)})
    return rawboost_batch(waves, draws, prob, params)


def _load(mod: torch.nn.Module, sd: Mapping[str, torch.Tensor],
          device: torch.device) -> torch.nn.Module:
    """Copies of `sd` in fp32 on `device` as the parameters of `mod`,
    which was built on the meta device."""
    mod.load_state_dict({k: v.to(device, torch.float32, copy=True)
                         for k, v in sd.items()}, strict=True, assign=True)
    return mod


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
        _load(self.compression, weights["compression"], self.device)
        if self.encoder is not None:
            _load(self.encoder, weights["encoder"], self.device)
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
            _norm_group_fn(self.layout, self._parts))
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
        return _to_device(batch, self.device)

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
                    b["waveforms"] = _device_rawboost(
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
        return {**_module_states(self.layout, self._parts),
                "optimizer": _optimizer_state(self.layout, self.optimizer,
                                              self._parts),
                "step": self.step, "gen": self.gen.get_state()}

    def load_state_dict(self, state: Mapping) -> None:
        """Load a full train state (in a gang, each rank its shards)."""
        _load_states(self.layout, self.optimizer, self._parts, state)
        self.step = int(state["step"])
        self.gen.set_state(state["gen"])

    # --------------------------------------------------------------- data
    def _put(self, b: Batch) -> Dict[str, torch.Tensor]:
        """A host batch as tensors in the wire dtype, pinned on the card
        (run in the prefetch thread); in a gang, this rank's rows of the
        global batch."""
        arrays = {
            "waveforms": quantize_wire(b.waveforms)
            if self.cfg.wire_dtype == "int16" else b.waveforms,
            "labels": b.labels.astype(np.int64),
            "multi_labels": b.multi_labels.astype(np.int64)}
        if self.layout is not None:
            arrays = local_batch(arrays, self.layout.shard)
        return _pinned(arrays, self.device)

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
        wire16 = self.cfg.wire_dtype == "int16"

        def put(b: Batch) -> Dict[str, torch.Tensor]:
            return _pinned({
                "waveforms": quantize_wire(b.waveforms) if wire16
                else b.waveforms, "labels": b.labels.astype(np.int64),
                "valid": b.valid.astype(np.uint8)}, self.device)

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
    def fit(self, train_pipe: BatchPipeline,
            dev_pipe: Optional[BatchPipeline] = None,
            save_dir: Optional[str] = None, start_epoch: int = 1,
            log_fn=print, metrics_logger=None, preemption=None,
            skip_steps: int = 0, best_dev: float = float("inf"),
            profile_dir: Optional[str] = None) -> Dict:
        """Epoch loop with the alpha ramp and best-by-dev-loss checkpoints.
        -> history {'train_loss', 'dev_loss', 'alpha', 'clips_per_sec'}
        (one entry an epoch), plus 'preempted': True after a stop.

        In a gang every rank runs it in lockstep: the losses are the
        global batch's on every rank (so is the best-by-dev decision),
        the preemption flag is agreed, and every save is collective.
        The step losses stay on the device and are read once an epoch.
        `metrics_logger` (anything with `.log(epoch, dict)`) receives the
        epoch's scalars. `preemption` (utils/preemption.PreemptionGuard or
        anything with `requested(step)`) is polled after every step; on a
        request the full state is saved to 'latest' with a `batches_done`
        cursor and fit returns. `skip_steps` resumes the first epoch past
        that cursor (the pipeline replays the batch and host-RawBoost
        stream), and `best_dev` carries the best dev loss across resumes.
        A NaN dev loss is never best; without a dev pipe 'best' is an
        alias of 'latest'. `profile_dir` receives a torch.profiler trace
        (`train_steps_2-5.json`) of the first epoch's steps 2-5 of this
        call."""
        cfg = self.cfg
        if dev_pipe is not None and dev_pipe.rawboost is not None:
            raise ValueError("dev pipeline must not apply RawBoost")
        history = {"train_loss": [], "dev_loss": [], "alpha": [],
                   "clips_per_sec": []}
        prof = None
        profile_path = profile_dir and os.path.join(profile_dir,
                                                    "train_steps_2-5.json")
        for epoch in range(start_epoch, cfg.epochs + 1):
            alpha = alpha_for_epoch(epoch, cfg.warmup_epochs,
                                    cfg.alpha_ramp_epochs, cfg.alpha_end)
            t_epoch = time.perf_counter()
            losses = []
            skip = skip_steps if epoch == start_epoch else 0
            n_steps = skip   # absolute batch cursor within the epoch
            preempted = False
            for batch in self._device_batches(
                    train_pipe.train_epoch(epoch, skip=skip)):
                if profile_path and n_steps == skip + 1 and prof is None:
                    losses[-1].item()   # step 1 stays out of the trace
                    prof = start_profile(self.device)
                losses.append(self.train_step(batch, alpha)["loss"])
                n_steps += 1
                if prof is not None and n_steps >= skip + 5:
                    log_fn(stop_profile(prof, profile_path, losses[-1]))
                    prof, profile_path = None, None
                if preemption is not None and preemption.requested(n_steps):
                    preempted = True
                    break
            if prof is not None:   # the epoch ended inside the window
                log_fn(stop_profile(prof, profile_path, losses[-1]))
                prof, profile_path = None, None
            if preempted:
                if save_dir is not None:
                    # blocking: the process is about to stop
                    ckpt.save_checkpoint(
                        save_dir, "latest", self.state_dict(),
                        cfg.ckpt_config(),
                        {"epoch": epoch, "batches_done": n_steps,
                         "preempted": True, "best_dev": best_dev},
                        self._sidecar_extra())
                log_fn(f"[PREEMPTED] "
                       f"{'saved mid-epoch state at' if save_dir else 'stopping (no save_dir) at'} "
                       f"epoch {epoch} batch {n_steps}"
                       + ("; resume with --resume" if save_dir else ""))
                history["preempted"] = True
                return history
            values = torch.stack(losses).tolist() if losses else []
            epoch_s = time.perf_counter() - t_epoch
            train_loss = float(np.mean(values)) if values else 0.0

            dev_loss = float("nan")
            if dev_pipe is not None:
                dev = [self.eval_step(b) for b in
                       self._device_batches(dev_pipe.train_epoch(epoch))]
                if dev:
                    dev_loss = float(np.mean(torch.stack(dev).tolist()))

            n_run = n_steps - skip   # steps run in this call
            cps = (n_run * cfg.batch_size / epoch_s
                   if n_run and epoch_s > 0 else 0.0)
            history["train_loss"].append(train_loss)
            history["dev_loss"].append(dev_loss)
            history["alpha"].append(alpha)
            history["clips_per_sec"].append(cps)
            log_fn(f"[epoch {epoch:03d}] train_loss={train_loss:.4f} | "
                   f"dev_loss={dev_loss:.4f} | alpha={alpha:.3f} | "
                   f"clips/s={cps:.1f}")
            if metrics_logger is not None:
                metrics_logger.log(epoch, {
                    "train_loss": train_loss, "dev_loss": dev_loss,
                    "alpha": alpha, "clips_per_sec": cps})

            is_new_best = dev_loss < best_dev   # NaN is never best
            if is_new_best:
                best_dev = dev_loss
            if save_dir is not None:
                metrics = {"epoch": epoch, "train_loss": train_loss,
                           "dev_loss": dev_loss, "best_dev": best_dev}
                extra = self._sidecar_extra()
                # one host copy of the state serves 'latest' and 'best';
                # the writer thread hides the file writes behind the next
                # epoch
                host = ckpt.snapshot_for_save(self.state_dict())
                ckpt.save_checkpoint(save_dir, "latest", None,
                                     cfg.ckpt_config(), metrics, extra,
                                     block=False, host_state=host)
                if dev_pipe is None:
                    ckpt.alias_checkpoint(save_dir, "best", "latest")
                elif is_new_best:
                    ckpt.save_checkpoint(save_dir, "best", None,
                                         cfg.ckpt_config(), metrics, extra,
                                         block=False, host_state=host)
                    log_fn(f"[epoch {epoch:03d}] new best "
                           f"dev_loss={dev_loss:.4f}")
        if save_dir is not None:
            ckpt.wait_for_saves()
        return history

    # ------------------------------------------------ from features
    def _feature_batches(self, features: np.ndarray, labels: np.ndarray,
                         multi: Optional[np.ndarray],
                         batches: Iterator[np.ndarray]) -> Iterator[Dict]:
        """Balanced rows gathered from the (N, F, T) features (a memmap
        stays on disk), pinned in the prefetch thread; the step copies
        them to the card non-blocking, and `_feature_step_batch` turns
        them into (B, T, F) there. In a gang, this data rank's rows of
        each global batch."""
        def put(idx):
            if self.layout is not None:
                idx = local_batch({"idx": idx}, self.layout.shard)["idx"]
            return _pinned({
                "features": np.asarray(features[idx], np.float32),
                "labels": np.asarray(labels[idx]).astype(np.int64),
                "multi_labels": np.asarray(
                    (multi if multi is not None else labels)[idx]
                ).astype(np.int64)}, self.device)
        return prefetch_to_device(batches, put, depth=2)

    def _feature_step_batch(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        b = _to_device(batch, self.device)
        b["features"] = b["features"].transpose(1, 2)   # (B, T, F)
        return b

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
        best dev loss ('best' an alias of 'latest' without a dev set).
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
        best_dev = float("inf")
        history = {"train_loss": [], "dev_loss": [], "alpha": []}
        for epoch in range(1, cfg.epochs + 1):
            alpha = alpha_for_epoch(epoch, cfg.warmup_epochs,
                                    cfg.alpha_ramp_epochs, cfg.alpha_end)
            losses = [self.train_step(self._feature_step_batch(b),
                                      alpha)["loss"]
                      for b in self._feature_batches(
                          features, labels, multi_labels,
                          sampler.epoch_batches(epoch))]
            train_loss = (float(np.mean(torch.stack(losses).tolist()))
                          if losses else 0.0)
            dev_loss = float("nan")
            if dev_sampler is not None:
                dev = [self.eval_step(self._feature_step_batch(b))
                       for b in self._feature_batches(
                           dev_features, dev_labels, None,
                           dev_sampler.epoch_batches(epoch))]
                if dev:
                    dev_loss = float(np.mean(torch.stack(dev).tolist()))
            history["train_loss"].append(train_loss)
            history["dev_loss"].append(dev_loss)
            history["alpha"].append(alpha)
            log_fn(f"[epoch {epoch:03d}] train_loss={train_loss:.4f} | "
                   f"dev_loss={dev_loss:.4f} | alpha={alpha:.3f}")
            if save_dir is not None:
                metrics = {"epoch": epoch, "train_loss": train_loss,
                           "dev_loss": dev_loss}
                extra = self._sidecar_extra()
                host = ckpt.snapshot_for_save(self.state_dict())
                ckpt.save_checkpoint(save_dir, "latest", None,
                                     cfg.ckpt_config(), metrics, extra,
                                     block=False, host_state=host)
                if dev_sampler is None:
                    ckpt.alias_checkpoint(save_dir, "best", "latest")
                elif dev_loss < best_dev:   # NaN is never best
                    best_dev = dev_loss
                    ckpt.save_checkpoint(save_dir, "best", None,
                                         cfg.ckpt_config(), metrics, extra,
                                         block=False, host_state=host)
        if save_dir is not None:
            ckpt.wait_for_saves()
        return history

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


def _named(modules: Mapping[str, Optional[torch.nn.Module]]):
    """{id(parameter): (module key, parameter name)} over `modules`."""
    return {id(p): (key, n) for key, m in modules.items() if m is not None
            for n, p in m.named_parameters()}


def _norm_group_fn(layout, modules):
    """The optimizer's `norm_group` of a gang's layout (None in one
    process)."""
    if layout is None:
        return None
    names = _named(modules)
    return lambda p: layout.norm_group(names[id(p)][1], p)


def _module_states(layout, modules) -> Dict:
    """{key: state dict} of the modules; a gang's gathered to full."""
    return {key: (m.state_dict() if layout is None
                  else layout.full_state_dict(m))
            for key, m in modules.items() if m is not None}


def _optimizer_state(layout, optimizer, modules) -> Dict:
    """The optimizer's state; a gang's moments gathered to full."""
    state = optimizer.state_dict()
    if layout is None:
        return state
    names = _named(modules)
    for gname, grp in optimizer.groups.items():
        for key in ("mu", "nu"):
            state[gname][key] = [
                layout.full(names[id(p)][1], m, p)
                for p, m in zip(grp.params, state[gname][key])]
    return state


def _load_states(layout, optimizer, modules, state: Mapping) -> None:
    """Load a full state into the modules and the optimizer (in a gang,
    each rank its shards); the optimizer checks first."""
    opt = state["optimizer"]
    if layout is not None:
        names = _named(modules)
        opt = {g: dict(s) for g, s in opt.items()}
        for gname, grp in optimizer.groups.items():
            if gname not in opt:
                continue
            for key in ("mu", "nu"):
                if len(opt[gname][key]) != len(grp.params):
                    continue   # load_state_dict names the mismatch
                opt[gname][key] = [
                    layout.local(names[id(p)][1], m.to(p.device), p)
                    for p, m in zip(grp.params, opt[gname][key])]
    optimizer.load_state_dict(opt)
    for key, m in modules.items():
        if m is None:
            continue
        if layout is None:
            m.load_state_dict(state[key], strict=True)
        else:
            layout.load_full_state_dict(m, state[key])
