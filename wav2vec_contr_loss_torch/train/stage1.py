"""Stage-1 training step: SupCon finetuning of the encoder.

The port of `Stage1Trainer` of wav2vec_contr_loss_tpu/train/stage1.py:
`train_step` (:355-404), `eval_step` (:406-410) and `embed_step`, whose
shared body is `_embed` (:296-320). One step runs, on one device:

  waveforms -> Wav2Vec2 encoder (train mode: dropout, SpecAugment; its
  LayerNorm+GELU and attention kernels forward and backward) ->
  compression (dropout) -> time-mean + L2 -> fused SupCon kernel (loss,
  dL/dz, dL/dalpha) -> backward -> grouped AdamW (train/optim.py).

With `finetune_encoder=False` the encoder runs in eval mode without
gradients, outside the differentiated part, as the JAX step hoists it.
Every random number (dropout seeds, SpecAugment uniforms) comes from one
CPU `torch.Generator` seeded with `cfg.seed`, so a CPU run and a GPU run
of the same config draw the same seeds.

Not ported yet: device RawBoost (`use_rawboost=True` with
`rawboost_mode='device'` raises), `fit`, checkpoints, the data pipeline,
the multiclass loss mode and `from_features`.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..config import Stage1Config, SupConConfig, Wav2Vec2Config
from ..device import resolve_device
from ..models.compression import CompressionModule, clip_embedding
from ..models.wav2vec2 import Wav2Vec2Encoder
from ..ops.supcon import supcon_binary_loss_fused
from ..ops.wire import dequantize_wire
from .optim import build_optimizer, resolve_grad_bf16

__all__ = ["Stage1Trainer"]


class Stage1Trainer:
    """`weights` holds the 'encoder' and 'compression' state dicts, as
    `bridge.jax_params_to_torch` returns them (a 'head' entry is
    ignored); the trainer trains copies of them on `device`."""

    def __init__(self, cfg: Stage1Config, enc_config: Wav2Vec2Config,
                 weights: Mapping[str, Mapping[str, torch.Tensor]],
                 device="cuda"):
        if cfg.use_rawboost and cfg.rawboost_mode == "device":
            raise NotImplementedError(
                "device RawBoost (rawboost_mode='device') is not ported "
                "yet: it comes with the next slice of the port, with `fit` "
                "and checkpoints. Pass use_rawboost=False.")
        if resolve_grad_bf16(cfg) and cfg.compute_dtype != "bfloat16":
            raise ValueError(
                "grad_dtype='bfloat16' requires compute_dtype='bfloat16' "
                "(with fp32 compute, bf16 weight gradients would change "
                "what the step computes)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.enc_config = enc_config.with_(dtype=cfg.compute_dtype)
        with torch.device("meta"):
            self.encoder = Wav2Vec2Encoder(
                self.enc_config, remat=cfg.remat_encoder,
                remat_conv=cfg.remat_conv,
                freeze_feature_extractor=cfg.freeze_feature_extractor)
            self.compression = CompressionModule(cfg.input_dim, cfg.hidden_dim,
                                                 cfg.dropout)
        for name, mod in (("encoder", self.encoder),
                          ("compression", self.compression)):
            mod.load_state_dict({k: v.to(self.device, torch.float32,
                                         copy=True)
                                 for k, v in weights[name].items()},
                                strict=True, assign=True)

        # the 'frozen' group of the JAX trainer: no gradient, no update
        fx = set(self.encoder.feature_extractor.parameters())
        enc = []
        for p in self.encoder.parameters():
            train = cfg.finetune_encoder and not (
                cfg.freeze_feature_extractor and p in fx)
            p.requires_grad_(train)
            if train:
                enc.append(p)
        self.optimizer = build_optimizer(
            cfg, list(self.compression.parameters()), enc)
        self.supcon_cfg = SupConConfig(
            temperature=cfg.temperature, similarity=cfg.supcon_similarity,
            topk_neg=cfg.topk_neg, uniformity_weight=cfg.uniformity_weight,
            uniformity_t=cfg.uniformity_t)
        self.gen = torch.Generator().manual_seed(cfg.seed)

    # ------------------------------------------------------------ helpers
    def _batch(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        """Host or device arrays -> tensors on the trainer's device; int16
        wire waveforms are dequantized there (dewire)."""
        out = {}
        for key in ("waveforms", "labels"):
            if key in batch:
                x = batch[key]
                x = torch.from_numpy(np.asarray(x)) if not isinstance(
                    x, torch.Tensor) else x
                out[key] = x.to(self.device, non_blocking=True)
        out["waveforms"] = dequantize_wire(out["waveforms"])
        return out

    def _embed(self, waves: torch.Tensor, train: bool) -> torch.Tensor:
        """waveforms -> (B, D) L2-normalized clip embeddings. The encoder
        trains only when finetuning; a frozen one stays in eval mode."""
        enc_train = train and self.cfg.finetune_encoder
        self.encoder.train(enc_train)
        self.compression.train(train)
        with torch.set_grad_enabled(enc_train):
            enc_out = self.encoder(waves, waves != 0.0,
                                   gen=self.gen if enc_train else None)
        seq = self.compression(enc_out["layer_mean"],
                               gen=self.gen if train else None)
        return clip_embedding(seq)

    # -------------------------------------------------------------- steps
    def train_step(self, batch: Mapping, alpha) -> Dict[str, torch.Tensor]:
        """One SupCon step on `batch` ({'waveforms': (B, T) float32 or
        int16 wire, 'labels': (B,) ints}) at mining weight `alpha`.
        -> {'loss': scalar tensor on the device} (no host sync)."""
        b = self._batch(batch)
        z = self._embed(b["waveforms"], train=True)
        loss = supcon_binary_loss_fused(z, b["labels"], alpha,
                                        self.supcon_cfg)
        self.optimizer.zero_grad()
        loss.backward()
        self.optimizer.step()
        return {"loss": loss.detach()}

    @torch.no_grad()
    def eval_step(self, batch: Mapping) -> torch.Tensor:
        """Dev loss: eval mode, alpha = 0 (as the JAX eval step)."""
        b = self._batch(batch)
        z = self._embed(b["waveforms"], train=False)
        return supcon_binary_loss_fused(z, b["labels"], 0.0, self.supcon_cfg)

    @torch.no_grad()
    def embed_step(self, batch: Mapping) -> torch.Tensor:
        """(B, D) clip embeddings in eval mode."""
        return self._embed(self._batch(batch)["waveforms"], train=False)
