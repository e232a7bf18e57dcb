"""Serving: waveform -> spoof score on one device.

The port of wav2vec_contr_loss_tpu/eval/serving.py. `SpoofScorer` runs
the encoder (compute dtype from its config, bf16 on the card), the
compression module, the clip pooling and the stage-2 head (fp32) on one
device, and returns one raw logit per clip (higher == more
bonafide-like). `from_checkpoints` builds it from a port stage-1 and
stage-2 checkpoint pair; `score_dataset` scores a pipeline's dataset
with decode, compute and the copy back overlapped. `quantize='w8a8'` or
`'w8'` quantizes the six transformer linears of each layer to int8 when
the weights are bound (ops/quant.py); nothing on disk changes.
`export` writes the whole scoring graph with its weights as one
`torch.export` artifact, which eval/artifact.py `load_exported` runs
without this module.
"""

from __future__ import annotations

import io
from typing import Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import Stage2Config, Wav2Vec2Config, config_from_dict
from ..data.pipeline import BatchPipeline, stream_through_device
from ..device import resolve_device
from ..models.compression import CompressionModule, clip_embedding
from ..models.heads import build_head
from ..models.wav2vec2 import Wav2Vec2Encoder
from ..ops.quant import QUANT_MODES, quantize_encoder_state_dict
from ..ops.wire import dequantize_wire, quantize_wire
from ..train import checkpoint as ckpt
from ..train.stage2 import STAGE2_BEST, load_stage2_head
from .artifact import (ExportedScorer, ExportSpec, load_exported,
                       wrap_export)

__all__ = ["SpoofScorer", "window_waveform", "ExportSpec", "ExportedScorer",
           "load_exported"]


def window_waveform(wave: np.ndarray, num_samples: int,
                    hop: int) -> np.ndarray:
    """Split a 1-D waveform into (W, num_samples) windows covering the
    whole clip: starts at 0, hop, 2*hop, ..., plus an end-aligned final
    window. A clip of at most num_samples gives one zero-padded window."""
    n = wave.shape[0]
    if n <= num_samples:
        out = np.zeros((1, num_samples), np.float32)
        out[0, :n] = wave
        return out
    starts = list(range(0, n - num_samples + 1, hop))
    if starts[-1] != n - num_samples:
        starts.append(n - num_samples)
    return np.stack([wave[s:s + num_samples] for s in starts])


_WINDOW_AGG = {
    # higher logit == more bonafide-like, so 'min' is the spoof-sensitive
    # choice: a clip is as fake as its fakest window
    "mean": np.mean,
    "min": np.min,
    "max": np.max,
    "median": np.median,
}

_WIRES = ("float32", "int16")


def _embed(encoder: nn.Module, compression: nn.Module,
           waves: torch.Tensor) -> torch.Tensor:
    """(B, T) float32 or int16-wire waves on the device -> (B, H) clip
    embeddings."""
    waves = dequantize_wire(waves)
    enc_out = encoder(waves, waves != 0.0)
    return clip_embedding(compression(enc_out["layer_mean"]))


class _ScoringProgram(nn.Module):
    """waves -> logits: the graph `SpoofScorer.export` traces."""

    def __init__(self, encoder, compression, head):
        super().__init__()
        self.encoder, self.compression, self.head = encoder, compression, head

    def forward(self, waves: torch.Tensor) -> torch.Tensor:
        return self.head(_embed(self.encoder, self.compression, waves))


class SpoofScorer:
    """Encoder + compression + stage-2 head as one scoring function.

    `weights` holds the 'encoder', 'compression' and 'head' state dicts,
    as `bridge.jax_params_to_torch` returns them, the encoder's in fp32.
    Clips are `max_duration_seconds * sample_rate` samples long.
    `quantize` ('none' | 'w8a8' | 'w8') quantizes the encoder's
    transformer linears at bind time, as the JAX scorer does
    (serving.py:151-170)."""

    def __init__(self, enc_config: Wav2Vec2Config,
                 weights: Mapping[str, Mapping[str, torch.Tensor]],
                 stage2_cfg: Stage2Config = Stage2Config(), *,
                 sample_rate: int = 16000, max_duration_seconds: int = 5,
                 device="cuda", quantize: str = "none"):
        if quantize not in QUANT_MODES:
            raise ValueError(f"quantize must be one of {QUANT_MODES}; got "
                             f"{quantize!r}")
        self.device = resolve_device(device)
        self.quantize = quantize
        enc_config = enc_config.with_(quant=quantize)
        if quantize != "none":
            weights = dict(weights, encoder=quantize_encoder_state_dict(
                weights["encoder"]))
        self.enc_config = enc_config
        self.sample_rate = sample_rate
        self.num_samples = max_duration_seconds * sample_rate
        # built without storage, then bound to the given tensors
        with torch.device("meta"):
            modules = {
                "encoder": Wav2Vec2Encoder(enc_config),
                "compression": CompressionModule(enc_config.hidden_size,
                                                 stage2_cfg.in_dim),
                "head": build_head(stage2_cfg.head_type, stage2_cfg.in_dim,
                                   stage2_cfg.hidden_dim, stage2_cfg.dropout),
            }
        for name, mod in modules.items():
            mod.load_state_dict(weights[name], strict=True, assign=True)
            mod.to(self.device).eval().requires_grad_(False)
        self.encoder = modules["encoder"]
        self.compression = modules["compression"]
        self.head = modules["head"]

    @classmethod
    def from_checkpoints(cls, stage1_dir: str, stage2_dir: str,
                         stage1_name: str = "best",
                         stage2_name: str = STAGE2_BEST, device="cuda",
                         compute_dtype: Optional[str] = None,
                         quantize: str = "none") -> "SpoofScorer":
        """A scorer from a port stage-1 checkpoint (<name>.pt beside its
        .config.json, as `Stage1Trainer.fit` writes it) and a stage-2 head
        checkpoint. Only the encoder and compression weights of the
        stage-1 state are read, not its optimizer moments. The encoder
        computes in the checkpoint's dtype unless `compute_dtype`
        ('bfloat16' | 'float32') is given; `quantize` as in __init__."""
        extra = ckpt.load_sidecar(stage1_dir, stage1_name)["extra"]
        enc_config = config_from_dict(extra["enc_config"])
        if compute_dtype is not None:
            enc_config = enc_config.with_(dtype=compute_dtype)
        s1 = extra["stage1_config"]
        weights = ckpt.restore_parts(stage1_dir, stage1_name,
                                     ("encoder", "compression"))
        cfg2, weights["head"] = load_stage2_head(stage2_dir, stage2_name)
        return cls(enc_config, weights, cfg2,
                   sample_rate=s1["target_sample_rate"],
                   max_duration_seconds=s1["max_duration_seconds"],
                   device=device, quantize=quantize)

    @torch.inference_mode()
    def run(self, waves: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, T) float32 or int16-wire waveforms -> ((B, H) clip
        embeddings, (B,) logits), both fp32 on the scorer's device."""
        z = _embed(self.encoder, self.compression,
                   waves.to(self.device, non_blocking=True))
        return z, self.head(z)

    def export(self, batch: int, wire: str = "float32") -> bytes:
        """The scoring graph with its weights as one artifact (bytes to
        write to a file): `torch.export` of waves -> logits at the static
        input (batch, num_samples) in the wire dtype (float32, or int16
        PCM), on this scorer's device, which the program bakes in. The
        two kernels are custom ops in the program, so it runs them; the
        weights are this scorer's (fp32, or int8 with `quantize`).
        `eval.artifact.load_exported` loads it."""
        if wire not in _WIRES:
            raise ValueError(f"wire must be one of {_WIRES}; got {wire!r}")
        program = _ScoringProgram(self.encoder, self.compression,
                                  self.head).eval()
        example = torch.zeros(batch, self.num_samples, device=self.device,
                              dtype=torch.int16 if wire == "int16"
                              else torch.float32)
        with torch.no_grad():
            exported = torch.export.export(program, (example,), strict=False)
        buf = io.BytesIO()
        torch.export.save(exported, buf)
        return wrap_export(buf.getvalue(), {
            "format": "torch.export", "sample_rate": self.sample_rate,
            "quantize": self.quantize, "wire": wire,
            "device": self.device.type})

    def score_waveforms(self, waves: np.ndarray,
                        wire: str = "float32") -> np.ndarray:
        """(B, T) float32 zero-padded waveforms -> (B,) raw logits.
        wire='int16' ships the batch as 16-bit PCM (ops/wire.py)."""
        if wire not in _WIRES:
            raise ValueError(f"wire must be one of {_WIRES}; got {wire!r}")
        host = (quantize_wire(waves) if wire == "int16"
                else np.asarray(waves, np.float32))
        _, logits = self.run(torch.from_numpy(host))
        return logits.cpu().numpy()

    def score_long_waveforms(self, waves, hop_seconds: float = 2.5,
                             agg: str = "mean", batch: int = 8,
                             wire: str = "float32") -> np.ndarray:
        """Variable-length clips -> one logit each: overlapping windows of
        the clip length are scored in fixed-shape batches and aggregated
        per clip with agg in 'mean' | 'min' | 'max' | 'median'."""
        t = self.num_samples
        hop = max(1, int(hop_seconds * self.sample_rate))
        aggf = _WINDOW_AGG[agg]

        wins = [window_waveform(np.asarray(w, np.float32), t, hop)
                for w in waves]
        flat = np.concatenate(wins) if wins else np.zeros((0, t), np.float32)
        pad = -flat.shape[0] % batch
        if pad:
            flat = np.concatenate([flat, np.zeros((pad, t), np.float32)])
        logits = np.concatenate([
            self.score_waveforms(flat[i:i + batch], wire=wire)
            for i in range(0, flat.shape[0], batch)
        ]) if flat.shape[0] else np.zeros((0,), np.float32)

        out, off = np.zeros(len(wins), np.float32), 0
        for i, w in enumerate(wins):
            out[i] = aggf(logits[off:off + w.shape[0]])
            off += w.shape[0]
        return out

    def score_dataset(self, pipe: BatchPipeline
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (logits, labels) of the valid rows of `pipe`'s dataset in
        order, float32 waveforms; decode, compute and the copy back
        overlap (stream_through_device)."""
        pin = self.device.type == "cuda"

        def put(b):
            w = torch.from_numpy(np.asarray(b.waveforms, np.float32))
            return w.pin_memory() if pin else w

        logits, labels = [], []
        for lg, b in stream_through_device(pipe.sequential(), put,
                                           lambda w: self.run(w)[1]):
            logits.append(lg[b.valid])
            labels.append(b.labels[b.valid])
        return np.concatenate(logits), np.concatenate(labels)
