"""Serving: waveform -> spoof score on one device.

The port of wav2vec_contr_loss_tpu/eval/serving.py. `SpoofScorer` runs
the encoder (compute dtype from its config, bf16 on the card), the
compression module, the clip pooling and the stage-2 head (fp32) on one
device, and returns one raw logit per clip (higher == more
bonafide-like). Artifact export and checkpoint loading are not ported.
"""

from __future__ import annotations

from typing import Mapping, Tuple

import numpy as np
import torch

from ..config import Stage2Config, Wav2Vec2Config
from ..models.compression import CompressionModule, clip_embedding
from ..models.heads import build_head
from ..models.wav2vec2 import Wav2Vec2Encoder
from ..ops.wire import dequantize_wire, quantize_wire

__all__ = ["SpoofScorer", "window_waveform"]


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


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; the port runs on "
                           "the GPU unless device='cpu' is passed")
    return dev


class SpoofScorer:
    """Encoder + compression + stage-2 head as one scoring function.

    `weights` holds the 'encoder', 'compression' and 'head' state dicts,
    as `bridge.jax_params_to_torch` returns them. Clips are
    `max_duration_seconds * sample_rate` samples long."""

    def __init__(self, enc_config: Wav2Vec2Config,
                 weights: Mapping[str, Mapping[str, torch.Tensor]],
                 stage2_cfg: Stage2Config = Stage2Config(), *,
                 sample_rate: int = 16000, max_duration_seconds: int = 5,
                 device="cuda"):
        self.device = _device(device)
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
                                   stage2_cfg.hidden_dim),
            }
        for name, mod in modules.items():
            mod.load_state_dict(weights[name], strict=True, assign=True)
            mod.to(self.device).eval().requires_grad_(False)
        self.encoder = modules["encoder"]
        self.compression = modules["compression"]
        self.head = modules["head"]

    @torch.inference_mode()
    def run(self, waves: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, T) float32 or int16-wire waveforms -> ((B, H) clip
        embeddings, (B,) logits), both fp32 on the scorer's device."""
        waves = dequantize_wire(waves.to(self.device))
        enc_out = self.encoder(waves, waves != 0.0)
        z = clip_embedding(self.compression(enc_out["layer_mean"]))
        return z, self.head(z)

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

