"""int16 wire format for waveform host->device transfer.

The port's copy of wav2vec_contr_loss_tpu/ops/wire.py: waveforms decoded
from 16-bit PCM are shipped as int16 (half the bytes of float32) and
dequantized on the device with the decoder's 1/32768 scale. Nonzero
samples are clamped to at least +-1 LSB, so the encoder's `wave != 0`
length rule sees the same mask through the wire.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["WIRE_SCALE", "quantize_wire", "dequantize_wire"]

WIRE_SCALE = 32768.0


def quantize_wire(wave_f32: np.ndarray) -> np.ndarray:
    """Host side: float32 waveforms -> int16 with the decoder's scale."""
    x = np.asarray(wave_f32, np.float32)
    q = np.round(x * WIRE_SCALE)
    q = np.where((q == 0) & (x != 0), np.sign(x), q)
    return np.clip(q, -32768.0, 32767.0).astype(np.int16)


def dequantize_wire(wave: torch.Tensor) -> torch.Tensor:
    """Device side: int16 wire batches -> float32; float inputs pass
    through unchanged."""
    if wave.dtype.is_floating_point:
        return wave
    return wave.to(torch.float32) * (1.0 / WIRE_SCALE)
