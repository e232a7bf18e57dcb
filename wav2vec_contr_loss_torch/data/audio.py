"""Audio loading, resampling, and fixed-shape pad/trim.

The port's copy of wav2vec_contr_loss_tpu/data/audio.py, with its
contract:
  * decode to mono float32 at `target_sample_rate` (default 16 kHz),
  * pad with zeros or trim to `max_duration_seconds * sr` samples
    (5 s -> 80,000 samples -> 249 wav2vec2 frames),
  * a corrupted or missing file gives an all-zero waveform and is counted
    (loaded/failed counters + print_summary()).

Backends, first that decodes wins: stdlib `wave`/numpy for PCM WAV,
scipy.io.wavfile for other WAV encodings, soundfile or librosa if
installed (FLAC). The JAX package's native C++ decoder is not ported; its
module takes the same Python backends when that library is absent.

Resampling uses a polyphase filter (scipy.signal.resample_poly).
"""

from __future__ import annotations

import math
import os
import sys
import threading
import wave
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

__all__ = ["AudioConfig", "AudioLoader", "load_waveform", "pad_or_trim",
           "resample", "decode_any", "write_wav"]


@dataclass(frozen=True)
class AudioConfig:
    target_sample_rate: int = 16000
    max_duration_seconds: Optional[int] = 5

    @property
    def num_samples(self) -> int:
        if self.max_duration_seconds is None:
            return self.target_sample_rate
        return int(self.max_duration_seconds * self.target_sample_rate)


def pad_or_trim(wave_f32: np.ndarray, target_len: int) -> np.ndarray:
    """Right-pad with zeros or truncate to `target_len` samples."""
    n = wave_f32.shape[0]
    if n == target_len:
        return wave_f32
    if n > target_len:
        return wave_f32[:target_len]
    out = np.zeros(target_len, dtype=np.float32)
    out[:n] = wave_f32
    return out


def _decode_wav_stdlib(path: str) -> Tuple[np.ndarray, int]:
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n_ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        x = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        x = (x - ((x >> 23) & 1) * (1 << 24)).astype(np.float32) / 8388608.0
    else:
        raise ValueError(f"unsupported WAV sample width: {width}")
    if n_ch > 1:
        x = x.reshape(-1, n_ch).mean(axis=1)
    return x, sr


def _decode_scipy(path: str) -> Tuple[np.ndarray, int]:
    from scipy.io import wavfile

    sr, x = wavfile.read(path)
    x = np.asarray(x)
    if x.dtype == np.int16:
        x = x.astype(np.float32) / 32768.0
    elif x.dtype == np.int32:
        x = x.astype(np.float32) / 2147483648.0
    elif x.dtype == np.uint8:
        x = (x.astype(np.float32) - 128.0) / 128.0
    else:
        x = x.astype(np.float32)
    if x.ndim > 1:
        x = x.mean(axis=1)
    return x, sr


def _decode_soundfile(path: str) -> Tuple[np.ndarray, int]:
    import soundfile as sf  # optional

    x, sr = sf.read(path, dtype="float32", always_2d=False)
    if x.ndim > 1:
        x = x.mean(axis=1)
    return np.asarray(x, np.float32), sr


def resample(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    if sr_in == sr_out:
        return x.astype(np.float32, copy=False)
    from scipy.signal import resample_poly

    g = math.gcd(sr_in, sr_out)
    return resample_poly(x, sr_out // g, sr_in // g).astype(np.float32)


def decode_any(path: str) -> Tuple[np.ndarray, int]:
    """Decode an audio file to (float32 mono waveform, sample_rate)."""
    p = str(path)
    ext = os.path.splitext(p)[1].lower()
    errors = []
    if ext == ".wav":
        for fn in (_decode_wav_stdlib, _decode_scipy, _decode_soundfile):
            try:
                return fn(p)
            except Exception as e:  # the next backend may decode it
                errors.append(f"{fn.__name__}: {e}")
    else:  # .flac and friends need soundfile or librosa
        try:
            return _decode_soundfile(p)
        except Exception as e:
            errors.append(f"_decode_soundfile: {e}")
        try:
            import librosa  # optional

            x, sr = librosa.load(p, sr=None, mono=True)
            return np.asarray(x, np.float32), int(sr)
        except Exception as e:
            errors.append(f"librosa: {e}")
    raise ValueError(f"could not decode {p}: {'; '.join(errors)}")


class AudioLoader:
    """Loader with the reference's corruption-tolerant contract: a failure
    returns an all-zero clip and is counted."""

    loaded_count = 0
    failed_count = 0
    _count_lock = threading.Lock()

    def __init__(self, config: AudioConfig = AudioConfig()):
        self.config = config

    def load(self, path) -> np.ndarray:
        cfg = self.config
        try:
            x, sr = decode_any(path)
            x = resample(x, sr, cfg.target_sample_rate)
            with AudioLoader._count_lock:
                AudioLoader.loaded_count += 1
        except Exception as e:  # any undecodable file becomes a zero clip
            try:
                # stderr: stdout may be a machine-readable stream
                print(f"[WARNING] Corrupted file: {path}. Error: {e}",
                      file=sys.stderr)
            except OSError:
                pass
            with AudioLoader._count_lock:
                AudioLoader.failed_count += 1
            return np.zeros(cfg.num_samples, dtype=np.float32)
        if cfg.max_duration_seconds is not None:
            x = pad_or_trim(x, cfg.num_samples)
        return x.astype(np.float32, copy=False)

    @classmethod
    def print_summary(cls) -> None:
        total = cls.loaded_count + cls.failed_count
        print(
            f"\n[DATASET SUMMARY] Loaded: {cls.loaded_count}, "
            f"Failed: {cls.failed_count}, Total: {total}"
        )

    @classmethod
    def reset_counters(cls) -> None:
        with cls._count_lock:
            cls.loaded_count = 0
            cls.failed_count = 0


def load_waveform(path, config: AudioConfig = AudioConfig()) -> np.ndarray:
    return AudioLoader(config).load(path)


def write_wav(path, waveform: np.ndarray, sample_rate: int = 16000) -> None:
    """Minimal 16-bit PCM WAV writer (tests, chip_smoke.py's corpus)."""
    x = np.clip(np.asarray(waveform, np.float32), -1.0, 1.0)
    pcm = (x * 32767.0).astype("<i2")
    parent = os.path.dirname(str(path))
    if parent:
        os.makedirs(parent, exist_ok=True)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
