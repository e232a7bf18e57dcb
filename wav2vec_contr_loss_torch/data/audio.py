"""Audio loading, resampling, and fixed-shape pad/trim.

The port's copy of wav2vec_contr_loss_tpu/data/audio.py, with its
contract:
  * decode to mono float32 at `target_sample_rate` (default 16 kHz),
  * pad with zeros or trim to `max_duration_seconds * sr` samples
    (5 s -> 80,000 samples -> 249 wav2vec2 frames),
  * a corrupted or missing file gives an all-zero waveform and is counted
    (loaded/failed counters + print_summary()).

Backends, first that decodes wins, as in the JAX module:
  1. the repository's native C++ decoder (native/w2vaudio.cpp: WAV and
     FLAC to mono float32), compiled with g++ at first use into the
     port's `_build/` (gitignored) under a name that carries a hash of the
     source and flags, and loaded with ctypes. If it cannot be built or
     loaded, decoding raises with the compiler's output: the run never
     goes on turning every FLAC clip into silence;
  2. stdlib `wave`/numpy for PCM WAV, scipy.io.wavfile for other WAV
     encodings, soundfile or librosa if installed, for a file the native
     decoder rejects.

Resampling uses a polyphase filter (scipy.signal.resample_poly).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import wave
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

__all__ = ["AudioConfig", "AudioLoader", "load_waveform", "pad_or_trim",
           "resample", "decode_any", "decode_batch", "write_wav",
           "native_decoder", "NATIVE_SRC"]

_PKG = Path(__file__).resolve().parent.parent
NATIVE_SRC = _PKG.parent / "native" / "w2vaudio.cpp"
BUILD_DIR = _PKG / "_build"
# the flags of native/Makefile
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared", "-pthread"]
# decode capacity of one file: 10 minutes at 16 kHz (the JAX module's)
_NATIVE_CAP = 16000 * 60 * 10


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


@functools.cache
def _native_target() -> Path:
    digest = hashlib.sha1(NATIVE_SRC.read_bytes()
                          + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libw2vaudio-{digest}.so"


def _build_native(so: Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or $CXX) to build the "
                           "native audio decoder")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a private name, then a rename: another process never loads a
    # half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(NATIVE_SRC)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building the native audio decoder from "
                           f"{NATIVE_SRC} failed ({cxx} exit "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)


@functools.cache
def _native() -> ctypes.CDLL:
    if not NATIVE_SRC.exists():
        raise RuntimeError(f"the native decoder's source {NATIVE_SRC} is "
                           f"missing: the port decodes FLAC with it")
    so = _native_target()
    if not so.exists():
        _build_native(so)
    lib = ctypes.CDLL(str(so))
    lib.w2v_decode_audio.restype = ctypes.c_longlong
    lib.w2v_decode_audio.argtypes = [
        ctypes.c_char_p,                  # path
        ctypes.POINTER(ctypes.c_float),   # out buffer
        ctypes.c_longlong,                # out capacity (samples)
        ctypes.POINTER(ctypes.c_int),     # out sample rate
    ]
    # threaded decode of n files into (n, target_len) rows, zero-padded
    # or trimmed; lengths[i] < 0 marks a file it could not decode
    lib.w2v_decode_batch.restype = None
    lib.w2v_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),  # paths
        ctypes.c_int,                     # n
        ctypes.POINTER(ctypes.c_float),   # out (n, target_len)
        ctypes.c_longlong,                # target_len
        ctypes.POINTER(ctypes.c_int),     # out sample rates (n,)
        ctypes.POINTER(ctypes.c_longlong),  # out decoded lengths (n,)
        ctypes.c_int,                     # threads
    ]
    return lib


_NATIVE_LOCK = threading.Lock()


def native_decoder() -> ctypes.CDLL:
    """The ctypes handle of the native decoder, compiled from
    native/w2vaudio.cpp into `_build/` at the first call. Raises
    RuntimeError, with the compiler's output, if it cannot be built or
    loaded (a failure is not cached: the next call tries again)."""
    with _NATIVE_LOCK:
        return _native()


def _decode_native(path: str) -> Tuple[np.ndarray, int]:
    lib = native_decoder()
    buf = np.empty(_NATIVE_CAP, dtype=np.float32)
    sr = ctypes.c_int(0)
    n = lib.w2v_decode_audio(
        str(path).encode(),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        _NATIVE_CAP, ctypes.byref(sr))
    if n < 0:
        raise ValueError(f"native decoder failed on {path} (code {n})")
    return buf[:n].copy(), int(sr.value)


def decode_batch(paths, target_len: int, threads: int = 8
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The native decoder's threaded batch decode: -> ((n, target_len)
    float32 rows, each file's first target_len samples zero-padded, at
    its own rate; (n,) int32 sample rates; (n,) int64 decoded lengths,
    negative for a file it could not decode, whose row is zeros)."""
    lib = native_decoder()
    n = len(paths)
    encoded = [str(p).encode() for p in paths]
    arr = (ctypes.c_char_p * n)(*encoded)
    out = np.zeros((n, target_len), np.float32)
    srs = np.zeros(n, np.int32)
    lens = np.zeros(n, np.int64)
    lib.w2v_decode_batch(
        arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        target_len, srs.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)), threads)
    return out, srs, lens


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
    try:
        return _decode_native(p)
    except ValueError as e:   # a file it rejects: the Python backends
        errors.append(f"native: {e}")
    if ext == ".wav":
        for fn in (_decode_wav_stdlib, _decode_scipy, _decode_soundfile):
            try:
                return fn(p)
            except Exception as e:  # the next backend may decode it
                errors.append(f"{fn.__name__}: {e}")
    else:  # other formats need soundfile or librosa
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
        native_decoder()   # a decoder that cannot be built is no bad file
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
