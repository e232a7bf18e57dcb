"""The port's native decoder (data/audio.py: native/w2vaudio.cpp built with
g++ into the port's `_build/`) against the JAX package's `decode_any`,
bit for bit, on PCM16, PCM24, float32 and stereo WAV and FLAC written by
tests/flac_writer.py; a truncated or missing file is a counted zero
clip, and a decoder that cannot be built raises instead. ~5 s alone."""

import os
import struct
from pathlib import Path

import numpy as np
import pytest

from wav2vec_contr_loss_tpu.data.audio import decode_any as jax_decode_any

from tests.flac_writer import write_flac
from tests.test_torch_bridge import cap_torch_threads
from wav2vec_contr_loss_torch.data import audio

cap_torch_threads()

SR = 16000
REPO = Path(__file__).resolve().parent.parent


def _pcm(rng, n, ch=1):
    x = 0.3 * np.sin(2 * np.pi * 330 * np.arange(n) / SR)[:, None] \
        + 0.05 * rng.standard_normal((n, ch))
    return np.clip(x, -1, 1)


def _write_wav(path, x, fmt: str, sr: int = SR):
    """A RIFF WAV of (n, ch) samples: 'pcm16', 'pcm24' or 'float32'."""
    n, ch = x.shape
    if fmt == "pcm16":
        data, tag, bits = (x * 32767).astype("<i2").tobytes(), 1, 16
    elif fmt == "pcm24":
        v = (x * 8388607).astype("<i4").reshape(-1)
        data = b"".join(int(s).to_bytes(3, "little", signed=True) for s in v)
        tag, bits = 1, 24
    else:
        data, tag, bits = x.astype("<f4").tobytes(), 3, 32
    block = ch * bits // 8
    fmt_chunk = struct.pack("<HHIIHH", tag, ch, sr, sr * block, block, bits)
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt_chunk)) + fmt_chunk
            + b"data" + struct.pack("<I", len(data)) + data)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)


CASES = {
    "pcm16.wav": lambda p, r: _write_wav(p, _pcm(r, 4000), "pcm16"),
    "pcm24.wav": lambda p, r: _write_wav(p, _pcm(r, 3000), "pcm24"),
    "float32.wav": lambda p, r: _write_wav(p, _pcm(r, 3500), "float32"),
    "stereo.wav": lambda p, r: _write_wav(p, _pcm(r, 2500, 2), "pcm16"),
    "verbatim.flac": lambda p, r: write_flac(
        p, (_pcm(r, 9000)[:, 0] * 32767).astype(np.int16), SR),
    "fixed.flac": lambda p, r: write_flac(
        p, (_pcm(r, 5000)[:, 0] * 32767).astype(np.int16), SR,
        block_size=1024, subframe_mode="fixed1"),
    "midside.flac": lambda p, r: write_flac(
        p, (_pcm(r, 4100, 2) * 32767).astype(np.int16), SR,
        subframe_mode="fixed1", stereo_mode="mid_side"),
    "rate8k.wav": lambda p, r: _write_wav(p, _pcm(r, 2000), "pcm16", 8000),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_native_decode_matches_jax_bit_for_bit(tmp_path, name):
    path = str(tmp_path / name)
    CASES[name](path, np.random.default_rng(len(name)))
    x, sr = audio.decode_any(path)
    y, sr_j = jax_decode_any(path)
    native, sr_n = audio._decode_native(path)   # the native backend took it
    assert sr == sr_j == sr_n
    assert x.dtype == np.float32 and x.shape == y.shape
    np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(x, native)
    assert x.size > 0 and np.abs(x).max() > 0.1


@pytest.mark.parametrize("name", ["pcm16.wav", "verbatim.flac"])
def test_truncated_or_missing_file_is_a_counted_zero_clip(tmp_path, name):
    path = str(tmp_path / name)
    CASES[name](path, np.random.default_rng(0))
    with open(path, "rb") as f:
        head = f.read(20)          # cut inside the header
    with open(path, "wb") as f:
        f.write(head)
    cfg = audio.AudioConfig(SR, 1)
    for p in (path, str(tmp_path / "missing" / name)):
        with pytest.raises(ValueError):
            jax_decode_any(p)
        with pytest.raises(ValueError, match="native"):
            audio.decode_any(p)
        before = audio.AudioLoader.failed_count
        out = audio.AudioLoader(cfg).load(p)
        assert audio.AudioLoader.failed_count == before + 1
        assert out.shape == (SR,) and not out.any()


def test_build_lands_in_the_port_build_dir():
    lib = audio.native_decoder()
    target = audio._native_target()
    assert target.parent == REPO / "wav2vec_contr_loss_torch" / "_build"
    assert target.exists() and lib._name == str(target)
    assert audio.NATIVE_SRC == REPO / "native" / "w2vaudio.cpp"
    # the name carries the source's and the flags' hash
    assert target.name.startswith("libw2vaudio-") and len(target.stem) == 24


def test_a_decoder_that_cannot_build_raises(tmp_path, monkeypatch):
    path = str(tmp_path / "a.wav")
    CASES["pcm16.wav"](path, np.random.default_rng(1))
    monkeypatch.setattr(audio, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(audio, "_native_target",
                        lambda: tmp_path / "build" / "libw2vaudio-x.so")
    monkeypatch.setenv("CXX", "false")   # a compiler that always fails
    audio._native.cache_clear()
    try:
        before = audio.AudioLoader.failed_count
        with pytest.raises(RuntimeError, match="native audio decoder"):
            audio.AudioLoader(audio.AudioConfig(SR, 1)).load(path)
        with pytest.raises(RuntimeError, match="native audio decoder"):
            audio.decode_any(path)
        assert audio.AudioLoader.failed_count == before
        assert not os.listdir(tmp_path / "build")   # no half-written file
    finally:
        audio._native.cache_clear()
