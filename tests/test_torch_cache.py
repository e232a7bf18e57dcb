"""The port's decode-once waveform cache (data/cache.py) against the JAX
package's: the same cases as tests/test_cache.py through the port's
pipeline (cached batches equal decoded ones bit for bit, float32 storage
bit-exact, corrupt rows zero, reuse and stale rebuild, a crash between
the two replaces leaves no valid manifest, an unheld path is decoded,
the loader's accounting, variable length refused), plus the manifest
equal to the JAX one for the same corpus, so a cache either package
built attaches in the other without a rebuild. ~5 s alone."""

import json
import os

import numpy as np
import pytest

from wav2vec_contr_loss_tpu.data import AudioConfig as JaxAudioConfig
from wav2vec_contr_loss_tpu.data import parse_asvspoof2019 as jax_parse
from wav2vec_contr_loss_tpu.data.cache import attach_cache as jax_attach

from tests.test_torch_bridge import cap_torch_threads
from wav2vec_contr_loss_torch.data import (AudioConfig, AudioLoader,
                                           BatchPipeline, parse_asvspoof2019)
from wav2vec_contr_loss_torch.data import cache as cache_mod
from wav2vec_contr_loss_torch.data.audio import write_wav
from wav2vec_contr_loss_torch.data.cache import (CachedLoader, attach_cache,
                                                 build_cache)

cap_torch_threads()

SR = 16000
QUIET = dict(log=lambda m: None, num_workers=2)


@pytest.fixture()
def corpus(tmp_path):
    """12 clips of 1 s (tones and noise) and one file that is no WAV."""
    root = tmp_path / "corpus"
    root.mkdir()
    rng = np.random.default_rng(5)
    lines = []
    for i in range(12):
        name = f"c{i:03d}.wav"
        if i % 2 == 0:
            x = 0.3 * np.sin(2 * np.pi * 300 * np.arange(SR) / SR)
        else:
            x = 0.1 * rng.standard_normal(SR)
        write_wav(root / name, x.astype(np.float32), SR)
        label = "bonafide" if i % 2 == 0 else "spoof"
        attack = "-" if i % 2 == 0 else "A01"
        lines.append(f"x/{name} {attack} {label} - SPK{i % 2}")
    (root / "bad.wav").write_bytes(b"not a wav")
    lines.append("x/bad.wav A02 spoof - SPK0")
    (root / "protocol.txt").write_text("\n".join(lines) + "\n")
    return root


def make_ds(root, seconds=1, num_samples=None):
    return parse_asvspoof2019(str(root / "protocol.txt"), str(root),
                              num_samples=num_samples,
                              audio=AudioConfig(SR, seconds))


def test_cached_batches_match_decoded(corpus, tmp_path):
    """Unresampled 16-bit PCM round-trips the int16 cache exactly, so a
    cached pipeline gives the same batches, bit for bit."""
    plain, cached = make_ds(corpus), make_ds(corpus)
    assert attach_cache(cached, str(tmp_path / "cache"), **QUIET)
    a = list(BatchPipeline(plain, 4, seed=3, num_workers=2).train_epoch(1))
    b = list(BatchPipeline(cached, 4, seed=3, num_workers=2).train_epoch(1))
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert np.array_equal(x.waveforms, y.waveforms)
        assert np.array_equal(x.labels, y.labels)
    s = list(BatchPipeline(cached, 5, num_workers=2).sequential())
    t = list(BatchPipeline(plain, 5, num_workers=2).sequential())
    for x, y in zip(s, t):
        assert np.array_equal(x.waveforms, y.waveforms)


def test_float32_cache_bit_exact(corpus, tmp_path):
    ds = make_ds(corpus)
    ref = [ds.loader.load(u.path) for u in ds.utterances]
    attach_cache(ds, str(tmp_path / "c32"), dtype="float32", **QUIET)
    assert isinstance(ds.loader, CachedLoader)
    for u, r in zip(ds.utterances, ref):
        assert np.array_equal(ds.loader.load(u.path), r)


def test_corrupted_rows_are_zero(corpus, tmp_path):
    ds = make_ds(corpus)
    attach_cache(ds, str(tmp_path / "cache"), **QUIET)
    bad = [u for u in ds.utterances if "bad" in str(u.path)][0]
    w = ds.loader.load(bad.path)
    assert w.shape == (SR,) and not w.any()


def test_reuse_and_stale_rebuild(corpus, tmp_path):
    cdir = str(tmp_path / "cache")
    assert attach_cache(make_ds(corpus), cdir, **QUIET) is True
    assert attach_cache(make_ds(corpus), cdir, **QUIET) is False
    ds3 = make_ds(corpus, seconds=2, num_samples=4)
    assert attach_cache(ds3, cdir, **QUIET) is True
    assert ds3.loader.load(ds3.utterances[0].path).shape == (2 * SR,)
    with open(os.path.join(cdir, "cache_manifest.json")) as f:
        assert json.load(f)["num_samples"] == 2 * SR
    # another storage dtype is another fingerprint
    assert attach_cache(make_ds(corpus, seconds=2, num_samples=4), cdir,
                        dtype="float32", **QUIET) is True


def test_rebuild_crash_between_replaces_invalidates(corpus, tmp_path,
                                                    monkeypatch):
    """A rebuild killed after the data swap, before the new manifest,
    leaves no manifest: the old one beside the new rows would serve the
    wrong audio."""
    cdir = str(tmp_path / "cache")
    attach_cache(make_ds(corpus), cdir, **QUIET)
    real_replace = os.replace

    def crash_after_data_swap(src, dst):
        real_replace(src, dst)
        if dst.endswith("waveforms.npy"):
            raise RuntimeError("simulated crash after data swap")

    monkeypatch.setattr(cache_mod.os, "replace", crash_after_data_swap)
    with pytest.raises(RuntimeError, match="simulated crash"):
        build_cache(make_ds(corpus, seconds=2, num_samples=4), cdir,
                    **QUIET)
    monkeypatch.undo()
    assert not os.path.exists(os.path.join(cdir, "cache_manifest.json"))
    ds4 = make_ds(corpus)
    assert attach_cache(ds4, cdir, **QUIET) is True
    ref = make_ds(corpus)
    for u in ds4.utterances:
        assert np.array_equal(ds4.loader.load(u.path),
                              ref.loader.load(u.path))


def test_unknown_path_falls_back_to_decode(corpus, tmp_path):
    ds = make_ds(corpus)
    attach_cache(ds, str(tmp_path / "cache"), **QUIET)
    extra = corpus / "extra.wav"
    x = 0.2 * np.sin(2 * np.pi * 440 * np.arange(SR) / SR)
    write_wav(extra, x.astype(np.float32), SR)
    rows = CachedLoader.rows_read
    w = ds.loader.load(extra)
    assert w.shape == (SR,) and w.any()
    assert CachedLoader.rows_read == rows


def test_cache_hits_keep_loader_accounting(corpus, tmp_path):
    """A row read counts as a successful load, and as a row read."""
    ds = make_ds(corpus)
    attach_cache(ds, str(tmp_path / "cache"), **QUIET)
    AudioLoader.reset_counters()
    rows = CachedLoader.rows_read
    for u in ds.utterances:
        ds.loader.load(u.path)
    assert AudioLoader.loaded_count == len(ds.utterances)
    assert AudioLoader.failed_count == 0
    assert CachedLoader.rows_read - rows == len(ds.utterances)


def test_variable_length_rejected(corpus, tmp_path):
    ds = make_ds(corpus, seconds=None)
    with pytest.raises(ValueError, match="fixed-length"):
        build_cache(ds, str(tmp_path / "never"))
    with pytest.raises(ValueError, match="int16|float32"):
        build_cache(make_ds(corpus), str(tmp_path / "never"), dtype="bf16")


@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_manifest_and_rows_are_interchangeable_with_jax(corpus, tmp_path,
                                                        dtype):
    """The same corpus gives the same manifest and the same rows in both
    packages; a cache the JAX package built attaches in the port without
    a rebuild and reads the JAX rows, and the other way round."""
    jds = jax_parse(str(corpus / "protocol.txt"), str(corpus),
                    audio=JaxAudioConfig(SR, 1))
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jax_attach(jds, jdir, dtype=dtype, **QUIET)
    assert attach_cache(make_ds(corpus), pdir, dtype=dtype, **QUIET)
    with open(os.path.join(jdir, "cache_manifest.json")) as f:
        want = json.load(f)
    with open(os.path.join(pdir, "cache_manifest.json")) as f:
        assert json.load(f) == want
    np.testing.assert_array_equal(
        np.load(os.path.join(pdir, "waveforms.npy")),
        np.load(os.path.join(jdir, "waveforms.npy")))

    ds = make_ds(corpus)
    assert attach_cache(ds, jdir, dtype=dtype, **QUIET) is False
    jds2 = jax_parse(str(corpus / "protocol.txt"), str(corpus),
                     audio=JaxAudioConfig(SR, 1))
    assert jax_attach(jds2, pdir, dtype=dtype, **QUIET) is False
    for u, ju in zip(ds.utterances, jds2.utterances):
        assert np.array_equal(ds.loader.load(u.path),
                              jds2.loader.load(ju.path))
