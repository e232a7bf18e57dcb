"""The port's host data pipeline against the JAX package's, on a synthetic
32-clip ASVspoof-2019-style corpus of 1 s WAV files: sampler, parsers,
decoding, balanced epochs with host RawBoost and sequential batches bit
for bit; the skip replay, the prefetcher's clean abandonment,
stream_through_device's order and results, the resume cursor and the
preemption guard."""

import os
import signal
import threading
import time

import numpy as np
import pytest

from wav2vec_contr_loss_tpu.data import AudioConfig as JaxAudioConfig
from wav2vec_contr_loss_tpu.data import BatchPipeline as JaxPipeline
from wav2vec_contr_loss_tpu.data import parse_asvspoof2019 as jax_parse
from wav2vec_contr_loss_tpu.data import parse_in_the_wild as jax_parse_itw
from wav2vec_contr_loss_tpu.data.rawboost import (
    RawBoostParams as JaxRawBoostParams)
from wav2vec_contr_loss_tpu.data.sampler import (
    BalancedBatchSampler as JaxSampler)

from chip_smoke import write_corpus
from wav2vec_contr_loss_torch.data import (AudioConfig, BalancedBatchSampler,
                                           BatchPipeline, load_waveform,
                                           parse_asvspoof2019,
                                           parse_in_the_wild,
                                           prefetch_to_device,
                                           stream_through_device)
from wav2vec_contr_loss_torch.data.audio import write_wav
from wav2vec_contr_loss_torch.data.rawboost import RawBoostParams
from wav2vec_contr_loss_torch.train.checkpoint import resume_cursor
from wav2vec_contr_loss_torch.utils.preemption import PreemptionGuard

from tests.test_torch_bridge import cap_torch_threads

cap_torch_threads()

SR = 16000


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_pipeline_corpus")
    return str(root), write_corpus(str(root), 32, seed=11, seconds=1.0)


def _datasets(corpus):
    root, proto = corpus
    return (jax_parse(proto, root, audio=JaxAudioConfig(SR, 1)),
            parse_asvspoof2019(proto, root, audio=AudioConfig(SR, 1)))


def _same_batch(a, b):
    np.testing.assert_array_equal(a.waveforms, b.waveforms)
    np.testing.assert_array_equal(a.labels, b.labels)
    np.testing.assert_array_equal(a.multi_labels, b.multi_labels)
    np.testing.assert_array_equal(a.valid, b.valid)
    assert a.names == b.names and a.speakers == b.speakers


@pytest.mark.parametrize("mode", ["global", "stride"])
def test_sampler_matches_jax(mode):
    labels = np.random.default_rng(0).integers(0, 2, 77)
    for seed, epoch, rank, world in ((0, 1, 0, 1), (3, 7, 1, 2),
                                     (1337, 2, 3, 4)):
        want = JaxSampler(labels, 8, seed, rank, world, mode)
        got = BalancedBatchSampler(labels, 8, seed, rank, world, mode)
        assert len(got) == len(want)
        np.testing.assert_array_equal(got.epoch_index_matrix(epoch),
                                      want.epoch_index_matrix(epoch))


def test_parsers_match_jax(corpus, tmp_path):
    want, got = _datasets(corpus)
    assert got.utterances == [type(got.utterances[0])(**vars(u))
                              for u in want.utterances]
    assert got.attack_to_idx == want.attack_to_idx
    sub_w = jax_parse(corpus[1], corpus[0], subset="spoof", num_samples=5)
    sub_g = parse_asvspoof2019(corpus[1], corpus[0], subset="spoof",
                               num_samples=5)
    assert [u.name for u in sub_g.utterances] == [u.name for u in
                                                  sub_w.utterances]
    csv = tmp_path / "itw.csv"
    rows = ["file,speaker,label"] + [
        f"clip_{i:04d}.wav,SPK{i},{'bona-fide' if i % 2 else 'spoof'}"
        for i in range(6)] + ["missing.wav,SPK9,spoof"]
    csv.write_text("\n".join(rows) + "\n")
    w = jax_parse_itw(str(csv), corpus[0], num_samples=4)
    g = parse_in_the_wild(str(csv), corpus[0], num_samples=4)
    assert [(u.path, u.label, u.speaker, u.name) for u in g.utterances] == [
        (u.path, u.label, u.speaker, u.name) for u in w.utterances]


def test_resampled_decode_matches_jax(tmp_path):
    from wav2vec_contr_loss_tpu.data import load_waveform as jax_load

    x = np.sin(np.arange(8000) / 7.0).astype(np.float32) * 0.3
    write_wav(tmp_path / "a.wav", x, 8000)
    got = load_waveform(str(tmp_path / "a.wav"), AudioConfig(SR, 1))
    want = jax_load(str(tmp_path / "a.wav"), JaxAudioConfig(SR, 1))
    assert got.shape == (SR,)
    np.testing.assert_array_equal(got, want)


def test_train_epoch_and_sequential_match_jax(corpus):
    """Balanced epochs with host RawBoost on, and sequential batches with
    a padded tail: the same arrays and names as the JAX pipeline."""
    jds, ds = _datasets(corpus)
    want = JaxPipeline(jds, 8, seed=7, num_workers=2,
                       rawboost=JaxRawBoostParams(), rawboost_prob=0.7)
    got = BatchPipeline(ds, 8, seed=7, num_workers=2,
                        rawboost=RawBoostParams(), rawboost_prob=0.7)
    assert got.batches_per_epoch == want.batches_per_epoch == 4
    for epoch in (1, 2):
        pairs = list(zip(got.train_epoch(epoch), want.train_epoch(epoch)))
        assert len(pairs) == 4
        for a, b in pairs:
            _same_batch(a, b)
    seq_w = list(JaxPipeline(jds, 12, num_workers=2).sequential())
    seq_g = list(BatchPipeline(ds, 12, num_workers=2).sequential())
    assert len(seq_g) == len(seq_w) == 3 and seq_g[-1].size == 8
    for a, b in zip(seq_g, seq_w):
        _same_batch(a, b)


def test_train_epoch_skip_replays_the_tail(corpus):
    _, ds = _datasets(corpus)
    rb = RawBoostParams(prob=1.0)
    full = list(BatchPipeline(ds, 8, seed=7, num_workers=2,
                              rawboost=rb).train_epoch(3))
    part = list(BatchPipeline(ds, 8, seed=7, num_workers=2,
                              rawboost=rb).train_epoch(3, skip=2))
    assert len(part) == len(full) - 2
    for a, b in zip(full[2:], part):
        _same_batch(a, b)


def test_abandoned_prefetch_leaves_no_live_thread(corpus):
    _, ds = _datasets(corpus)
    before = set(threading.enumerate())
    pipe = BatchPipeline(ds, 8, seed=7, num_workers=3)
    it = prefetch_to_device(pipe.train_epoch(1), lambda b: b, depth=1)
    first = next(it)
    assert first.waveforms.shape == (8, SR)
    it.close()                        # the consumer walks away mid-epoch
    deadline = time.monotonic() + 10.0
    while set(threading.enumerate()) - before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not set(threading.enumerate()) - before


def test_prefetch_surfaces_producer_errors():
    def boom():
        yield 1
        raise RuntimeError("decode failed")

    with pytest.raises(RuntimeError, match="decode failed"):
        list(prefetch_to_device(boom(), lambda x: x))


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_stream_through_device_keeps_order_and_result_shape(depth):
    """Results come back in order as numpy, tuples as tuples, whatever
    the depth; `put` runs in the prefetch thread; a failing producer
    surfaces in the consumer."""
    import torch

    main = threading.get_ident()
    put_threads = set()

    def put(i):
        put_threads.add(threading.get_ident())
        return torch.full((2,), float(i))

    out = list(stream_through_device(iter(range(7)), put,
                                     lambda x: (x * 2, x[:1] + 1),
                                     depth=depth))
    assert [b for _, b in out] == list(range(7))
    for (twice, first), i in out:
        assert isinstance(twice, np.ndarray)
        np.testing.assert_array_equal(twice, [2 * i, 2 * i])
        np.testing.assert_array_equal(first, [i + 1])
    assert put_threads and main not in put_threads
    single = list(stream_through_device(iter(range(3)), put, lambda x: x))
    assert [float(r[0]) for r, _ in single] == [0.0, 1.0, 2.0]

    def bad():
        yield 0
        raise OSError("decode failed")

    with pytest.raises(OSError, match="decode failed"):
        list(stream_through_device(bad(), put, lambda x: x, depth=depth))


def test_resume_cursor_semantics():
    assert resume_cursor({"epoch": 5}) == (6, 0)
    assert resume_cursor(
        {"epoch": 5, "preempted": True, "batches_done": 3}) == (5, 3)


def test_guard_sigterm_sets_flag_and_restores_handler():
    sentinel = []
    prev = signal.signal(signal.SIGTERM, lambda *a: sentinel.append(1))
    try:
        with PreemptionGuard() as guard:
            assert not guard.requested()
            os.kill(os.getpid(), signal.SIGTERM)
            assert guard.requested()
            assert guard.requested(step=3)   # any-step poll stays true
        assert signal.getsignal(signal.SIGTERM) is not signal.SIG_DFL
        os.kill(os.getpid(), signal.SIGTERM)
        assert sentinel == [1]
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_guard_double_install_restores_original_handler():
    sentinel = []
    prev = signal.signal(signal.SIGTERM, lambda *a: sentinel.append(1))
    try:
        guard = PreemptionGuard().install()
        with guard:
            pass
        os.kill(os.getpid(), signal.SIGTERM)
        assert sentinel == [1]       # the original handler, not the guard's
        assert not guard.requested()
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_guard_mark_is_programmatic_request():
    guard = PreemptionGuard()
    assert not guard.requested(step=1)
    guard.mark()
    assert guard.requested(step=1)
