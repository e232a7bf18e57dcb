"""The port's named spans (utils/timing.py `span`) on the CPU: no range is
made while no profiler runs; a profiled stage-1 step records each of its
`w2v.*` phases nested in `w2v.step`, and `w2v.dropout` once per drawn
dropout site, in the backward too under remat; the prefetch records the
consumer's wait and, where the profiler traces every thread, the
producer's work; `fit(profile_dir=...)` writes its trace with the
spans."""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from chip_smoke import train_batch, write_corpus
from tests.test_torch_bridge import cap_torch_threads
from wav2vec_contr_loss_torch import (Stage1Config, Stage1Trainer,
                                      jax_params_to_torch)
from wav2vec_contr_loss_torch.bridge import random_jax_trees
from wav2vec_contr_loss_torch.config import Wav2Vec2Config
from wav2vec_contr_loss_torch.data import (AudioConfig, BatchPipeline,
                                           parse_asvspoof2019)
from wav2vec_contr_loss_torch.data.pipeline import prefetch_to_device
from wav2vec_contr_loss_torch.ops import dropout
from wav2vec_contr_loss_torch.utils import timing

cap_torch_threads()

SR = 16000
TINY = Wav2Vec2Config(
    hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
    conv_dim=(16, 16, 16, 16), conv_kernel=(10, 3, 3, 3),
    conv_stride=(5, 2, 2, 2), num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4, dtype="float32", hidden_dropout=0.1,
    attention_dropout=0.1, activation_dropout=0.1, feat_proj_dropout=0.1)
PHASES = ("w2v.batch", "w2v.rawboost", "w2v.forward", "w2v.loss",
          "w2v.backward", "w2v.optimizer")


def _trainer(**kw):
    cfg = Stage1Config(**dict(
        dict(finetune_encoder=True, compute_dtype="float32",
             grad_dtype="float32", input_dim=32, hidden_dim=16, dropout=0.1,
             batch_size=4, max_duration_seconds=1, seed=3, epochs=1), **kw))
    return Stage1Trainer(cfg, TINY, jax_params_to_torch(
        TINY, *random_jax_trees(TINY, comp_dim=16)), device="cpu")


def _ranges(prof, name):
    return [e for e in prof.events() if e.name == name]


def _inside(inner, outer) -> bool:
    return (outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


def _profiled_steps(trainer, steps: int):
    """Profile `steps` train steps; -> (profiler, murmur sites drawn)."""
    batch = train_batch(np.random.default_rng(0), 4, SR)
    trainer.train_step(batch, 0.5)   # lazy set-up outside the profile
    drawn = []
    bits = dropout.murmur_bits

    def counted(*a, **kw):
        drawn.append(a[0])
        return bits(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dropout, "murmur_bits", counted)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(steps):
                trainer.train_step(batch, 0.5)
    return prof, len(drawn)


def test_no_range_is_made_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert timing.span("w2v.a") is timing.span("w2v.b")
    trainer = _trainer()
    for b in prefetch_to_device(
            iter([train_batch(np.random.default_rng(1), 4, SR)] * 2),
            lambda b: b):
        assert torch.isfinite(trainer.train_step(b, 0.5)["loss"])


def test_a_profiled_step_records_every_phase_nested():
    """Each phase once a step inside its `w2v.step` (the optimizer twice:
    the gradients are cleared before the backward), and one
    `w2v.dropout` inside the forward for each murmur site drawn."""
    steps = 2
    prof, drawn = _profiled_steps(_trainer(remat_encoder=False), steps)
    outer = _ranges(prof, "w2v.step")
    assert len(outer) == steps
    for name in PHASES:
        got = _ranges(prof, name)
        per_step = 2 if name == "w2v.optimizer" else 1
        assert len(got) == per_step * steps, name
        for s in outer:
            assert sum(_inside(e, s) for e in got) == per_step, name
    drops = _ranges(prof, "w2v.dropout")
    # feature projection, compression, the encoder's input, and three
    # sites a layer
    assert drawn == len(drops) == steps * (3 + 3 * TINY.num_layers)
    forward = _ranges(prof, "w2v.forward")
    assert all(any(_inside(d, f) for f in forward) for d in drops)
    assert not _ranges(prof, "w2v.feed_wait")


def test_remat_draws_dropout_again_in_the_backward():
    prof, drawn = _profiled_steps(_trainer(remat_encoder=True), 1)
    drops = _ranges(prof, "w2v.dropout")
    backward, = _ranges(prof, "w2v.backward")
    again = [d for d in drops if _inside(d, backward)]
    assert drawn == len(drops)
    # each layer's three sites are drawn again by its recompute
    assert len(again) == 3 * TINY.num_layers


def _thread_of(prof, name):
    threads = {e.thread for e in _ranges(prof, name)}
    assert len(threads) == 1, (name, threads)
    return threads.pop()


def _all_threads_config():
    try:
        from torch._C._profiler import _ExperimentalConfig

        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


@pytest.mark.parametrize("all_threads", [False, True])
def test_prefetch_records_the_wait_and_the_put(all_threads):
    kw = {}
    if all_threads:
        kw["experimental_config"] = _all_threads_config()
        if kw["experimental_config"] is None:
            pytest.skip("this torch cannot profile every thread")
    with profile(activities=[ProfilerActivity.CPU], **kw) as prof:
        with record_function("consumer"):
            got = list(prefetch_to_device(iter(range(3)), lambda x: 2 * x))
    assert got == [0, 2, 4]
    consumer = _thread_of(prof, "consumer")
    # one wait for each item and one for the end of the stream
    assert len(_ranges(prof, "w2v.feed_wait")) == 4
    assert _thread_of(prof, "w2v.feed_wait") == consumer
    puts = _ranges(prof, "w2v.feed_put")
    if all_threads:
        assert len(puts) == 3
        assert _thread_of(prof, "w2v.feed_put") != consumer
    else:
        assert puts == []


def test_fit_writes_its_trace_with_the_spans(tmp_path):
    root = str(tmp_path / "corpus")
    proto = write_corpus(root, 24, seed=5, seconds=1.0)
    ds = parse_asvspoof2019(proto, root, audio=AudioConfig(SR, 1))
    pipe = BatchPipeline(ds, 4, seed=7, num_workers=2)
    logged = []
    _trainer().fit(pipe, log_fn=logged.append,
                   profile_dir=str(tmp_path / "prof"))
    path = tmp_path / "prof" / "train_steps_2-5.json"
    assert os.listdir(tmp_path / "prof") == [path.name]
    assert any(m.startswith("[PROFILE]") and str(path) in m for m in logged)
    with open(path) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    # steps 2-5 of the epoch's 6
    assert names.count("w2v.step") == 4
    # the waits for batches 3-5
    assert names.count("w2v.feed_wait") == 3
