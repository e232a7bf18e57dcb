"""The shared epoch loop (train/core.py `fit_epochs`) with a fake trainer
on the CPU: no encoder, a one-tensor state that counts the steps, two
batches an epoch and the dev scores the case gives. Each case holds one
rule of the checkpoint and preemption policy that stage 1's two loops and
the baseline's take from it."""

import math
import os
from types import SimpleNamespace

import pytest
import torch

from wav2vec_contr_loss_torch.train import checkpoint as ckpt
from wav2vec_contr_loss_torch.train import core
from wav2vec_contr_loss_torch.train.core import EpochEnd, fit_epochs

STEPS = 2   # batches an epoch


class FakeTrainer:
    def __init__(self, epochs: int):
        self.cfg = SimpleNamespace(epochs=epochs,
                                   ckpt_config=lambda: {"fake": 1})
        self.w = torch.zeros(())

    def state_dict(self):
        return {"w": self.w}

    def _sidecar_extra(self):
        return {"trainer": "fake"}


class StopAt:
    """A preemption request at the `at`-th poll."""

    def __init__(self, at: int):
        self.at, self.polls = at, 0

    def requested(self, step: int) -> bool:
        self.polls += 1
        return self.polls == self.at


def _fit(tr, scores, save_dir, **kw):
    """fit_epochs over STEPS batches an epoch; epoch e's dev score is
    scores[e - 1]. -> (history, log lines, end_epoch's n_run by epoch)."""
    log, runs = [], {}

    def step(batch, epoch):
        tr.w += 1
        return torch.tensor(float(batch))

    def end_epoch(epoch, train_loss, n_run, seconds):
        runs[epoch] = n_run
        s = scores[epoch - 1]
        log.append(f"epoch {epoch}")
        return EpochEnd(s, {"train_loss": train_loss, "score": s},
                        {"score": s}, f"new best {s}")

    hist = fit_epochs(tr, ("train_loss", "score"),
                      lambda epoch, skip: iter(range(skip, STEPS)), step,
                      end_epoch, save_dir=save_dir, log_fn=log.append, **kw)
    return hist, log, runs


def _state_w(d, name) -> float:
    return float(ckpt.restore_checkpoint(d, name)[0]["w"])


def nan_is_never_best(d, monkeypatch):
    hist, log, _ = _fit(FakeTrainer(3), [math.nan, 0.5, math.nan], d)
    assert [math.isnan(s) for s in hist["score"]] == [True, False, True]
    assert ckpt.load_sidecar(d, "best")["metrics"] == {"epoch": 2,
                                                       "score": 0.5}
    assert _state_w(d, "best") == 2 * STEPS
    assert _state_w(d, "latest") == 3 * STEPS
    assert [m for m in log if m.startswith("new best")] == ["new best 0.5"]


def best_aliases_latest_without_dev(d, monkeypatch):
    _, log, _ = _fit(FakeTrainer(2), [0.3, 0.2], d, has_dev=False)
    assert os.path.islink(os.path.join(d, "best.pt"))
    assert ckpt.load_sidecar(d, "best") == ckpt.load_sidecar(d, "latest")
    assert ckpt.load_sidecar(d, "latest")["metrics"]["epoch"] == 2
    assert _state_w(d, "best") == 2 * STEPS
    assert not any(m.startswith("new best") for m in log)


def patience_stops_the_run(d, monkeypatch):
    def cursor(name, best, stale):
        return {"best": best, "stale": stale} if name == "latest" else {}
    hist, log, _ = _fit(FakeTrainer(5), [0.5, 0.6, 0.7, 0.1, 0.1], d,
                        patience=2, cursor=cursor,
                        show_best=lambda b: f"best={b}")
    assert hist["score"] == [0.5, 0.6, 0.7]
    assert log[-1] == "[EARLY STOP] patience 2 reached (best=0.5)"
    assert ckpt.load_sidecar(d, "latest")["metrics"] == {
        "epoch": 3, "score": 0.7, "best": 0.5, "stale": 2}
    assert ckpt.load_sidecar(d, "best")["metrics"] == {"epoch": 1,
                                                       "score": 0.5}


def resume_at_patience_is_a_noop(d, monkeypatch):
    tr = FakeTrainer(5)
    hist, log, _ = _fit(tr, [0.1] * 5, d, start_epoch=3, best=0.5,
                        stale=2, patience=2, show_best=lambda b: f"best={b}")
    assert hist == {"train_loss": [], "score": []}
    assert log == ["[EARLY STOP] patience 2 already reached at resume "
                   "(best=0.5)"]
    assert float(tr.w) == 0 and os.listdir(d) == []


def preemption_saves_latest_with_the_cursor(d, monkeypatch):
    tr = FakeTrainer(3)
    hist, log, _ = _fit(tr, [0.5, 0.4, 0.3], d, preemption=StopAt(STEPS + 1),
                        cursor=lambda name, best, stale: {"best_dev": best})
    assert hist["preempted"] is True and hist["score"] == [0.5]
    m = ckpt.load_sidecar(d, "latest")["metrics"]
    assert m == {"epoch": 2, "batches_done": 1, "preempted": True,
                 "best_dev": 0.5}
    assert _state_w(d, "latest") == STEPS + 1
    assert log[-1] == ("[PREEMPTED] saved mid-epoch state at epoch 2 "
                       "batch 1; resume with --resume")
    # the resume runs the rest of epoch 2 and epoch 3
    start, skip = ckpt.resume_cursor(m)
    hist, _, runs = _fit(tr, [0.5, 0.4, 0.3], d, start_epoch=start,
                         skip_steps=skip, best=m["best_dev"])
    assert runs == {2: STEPS - 1, 3: STEPS} and hist["score"] == [0.4, 0.3]
    assert _state_w(d, "latest") == 3 * STEPS


def latest_is_written_before_best(d, monkeypatch):
    order = []
    save = core.ckpt.save_checkpoint

    def recorded(directory, name, *a, **kw):
        order.append(name)
        return save(directory, name, *a, **kw)
    monkeypatch.setattr(core.ckpt, "save_checkpoint", recorded)
    _fit(FakeTrainer(3), [0.5, 0.4, 0.6], d, names=("L", "B"))
    assert order == ["L", "B", "L", "B", "L"]
    assert ckpt.load_sidecar(d, "B")["metrics"]["epoch"] == 2


CASES = {f.__name__: f for f in (
    nan_is_never_best, best_aliases_latest_without_dev,
    patience_stops_the_run, resume_at_patience_is_a_noop,
    preemption_saves_latest_with_the_cursor, latest_is_written_before_best)}


@pytest.mark.parametrize("case", CASES)
def test_fit_epochs(case, tmp_path, monkeypatch):
    CASES[case](str(tmp_path), monkeypatch)
