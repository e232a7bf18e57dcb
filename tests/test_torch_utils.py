"""The port's MetricsLogger (utils/logging.py) against the JAX package's
for the same calls: the same JSONL records (but their clock), the same
printed lines; only rank 0 of a gang writes."""

import json
import os

from wav2vec_contr_loss_tpu.utils import MetricsLogger as JaxLogger

from wav2vec_contr_loss_torch.utils import logging as port_logging
from wav2vec_contr_loss_torch.utils.logging import MetricsLogger

CALLS = [(1, {"train_loss": 1.5, "dev_loss": float("nan"), "alpha": 0.0},
          "[epoch 001] train_loss=1.5"),
         (2, {"train_loss": 1.25, "clips_per_sec": 12}, None),
         (3, {"note": "text", "n": 3}, "[epoch 003]")]


def _records(path):
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    for r in recs:
        assert isinstance(r.pop("time"), float)
    return recs


def test_metrics_logger_jsonl_matches_jax(tmp_path):
    printed = {"jax": [], "port": []}
    for name, cls in (("jax", JaxLogger), ("port", MetricsLogger)):
        logger = cls(str(tmp_path / name), print_fn=printed[name].append)
        for step, metrics, message in CALLS:
            logger.log(step, metrics, message=message)
        logger.close()
    got = _records(tmp_path / "port" / "metrics.jsonl")
    want = _records(tmp_path / "jax" / "metrics.jsonl")
    assert len(got) == len(CALLS)
    # NaN round-trips as NaN in both (json allows it)
    assert json.dumps(got) == json.dumps(want)
    assert printed["port"] == printed["jax"] == [
        "[epoch 001] train_loss=1.5", "[epoch 003]"]


def test_metrics_logger_appends_and_runs_without_a_directory(tmp_path,
                                                             capsys):
    MetricsLogger().log(0, {"x": 1.0}, message="hello")
    assert "hello" in capsys.readouterr().out
    for _ in range(2):
        logger = MetricsLogger(str(tmp_path))
        logger.log(1, {"x": 1.0})
        logger.close()
    assert len(_records(tmp_path / "metrics.jsonl")) == 2


def test_metrics_logger_tensorboard_scalars_or_a_warning(tmp_path):
    """With tensorboard installed, every finite number becomes a scalar
    event file in the log directory; without it, the JAX class's
    warning and the JSONL stream alone."""
    warned = []
    logger = MetricsLogger(str(tmp_path), tensorboard=True,
                           print_fn=warned.append)
    logger.log(1, {"loss": 0.5, "nan": float("nan"), "tag": "x"})
    logger.close()
    events = [f for f in os.listdir(tmp_path) if "tfevents" in f]
    if logger._tb is None:
        assert warned and warned[0].startswith("[WARN] TensorBoard "
                                               "unavailable")
    else:
        assert events and not warned
    assert len(_records(tmp_path / "metrics.jsonl")) == 1


def test_metrics_logger_writes_on_rank_0_only(tmp_path, monkeypatch):
    monkeypatch.setattr(port_logging.distributed, "is_primary",
                        lambda: False)
    printed = []
    logger = MetricsLogger(str(tmp_path / "logs"), print_fn=printed.append)
    logger.log(1, {"x": 1.0}, message="rank 1")
    logger.close()
    assert printed == [] and not (tmp_path / "logs").exists()
