"""The port's CLIs on 2-rank Gloo gangs on the CPU, launched with
torchrun's variables (parallel/mp_smoke.py `spawn`), all four at once in
one module fixture: `train_stage1 --param_sharding pp
--pipeline_microbatches 2 --mesh_model 2` (two stages of the tiny
encoder's two layers), `train_stage1 --mesh_model 2 --sequence_parallel
1`, `train_stage1 --features_dir` (the head data-parallel on
precomputed features) and `run_pipeline` (training, then extraction on
every rank, stage 2 and the EER on rank 0), whose embeddings are held
against a single-process extraction of its checkpoint to 1e-5."""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from chip_smoke import write_corpus
from tests.test_torch_bridge import cap_torch_threads
from wav2vec_contr_loss_torch.cli import extract_embeddings
from wav2vec_contr_loss_torch.parallel import mp_smoke
from wav2vec_contr_loss_torch.train import checkpoint as ckpt

cap_torch_threads()

TAG = "test__tiny-wav2vec2"
TINY = ["--model_name", "test/tiny-wav2vec2", "--encoder_init", "random",
        "--batch_size", "8", "--max_duration_seconds", "1", "--input_dim",
        "32", "--hidden_dim", "16", "--device", "cpu"]


def _cli(module: str) -> list:
    return [sys.executable, "-m", f"wav2vec_contr_loss_torch.cli.{module}"]


def _train(root: str, save: str, *layout: str) -> list:
    return _cli("train_stage1") + TINY + [
        "--compute_dtype", "float32", "--train_root", root,
        "--train_protocol", os.path.join(root, "protocol.txt"),
        "--epochs", "1", "--num_workers", "1", "--save_dir", save, *layout]


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    """{name: (each rank's log, its directory)} of the four CLI gangs,
    and 'root', the corpus."""
    tmp = tmp_path_factory.mktemp("gang_cli")
    root = str(tmp / "corpus")
    write_corpus(root, 16, seed=0, seconds=1.0)
    proto = os.path.join(root, "protocol.txt")
    feats = tmp / "features"
    feats.mkdir()
    rng = np.random.default_rng(0)
    labels = np.array([1, 0] * 12)
    for split, n in (("train", 24), ("dev", 12)):
        np.save(feats / f"{split}_features.npy",
                rng.normal(size=(n, 32, 250)).astype(np.float32))
        np.save(feats / f"{split}_feature_labels.npy", labels[:n])
    runs = {
        "pp": (_train(root, str(tmp / "pp"), "--param_sharding", "pp",
                      "--pipeline_microbatches", "2", "--mesh_model", "2"),
               str(tmp / "pp")),
        "sp": (_train(root, str(tmp / "sp"), "--mesh_model", "2",
                      "--sequence_parallel", "1"), str(tmp / "sp")),
        "features": (_cli("train_stage1") + TINY + [
            "--features_dir", str(feats), "--epochs", "2",
            "--save_dir", str(tmp / "features")], str(tmp / "features")),
        "pipeline": (_cli("run_pipeline") + [
            "--exp_name", "supcon_temp_0.07", "--model_name",
            "test/tiny-wav2vec2", "--encoder_init", "random",
            "--work_dir", str(tmp / "work"), "--epochs", "1",
            "--batch_size", "8", "--max_duration_seconds", "1",
            "--input_dim", "32", "--hidden_dim", "16", "--stage2_lr",
            "5e-2", "--stage2_epochs", "40", "--skip_plots", "--device",
            "cpu"] + [a for s in ("train", "dev", "eval") for a in (
                f"--{s}_root", root, f"--{s}_protocol", proto)],
            str(tmp / "work")),
    }
    with ThreadPoolExecutor(len(runs)) as pool:
        futures = {name: pool.submit(mp_smoke.spawn, cmd, 2, timeout=300,
                                     threads=1)
                   for name, (cmd, _) in runs.items()}
        return {"root": root, **{name: (f.result(), runs[name][1])
                                 for name, f in futures.items()}}


@pytest.mark.parametrize("name,layout", [
    ("pp", {"param_sharding": "pp", "pipeline_microbatches": 2}),
    ("sp", {"param_sharding": "replicated", "sequence_parallel": True}),
])
def test_train_stage1_trains_pipeline_and_sequence_parallel_gangs(
        gangs, name, layout):
    """Flags that exited 2 before this port now train an epoch as one
    gang; rank 0 alone logs and writes the checkpoints."""
    logs, save = gangs[name]
    assert "Stage-1 training complete" in logs[0]
    assert "=== CONFIG ===" not in logs[1]
    directory = os.path.join(save, TAG)
    side = ckpt.load_sidecar(directory, "latest")
    assert side["metrics"]["epoch"] == 1
    for key, value in layout.items():
        assert side["extra"]["stage1_config"][key] == value
    assert np.isfinite(side["metrics"]["train_loss"])


def test_train_stage1_from_features_in_a_gang(gangs):
    logs, save = gangs["features"]
    assert "Stage-1 (from features) complete" in logs[0]
    directory = os.path.join(save, TAG)
    side = ckpt.load_sidecar(directory, "latest")
    assert side["metrics"]["epoch"] == 2
    assert side["extra"]["from_features"] is True
    assert ckpt.checkpoint_exists(directory, "best")


def test_run_pipeline_extracts_on_every_rank(gangs, tmp_path):
    """The gang trains, both ranks extract (each its rows of every
    batch), rank 0 writes the embeddings in corpus order and goes on to
    stage 2 and the EER; the embeddings equal a single-process
    extraction of the same checkpoint."""
    logs, work = gangs["pipeline"]
    assert "EER" in logs[0]
    assert "EER" not in logs[1]
    exp = os.path.join(work, "supcon_temp_0.07")
    ckpt_dir = os.path.join(exp, "checkpoints_stage1", TAG)
    emb = os.path.join(exp, "embeddings")
    root = gangs["root"]
    extract_embeddings.main([
        "--ckpt_dir", ckpt_dir, "--out_dir", str(tmp_path), "--device",
        "cpu", "--eval_root", root, "--eval_protocol",
        os.path.join(root, "protocol.txt")])
    got = np.load(os.path.join(emb, "eval_embeddings.npy"))
    want = np.load(tmp_path / "eval_embeddings.npy")
    assert got.shape == want.shape == (16, 16)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.array_equal(np.load(os.path.join(emb, "eval_labels.npy")),
                          np.load(tmp_path / "eval_labels.npy"))
