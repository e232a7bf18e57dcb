"""The port's pipeline CLI and host-only CLIs on the CPU: `run_pipeline
--device cpu` on the synthetic corpus and flags of tests/test_cli.py
(train -> extract -> plots -> stage-2 -> scores -> EER), its
--stage1_ckpt rerun and refusal, and `eval_scores` / `plot_umap` as
tests/test_cli.py holds the JAX CLIs, with eval_scores' report equal to
the JAX CLI's on the same files. Budget: ~30 s alone."""

import os
import sys

import numpy as np
import pytest

import torch

from wav2vec_contr_loss_tpu.cli import eval_scores as jax_eval_scores

from tests.test_cli import cli_corpus  # noqa: F401  (a fixture)
from tests.test_torch_bridge import cap_torch_threads
from wav2vec_contr_loss_torch.cli import (eval_scores, extract_embeddings,
                                          generate_scores, plot_umap,
                                          run_pipeline, train_stage2)
from wav2vec_contr_loss_torch.device import resolve_device
from wav2vec_contr_loss_torch.eval.metrics import calculate_eer_from_file
from wav2vec_contr_loss_torch.eval.score import write_cm_scores

cap_torch_threads()

TAG = "test__tiny-wav2vec2"
EXP = "supcon_temp_0.07"


def _paths(root, proto, splits=("train", "dev", "eval")):
    out = []
    for s in splits:
        out += [f"--{s}_root", root, f"--{s}_protocol", proto]
    return out


def test_run_pipeline_cpu(cli_corpus, tmp_path, monkeypatch):  # noqa: F811
    work = str(tmp_path / "exp")
    root, proto = str(cli_corpus), str(cli_corpus / "protocol.txt")
    run_pipeline.main([
        "--exp_name", EXP, "--model_name", "test/tiny-wav2vec2",
        "--encoder_init", "random", "--work_dir", work,
        *_paths(root, proto),
        "--epochs", "2", "--batch_size", "8", "--max_duration_seconds", "1",
        "--input_dim", "32", "--hidden_dim", "16",
        # the hot stage-2 of tests/test_cli.py: the corpus is separable,
        # so the EER goes to ~0, and an inverted score reads as 100
        "--stage2_lr", "5e-2", "--stage2_epochs", "40", "--device", "cpu",
    ])
    exp = os.path.join(work, EXP)
    ckpt = os.path.join(exp, "checkpoints_stage1", TAG)
    assert os.path.exists(os.path.join(ckpt, "best.pt"))
    assert os.path.exists(os.path.join(ckpt, "best.config.json"))
    for split in ("train", "dev", "eval"):
        assert os.path.exists(
            os.path.join(exp, "embeddings", f"{split}_embeddings.npy"))
    assert os.path.exists(os.path.join(exp, "plots", "umap_eval.png"))
    assert os.path.exists(os.path.join(exp, "checkpoints_stage2",
                                       "stage2_binary_head_best.pt"))
    score_file = os.path.join(exp, "scores", EXP, TAG, "score_cm_eval.txt")
    assert calculate_eer_from_file(score_file) <= 10.0

    # --stage1_ckpt: the training leg is skipped, the rest still runs
    def boom(*a, **k):
        raise AssertionError("training leg must be skipped")

    monkeypatch.setattr(run_pipeline.train_stage1, "main", boom)
    work2 = str(tmp_path / "exp2")
    run_pipeline.main([
        "--exp_name", EXP, "--model_name", "test/tiny-wav2vec2",
        "--work_dir", work2, "--stage1_ckpt", ckpt, *_paths(root, proto),
        "--skip_plots", "--stage2_lr", "5e-2", "--stage2_epochs", "40",
        "--device", "cpu",
    ])
    exp2 = os.path.join(work2, EXP)
    assert not os.path.exists(os.path.join(exp2, "plots"))
    score2 = os.path.join(exp2, "scores", EXP, TAG, "score_cm_eval.txt")
    assert calculate_eer_from_file(score2) <= 10.0

    # attack-colored plot from the saved multi-labels and attack map
    emb_dir = os.path.join(exp, "embeddings")
    assert os.path.exists(os.path.join(emb_dir, "eval_multi_labels.npy"))
    plot_umap.main(["--emb_dir", emb_dir, "--split", "eval", "--by_attack",
                    "--out_dir", os.path.join(exp, "plots_attack")])
    png = os.path.join(exp, "plots_attack", "umap_eval.png")
    assert os.path.getsize(png) > 10_000

    # without matplotlib the plot raises, and says how to run without it
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="--skip_plots"):
        plot_umap.main(["--emb_dir", emb_dir, "--split", "eval",
                        "--out_dir", str(tmp_path / "none")])
    with pytest.raises(ImportError, match="--det"):
        eval_scores.main([score_file, "--det", str(tmp_path / "d.png")])


def test_run_pipeline_stage1_ckpt_rejects_training_flags(capsys):
    with pytest.raises(SystemExit) as e:
        run_pipeline.main(["--exp_name", EXP, "--stage1_ckpt", "/some/ckpt",
                           "--epochs", "10", "--encoder_init", "random",
                           "--resume"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "--epochs" in err and "--encoder_init" in err and "--resume" in err
    assert "stage1_ckpt skips" in err


@pytest.mark.parametrize("cli,argv", [
    (extract_embeddings, ["--ckpt_dir", "x"]),
    (train_stage2, ["--emb_dir", "x"]),
    (generate_scores, ["--emb_dir", "x", "--stage2_dir", "x",
                       "--scores_dir", "x"]),
])
def test_card_clis_default_to_the_gpu(cli, argv):
    """Each CLI that touches the card takes --device, 'cuda' by default."""
    assert cli.build_parser().parse_args(argv).device == "cuda"
    assert run_pipeline.build_parser().parse_args(
        ["--exp_name", EXP]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(cli.build_parser().parse_args(argv).device)


def _report(mod, argv, capsys):
    mod.main(argv)
    return capsys.readouterr().out


def test_eval_scores_cli_matches_jax(tmp_path, capsys):
    rng = np.random.default_rng(0)
    labels = np.array([1] * 50 + [0] * 80)
    scores = np.where(labels == 1, rng.normal(2, 1, 130),
                      rng.normal(-2, 1, 130))
    path = str(tmp_path / "score_cm_eval.txt")
    write_cm_scores(path, labels, scores, utt_prefix="asv_eval")
    asv = str(tmp_path / "asv_scores.txt")
    asv_rng = np.random.default_rng(1)
    with open(asv, "w") as f:
        for key, mu in (("target", 3), ("nontarget", -3), ("spoof", -1)):
            for s in asv_rng.normal(mu, 1, 40):
                f.write(f"bonafide {key} {s}\n")
    for argv in ([path, "--tdcf", "--asv_operating_point", "0.01", "0.01",
                  "0.9"],
                 [path, "--tdcf", "--asv_scores", asv],
                 [path, "--bootstrap", "40", "--operating_point", "1",
                  "--operating_point", "10"],
                 [str(tmp_path)]):
        got = _report(eval_scores, argv, capsys)
        assert got == _report(jax_eval_scores, argv, capsys)
        assert "EER = " in got
        assert ("min-tDCF" in got) == ("--tdcf" in argv)
    # --tdcf without an operating point, with both, and an operating
    # point without --tdcf all fail fast
    for bad in ([path, "--tdcf"],
                [path, "--tdcf", "--asv_scores", asv,
                 "--asv_operating_point", "0.01", "0.01", "0.9"],
                [path, "--asv_scores", asv]):
        with pytest.raises(SystemExit):
            eval_scores.main(bad)
        capsys.readouterr()


def test_eval_scores_bootstrap_by_attack_and_det(tmp_path, capsys):
    rng = np.random.default_rng(1)
    labels = np.array([1] * 40 + [0] * 60)
    attacks = ["-"] * 40 + ["A01"] * 30 + ["A02"] * 30
    scores = np.concatenate([rng.normal(1.0, 1.0, 40),
                             rng.normal(0.5, 1.0, 30),
                             rng.normal(-6.0, 0.5, 30)])
    proto = str(tmp_path / "protocol.txt")
    with open(proto, "w") as f:
        for i, (att, lab) in enumerate(zip(attacks, labels)):
            key = "bonafide" if lab == 1 else "spoof"
            f.write(f"LA_E_{i:06d} {att} {key} - SPK{i % 5}\n")
    path = str(tmp_path / "exp0" / "score_cm_eval.txt")
    write_cm_scores(path, labels, scores, utt_prefix="asv_eval")

    argv = [path, "--bootstrap", "50", "--by_attack", proto]
    out = _report(eval_scores, argv, capsys)
    assert out == _report(jax_eval_scores, argv, capsys)
    assert "95% CI [" in out
    a01 = next(ln for ln in out.splitlines() if ln.strip().startswith("A01:"))
    a02 = next(ln for ln in out.splitlines() if ln.strip().startswith("A02:"))
    assert "(n=30)" in a01 and "(n=30)" in a02
    assert float(a02.split("=")[1].split("%")[0]) == 0.0
    assert float(a01.split("=")[1].split("%")[0]) > 10.0
    with open(proto, "a") as f:
        f.write("LA_E_999999 A03 spoof - SPK0\n")
    with pytest.raises(SystemExit, match="positional"):
        eval_scores.main([path, "--by_attack", proto])

    # --det: one probit-axis PNG over the files; too many curves fail
    other = str(tmp_path / "exp1" / "score_cm_eval.txt")
    write_cm_scores(other, labels, scores + rng.normal(0, 2, 100),
                    utt_prefix="asv_eval")
    det = str(tmp_path / "det.png")
    eval_scores.main([path, other, "--det", det])
    assert os.path.getsize(det) > 10_000
    with pytest.raises(SystemExit, match="distinguishable"):
        eval_scores.main([path, other] * 5 + ["--det", det])
