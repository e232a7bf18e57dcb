"""The port's two host commands, `verify_parity` and `run_sweep`, as
tests/test_verify_parity.py holds the JAX ones: verify_parity's exit
codes on synthetic score files, its reference table against the JAX one,
its default score layout, the reference's committed score files where
they are mounted; run_sweep's argv for each preset (monkeypatched
run_pipeline), unknown presets, --keep_going, and one real tiny-width
preset on the synthetic corpus of tests/test_cli.py. Budget: ~20 s
alone."""

import os

import numpy as np
import pytest

from wav2vec_contr_loss_tpu.cli import verify_parity as jax_verify_parity

import tests.test_verify_parity as jax_tests
from tests.test_cli import cli_corpus  # noqa: F401  (a fixture)
from tests.test_torch_bridge import cap_torch_threads
from wav2vec_contr_loss_torch.cli import run_sweep, verify_parity
from wav2vec_contr_loss_torch.config import EXPERIMENT_PRESETS
from wav2vec_contr_loss_torch.eval.metrics import calculate_eer_from_file
from wav2vec_contr_loss_torch.eval.score import write_cm_scores

cap_torch_threads()


def make_scores(path, eer_target, n_bona=500, n_spoof=800, seed=0):
    """Scores with about the EER asked for (a share of swapped labels),
    as tests/test_verify_parity.py writes them."""
    rng = np.random.default_rng(seed)
    bona = rng.normal(3.0, 0.5, n_bona)
    spoof = rng.normal(-3.0, 0.5, n_spoof)
    flip = int(eer_target / 100 * min(n_bona, n_spoof))
    bona[:flip], spoof[:flip] = spoof[:flip].copy(), bona[:flip].copy()
    labels = np.concatenate([np.ones(n_bona, int), np.zeros(n_spoof, int)])
    write_cm_scores(str(path), labels, np.concatenate([bona, spoof]),
                    utt_prefix="asv_eval")


def _exit_code(argv) -> int:
    with pytest.raises(SystemExit) as e:
        verify_parity.main(argv)
    return e.value.code


def test_reference_table_is_the_jax_one_and_covers_presets():
    assert verify_parity.REFERENCE_EER == jax_verify_parity.REFERENCE_EER
    assert set(verify_parity.REFERENCE_EER) == set(EXPERIMENT_PRESETS)


def test_pass_fail_and_missing(tmp_path, capsys):
    d = tmp_path / "scores"
    make_scores(d / "score_cm_eval.txt", 0.3)   # supcon's reference 0.299
    assert _exit_code(["--exp_name", "supcon", "--scores_dir", str(d)]) == 0
    assert "-> PASS" in capsys.readouterr().out
    make_scores(d / "score_cm_itw.txt", 30.0)   # ITW far off: 13.694
    assert _exit_code(["--exp_name", "supcon", "--scores_dir", str(d)]) == 1
    os.remove(d / "score_cm_itw.txt")
    make_scores(d / "score_cm_eval.txt", 5.0)   # eval far off
    assert _exit_code(["--exp_name", "supcon", "--scores_dir", str(d)]) == 1
    assert _exit_code(["--exp_name", "supcon", "--scores_dir", str(d),
                       "--tolerance", "10"]) == 0
    assert _exit_code(["--exp_name", "supcon",
                       "--scores_dir", str(tmp_path / "none")]) == 1
    assert "FAIL: missing" in capsys.readouterr().out


def test_default_layout_under_work_dir(tmp_path, monkeypatch):
    """Without --scores_dir the pipeline runs first (here a stand-in that
    writes the eval file) and the file is read from run_pipeline's
    layout: <work_dir>/<exp>/scores/<exp>/<run tag>/."""
    from wav2vec_contr_loss_torch.cli import run_pipeline

    calls = []

    def fake_pipeline(argv):
        calls.append(argv)
        d = tmp_path / "w" / "supcon" / "scores" / "supcon" / "org__m"
        make_scores(d / "score_cm_eval.txt", 0.3)

    monkeypatch.setattr(run_pipeline, "main", fake_pipeline)
    argv = ["--work_dir", str(tmp_path / "w"), "--model_name", "org/m",
            "--device", "cpu"]
    assert _exit_code(["--exp_name", "supcon"] + argv) == 0
    assert calls == [["--exp_name", "supcon"] + argv]


@pytest.mark.parametrize("exp", ["supcon", "supcon_temp_0.07",
                                 "supcon_geodesic_temp_0.07",
                                 "supcon_uniformity_weight_0.05"])
def test_reference_committed_scores_pass(exp, monkeypatch):
    """tests/test_verify_parity.py's checks on the reference's own
    committed score files (zero slack on the eval and ITW legs; another
    experiment's files fail), run against the port's command; they skip
    where those files are not mounted."""
    monkeypatch.setattr(jax_tests, "verify_parity", verify_parity)
    jax_tests.test_directory_mode_on_reference_committed_scores(exp)
    jax_tests.test_directory_mode_rejects_mismatched_experiment()


def test_sweep_argv_order_and_unknown(monkeypatch, capsys):
    calls = []
    monkeypatch.setattr(run_sweep.run_pipeline, "main", calls.append)
    run_sweep.main(["--experiments", "supcon_temp_0.1", "supcon",
                    "--work_dir", "W", "--train_root", "R", "--epochs", "3",
                    "--device", "cpu", "--batch_size", "8"])
    tail = ["--work_dir", "W", "--train_root", "R", "--epochs", "3",
            "--device", "cpu", "--batch_size", "8"]
    assert calls == [["--exp_name", "supcon_temp_0.1"] + tail,
                     ["--exp_name", "supcon"] + tail]
    assert "[SWEEP] all 2 experiments complete" in capsys.readouterr().out
    calls.clear()
    run_sweep.main([])
    assert [c[1] for c in calls] == sorted(EXPERIMENT_PRESETS)
    with pytest.raises(SystemExit, match="unknown presets"):
        run_sweep.main(["--experiments", "supcon", "no_such_preset"])


def test_sweep_keep_going(monkeypatch, capsys):
    ran = []

    def pipeline(argv):
        ran.append(argv[1])
        if argv[1] == "supcon_temp_0.05":
            raise RuntimeError("boom")

    monkeypatch.setattr(run_sweep.run_pipeline, "main", pipeline)
    names = ["supcon", "supcon_temp_0.05", "supcon_temp_0.1"]
    with pytest.raises(RuntimeError, match="boom"):
        run_sweep.main(["--experiments", *names])
    assert ran == names[:2]
    ran.clear()
    run_sweep.main(["--experiments", *names, "--keep_going"])
    assert ran == names
    assert ("[SWEEP] failed experiments: ['supcon_temp_0.05']"
            in capsys.readouterr().out)


def test_sweep_runs_a_real_preset(cli_corpus, tmp_path):  # noqa: F811
    """One preset end to end at the tiny width of
    tests/test_torch_run_pipeline.py, on the CPU, through the sweep."""
    work = str(tmp_path / "exp")
    root, proto = str(cli_corpus), str(cli_corpus / "protocol.txt")
    paths = []
    for s in ("train", "dev", "eval"):
        paths += [f"--{s}_root", root, f"--{s}_protocol", proto]
    run_sweep.main([
        "--experiments", "supcon_temp_0.07", "--model_name",
        "test/tiny-wav2vec2", "--encoder_init", "random", "--work_dir", work,
        *paths, "--epochs", "2", "--device", "cpu", "--batch_size", "8",
        "--max_duration_seconds", "1", "--input_dim", "32", "--hidden_dim",
        "16", "--stage2_lr", "5e-2", "--stage2_epochs", "40", "--skip_plots"])
    scores = os.path.join(work, "supcon_temp_0.07", "scores",
                          "supcon_temp_0.07", "test__tiny-wav2vec2")
    assert calculate_eer_from_file(
        os.path.join(scores, "score_cm_eval.txt")) <= 10.0
    # verify_parity reads the run's file (the synthetic corpus is not
    # ASVspoof: its EER is held to a tolerance that takes it)
    assert _exit_code(["--exp_name", "supcon_temp_0.07", "--scores_dir",
                       scores, "--tolerance", "10"]) == 0
