"""The port's copies of eval/metrics.py and eval/score.py against the JAX
package's, on the same seeded scores, ties included: every metric equal
(== or rtol 1e-12), score files byte-identical, and the reader's round
trip. Budget: a few seconds alone."""

import numpy as np
import pytest

from wav2vec_contr_loss_tpu.eval import metrics as jm
from wav2vec_contr_loss_tpu.eval import score as js

from wav2vec_contr_loss_torch.eval import metrics as pm
from wav2vec_contr_loss_torch.eval import score as ps

from tests.test_torch_bridge import cap_torch_threads

cap_torch_threads()

RTOL = 1e-12


def _scores(seed: int, ties: bool):
    """(bonafide, spoof) scores; with `ties`, rounded to one decimal so
    many scores tie across and within the classes."""
    rng = np.random.default_rng(seed)
    bona = rng.normal(1.0, 1.0, 60 + seed)
    spoof = rng.normal(-0.5, 1.2, 90 - seed)
    if ties:
        bona, spoof = np.round(bona, 1), np.round(spoof, 1)
    return bona, spoof


def _same(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif a is None or b is None:
        assert a is None and b is None
    else:
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=0)


CASES = [(0, False), (1, True), (7, True)]


@pytest.mark.parametrize("seed,ties", CASES)
def test_det_eer_and_operating_points_equal(seed, ties):
    bona, spoof = _scores(seed, ties)
    for got, want in zip(pm.compute_det_curve(bona, spoof),
                         jm.compute_det_curve(bona, spoof)):
        np.testing.assert_array_equal(got, want)
    assert pm.compute_eer(bona, spoof) == jm.compute_eer(bona, spoof)
    for far in (0.0, 0.01, 0.1, 0.5, 1.0):
        assert pm.threshold_at_far(bona, spoof, far) == \
            jm.threshold_at_far(bona, spoof, far)
    with pytest.raises(ValueError):
        pm.threshold_at_far(bona, spoof, 1.5)
    with pytest.raises(ValueError):
        pm.compute_det_curve(bona, spoof[:0])


@pytest.mark.parametrize("seed,ties", CASES)
def test_bootstrap_and_sweep_equal(seed, ties):
    bona, spoof = _scores(seed, ties)
    _same(pm.bootstrap_eer_ci(bona, spoof, n_boot=60, seed=seed),
          jm.bootstrap_eer_ci(bona, spoof, n_boot=60, seed=seed))
    labels = np.concatenate([np.ones(bona.size), np.zeros(spoof.size)])
    scores = np.concatenate([bona, spoof])
    _same(pm.eer_threshold_sweep(labels, scores),
          jm.eer_threshold_sweep(labels, scores))


@pytest.mark.parametrize("seed,ties", CASES)
def test_tdcf_and_asv_operating_point_equal(seed, ties, tmp_path):
    bona, spoof = _scores(seed, ties)
    rng = np.random.default_rng(100 + seed)
    tar, non, sp = (rng.normal(3, 1, 40), rng.normal(-3, 1, 40),
                    rng.normal(-1, 1, 40))
    _same(pm.asv_operating_point_from_scores(tar, non, sp),
          jm.asv_operating_point_from_scores(tar, non, sp))
    path = str(tmp_path / "asv.txt")
    with open(path, "w") as f:
        for key, arr in (("target", tar), ("nontarget", non),
                         ("spoof", sp)):
            for s in arr:
                f.write(f"LA_0001 bonafide {key} {s}\n")
    _same(pm.read_asv_score_file(path), jm.read_asv_score_file(path))
    point = pm.asv_operating_point_from_scores(tar, non, sp)[:3]
    got = pm.compute_tdcf(bona, spoof, *point, pm.ASVSPOOF2019_COST_MODEL)
    want = jm.compute_tdcf(bona, spoof, *point, jm.ASVSPOOF2019_COST_MODEL)
    _same(got, want)
    assert pm.ASVSPOOF2019_COST_MODEL == pm.TDCFCostModel(
        **vars(jm.ASVSPOOF2019_COST_MODEL))
    with pytest.raises(ValueError, match="hard decisions"):
        pm.compute_tdcf(np.ones(5), np.zeros(5), *point)


@pytest.mark.parametrize("seed,ties", CASES)
def test_binary_classification_metrics_equal(seed, ties):
    bona, spoof = _scores(seed, ties)
    labels = np.concatenate([np.ones(bona.size), np.zeros(spoof.size)])
    probs = 1.0 / (1.0 + np.exp(-np.concatenate([bona, spoof])))
    _same(pm.binary_classification_metrics(labels, probs),
          jm.binary_classification_metrics(labels, probs))
    # one class only: accuracy, no AUC or EER
    assert pm.binary_classification_metrics(labels[:5], probs[:5]) == \
        jm.binary_classification_metrics(labels[:5], probs[:5])


@pytest.mark.parametrize("seed,ties", CASES)
def test_score_files_byte_identical_and_round_trip(seed, ties, tmp_path):
    bona, spoof = _scores(seed, ties)
    labels = np.concatenate([np.ones(bona.size), np.zeros(spoof.size)])
    scores = np.concatenate([bona, spoof])
    order = np.random.default_rng(seed).permutation(labels.size)
    labels, scores = labels[order], scores[order]
    got, want = str(tmp_path / "port.txt"), str(tmp_path / "jax.txt")
    ps.write_cm_scores(got, labels, scores, utt_prefix="asv_eval")
    js.write_cm_scores(want, labels, scores, utt_prefix="asv_eval")
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()
    ids = [f"LA_E_{i:07d}" for i in range(labels.size)]
    ps.write_cm_scores(got, labels, scores, utt_ids=ids)
    js.write_cm_scores(want, labels, scores, utt_ids=ids)
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()

    rec = ps.read_score_file(got)
    assert len(rec) == labels.size and list(rec.utt_ids) == ids
    np.testing.assert_array_equal(rec.keys == "bonafide", labels == 1)
    np.testing.assert_allclose(rec.scores, scores, atol=5e-7, rtol=0)
    np.testing.assert_array_equal(rec.bonafide_scores,
                                  js.read_score_file(want).bonafide_scores)
    assert pm.calculate_eer_from_file(got) == jm.calculate_eer_from_file(want)
    with pytest.raises(ValueError, match="utt_prefix or utt_ids"):
        ps.write_cm_scores(got, labels, scores)
