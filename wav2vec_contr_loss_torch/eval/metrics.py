"""EER / DET-curve / t-DCF metrics for ASVspoof-style scoring.

The port's own copy of wav2vec_contr_loss_tpu/eval/metrics.py (pure
numpy; the port imports nothing of the JAX package), giving the same
numbers on the same scores. Numerically equivalent re-implementation of
the reference metric stack (reference: evaluation.py:7-255 and
baseline_train.py:114-148).

Conventions (same as ASVspoof tooling):
  * higher score  == stronger support for the *bonafide* hypothesis,
  * "target"      == bonafide trials, "nontarget" == spoof trials,
  * EER and error rates are returned as fractions (multiply by 100 for %).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "compute_det_curve",
    "compute_eer",
    "calculate_eer_from_file",
    "threshold_at_far",
    "bootstrap_eer_ci",
    "eer_threshold_sweep",
    "obtain_asv_error_rates",
    "read_asv_score_file",
    "asv_operating_point_from_scores",
    "TDCFCostModel",
    "ASVSPOOF2019_COST_MODEL",
    "compute_tdcf",
    "binary_classification_metrics",
]


def compute_det_curve(
    target_scores: np.ndarray, nontarget_scores: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Detection error tradeoff curve.

    Returns (frr, far, thresholds), each of length n_target+n_nontarget+1.
    Matches the ASVspoof reference algorithm (reference: evaluation.py:46-71):
    a *stable* ascending sort of the pooled scores, cumulative counts, and a
    leading (frr=0, far=1) operating point at threshold min(score)-0.001.
    """
    target_scores = np.asarray(target_scores, dtype=np.float64).ravel()
    nontarget_scores = np.asarray(nontarget_scores, dtype=np.float64).ravel()
    n_tar = target_scores.size
    n_non = nontarget_scores.size
    if n_tar == 0 or n_non == 0:
        raise ValueError("compute_det_curve needs at least one score per class")

    pooled = np.concatenate([target_scores, nontarget_scores])
    is_target = np.concatenate(
        [np.ones(n_tar, dtype=np.float64), np.zeros(n_non, dtype=np.float64)]
    )

    # Stable sort keeps the reference's tie-breaking (targets-before-nontargets
    # at equal scores, because targets come first in the pooled array).
    order = np.argsort(pooled, kind="mergesort")
    is_target = is_target[order]

    tar_below = np.cumsum(is_target)                  # targets <= threshold i
    non_below = np.arange(1, pooled.size + 1) - tar_below
    non_above = n_non - non_below                     # nontargets > threshold i

    frr = np.concatenate([[0.0], tar_below / n_tar])
    far = np.concatenate([[1.0], non_above / n_non])
    thresholds = np.concatenate([[pooled[order[0]] - 0.001], pooled[order]])
    return frr, far, thresholds


def compute_eer(
    target_scores: np.ndarray, nontarget_scores: np.ndarray
) -> Tuple[float, float]:
    """Equal error rate and its threshold (reference: evaluation.py:74-80)."""
    frr, far, thresholds = compute_det_curve(target_scores, nontarget_scores)
    idx = int(np.argmin(np.abs(frr - far)))
    eer = float(0.5 * (frr[idx] + far[idx]))
    return eer, float(thresholds[idx])


def calculate_eer_from_file(cm_scores_file: str) -> float:
    """EER (in percent) of an ASVspoof CM score file.

    File format: ``<utt_id> <source> <key> <score>`` per line with key in
    {bonafide, spoof} (reference: evaluation.py:7-28).
    """
    from .score import read_score_file

    rec = read_score_file(cm_scores_file)
    bona = rec.scores[rec.keys == "bonafide"]
    spoof = rec.scores[rec.keys == "spoof"]
    return compute_eer(bona, spoof)[0] * 100.0


def threshold_at_far(
    target_scores: np.ndarray,
    nontarget_scores: np.ndarray,
    far_target: float,
) -> Tuple[float, float, float]:
    """Lowest-FRR operating point with FAR <= `far_target` (fraction).

    Returns (threshold, frr, far) on the DET curve — the score threshold
    to deploy (e.g. `serve --threshold`) when a false-acceptance budget,
    not the EER, is the requirement. FAR is non-increasing along the
    curve, so the first index meeting the budget has the lowest FRR.
    """
    if not 0.0 <= far_target <= 1.0:
        raise ValueError(f"far_target must be a fraction in [0,1], "
                         f"got {far_target}")
    frr, far, thr = compute_det_curve(target_scores, nontarget_scores)
    idx = int(np.argmax(far <= far_target))  # first True (far is sorted desc)
    return float(thr[idx]), float(frr[idx]), float(far[idx])


def bootstrap_eer_ci(
    target_scores: np.ndarray,
    nontarget_scores: np.ndarray,
    n_boot: int = 1000,
    seed: int = 1337,
    ci: float = 95.0,
) -> Tuple[float, float]:
    """Percentile-bootstrap confidence interval for the EER.

    Bonafide and spoof trials are resampled independently with
    replacement (the two classes are independent trial sets), the EER is
    recomputed per replicate, and the (100-ci)/2 .. 100-(100-ci)/2
    percentiles are returned — same 0-1 units as `compute_eer`. Seeded
    and deterministic. The reference reports point EERs only
    (evaluation.py:74-80); trial counts of a few thousand bonafide make
    the sampling error worth stating (ASV19-LA eval: 7,355 bonafide).
    """
    t = np.asarray(target_scores, dtype=np.float64)
    n = np.asarray(nontarget_scores, dtype=np.float64)
    if t.size == 0 or n.size == 0:
        raise ValueError("bootstrap_eer_ci needs non-empty trial sets")
    if not 0.0 < ci < 100.0:
        raise ValueError(f"ci must be in (0, 100), got {ci}")
    rng = np.random.default_rng(seed)
    eers = np.empty(int(n_boot), dtype=np.float64)
    for b in range(int(n_boot)):
        eers[b] = compute_eer(
            t[rng.integers(0, t.size, t.size)],
            n[rng.integers(0, n.size, n.size)],
        )[0]
    half = (100.0 - ci) / 2.0
    lo, hi = np.percentile(eers, [half, 100.0 - half])
    return float(lo), float(hi)


def eer_threshold_sweep(
    labels01: np.ndarray, scores: np.ndarray
) -> Tuple[float, float]:
    """In-training EER via an exact descending threshold sweep with duplicate
    score grouping — the baseline trainer's early-stopping metric
    (reference: baseline_train.py:114-148). labels01: 1=bonafide, 0=spoof.

    Vectorized: group ties, evaluate (fpr, fnr) after each distinct
    threshold, pick the point minimising |fpr - fnr|.
    """
    labels01 = np.asarray(labels01).astype(np.int64).ravel()
    scores = np.asarray(scores, dtype=np.float64).ravel()
    n_pos = int((labels01 == 1).sum())
    n_neg = int((labels01 == 0).sum())
    if n_pos == 0 or n_neg == 0:
        raise ValueError("eer_threshold_sweep needs both classes present")

    order = np.argsort(-scores, kind="mergesort")
    y = labels01[order]
    s = scores[order]

    # indices of the last element of each tie-group (thresholds are distinct)
    last_of_group = np.nonzero(np.diff(s, append=np.nan) != 0)[0]
    tp = np.cumsum(y == 1)[last_of_group].astype(np.float64)
    fp = np.cumsum(y == 0)[last_of_group].astype(np.float64)
    fpr = fp / n_neg
    fnr = (n_pos - tp) / n_pos
    idx = int(np.argmin(np.abs(fpr - fnr)))
    eer = float(0.5 * (fpr[idx] + fnr[idx]))
    return eer, float(s[last_of_group[idx]])


def obtain_asv_error_rates(
    tar_asv: np.ndarray,
    non_asv: np.ndarray,
    spoof_asv: np.ndarray,
    asv_threshold: float,
) -> Tuple[float, float, Optional[float]]:
    """ASV operating-point error rates (reference: evaluation.py:31-43)."""
    tar_asv = np.asarray(tar_asv, dtype=np.float64)
    non_asv = np.asarray(non_asv, dtype=np.float64)
    spoof_asv = np.asarray(spoof_asv, dtype=np.float64)
    pfa_asv = float(np.sum(non_asv >= asv_threshold) / non_asv.size)
    pmiss_asv = float(np.sum(tar_asv < asv_threshold) / tar_asv.size)
    pmiss_spoof_asv = (
        None
        if spoof_asv.size == 0
        else float(np.sum(spoof_asv < asv_threshold) / spoof_asv.size)
    )
    return pfa_asv, pmiss_asv, pmiss_spoof_asv


def read_asv_score_file(
    path: str,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (target, nontarget, spoof) score arrays from an ASV score file.

    Accepts the official ASVspoof2019 ASV score format (3 whitespace
    columns: ``<source> <key> <score>``, e.g.
    ``ASVspoof2019.LA.asv.eval.gi.trl.scores.txt``) and any wider variant
    with the trial key in the second-to-last column and the score last.
    Keys must be 'target' / 'nontarget' / 'spoof'.
    """
    keys, scores = [], []
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            parts = line.split()
            if not parts:
                continue
            if len(parts) < 2:
                raise ValueError(f"{path}:{ln}: need at least <key> <score>")
            keys.append(parts[-2])
            try:
                scores.append(float(parts[-1]))
            except ValueError:
                raise ValueError(
                    f"{path}:{ln}: last column is not a score: {parts[-1]!r}")
    keys_arr = np.array(keys)
    scores_arr = np.array(scores, dtype=np.float64)
    bad = set(keys_arr) - {"target", "nontarget", "spoof"}
    if bad:
        raise ValueError(
            f"{path}: unknown ASV trial keys {sorted(bad)} — expected "
            "target/nontarget/spoof in the second-to-last column")
    out = (scores_arr[keys_arr == "target"],
           scores_arr[keys_arr == "nontarget"],
           scores_arr[keys_arr == "spoof"])
    empty = [n for n, a in zip(("target", "nontarget", "spoof"), out)
             if a.size == 0]
    if empty:
        raise ValueError(
            f"{path}: no {'/'.join(empty)} trials — the t-DCF operating "
            "point needs all three (target/nontarget fix the ASV EER "
            "threshold, spoof gives pmiss_spoof_asv); is this a plain "
            "ASV score file without spoof trials?")
    return out


def asv_operating_point_from_scores(
    tar_asv: np.ndarray,
    non_asv: np.ndarray,
    spoof_asv: np.ndarray,
) -> Tuple[float, float, Optional[float], float, float]:
    """-> (pfa_asv, pmiss_asv, pmiss_spoof_asv, eer_asv, asv_threshold).

    Fixes the ASV operating point at the ASV system's EER threshold over
    its target/nontarget trials and derives the error rates the t-DCF
    needs — the official ASVspoof t-DCF usage (reference: evaluation.py:26
    'fix ASV operating point to EER threshold' and 31-43).
    """
    eer_asv, thr = compute_eer(tar_asv, non_asv)
    pfa, pmiss, pmiss_spoof = obtain_asv_error_rates(
        tar_asv, non_asv, spoof_asv, thr)
    return pfa, pmiss, pmiss_spoof, eer_asv, thr


@dataclass(frozen=True)
class TDCFCostModel:
    """t-DCF cost model parameters (ASVspoof 2019 evaluation plan)."""

    Ptar: float
    Pnon: float
    Pspoof: float
    Cmiss_asv: float
    Cfa_asv: float
    Cmiss_cm: float
    Cfa_cm: float

    def validate(self) -> None:
        if min(self.Cfa_asv, self.Cmiss_asv, self.Cfa_cm, self.Cmiss_cm) < 0:
            raise ValueError("t-DCF costs must be non-negative")
        priors = (self.Ptar, self.Pnon, self.Pspoof)
        if min(priors) < 0 or abs(sum(priors) - 1.0) > 1e-10:
            raise ValueError("t-DCF priors must be positive and sum to one")


# The ASVspoof 2019 LA cost model constants.
ASVSPOOF2019_COST_MODEL = TDCFCostModel(
    Ptar=0.9405, Pnon=0.0095, Pspoof=0.05,
    Cmiss_asv=1.0, Cfa_asv=10.0, Cmiss_cm=1.0, Cfa_cm=10.0,
)


def compute_tdcf(
    bonafide_score_cm: np.ndarray,
    spoof_score_cm: np.ndarray,
    pfa_asv: float,
    pmiss_asv: float,
    pmiss_spoof_asv: Optional[float],
    cost_model: TDCFCostModel = ASVSPOOF2019_COST_MODEL,
) -> Tuple[np.ndarray, np.ndarray]:
    """Normalized tandem detection cost function curve over CM thresholds.

    Same math as the reference (evaluation.py:83-255); invalid inputs raise
    ValueError instead of calling sys.exit.

    Returns (tdcf_norm, cm_thresholds); min(tdcf_norm) is the min-tDCF.
    """
    cost_model.validate()
    if pmiss_spoof_asv is None:
        raise ValueError("pmiss_spoof_asv is required (spoof trials vs ASV)")

    combined = np.concatenate([bonafide_score_cm, spoof_score_cm]).astype(np.float64)
    if np.isnan(combined).any() or np.isinf(combined).any():
        raise ValueError("CM scores contain nan or inf")
    if np.unique(combined).size < 3:
        raise ValueError("CM scores look like hard decisions, not soft scores")

    pmiss_cm, pfa_cm, cm_thresholds = compute_det_curve(
        bonafide_score_cm, spoof_score_cm
    )

    c1 = (
        cost_model.Ptar * (cost_model.Cmiss_cm - cost_model.Cmiss_asv * pmiss_asv)
        - cost_model.Pnon * cost_model.Cfa_asv * pfa_asv
    )
    c2 = cost_model.Cfa_cm * cost_model.Pspoof * (1.0 - pmiss_spoof_asv)
    if c1 < 0 or c2 < 0:
        raise ValueError("negative t-DCF weights; check the ASV error rates")

    tdcf = c1 * pmiss_cm + c2 * pfa_cm
    tdcf_norm = tdcf / min(c1, c2)
    return tdcf_norm, cm_thresholds


def binary_classification_metrics(
    labels01: np.ndarray, scores: np.ndarray, threshold: float = 0.5
) -> Tuple[float, Optional[float], Optional[float]]:
    """(accuracy, auc, eer) for stage-2 dev monitoring.

    `scores` are probabilities (post-sigmoid); accuracy thresholds at 0.5,
    matching the reference's monitoring metric (stage2_utils.py:61-83).
    AUC/EER computed in numpy (no sklearn dependency); EER uses the DET-curve
    definition, identical at the equal-error point to sklearn's ROC variant.
    """
    labels01 = np.asarray(labels01).astype(np.int64).ravel()
    scores = np.asarray(scores, dtype=np.float64).ravel()
    preds = (scores > threshold).astype(np.int64)
    acc = float((preds == labels01).mean())

    pos = scores[labels01 == 1]
    neg = scores[labels01 == 0]
    if pos.size == 0 or neg.size == 0:
        return acc, None, None

    # Mann-Whitney U statistic -> exact ROC AUC with tie correction.
    pooled = np.concatenate([pos, neg])
    # average ranks (ties share the mean rank)
    order = np.argsort(pooled, kind="mergesort")
    ranks = np.empty_like(pooled)
    ranks[order] = np.arange(1, pooled.size + 1, dtype=np.float64)
    _, inv, counts = np.unique(pooled, return_inverse=True, return_counts=True)
    if (counts > 1).any():
        rank_sums = np.zeros(counts.size)
        np.add.at(rank_sums, inv, ranks)
        ranks = (rank_sums / counts)[inv]
    auc = float((ranks[: pos.size].sum() - pos.size * (pos.size + 1) / 2.0)
                / (pos.size * neg.size))

    eer = compute_eer(pos, neg)[0]
    return acc, auc, float(eer)
