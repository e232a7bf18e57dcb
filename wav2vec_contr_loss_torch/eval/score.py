"""ASVspoof CM score-file I/O.

The port's own copy of wav2vec_contr_loss_tpu/eval/score.py: given the
same scores it writes the same bytes.

The score file is the filesystem contract between scoring and evaluation
(reference: generate_eval_score_file.py:149-166, evaluation.py:7-28).
Each line: ``<utt_id> <source> <key> <score>`` with key in {bonafide, spoof}
and score a raw logit (higher == more bonafide-like), printed with 6 decimals.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterable, Optional, Sequence

import numpy as np

__all__ = [
    "ScoreRecords",
    "read_score_file",
    "write_score_file",
    "write_cm_scores",
    "make_utt_ids",
    "KEY_BONAFIDE",
    "KEY_SPOOF",
]

KEY_BONAFIDE = "bonafide"
KEY_SPOOF = "spoof"


@dataclass
class ScoreRecords:
    utt_ids: np.ndarray   # (N,) str
    sources: np.ndarray   # (N,) str
    keys: np.ndarray      # (N,) str, 'bonafide' | 'spoof'
    scores: np.ndarray    # (N,) float64

    def __len__(self) -> int:
        return int(self.scores.size)

    @property
    def bonafide_scores(self) -> np.ndarray:
        return self.scores[self.keys == KEY_BONAFIDE]

    @property
    def spoof_scores(self) -> np.ndarray:
        return self.scores[self.keys == KEY_SPOOF]


def read_score_file(path: str) -> ScoreRecords:
    """Parse a 4-column CM score file (reference: evaluation.py:13-17)."""
    data = np.genfromtxt(path, dtype=str)
    if data.ndim == 1:  # single-line file
        data = data.reshape(1, -1)
    if data.shape[1] < 4:
        raise ValueError(f"score file {path} has {data.shape[1]} columns, need 4")
    return ScoreRecords(
        utt_ids=data[:, 0],
        sources=data[:, 1],
        keys=data[:, 2],
        scores=data[:, 3].astype(np.float64),
    )


def make_utt_ids(prefix: str, n: int, start: int = 0) -> list:
    """Synthetic utterance ids, e.g. asv_eval_000042 / itw_000007
    (reference: generate_eval_score_file.py:160-161)."""
    return [f"{prefix}_{i:06d}" for i in range(start, start + n)]


def write_score_file(
    path: str,
    utt_ids: Sequence[str],
    keys: Sequence[str],
    scores: Iterable[float],
    sources: Optional[Sequence[str]] = None,
) -> None:
    scores = np.asarray(list(scores), dtype=np.float64)
    n = len(utt_ids)
    if sources is None:
        sources = ["NA"] * n
    if not (len(keys) == n == scores.size == len(sources)):
        raise ValueError("write_score_file: column length mismatch")
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        for uid, src, key, sc in zip(utt_ids, sources, keys, scores):
            f.write(f"{uid} {src} {key} {sc:.6f}\n")


def write_cm_scores(
    path: str,
    labels01: np.ndarray,
    scores: np.ndarray,
    utt_prefix: Optional[str] = None,
    utt_ids: Optional[Sequence[str]] = None,
) -> None:
    """Write scores with keys derived from binary labels (1=bonafide, 0=spoof).

    Provide either `utt_prefix` (synthetic ids) or explicit `utt_ids`
    (real audio names, as the baseline scorer does —
    reference: eval_baseline_score_file.py:77-169).
    """
    labels01 = np.asarray(labels01).astype(np.int64).ravel()
    scores = np.asarray(scores, dtype=np.float64).ravel()
    if labels01.size != scores.size:
        raise ValueError("labels and scores must be the same length")
    if utt_ids is None:
        if utt_prefix is None:
            raise ValueError("need utt_prefix or utt_ids")
        utt_ids = make_utt_ids(utt_prefix, labels01.size)
    keys = [KEY_BONAFIDE if int(y) == 1 else KEY_SPOOF for y in labels01]
    write_score_file(path, utt_ids, keys, scores)
