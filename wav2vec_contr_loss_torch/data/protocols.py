"""Protocol parsers and dataset objects.

The port's copy of the ASVspoof2019-LA and In-The-Wild parts of
wav2vec_contr_loss_tpu/data/protocols.py. Each parser returns a
`SpoofDataset`: an ordered list of `Utterance` records plus an
`AudioLoader`; batching happens in pipeline.py.

Label conventions (as the reference): binary 1 = bonafide, 0 = spoof;
multi-class attack ids are assigned in file order with bonafide = 0.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from .audio import AudioConfig, AudioLoader

__all__ = ["Utterance", "SpoofDataset", "parse_asvspoof2019",
           "parse_in_the_wild"]


@dataclass(frozen=True)
class Utterance:
    path: str
    label: int                 # 1 = bonafide, 0 = spoof
    multi_label: int = 0       # attack-id class (bonafide = 0)
    speaker: str = "unknown"
    source: str = "NA"
    name: str = ""             # audio file name (utt id for scoring)


class SpoofDataset:
    """An ordered utterance list + audio loader. Indexing decodes audio to a
    fixed-length float32 waveform; label metadata is available without
    decoding via `.utterances`."""

    def __init__(
        self,
        utterances: Sequence[Utterance],
        audio: AudioConfig = AudioConfig(),
        attack_to_idx: Optional[Dict[str, int]] = None,
        name: str = "dataset",
    ):
        if not utterances:
            raise RuntimeError(f"{name}: no utterances after filtering")
        self.utterances: List[Utterance] = list(utterances)
        self.audio_config = audio
        self.loader = AudioLoader(audio)
        self.attack_to_idx = dict(attack_to_idx or {"bonafide": 0})
        self.name = name

    def __len__(self) -> int:
        return len(self.utterances)

    def __getitem__(self, idx: int):
        utt = self.utterances[idx]
        return self.loader.load(utt.path), utt

    @property
    def labels(self) -> np.ndarray:
        return np.array([u.label for u in self.utterances], dtype=np.int32)

    @property
    def multi_labels(self) -> np.ndarray:
        return np.array([u.multi_label for u in self.utterances], dtype=np.int32)

    def subset_indices(self, subset: str) -> np.ndarray:
        labels = self.labels
        if subset == "bonafide":
            return np.nonzero(labels == 1)[0]
        if subset == "spoof":
            return np.nonzero(labels == 0)[0]
        return np.arange(len(self))


def _apply_subset(utts: List[Utterance], subset: str) -> List[Utterance]:
    subset = (subset or "all").lower()
    if subset not in ("all", "bonafide", "spoof"):
        raise ValueError(f"subset must be all|bonafide|spoof, got {subset}")
    if subset == "bonafide":
        return [u for u in utts if u.label == 1]
    if subset == "spoof":
        return [u for u in utts if u.label == 0]
    return utts


def _subsample(utts: List[Utterance], num_samples: Optional[int], seed: int) -> List[Utterance]:
    """Seeded random subset without replacement."""
    if num_samples is None or len(utts) <= num_samples:
        return utts
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(utts))[: int(num_samples)]
    return [utts[i] for i in idx]


def _norm_label(s: str) -> str:
    return str(s).strip().lower().replace("bona-fide", "bonafide")


def parse_asvspoof2019(
    protocol_file: str,
    root_dir: str = "",
    subset: str = "all",
    num_samples: Optional[int] = None,
    sample_seed: int = 1337,
    audio: AudioConfig = AudioConfig(),
) -> SpoofDataset:
    """ASVspoof2019-LA 5-column protocol:
    ``<path> <attackID> <label> <_> <speaker>`` with attackID '-' for
    bonafide. The multi-class attack map is built in file order, seeded
    with {'bonafide': 0}."""
    root = Path(root_dir)
    attack_to_idx: Dict[str, int] = {"bonafide": 0}
    utts: List[Utterance] = []
    with open(protocol_file) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 5:
                continue
            rel, attack_raw, label_str, speaker = parts[0], parts[1], _norm_label(parts[2]), parts[4]
            fname = rel.split("/")[-1]
            label = 1 if label_str == "bonafide" else 0
            key = "bonafide" if label == 1 else attack_raw
            if key not in attack_to_idx:
                attack_to_idx[key] = len(attack_to_idx)
            utts.append(
                Utterance(
                    path=str(root / fname),
                    label=label,
                    multi_label=attack_to_idx[key],
                    speaker=speaker,
                    name=fname,
                )
            )
    utts = _apply_subset(utts, subset)
    utts = _subsample(utts, num_samples, sample_seed)
    return SpoofDataset(utts, audio, attack_to_idx, name="asvspoof2019")


def parse_in_the_wild(
    protocol_file: str,
    root_dir: str = "",
    subset: str = "all",
    num_samples: Optional[int] = None,
    sample_seed: int = 42,
    audio: AudioConfig = AudioConfig(),
    filter_missing: bool = True,
) -> SpoofDataset:
    """In-The-Wild CSV protocol (columns file,speaker,label); normalizes
    'bona-fide' -> 'bonafide' and drops rows whose audio is missing. Read
    with the stdlib csv module (the JAX package uses pandas)."""
    root = Path(root_dir)
    utts: List[Utterance] = []
    n_missing = 0
    with open(protocol_file, newline="") as f:
        for row in csv.DictReader(f):
            p = root / str(row["file"])
            if filter_missing and not p.exists():
                n_missing += 1
                continue
            utts.append(
                Utterance(
                    path=str(p),
                    label=1 if _norm_label(row["label"]) == "bonafide" else 0,
                    speaker=str(row.get("speaker", "unknown")),
                    name=Path(str(row["file"])).name,
                )
            )
    if n_missing:
        print(f"[INFO] InTheWild: filtered out {n_missing} missing audio files.")
    utts = _apply_subset(utts, subset)
    utts = _subsample(utts, num_samples, sample_seed)
    return SpoofDataset(utts, audio, name="in_the_wild")
