"""Protocol parsers and dataset objects.

The port's copy of wav2vec_contr_loss_tpu/data/protocols.py: ASVspoof
2019-LA, In-The-Wild, FamousFigures, ASVspoof 2021-DF, RAVDESS and
Common Voice. Each parser returns a `SpoofDataset`: an ordered list of
`Utterance` records plus an `AudioLoader`; batching happens in
pipeline.py. Tables are read with the stdlib `csv` module where the JAX
package uses pandas; every value is kept as the text it is written as.

Label conventions (as the reference): binary 1 = bonafide, 0 = spoof;
multi-class attack ids are assigned in file order with bonafide = 0.
"""

from __future__ import annotations

import csv
import glob as _glob
import os
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .audio import AudioConfig, AudioLoader

__all__ = ["Utterance", "SpoofDataset", "parse_asvspoof2019",
           "parse_in_the_wild", "parse_famous_figures", "parse_asvspoof2021",
           "parse_ravdess", "parse_common_voice"]


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


def _read_table(path: str) -> Tuple[List[str], List[Dict[str, str]]]:
    """(header, rows as dicts) of a tab-separated table with a header
    line; a table whose rows have more fields than its header (the JAX
    package's pandas reader raises on those) is read again split on runs
    of whitespace. Blank lines are skipped and short rows padded with ''
    (pandas: NaN)."""
    with open(path, newline="") as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    rows = list(csv.reader(lines, delimiter="\t"))
    if any(len(r) > len(rows[0]) for r in rows[1:]):
        rows = [re.split(r"\s+", ln.strip()) for ln in lines]
        if any(len(r) > len(rows[0]) for r in rows[1:]):
            raise ValueError(f"{path}: rows with more fields than the "
                             f"header {rows[0]}")
    if not rows:
        return [], []
    header = rows[0]
    return header, [dict(zip(header, r + [""] * (len(header) - len(r))))
                    for r in rows[1:]]


def parse_famous_figures(
    protocol_file: str,
    root_dir: str = "",
    subset: str = "all",
    include_speakers: Optional[Sequence[str]] = None,
    include_sources: Optional[Sequence[str]] = None,
    num_samples: Optional[int] = None,
    sample_seed: int = 42,
    audio: AudioConfig = AudioConfig(),
    filter_missing: bool = True,
) -> SpoofDataset:
    """FamousFigures TSV protocol (AudioName, Speaker, Source, Label,
    AudioPath): each path cut after its '.wav' and joined to the root
    when relative, speaker and source allowlists, rows whose audio is
    missing dropped."""
    header, rows = _read_table(protocol_file)
    expected = {"AudioName", "Speaker", "Source", "Label", "AudioPath"}
    missing_cols = expected - set(header)
    if missing_cols:
        raise ValueError(f"Protocol is missing columns: {sorted(missing_cols)}")

    def clean(p: str) -> str:
        i = p.lower().find(".wav")
        return p[: i + 4] if i >= 0 else p

    root = Path(root_dir) if root_dir else None
    utts: List[Utterance] = []
    n_missing = 0
    spk_keep = set(map(str, include_speakers)) if include_speakers else None
    src_keep = set(map(str, include_sources)) if include_sources else None
    for row in rows:
        speaker, source = row["Speaker"], row["Source"]
        if spk_keep is not None and speaker not in spk_keep:
            continue
        if src_keep is not None and source not in src_keep:
            continue
        p = Path(clean(row["AudioPath"]))
        if root is not None and not p.is_absolute():
            p = root / p
        if filter_missing and not p.exists():
            n_missing += 1
            continue
        utts.append(
            Utterance(
                path=str(p),
                label=1 if _norm_label(row["Label"]) == "bonafide" else 0,
                speaker=speaker,
                source=source,
                name=Path(row["AudioName"]).name or p.name,
            )
        )
    if n_missing:
        print(f"[INFO] FamousFigures: filtered out {n_missing} missing audio files.")
    utts = _apply_subset(utts, subset)
    utts = _subsample(utts, num_samples, sample_seed)
    return SpoofDataset(utts, audio, name="famous_figures")


def parse_asvspoof2021(
    root_dir: str,
    ok_files: str,
    protocol_file: str,
    subset: str = "all",
    num_samples: Optional[int] = None,
    sample_seed: int = 42,
    audio: AudioConfig = AudioConfig(),
) -> SpoofDataset:
    """ASVspoof2021-DF eval: flac files under <root>/flac, kept when their
    stem is listed in ok_files, labelled by the 13-column protocol
    (speaker, file, ..., label in column 6)."""
    with open(ok_files) as f:
        ok = {Path(line.strip()).stem for line in f if line.strip()}
    flac_dir = Path(root_dir) / "flac"
    utts: List[Utterance] = []
    with open(protocol_file) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 6:
                continue
            speaker, fname, label_str = parts[0], parts[1], _norm_label(parts[5])
            if fname not in ok:
                continue
            utts.append(
                Utterance(
                    path=str(flac_dir / f"{fname}.flac"),
                    label=1 if label_str == "bonafide" else 0,
                    speaker=speaker,
                    name=f"{fname}.flac",
                )
            )
    utts = _apply_subset(utts, subset)
    utts = _subsample(utts, num_samples, sample_seed)
    return SpoofDataset(utts, audio, name="asvspoof2021")


def _glob_dataset(root_dir: str, pattern: str, name: str,
                  num_samples: Optional[int],
                  audio: AudioConfig) -> SpoofDataset:
    files = sorted(_glob.glob(os.path.join(root_dir, pattern), recursive=True))
    if num_samples is not None:
        files = files[: int(num_samples)]
    utts = [Utterance(path=f, label=1, speaker="unknown",
                      name=os.path.basename(f)) for f in files]
    return SpoofDataset(utts, audio, name=name)


def parse_ravdess(root_dir: str, num_samples: Optional[int] = None,
                  audio: AudioConfig = AudioConfig()) -> SpoofDataset:
    """RAVDESS: every Actor_*/ wav under the root, all bonafide."""
    return _glob_dataset(root_dir, "**/Actor_*/*.wav", "ravdess",
                         num_samples, audio)


def parse_common_voice(root_dir: str, num_samples: Optional[int] = None,
                       audio: AudioConfig = AudioConfig()) -> SpoofDataset:
    """Common Voice: every wav under the root, all bonafide."""
    return _glob_dataset(root_dir, "**/*.wav", "common_voice", num_samples,
                         audio)
