"""The port's protocol parsers for FamousFigures, ASVspoof 2021-DF,
RAVDESS and Common Voice (data/protocols.py) against the JAX parsers on
the same synthetic files, the cases of tests/test_data.py:158-233: the
utterances (paths, names, labels, multi-labels, speakers, sources) and
their order, the column check and its error, the '.wav' path cleaning,
the speaker and source allowlists, the subset, the seeded subsample, the
missing-file filter, the whitespace fallback of the TSV reader and the
empty-dataset error. ~3 s alone."""

import os

import numpy as np
import pytest

from wav2vec_contr_loss_tpu.data import protocols as jax_protocols

from tests.test_torch_bridge import cap_torch_threads
from wav2vec_contr_loss_torch.data import protocols
from wav2vec_contr_loss_torch.data.audio import write_wav

cap_torch_threads()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("protocols")
    rng = np.random.default_rng(0)
    names = []
    for i in range(12):
        name = f"LA_T_{i:07d}.wav"
        write_wav(root / name, rng.normal(0, 0.1, 800).astype(np.float32),
                  16000)
        names.append(name)

    # FamousFigures: a malformed path that needs the '.wav' cut, two
    # speakers and two sources, a missing file, an absolute path
    ff = ["AudioName\tSpeaker\tSource\tLabel\tAudioPath"]
    for i, n in enumerate(names[:8]):
        junk = ", 0.95" if i == 2 else ""
        label = "Bona-Fide" if i % 2 == 0 else "Spoof"
        source = "youtube" if i < 5 else "podcast"
        path = str(root / n) if i == 7 else n
        ff.append(f"{n}\tceleb{i % 2}\t{source}\t{label}\t{path}{junk}")
    ff.append("gone.wav\tceleb0\tyoutube\tbonafide\tgone.wav")
    (root / "ff.tsv").write_text("\n".join(ff) + "\n")
    # the same table separated by spaces, one row carrying a tab: the tab
    # reading gives ragged rows, the whitespace reading does not
    spaced = [ln.replace("\t", " ") for ln in ff if ", 0.95" not in ln]
    spaced[3] = spaced[3].replace(" ", "\t", 1)
    (root / "ff_spaced.tsv").write_text("\n".join(spaced) + "\n")
    # a row with two fields more than the header either way: refused
    ragged = ff[:3] + [ff[3] + "\textra\tmore"]
    (root / "ff_ragged.tsv").write_text("\n".join(ragged) + "\n")
    (root / "itw.csv").write_text("file,speaker,label\nx.wav,s,spoof\n")

    # ASVspoof 2021: flac layout, ok_files, a 13-column protocol and a
    # short line that is skipped
    flac = root / "asv21" / "flac"
    os.makedirs(flac)
    p21 = []
    for i in range(6):
        stem = f"DF_E_{2000000 + i}"
        write_wav(flac / f"{stem}.flac",
                  rng.normal(0, 0.1, 800).astype(np.float32))
        label = "bonafide" if i % 2 == 0 else "spoof"
        p21.append(f"SPK{i} {stem} nocodec asvspoof A{i:02d} {label} "
                   f"notrim eval x - - - -")
    p21.append("short line")
    (root / "asv21_protocol.txt").write_text("\n".join(p21) + "\n")
    (root / "ok_files.txt").write_text(
        "\n".join(f"flac/DF_E_{2000000 + i}.flac" for i in range(5)) + "\n")

    # RAVDESS and Common Voice trees
    for actor in ("Actor_01", "Actor_02"):
        os.makedirs(root / "rav" / actor)
        for k in range(2):
            write_wav(root / "rav" / actor / f"{k}.wav",
                      rng.normal(0, 0.1, 800).astype(np.float32))
    os.makedirs(root / "rav" / "other")
    write_wav(root / "rav" / "other" / "x.wav",
              rng.normal(0, 0.1, 800).astype(np.float32))
    return root


def _same(got, want):
    """The same utterances in the same order, and the same attack map."""
    assert len(got) == len(want)
    assert got.utterances == [protocols.Utterance(**vars(u))
                              for u in want.utterances]
    assert got.attack_to_idx == want.attack_to_idx
    assert got.name == want.name
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.multi_labels, want.multi_labels)


def _both(name, *args, **kw):
    return (getattr(protocols, name)(*args, **kw),
            getattr(jax_protocols, name)(*args, **kw))


@pytest.mark.parametrize("kw", [
    {},
    {"include_speakers": ["celeb0"]},
    {"include_sources": ["podcast"]},
    {"include_speakers": ["celeb1"], "include_sources": ["youtube"]},
    {"subset": "bonafide"},
    {"subset": "spoof"},
    {"num_samples": 3, "sample_seed": 1},
    {"filter_missing": False},
], ids=["all", "speaker", "source", "both", "bonafide", "spoof",
        "subsample", "keep_missing"])
def test_famous_figures_matches_jax(corpus, capsys, kw):
    got, want = _both("parse_famous_figures", str(corpus / "ff.tsv"),
                      str(corpus), **kw)
    _same(got, want)
    if not kw:
        assert len(got) == 8        # the malformed path is cut, found
        assert got.labels.sum() == 4
        assert got.utterances[7].path == str(corpus / "LA_T_0000007.wav")
        out = capsys.readouterr().out
        assert out.count("filtered out 1 missing") == 2


def test_famous_figures_reads_whitespace_tables(corpus):
    got, want = _both("parse_famous_figures", str(corpus / "ff_spaced.tsv"),
                      str(corpus))
    _same(got, want)
    assert len(got) == 7


def test_famous_figures_errors_match_jax(corpus):
    for path, exc in (("itw.csv", ValueError), ("ff_ragged.tsv", ValueError)):
        for mod in (protocols, jax_protocols):
            with pytest.raises(exc):
                mod.parse_famous_figures(str(corpus / path), str(corpus))
    for mod in (protocols, jax_protocols):
        with pytest.raises(ValueError, match="missing columns"):
            mod.parse_famous_figures(str(corpus / "itw.csv"), str(corpus))
        with pytest.raises(RuntimeError, match="no utterances"):
            mod.parse_famous_figures(str(corpus / "ff.tsv"), str(corpus),
                                     include_speakers=["nobody"])


@pytest.mark.parametrize("kw", [{}, {"subset": "spoof"},
                                {"num_samples": 2, "sample_seed": 3}])
def test_asvspoof2021_matches_jax(corpus, kw):
    got, want = _both("parse_asvspoof2021", str(corpus / "asv21"),
                      str(corpus / "ok_files.txt"),
                      str(corpus / "asv21_protocol.txt"), **kw)
    _same(got, want)
    if not kw:
        assert len(got) == 5 and got.labels.sum() == 3
        assert got.utterances[0].name == "DF_E_2000000.flac"


@pytest.mark.parametrize("name,sub,n", [
    ("parse_ravdess", "rav", None), ("parse_ravdess", "rav", 3),
    ("parse_common_voice", "rav", None), ("parse_common_voice", "", 4),
])
def test_glob_datasets_match_jax(corpus, name, sub, n):
    got, want = _both(name, str(corpus / sub), num_samples=n)
    _same(got, want)
    assert (got.labels == 1).all()
    if name == "parse_ravdess" and n is None:
        assert len(got) == 4        # Actor_* directories only
    for mod in (protocols, jax_protocols):
        with pytest.raises(RuntimeError):
            getattr(mod, name)(str(corpus / "asv21"))
