"""The port's serving front door (eval/server.py, cli/serve.py) against the
JAX package's on the same weights and files, fp32 on the CPU at a tiny
width with 1 s clips: the DynamicBatcher's order, padding, wait and
stats; ScoringServer over a localhost socket (bare and tagged lines, a
missing file); `serve` in-process on stdin, `--list`, `--threshold` and
`--windowed`; the flags it refuses. ~20 s alone."""

import io
import socket
import sys
import threading
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wav2vec_contr_loss_tpu.cli.serve import score_paths as jax_score_paths
from wav2vec_contr_loss_tpu.cli.serve import \
    score_paths_windowed as jax_score_paths_windowed
from wav2vec_contr_loss_tpu.config import Stage1Config as JaxStage1Config
from wav2vec_contr_loss_tpu.config import Stage2Config as JaxStage2Config
from wav2vec_contr_loss_tpu.data.audio import AudioConfig as JaxAudioConfig
from wav2vec_contr_loss_tpu.eval.server import ScoringServer as JaxServer
from wav2vec_contr_loss_tpu.eval.serving import SpoofScorer as JaxScorer
from wav2vec_contr_loss_tpu.models.heads import build_head as jax_build_head
from wav2vec_contr_loss_tpu.train import Stage1Trainer as JaxTrainer

from tests.flac_writer import write_flac
from tests.test_serve_socket import TINY_ENC
from tests.test_torch_bridge import cap_torch_threads, perturbed, port_config
from wav2vec_contr_loss_torch import (SpoofScorer, Stage1Config,
                                      Stage1Trainer, Stage2Config,
                                      jax_params_to_torch)
from wav2vec_contr_loss_torch.cli import serve
from wav2vec_contr_loss_torch.data import AudioConfig, AudioLoader
from wav2vec_contr_loss_torch.data.audio import write_wav
from wav2vec_contr_loss_torch.eval.server import DynamicBatcher, ScoringServer
from wav2vec_contr_loss_torch.train import checkpoint as ckpt
from wav2vec_contr_loss_torch.train.stage2 import STAGE2_BEST

cap_torch_threads()

SR = 16000


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(JAX scorer, port scorer, port stage-1 dir, stage-2 dir, paths):
    one set of weights, 1 s clips; files of 0.6-2.7 s, WAV and FLAC, and
    a missing path."""
    tmp = tmp_path_factory.mktemp("served")
    jcfg = JaxStage1Config(batch_size=4, input_dim=32, hidden_dim=16,
                           max_duration_seconds=1, use_rawboost=False,
                           finetune_encoder=False, compute_dtype="float32")
    init = JaxTrainer(jcfg, enc_config=TINY_ENC).init_state()
    enc = perturbed(init.frozen["encoder"], 1)
    trainer = JaxTrainer(jcfg, enc_config=TINY_ENC, enc_params=enc)
    state = trainer.init_state()
    comp = jax.tree_util.tree_map(np.asarray, state.params["compression"])
    head = perturbed(jax_build_head("linear", 8).init(
        jax.random.PRNGKey(2), jnp.zeros((1, 16)))["params"], 3)
    want = JaxScorer(trainer, state, JaxStage2Config(), head)

    cfg = port_config(TINY_ENC)
    weights = jax_params_to_torch(cfg, enc, comp, head)
    s1, s2 = str(tmp / "stage1"), str(tmp / "stage2")
    scfg = Stage1Config(input_dim=32, hidden_dim=16, max_duration_seconds=1,
                        compute_dtype="float32", use_rawboost=False)
    tr = Stage1Trainer(scfg, cfg, weights, device="cpu")
    ckpt.save_checkpoint(s1, "best", tr.state_dict(), scfg.ckpt_config(),
                         {}, tr._sidecar_extra())
    cfg2 = Stage2Config(in_dim=16)
    ckpt.save_checkpoint(s2, STAGE2_BEST, weights["head"], cfg2.ckpt_config())
    got = SpoofScorer.from_checkpoints(s1, s2, device="cpu")

    rng = np.random.default_rng(4)
    paths = []
    for i, n in enumerate((9600, 16000, 43000, 20000, 30000)):
        x = (0.3 * rng.standard_normal(n)).clip(-1, 1).astype(np.float32)
        if i % 2:
            p = str(tmp / f"c{i}.flac")
            write_flac(p, (x * 32767).astype(np.int16), SR)
        else:
            p = str(tmp / f"c{i}.wav")
            write_wav(p, x, SR)
        paths.append(p)
    paths.append(str(tmp / "missing.wav"))
    return want, got, s1, s2, paths


# ---------------------------------------------------------------- batcher
def test_batcher_order_padding_wait_and_stats():
    calls = []

    def score(w):
        calls.append(w.clone())
        return w.sum(dim=1)

    b = DynamicBatcher(score, batch=4, num_samples=8, max_wait_ms=300)
    futs = [b.submit(np.full(8, i + 1, np.float32)) for i in range(4)]
    assert [f.result(timeout=10) for f in futs] == [8.0, 16.0, 24.0, 32.0]
    assert (b.n_clips, b.n_batches) == (4, 1) and calls[0].shape == (4, 8)

    t0 = time.monotonic()   # under-full: dispatched after max_wait, padded
    f = b.submit(np.ones(10, np.float32))          # trimmed to 8 samples
    assert f.result(timeout=10) == 8.0
    assert 0.25 <= time.monotonic() - t0 < 5.0
    assert calls[-1].shape == (4, 8) and not calls[-1][1:].any()

    stats = b.close()
    assert stats == {"clips": 5, "batches": 2, "occupancy": 0.625}
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(np.ones(8, np.float32))


def test_batcher_failure_reaches_the_futures_and_it_survives():
    def score(w):
        if w[0, 0] < 0:
            raise ValueError("bad batch")
        return w.sum(dim=1)

    b = DynamicBatcher(score, batch=2, num_samples=4, max_wait_ms=1)
    with pytest.raises(ValueError, match="bad batch"):
        b.submit(-np.ones(4, np.float32)).result(timeout=10)
    assert b.submit(np.ones(4, np.float32)).result(timeout=10) == 4.0
    b.close()


# ----------------------------------------------------------------- server
def _serve(server_cls, scorer, lines, **kw):
    server = server_cls(scorer, "127.0.0.1", 0, batch=4, max_wait_ms=5,
                        audio_config=kw.pop("audio", None) or (
                            AudioConfig(SR, 1) if server_cls is ScoringServer
                            else JaxAudioConfig(SR, 1)),
                        log_fn=lambda m: None, **kw)
    # daemon: the JAX server's accept loop outlives its shutdown (closing
    # a listening socket does not wake accept() on Linux); the port's
    # must end, and is joined
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with socket.create_connection(server.address, timeout=120) as s:
            f = s.makefile("rw", encoding="utf-8", newline="\n")
            for line in lines:
                f.write(line + "\n")
            f.flush()
            s.shutdown(socket.SHUT_WR)
            replies = [f.readline().rstrip("\n") for _ in lines]
            assert f.readline() == ""
    finally:
        stats = server.shutdown()
    if server_cls is ScoringServer:
        thread.join(timeout=30)
        assert not thread.is_alive()
    return [r.split("\t") for r in replies], stats


def test_server_matches_the_jax_server(served):
    want, got, _, _, paths = served
    lines = [p if i % 2 == 0 else f"id{i}\t{p}" for i, p in enumerate(paths)]
    failed = AudioLoader.failed_count
    ours, stats = _serve(ScoringServer, got, lines)
    theirs, _ = _serve(JaxServer, want, lines)
    assert AudioLoader.failed_count == failed + 1    # the missing file
    assert stats["clips"] == len(lines)
    assert [r[0] for r in ours] == [r[0] for r in theirs] == [
        p if i % 2 == 0 else f"id{i}" for i, p in enumerate(paths)]
    a = np.array([float(r[1]) for r in ours])
    b = np.array([float(r[1]) for r in theirs])
    np.testing.assert_allclose(a, b, atol=1e-5)
    # the missing file scored as silence
    silence = got.score_waveforms(np.zeros((4, SR), np.float32))[0]
    assert abs(a[-1] - silence) < 1e-5


def test_server_windowed_matches_score_long(served):
    _, got, _, _, paths = served
    ours, _ = _serve(ScoringServer, got, paths[:5], windowed="mean",
                     hop_seconds=0.5)
    loader = AudioLoader(AudioConfig(SR, None))
    want = got.score_long_waveforms([loader.load(p) for p in paths[:5]],
                                    hop_seconds=0.5, agg="mean", batch=4)
    np.testing.assert_allclose([float(r[1]) for r in ours], want, atol=1e-5)


# ------------------------------------------------------------------- CLI
def _cli(argv, capsys, stdin=None, monkeypatch=None):
    if stdin is not None:
        monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    serve.main(argv)
    return [ln.split("\t") for ln in capsys.readouterr().out.splitlines()]


def test_serve_cli_matches_jax_score_paths(served, tmp_path, capsys,
                                           monkeypatch):
    want, _, s1, s2, paths = served
    base = ["--stage1_dir", s1, "--stage2_dir", s2, "--device", "cpu",
            "--batch", "4", "--max_duration_seconds", "1"]
    listing = tmp_path / "paths.txt"
    listing.write_text("\n".join(paths) + "\n")
    ref = list(jax_score_paths(want, paths, batch=4,
                               audio_config=JaxAudioConfig(SR, 1)))
    ref_logits = np.array([lg for _, lg in ref])

    from_list = _cli(base + ["--list", str(listing)], capsys)
    from_stdin = _cli(base, capsys, "\n".join(paths) + "\n\n", monkeypatch)
    for out in (from_list, from_stdin):
        assert [r[0] for r in out] == paths
        np.testing.assert_allclose([float(r[1]) for r in out], ref_logits,
                                   atol=1e-5)
    thr = float(np.median(ref_logits))
    labelled = _cli(base + ["--list", str(listing), "--threshold", str(thr)],
                    capsys)
    assert [r[2] for r in labelled] == [
        "bonafide" if float(r[1]) >= thr else "spoof" for r in labelled]
    assert {r[2] for r in labelled} == {"bonafide", "spoof"}

    windowed = _cli(base + ["--list", str(listing), "--windowed", "min",
                            "--hop_seconds", "0.5"], capsys)
    ref_w = list(jax_score_paths_windowed(
        want, paths, batch=4, audio_config=JaxAudioConfig(SR, 1),
        hop_seconds=0.5, agg="min"))
    assert [r[0] for r in windowed] == [p for p, _ in ref_w]
    np.testing.assert_allclose([float(r[1]) for r in windowed],
                               [lg for _, lg in ref_w], atol=1e-5)


@pytest.mark.parametrize("argv,msg", [
    # --artifact and --quantize are served since they were ported
    # (ROADMAP A8, A9); what stays refused is their combination and
    # --quantize without checkpoints
    pytest.param(["--artifact", "scorer.export", "--quantize", "w8"],
                 "--quantize is baked into the artifact", id="argv0-A8"),
    pytest.param(["--quantize", "w8a8"], "--stage1_dir", id="argv1-A9"),
    (["--socket", "127.0.0.1:0", "--threshold", "0"], "--threshold"),
    (["--socket", "127.0.0.1:0", "--list", "x.txt"], "--list"),
    (["--socket", "nope"], "HOST:PORT"),
    ([], "--stage1_dir"),
])
def test_serve_refuses_what_it_does_not_run(argv, msg, capsys):
    with pytest.raises(SystemExit) as e:
        serve.main(argv)
    assert e.value.code == 2
    assert msg in capsys.readouterr().err


def test_put_fn_pins_only_for_the_card():
    class Scorer:
        device = torch.device("cpu")

    put = serve._put_fn("int16", Scorer())
    out = put((None, np.full((2, 4), 0.5, np.float32)))
    assert out.dtype == torch.int16 and not out.is_pinned()
    with pytest.raises(ValueError, match="wire"):
        serve._put_fn("int8", Scorer())
