"""The port's extraction and dataset scoring against the JAX package's on
the same weights and corpus, at a tiny width in fp32: `embed_dataset` and
`extract_embeddings` (20 clips at batch 8, so the last batch is partial),
the skip-if-exists rule, the int16 wire, and `SpoofScorer.from_checkpoints`
with `score_dataset`. Budget: ~30 s alone."""

import json
import os

import numpy as np
import pytest

import jax
import torch

from wav2vec_contr_loss_tpu.config import Stage1Config as JaxStage1Config
from wav2vec_contr_loss_tpu.config import Stage2Config as JaxStage2Config
from wav2vec_contr_loss_tpu.data import AudioConfig as JaxAudioConfig
from wav2vec_contr_loss_tpu.data import BatchPipeline as JaxPipeline
from wav2vec_contr_loss_tpu.data import parse_asvspoof2019 as jax_parse
from wav2vec_contr_loss_tpu.eval.extract import \
    extract_embeddings as jax_extract
from wav2vec_contr_loss_tpu.eval.serving import SpoofScorer as JaxScorer
from wav2vec_contr_loss_tpu.models.heads import build_head as jax_build_head
from wav2vec_contr_loss_tpu.parallel.mesh import make_mesh
from wav2vec_contr_loss_tpu.train import Stage1Trainer as JaxTrainer

from chip_smoke import write_corpus
from tests.test_torch_bridge import cap_torch_threads, perturbed, port_config
from tests.test_torch_fit import TINY
from wav2vec_contr_loss_torch import (SpoofScorer, Stage1Config, Stage1Trainer,
                                      Stage2Config, jax_params_to_torch)
from wav2vec_contr_loss_torch.bridge import head_state_dict, random_jax_trees
from wav2vec_contr_loss_torch.data import (AudioConfig, BatchPipeline,
                                           parse_asvspoof2019)
from wav2vec_contr_loss_torch.eval.extract import (extract_embeddings,
                                                   load_embeddings)
from wav2vec_contr_loss_torch.train import checkpoint as ckpt
from wav2vec_contr_loss_torch.train.stage2 import STAGE2_BEST

cap_torch_threads()

SR = 16000
N_CLIPS, BATCH = 20, 8
KW = dict(batch_size=BATCH, input_dim=32, hidden_dim=16,
          max_duration_seconds=1, use_rawboost=False, finetune_encoder=False,
          compute_dtype="float32", seed=0)
# fp32 on both sides: the serving tolerance of tests/test_torch_serving.py
ATOL = 1e-5


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_extract_corpus"))
    return root, write_corpus(root, N_CLIPS, seed=4, seconds=1.0)


@pytest.fixture(scope="module")
def trainers():
    """-> wire dtype -> (JAX trainer, its state, port trainer) on the same
    seeded weights (the state does not depend on the wire)."""
    enc = random_jax_trees(port_config(TINY), comp_dim=16, seed=1)[0]
    out, state = {}, None
    for wire in ("float32", "int16"):
        jt = JaxTrainer(JaxStage1Config(**KW, wire_dtype=wire),
                        enc_config=TINY, enc_params=enc,
                        mesh=make_mesh(devices=jax.devices()[:1]))
        if state is None:
            state = jt.init_state(jax.random.PRNGKey(0))
        comp = jax.device_get(state.params["compression"])
        port = Stage1Trainer(Stage1Config(**KW, wire_dtype=wire),
                             port_config(TINY),
                             jax_params_to_torch(port_config(TINY), enc,
                                                 comp, {}), device="cpu")
        out[wire] = (jt, state, port)
    return out


def _pipes(corpus):
    root, proto = corpus
    return (BatchPipeline(parse_asvspoof2019(proto, root,
                                             audio=AudioConfig(SR, 1)),
                          BATCH, num_workers=2),
            JaxPipeline(jax_parse(proto, root, audio=JaxAudioConfig(SR, 1)),
                        BATCH, num_workers=2))


@pytest.mark.parametrize("wire", ["float32", "int16"])
def test_embed_dataset_matches_jax(corpus, trainers, wire):
    jt, state, port = trainers[wire]
    pipe, jpipe = _pipes(corpus)
    got_z, got_y = port.embed_dataset(pipe)
    want_z, want_y = jt.embed_dataset(state, jpipe)
    assert got_z.shape == (N_CLIPS, 16) and got_z.dtype == np.float32
    np.testing.assert_allclose(got_z, np.asarray(want_z), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(got_y, want_y)
    np.testing.assert_allclose(np.linalg.norm(got_z, axis=1), 1.0,
                               atol=1e-6)


def test_int16_wire_ships_int16_and_is_exact_for_pcm(corpus, trainers):
    """With wire_dtype='int16' the prefetch thread ships int16 batches;
    the corpus is 16-bit PCM, so the wire loses nothing."""
    pipe, _ = _pipes(corpus)
    port16 = trainers["int16"][2]
    assert port16._put(next(iter(pipe.sequential())))[
        "waveforms"].dtype == torch.int16
    z32, _ = trainers["float32"][2].embed_dataset(pipe)
    z16, _ = port16.embed_dataset(pipe)
    np.testing.assert_array_equal(z16, z32)


def test_extract_embeddings_matches_jax_and_skips(corpus, trainers,
                                                  tmp_path):
    jt, state, port = trainers["float32"]
    pipe, jpipe = _pipes(corpus)
    got_dir, want_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    logs = []
    paths = extract_embeddings(port.embed_dataset, pipe, got_dir, "eval",
                               log_fn=logs.append)
    jax_extract(lambda w: jt.embed_step(state.params, state.frozen,
                                        {"waveforms": w}),
                jpipe, want_dir, "eval", log_fn=lambda m: None)
    assert paths == (os.path.join(got_dir, "eval_embeddings.npy"),
                     os.path.join(got_dir, "eval_labels.npy"))
    assert logs[-1].startswith("[OK] eval: (20, 16)")
    for suffix in ("embeddings", "labels", "multi_labels"):
        got = np.load(os.path.join(got_dir, f"eval_{suffix}.npy"))
        want = np.load(os.path.join(want_dir, f"eval_{suffix}.npy"))
        assert got.dtype == want.dtype and got.shape == want.shape
        if suffix == "embeddings":
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
        else:
            np.testing.assert_array_equal(got, want)
    maps = []
    for d in (got_dir, want_dir):
        with open(os.path.join(d, "eval_attack_map.json")) as f:
            maps.append(json.load(f))
    assert maps[0] == maps[1] == {"bonafide": 0, "A02": 1, "A01": 2,
                                  "A03": 3}
    embs, labels = load_embeddings(got_dir, "eval", mmap=True)
    assert isinstance(embs, np.memmap) and labels.shape == (N_CLIPS,)

    # both files present: skipped, nothing is embedded or rewritten
    def boom(_pipe):
        raise AssertionError("an existing split must be skipped")

    before = os.path.getmtime(paths[0])
    extract_embeddings(boom, pipe, got_dir, "eval", log_fn=logs.append)
    assert logs[-1].startswith("[SKIP] existing eval embeddings")
    assert os.path.getmtime(paths[0]) == before
    # overwrite, or a missing labels file, embeds again
    calls = []

    def counted(p):
        calls.append(1)
        return port.embed_dataset(p)

    extract_embeddings(counted, pipe, got_dir, "eval", overwrite=True,
                       log_fn=logs.append)
    os.remove(paths[1])
    extract_embeddings(counted, pipe, got_dir, "eval", log_fn=logs.append)
    assert len(calls) == 2 and os.path.exists(paths[1])


@pytest.mark.parametrize("head_type", ["linear", "mlp"])
def test_scorer_from_checkpoints_matches_jax(corpus, trainers, tmp_path,
                                             head_type):
    """The port scorer built from a stage-1 checkpoint (written as `fit`
    writes one) and a stage-2 checkpoint scores the corpus as the JAX
    scorer does on the same weights."""
    jt, state, port = trainers["float32"]
    head = perturbed(jax_build_head(head_type, 8).init(
        jax.random.PRNGKey(2), np.zeros((1, 16), np.float32))["params"], 3)
    s1, s2 = str(tmp_path / "s1"), str(tmp_path / "s2")
    ckpt.save_checkpoint(s1, "best", port.state_dict(),
                         port.cfg.ckpt_config(), {}, port._sidecar_extra())
    ckpt.save_checkpoint(s2, STAGE2_BEST, head_state_dict(head),
                         Stage2Config(head_type=head_type, in_dim=16,
                                      hidden_dim=8).ckpt_config())
    scorer = SpoofScorer.from_checkpoints(s1, s2, device="cpu")
    assert scorer.num_samples == SR and scorer.enc_config.dtype == "float32"
    pipe, jpipe = _pipes(corpus)
    got, got_y = scorer.score_dataset(pipe)
    want, want_y = JaxScorer(jt, state, JaxStage2Config(head_type=head_type,
                                                        hidden_dim=8),
                             head).score_dataset(jpipe)
    assert got.shape == (N_CLIPS,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)
    np.testing.assert_array_equal(got_y, want_y)
    # the dataset path and the batch path agree
    batch = next(iter(pipe.sequential()))
    np.testing.assert_allclose(scorer.score_waveforms(batch.waveforms),
                               got[:BATCH], atol=1e-6)
    # a compute dtype given by the caller replaces the checkpoint's
    bf16 = SpoofScorer.from_checkpoints(s1, s2, device="cpu",
                                        compute_dtype="bfloat16")
    assert bf16.enc_config.dtype == "bfloat16"


def test_from_checkpoints_defaults_to_the_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(FileNotFoundError):
        SpoofScorer.from_checkpoints(str(tmp_path), str(tmp_path),
                                     device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Stage1Trainer(Stage1Config(**KW), port_config(TINY), {})
