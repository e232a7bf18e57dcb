"""The port's serving slice against the JAX `SpoofScorer` on the same
weights (fp32, CPU), and the port's import hygiene."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wav2vec_contr_loss_tpu.config import Stage1Config
from wav2vec_contr_loss_tpu.config import Stage2Config as JaxStage2Config
from wav2vec_contr_loss_tpu.eval.serving import SpoofScorer as JaxScorer
from wav2vec_contr_loss_tpu.models.heads import build_head as jax_build_head
from wav2vec_contr_loss_tpu.train import Stage1Trainer

from tests.test_serving import TINY_ENC
from tests.test_torch_bridge import perturbed, port_config
from wav2vec_contr_loss_torch import (SpoofScorer, Stage2Config,
                                      jax_params_to_torch)

from tests.test_torch_bridge import cap_torch_threads

cap_torch_threads()

SR = 16000
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", params=["linear", "mlp"])
def scorers(request):
    """(JAX scorer, port scorer) on the same weights, 1 s clips."""
    head_type = request.param
    cfg = Stage1Config(batch_size=8, input_dim=32, hidden_dim=16,
                       max_duration_seconds=1, use_rawboost=False,
                       finetune_encoder=False, compute_dtype="float32",
                       seed=0)
    init = Stage1Trainer(cfg, enc_config=TINY_ENC).init_state()
    enc = perturbed(init.frozen["encoder"], 1)
    trainer = Stage1Trainer(cfg, enc_config=TINY_ENC, enc_params=enc)
    state = trainer.init_state()
    comp = jax.tree_util.tree_map(np.asarray, state.params["compression"])
    head = perturbed(jax_build_head(head_type, 8).init(
        jax.random.PRNGKey(2), jnp.zeros((1, 16)))["params"], 3)

    want = JaxScorer(trainer, state,
                     JaxStage2Config(head_type=head_type, hidden_dim=8), head)
    weights = jax_params_to_torch(port_config(TINY_ENC), enc, comp, head)
    got = SpoofScorer(port_config(TINY_ENC), weights,
                      Stage2Config(head_type=head_type, in_dim=16,
                                   hidden_dim=8),
                      max_duration_seconds=1, device="cpu")
    return want, got


def _batch():
    rng = np.random.default_rng(7)
    w = rng.normal(0, 0.2, (8, SR)).astype(np.float32)
    w[1, SR // 2:] = 0.0          # zero padding
    w[2, 100] = 0.0               # interior zero
    w[3] = 0.0                    # an all-zero clip
    w[4, SR // 3:] = 0.0
    return w


@pytest.mark.parametrize("wire", ["float32", "int16"])
def test_score_waveforms_matches_jax(scorers, wire):
    want, got = scorers
    waves = _batch()
    a = got.score_waveforms(waves, wire=wire)
    b = want.score_waveforms(waves, wire=wire)
    assert a.shape == (8,) and np.isfinite(a).all()
    # fp32 on both sides; tolerance of tests/test_serving.py
    np.testing.assert_allclose(a, b, atol=1e-5)


@pytest.mark.parametrize("agg", ["mean", "min"])
def test_score_long_waveforms_matches_jax(scorers, agg):
    want, got = scorers
    rng = np.random.default_rng(9)
    clips = [rng.normal(0, 0.2, n).astype(np.float32)
             for n in (2 * SR + 700, SR // 2, 3 * SR)]
    a = got.score_long_waveforms(clips, hop_seconds=0.5, agg=agg, batch=4)
    b = want.score_long_waveforms(clips, hop_seconds=0.5, agg=agg, batch=4)
    assert a.shape == (3,)
    np.testing.assert_allclose(a, b, atol=1e-5)


def test_scorer_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SpoofScorer(port_config(TINY_ENC), {}, Stage2Config(in_dim=16))


def test_port_imports_no_jax():
    """In a fresh interpreter (this one has JAX loaded), importing every
    module of the port and chip_smoke.py loads no JAX, flax, optax or
    JAX-package module, and none of transformers, safetensors, soundfile,
    librosa or pandas, which the machine with the card does not have."""
    code = (
        "import importlib, pkgutil, sys\n"
        "before = set(sys.modules)\n"
        "import chip_smoke\n"
        "import wav2vec_contr_loss_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in set(sys.modules) - before\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
        "                                    'optax',\n"
        "                                    'wav2vec_contr_loss_tpu',\n"
        "                                    'transformers', 'safetensors',\n"
        "                                    'soundfile', 'librosa',\n"
        "                                    'pandas'))\n"
        "assert not bad, bad\n"
        "print(' '.join(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    walked = set(out.stdout.split())
    assert len(walked) >= 60   # every submodule was walked
    # the stage-1 pipeline, device RawBoost, checkpoints and the CLI; the
    # inference half (metrics, score files, BCE, stage 2, extraction,
    # plots) and its CLIs
    assert {f"wav2vec_contr_loss_torch.{m}" for m in (
        "data.audio", "data.pipeline", "data.protocols", "data.rawboost",
        "data.sampler", "ops.rawboost", "train.checkpoint",
        "utils.preemption", "cli.common", "cli.train_stage1",
        "eval.metrics", "eval.score", "eval.extract", "losses.bce",
        "train.stage2", "viz", "viz.umap_plots", "cli.extract_embeddings",
        "cli.train_stage2", "cli.generate_scores", "cli.eval_scores",
        "cli.plot_umap", "cli.run_pipeline",
        # the serving front door: conversion, the server, the CLIs
        "models.hf_convert", "models.export_hf", "models.ref_convert",
        "eval.server", "cli.serve", "cli.convert_hf_checkpoint",
        "cli.convert_reference_checkpoint", "cli.export_hf_checkpoint",
        "cli.export_reference_checkpoint", "cli.doctor", "__main__",
        # the baseline, the waveform cache, the other corpora and stage 1
        # from features
        "train.baseline", "data.cache", "cli.train_baseline",
        "cli.score_baseline", "cli.score_famous_figures",
        "cli.extract_encoder_features", "cli.cache_waveforms",
        # multi-process training
        "parallel.mesh", "parallel.collectives", "parallel.mp_smoke",
        "parallel.gloo_probe", "utils.distributed",
        # pipeline and sequence parallelism, metrics and timers
        "parallel.pipeline", "utils.logging", "utils.timing",
        # the component benchmarks
        "cli.bench_components")} <= walked
