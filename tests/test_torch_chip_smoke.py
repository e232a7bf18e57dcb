"""chip_smoke.py's CPU-reachable parts: its seeded random weights have
exactly the JAX package's tree layout, and its serving path and its train
phase's model run at the XLS-R-300M widths (depth cut to one or two
layers, 1 s clips) on the CPU."""

import numpy as np
import pytest

import jax

from chip_smoke import (expected_extract_launches, expected_train_launches,
                        random_jax_trees, serving_waves, train_batch,
                        write_corpus)
from tests.test_torch_bridge import jax_config, jax_trees, port_config
from wav2vec_contr_loss_torch import (XLSR_300M, SpoofScorer, Stage1Config,
                                      Stage1Trainer, Stage2Config,
                                      jax_params_to_torch)
from wav2vec_contr_loss_torch.data import (AudioConfig, BatchPipeline,
                                           parse_asvspoof2019)
from wav2vec_contr_loss_torch.ops import attention, conv_ln, supcon

from tests.test_torch_bridge import cap_torch_threads

cap_torch_threads()


def _shapes(tree):
    return jax.tree_util.tree_map(np.shape, tree)


@pytest.mark.parametrize("variant,head_type", [("xlsr", "linear"),
                                               ("large960h", "mlp")])
def test_random_trees_have_the_jax_layout(variant, head_type):
    cfg = jax_config(variant)
    want = jax_trees(cfg, head_type)
    got = random_jax_trees(port_config(cfg), comp_dim=16, head_type=head_type,
                           head_hidden=8)
    for w, g in zip(want, got):
        assert _shapes(g) == _shapes(w)
        assert all(a.dtype == np.float32
                   for a in jax.tree_util.tree_leaves(g))


def test_serving_path_at_xlsr_width_on_cpu():
    cfg = XLSR_300M.with_(num_layers=1, dtype="float32")
    scorer = SpoofScorer(cfg, jax_params_to_torch(cfg, *random_jax_trees(cfg)),
                         Stage2Config(), max_duration_seconds=1, device="cpu")
    waves = serving_waves(np.random.default_rng(0), 1)[0, [0, 1, 7], :16000]
    waves[1, 9000:] = 0.0         # padded; row 2 is the all-zero clip
    before = attention.launches, conv_ln.launches
    logits = scorer.score_waveforms(waves)
    assert (attention.launches, conv_ln.launches) == before
    assert logits.shape == (3,) and np.isfinite(logits).all()


def test_train_phase_model_steps_on_cpu():
    """The train phase's trainer (Stage1Config defaults with
    finetune_encoder=True, use_rawboost=False: dropout, SpecAugment and
    remat on) at XLS-R-300M width, 2 layers, fp32, 4 clips of 1 s."""
    cfg = XLSR_300M.with_(num_layers=2)
    scfg = Stage1Config(finetune_encoder=True, use_rawboost=False,
                        compute_dtype="float32", grad_dtype="float32")
    trainer = Stage1Trainer(scfg, cfg, jax_params_to_torch(
        cfg, *random_jax_trees(cfg)), device="cpu")
    batch = train_batch(np.random.default_rng(0), 4, 16000)
    before = (attention.launches, attention.bwd_launches, conv_ln.launches,
              conv_ln.bwd_launches, supcon.launches)
    losses = [trainer.train_step(batch, 1.0)["loss"].item()
              for _ in range(2)]
    assert before == (attention.launches, attention.bwd_launches,
                      conv_ln.launches, conv_ln.bwd_launches, supcon.launches)
    assert np.isfinite(losses).all()
    assert trainer.compression.proj.weight.grad is not None
    assert expected_train_launches(scfg, cfg) == {
        "attention_fwd": 4, "attention_bwd": 2, "ln_gelu_fwd": 7,
        "ln_gelu_bwd": 7, "supcon": 1}


def test_pipeline_phase_extraction_on_cpu(tmp_path):
    """The pipeline phase's extraction: `embed_dataset` of a full-width
    trainer (1 layer, fp32, 1 s clips) over 5 clips at batch 4 (a padded
    last batch), and the per-batch launch counts it expects on the card."""
    cfg = XLSR_300M.with_(num_layers=1)
    scfg = Stage1Config(compute_dtype="float32", max_duration_seconds=1)
    trainer = Stage1Trainer(scfg, cfg, jax_params_to_torch(
        cfg, *random_jax_trees(cfg)), device="cpu")
    proto = write_corpus(str(tmp_path), 5, seed=1, seconds=1.0)
    pipe = BatchPipeline(parse_asvspoof2019(proto, str(tmp_path),
                                            audio=AudioConfig(16000, 1)),
                         4, num_workers=2)
    z, y = trainer.embed_dataset(pipe)
    assert z.shape == (5, 256) and np.isfinite(z).all()
    np.testing.assert_array_equal(y, [1, 0, 1, 0, 1])
    assert expected_extract_launches(XLSR_300M, 4) == {
        "attention_fwd": 96, "attention_bwd": 0, "ln_gelu_fwd": 28,
        "ln_gelu_bwd": 0, "supcon": 0}
