"""chip_smoke.py's CPU-reachable parts: its seeded random weights have
exactly the JAX package's tree layout, and its serving path runs at the
XLS-R-300M widths (depth cut to one layer, 1 s clips) on the CPU."""

import numpy as np
import pytest

import jax

from chip_smoke import random_jax_trees, serving_waves
from tests.test_torch_bridge import jax_config, jax_trees, port_config
from wav2vec_contr_loss_torch import (XLSR_300M, SpoofScorer, Stage2Config,
                                      jax_params_to_torch)
from wav2vec_contr_loss_torch.ops import attention, conv_ln


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
