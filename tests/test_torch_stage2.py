"""The port's stage-2 trainer against the JAX package's on the same
numpy-seeded embeddings and the same bridged head parameters: the masked
BCE, the batching, 6 epochs of `train_stage2` (losses, dev EER, step
losses, early-stop epoch, best parameters), `stage2_scores`, the MLP
head's dropout, and the stage-2 checkpoint's round trip. Budget: ~20 s
alone."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wav2vec_contr_loss_tpu.config import Stage2Config as JaxStage2Config
from wav2vec_contr_loss_tpu.losses import bce_logits_loss as jax_bce
from wav2vec_contr_loss_tpu.models.heads import build_head as jax_build_head
from wav2vec_contr_loss_tpu.train import stage2 as jax_stage2

from wav2vec_contr_loss_torch import Stage2Config
from wav2vec_contr_loss_torch.bridge import head_state_dict
from wav2vec_contr_loss_torch.cli.generate_scores import load_stage2_head
from wav2vec_contr_loss_torch.losses import (bce_logits_loss,
                                             pos_weight_from_labels)
from wav2vec_contr_loss_torch.models import build_head
from wav2vec_contr_loss_torch.train import stage2

from tests.test_torch_bridge import cap_torch_threads

cap_torch_threads()

D = 16
# lr high enough that the dev EER settles within a few epochs, so that
# patience 2 stops both trainers inside the 6 epochs
KW = dict(in_dim=D, hidden_dim=8, dropout=0.0, lr=3e-2, weight_decay=1e-2,
          epochs=6, batch_size=16, patience=2, seed=5)


def _embeddings(seed: int = 0):
    """(train x, y, dev x, y): 50 train rows (a partial last batch of
    16), 30 dev rows, unit-norm, the classes overlapping."""
    rng = np.random.default_rng(seed)

    def split(n):
        y = (rng.random(n) < 0.4).astype(np.int64)
        x = rng.normal(0, 1, (n, D)) + 1.5 * y[:, None] * np.linspace(
            1, -1, D)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        return x.astype(np.float32), y

    return (*split(50), *split(30))


def _jax_head(head_type: str, seed: int = 3):
    params = jax_build_head(head_type, 8, 0.0).init(
        jax.random.PRNGKey(seed), jnp.zeros((2, D)))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def test_bce_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(0, 3, 40).astype(np.float32)
    y = (rng.random(40) < 0.3).astype(np.float32)
    m = np.arange(40) < 33
    for pw in (None, 2.5):
        for mask in (None, m):
            want = float(jax_bce(jnp.asarray(x), jnp.asarray(y), pw,
                                 None if mask is None else jnp.asarray(mask)))
            got = float(bce_logits_loss(torch.from_numpy(x),
                                        torch.from_numpy(y), pw,
                                        None if mask is None
                                        else torch.from_numpy(mask)))
            assert abs(got - want) <= 1e-6 * max(1.0, abs(want))
    assert pos_weight_from_labels(y) == (y == 0).sum() / (y == 1).sum()
    assert pos_weight_from_labels(np.ones(4)) == 1.0


def test_batchify_matches_jax():
    x, y, _, _ = _embeddings()
    for bs, seeded in ((16, True), (16, False), (64, True), (50, False)):
        got = stage2._batchify(x, y, bs,
                               np.random.default_rng(4) if seeded else None)
        want = jax_stage2._batchify(
            x, y, bs, np.random.default_rng(4) if seeded else None)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert got[0].shape == (1, 50, D) and got[2].all()


@pytest.mark.parametrize("head_type", ["linear", "mlp"])
def test_train_stage2_matches_jax(head_type, tmp_path):
    """6 epochs from the same head parameters (the MLP at dropout 0):
    per-epoch losses and dev EER rtol 1e-5, step losses the same, the same
    early-stop epoch, best parameters within 1e-5."""
    x, y, dx, dy = _embeddings()
    jhead = _jax_head(head_type)
    quiet = lambda m: None  # noqa: E731
    want_p, want = jax_stage2.train_stage2(
        JaxStage2Config(head_type=head_type, **KW), x, y, dx, dy,
        log_fn=quiet, init_params=jhead)
    got_p, got = stage2.train_stage2(
        Stage2Config(head_type=head_type, **KW), x, y, dx, dy,
        save_dir=str(tmp_path), log_fn=quiet,
        init_state=head_state_dict(jhead), device="cpu")

    n = len(want["train_loss"])
    assert 2 < n < KW["epochs"]          # patience stopped both early
    assert len(got["train_loss"]) == n
    for key in ("train_loss", "dev_loss", "dev_acc"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5)
    np.testing.assert_allclose(np.array(got["dev_eer"], float),
                               np.array(want["dev_eer"], float), rtol=1e-5)
    for g, w in zip(got["step_losses"], want["step_losses"]):
        assert g.shape == w.shape == (4,)
        np.testing.assert_allclose(g, w, rtol=1e-5)
    want_sd = head_state_dict(jax.device_get(want_p))
    assert got_p.keys() == want_sd.keys()
    for k in got_p:
        np.testing.assert_allclose(got_p[k].numpy(), want_sd[k].numpy(),
                                   atol=1e-5, rtol=0)

    # the saved head is the best one, with its config
    cfg, state = load_stage2_head(str(tmp_path))
    assert cfg == Stage2Config(head_type=head_type, in_dim=D, hidden_dim=8,
                               dropout=0.0)
    for k in got_p:
        assert torch.equal(state[k], got_p[k])

    # stage2_scores of the best head, against the JAX function
    got_s = stage2.stage2_scores(cfg, state, dx, batch_size=7, device="cpu")
    want_s = jax_stage2.stage2_scores(
        JaxStage2Config(head_type=head_type, **KW), want_p, dx, batch_size=7)
    assert got_s.shape == (30,) and got_s.dtype == np.float32
    np.testing.assert_allclose(got_s, np.asarray(want_s), atol=1e-5)


def test_stage2_scores_match_jax():
    """Same parameters in: logits within 1e-6."""
    _, _, dx, _ = _embeddings(2)
    for head_type in ("linear", "mlp"):
        jhead = _jax_head(head_type, seed=9)
        cfg = Stage2Config(head_type=head_type, **KW)
        got = stage2.stage2_scores(cfg, head_state_dict(jhead), dx,
                                   batch_size=8, device="cpu")
        want = jax_stage2.stage2_scores(
            JaxStage2Config(head_type=head_type, **KW), jhead, dx)
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)
    assert stage2.stage2_scores(cfg, head_state_dict(jhead), dx[:0],
                                device="cpu").shape == (0,)


def test_mlp_dropout_trains_and_eval_ignores_it():
    x, y, dx, dy = _embeddings(3)
    cfg = Stage2Config(head_type="mlp", **{**KW, "dropout": 0.2,
                                          "patience": 10})
    best, hist = stage2.train_stage2(cfg, x, y, dx, dy, log_fn=lambda m: None,
                                     device="cpu")
    assert len(hist["train_loss"]) == 6
    assert np.isfinite(hist["train_loss"]).all()
    assert np.isfinite(np.concatenate(hist["step_losses"])).all()

    head = build_head("mlp", D, 8, 0.2)
    head.load_state_dict(best)
    xt = torch.from_numpy(dx)
    gen = torch.Generator().manual_seed(0)
    head.eval()
    plain = head.fc2(torch.relu(head.fc1(xt)))[..., 0]
    assert torch.equal(head(xt, gen=gen), plain)
    assert torch.equal(head(xt), plain)
    head.train()
    dropped = head(xt, gen=gen)
    assert not torch.allclose(dropped, plain)
    with pytest.raises(ValueError, match="generator"):
        head(xt)


def test_trainer_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    x, y, dx, dy = _embeddings()
    cfg = Stage2Config(**KW)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stage2.train_stage2(cfg, x, y, dx, dy)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stage2.stage2_scores(cfg, head_state_dict(_jax_head("linear")), dx)
    with pytest.raises(ValueError, match="in_dim"):
        stage2.train_stage2(cfg.replace(in_dim=8), x, y, dx, dy,
                            device="cpu")
