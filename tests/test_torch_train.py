"""The training slice as a whole: the port's `Stage1Trainer` against the
JAX `Stage1Trainer` on the same weights and batches (fp32 but where a
test says bf16, CPU, plain kernel versions), on the tiny encoder of
tests/test_train_variants.py::test_freeze_feature_extractor with every
dropout and SpecAugment off and RawBoost off, so both sides compute the
same deterministic step."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wav2vec_contr_loss_tpu.config import Stage1Config as JaxStage1Config
from wav2vec_contr_loss_tpu.models.hf_convert import convert_hf_state_dict
from wav2vec_contr_loss_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from wav2vec_contr_loss_tpu.train import Stage1Trainer as JaxTrainer

from tests.test_torch_bridge import port_config
from wav2vec_contr_loss_torch import (Stage1Config, Stage1Trainer,
                                      jax_params_to_torch)
from wav2vec_contr_loss_torch.ops import attention, conv_ln, supcon

from tests.test_torch_bridge import cap_torch_threads

cap_torch_threads()

TINY = JaxConfig(
    hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
    conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2),
    num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
    dtype=jnp.float32, apply_spec_augment=False, hidden_dropout=0.0,
    attention_dropout=0.0, activation_dropout=0.0, feat_proj_dropout=0.0)
KW = dict(batch_size=8, max_duration_seconds=1, target_sample_rate=2000,
          input_dim=32, hidden_dim=16, use_rawboost=False,
          finetune_encoder=True, compute_dtype="float32", seed=0,
          dropout=0.0, adam_mu_dtype="float32", adam_nu_dtype="float32",
          grad_dtype="float32")
STEPS = 3


def _batch():
    rng = np.random.default_rng(0)
    wave = rng.normal(0, 0.2, (8, 2000)).astype(np.float32)
    wave[1, 1500:] = 0.0                 # zero padding
    wave[6, 700:] = 0.0
    return {"waveforms": wave, "labels": np.array([1, 0] * 4, np.int32)}


def _weights(state):
    """The port's state dicts of a JAX trainer state."""
    p0 = jax.device_get(state.params)
    enc = p0.get("encoder", jax.device_get(state.frozen).get("encoder"))
    return jax_params_to_torch(port_config(TINY), enc, p0["compression"], {})


def _pair(**kw):
    """(JAX trainer, its state, port trainer) on the same initial params."""
    jt = JaxTrainer(JaxStage1Config(**{**KW, **kw}), enc_config=TINY)
    state = jt.init_state(jax.random.PRNGKey(0))
    port = Stage1Trainer(Stage1Config(**{**KW, **kw}), port_config(TINY),
                         _weights(state), device="cpu")
    return jt, state, port


def _jax_batch(b):
    return {"waveforms": jnp.asarray(b["waveforms"]),
            "labels": jnp.asarray(b["labels"]),
            "multi_labels": jnp.asarray(b["labels"])}


@pytest.mark.parametrize("alpha", [1.0, 0.3])
def test_train_steps_match_jax(alpha):
    jt, state, port = _pair()
    batch = _batch()
    counts = (attention.launches, attention.bwd_launches, conv_ln.launches,
              conv_ln.bwd_launches, supcon.launches)
    want, got = [], []
    for _ in range(STEPS):
        state, m = jt.train_step(state, _jax_batch(batch), jnp.float32(alpha))
        want.append(float(m["loss"]))
        got.append(float(port.train_step(batch, alpha)["loss"]))
    assert counts == (attention.launches, attention.bwd_launches,
                      conv_ln.launches, conv_ln.bwd_launches, supcon.launches)
    # fp32 on both sides, the same deterministic step
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]

    final = jax.device_get(state.params)
    back = convert_hf_state_dict(
        {k: v.numpy() for k, v in port.encoder.state_dict().items()}, TINY)
    want_leaves, want_def = jax.tree_util.tree_flatten(final["encoder"])
    got_leaves, got_def = jax.tree_util.tree_flatten(back)
    assert got_def == want_def
    # encoder (AdamW at 1e-5): 3 steps move a weight by at most ~3e-5; a
    # gradient that is zero up to rounding (the key bias under the
    # softmax) can take Adam's sign-like step either way, so the bound is
    # two such steps, 2e-5, over the 1e-6 of fp32 rounding. This bound
    # sees a flipped or missing update only; the gradients themselves are
    # held by test_first_step_encoder_grads_match_jax
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g, np.asarray(w), atol=2e-5, rtol=0)
    # head (AdamW at 5e-3 behind the norm clip): gradients well above
    # rounding, so the two sides take the same steps up to fp32 rounding
    proj = final["compression"]["proj"]
    np.testing.assert_allclose(port.compression.proj.weight.detach().numpy(),
                               np.asarray(proj["kernel"]).T, atol=1e-5)
    np.testing.assert_allclose(port.compression.proj.bias.detach().numpy(),
                               np.asarray(proj["bias"]), atol=1e-5)


@pytest.mark.parametrize("alpha", [1.0, 0.3])
def test_first_step_encoder_grads_match_jax(alpha):
    """The gradients of one port train step, every encoder leaf and the
    compression projection, against jax.grad of the JAX trainer's loss on
    the same params: this holds the encoder backward (attention, LN+GELU,
    conv tower) directly, where the params after Adam cannot."""
    jt, state, port = _pair()
    batch = _batch()
    jb = _jax_batch(batch)

    def loss_fn(params):
        # every dropout is off, so the key changes nothing
        z = jt._embed(params, state.frozen, jb, True, jax.random.PRNGKey(0))
        return jt._loss(z, jb, jnp.float32(alpha))

    want = jax.device_get(jax.grad(loss_fn)(state.params))
    port.train_step(batch, alpha)
    got = convert_hf_state_dict(
        {k: p.grad.numpy() for k, p in port.encoder.named_parameters()}, TINY)
    want_leaves, want_def = jax.tree_util.tree_flatten(want["encoder"])
    got_leaves, got_def = jax.tree_util.tree_flatten(got)
    assert got_def == want_def
    # fp32 on both sides: measured at most 6e-6 of each leaf's largest
    # entry; 2e-5 of it, plus 1e-8 for the key bias, whose gradient is
    # zero up to rounding (~4e-9) under the softmax
    for g, w in zip(got_leaves, want_leaves):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=2e-5 * np.abs(w).max() + 1e-8)
    proj = np.asarray(want["compression"]["proj"]["kernel"]).T
    np.testing.assert_allclose(port.compression.proj.weight.grad.numpy(),
                               proj, rtol=0, atol=2e-5 * np.abs(proj).max())


def _update_cosine(init, a, b) -> float:
    da = (np.asarray(a) - np.asarray(init)).ravel()
    db = (np.asarray(b) - np.asarray(init)).ravel()
    return float(da @ db / (np.linalg.norm(da) * np.linalg.norm(db)))


@pytest.mark.parametrize("alpha", [1.0, 0.3])
def test_fp32_grads_under_bf16_compute_match_jax(alpha):
    """grad_dtype='float32' with compute_dtype='bfloat16': 3 port steps
    against the JAX trainer at the same settings. JAX's bf16 Dense rounds
    its weight-gradient product to bf16 before the cast's transpose takes
    it to the fp32 leaf, so its 'float32' and 'bfloat16' runs take the
    same first step, bit for bit (held here), and the port's bf16
    linears compute that."""
    bf16 = dict(compute_dtype="bfloat16", grad_dtype="float32")
    jt, state, port = _pair(**bf16)
    jt16 = JaxTrainer(JaxStage1Config(**{**KW, **bf16,
                                         "grad_dtype": "bfloat16"}),
                      enc_config=TINY)
    state16 = jt16.init_state(jax.random.PRNGKey(0))
    init = jax.device_get(state.params)
    batch = _batch()
    want, want16, got = [], [], []
    for step in range(STEPS):
        state, m = jt.train_step(state, _jax_batch(batch), jnp.float32(alpha))
        state16, m16 = jt16.train_step(state16, _jax_batch(batch),
                                       jnp.float32(alpha))
        want.append(float(m["loss"]))
        want16.append(float(m16["loss"]))
        got.append(float(port.train_step(batch, alpha)["loss"]))
        if step == 0:
            # JAX's two settings: one step, the same bits in every leaf
            for a, b in zip(
                    jax.tree_util.tree_leaves(jax.device_get(state.params)),
                    jax.tree_util.tree_leaves(
                        jax.device_get(state16.params))):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    final = jax.device_get(state.params)
    # after that XLA fuses the two programs differently: fp32 bias
    # gradients summed in another order, measured a few ulps apart at
    # steps 2-3; the losses stay equal
    np.testing.assert_allclose(want16, want, rtol=1e-6)
    # bf16 on both sides, rounded at other places: losses measured within
    # 5.5e-4 (relative) of JAX's at both alphas
    np.testing.assert_allclose(got, want, rtol=2e-3)
    # Adam's first steps are near lr * sign(g), so a gradient element at
    # bf16 rounding level steps either way: each update is held by its
    # direction and size. Measured: encoder leaves' update cosines >=
    # 0.981 and norm ratios within 1.8 % of 1, the compression
    # projection's 0.9993; the key bias, whose gradient is zero up to
    # rounding under the softmax, is noise on both sides (cosine 0.06)
    back = convert_hf_state_dict(
        {k: v.numpy() for k, v in port.encoder.state_dict().items()}, TINY)
    leaves = zip(jax.tree_util.tree_leaves_with_path(init["encoder"]),
                 jax.tree_util.tree_leaves(final["encoder"]),
                 jax.tree_util.tree_leaves(back))
    for (path, i), w, g in leaves:
        name = jax.tree_util.keystr(path)
        if "k_proj" in name and "bias" in name:
            continue
        assert _update_cosine(i, w, g) >= 0.95, name
        ratio = (np.linalg.norm(np.asarray(g) - np.asarray(i))
                 / np.linalg.norm(np.asarray(w) - np.asarray(i)))
        assert abs(ratio - 1) <= 0.05, name
    proj = init["compression"]["proj"]["kernel"]
    assert _update_cosine(
        np.asarray(proj).T, np.asarray(final["compression"]["proj"]
                                       ["kernel"]).T,
        port.compression.proj.weight.detach().numpy()) >= 0.995


def test_eval_and_embed_steps_match_jax():
    jt, state, port = _pair()
    batch = _batch()
    z = port.embed_step(batch)
    want_z = jt.embed_step(state.params, state.frozen,
                           {"waveforms": jnp.asarray(batch["waveforms"])})
    assert z.shape == (8, 16)
    np.testing.assert_allclose(z.numpy(), np.asarray(want_z), atol=1e-5)
    loss = port.eval_step(batch)
    want = jt.eval_step(state, _jax_batch(batch))
    assert float(loss) == pytest.approx(float(want), rel=1e-5)


def test_frozen_encoder_step_matches_jax():
    """finetune_encoder=False: the encoder runs without gradients and only
    the compression module trains."""
    jt, state, port = _pair(finetune_encoder=False)
    before = {k: v.clone() for k, v in port.encoder.state_dict().items()}
    batch = _batch()
    state, m = jt.train_step(state, _jax_batch(batch), jnp.float32(0.5))
    got = float(port.train_step(batch, 0.5)["loss"])
    assert got == pytest.approx(float(m["loss"]), rel=1e-4)
    for k, v in port.encoder.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_freeze_feature_extractor_keeps_conv_params():
    _, _, port = _pair(freeze_feature_extractor=True)
    fx = port.encoder.feature_extractor
    before = {k: v.clone() for k, v in fx.state_dict().items()}
    proj = port.encoder.feature_projection.projection.weight.detach().clone()
    port.train_step(_batch(), 1.0)
    for k, v in fx.state_dict().items():
        assert torch.equal(v, before[k]), k        # bit for bit
    assert not torch.equal(
        port.encoder.feature_projection.projection.weight, proj)


def test_trainer_refuses_what_it_does_not_run():
    w = _weights(JaxTrainer(JaxStage1Config(**KW), enc_config=TINY)
                 .init_state(jax.random.PRNGKey(0)))
    # device RawBoost is ported: the JAX default builds
    Stage1Trainer(Stage1Config(**{**KW, "use_rawboost": True}),
                  port_config(TINY), w, device="cpu")
    with pytest.raises(ValueError, match="grad_dtype"):
        Stage1Trainer(Stage1Config(**{**KW, "grad_dtype": "bfloat16"}),
                      port_config(TINY), w, device="cpu")
    # fp32 weight gradients under bf16 compute: what the JAX trainer
    # computes there (test_fp32_grads_under_bf16_compute_match_jax)
    Stage1Trainer(Stage1Config(**{**KW, "compute_dtype": "bfloat16"}),
                  port_config(TINY), w, device="cpu")
    for gd in ("auto", "bfloat16"):
        Stage1Trainer(Stage1Config(**{**KW, "compute_dtype": "bfloat16",
                                      "grad_dtype": gd}),
                      port_config(TINY), w, device="cpu")
    with pytest.raises(ValueError, match="rawboost_mode"):
        Stage1Trainer(Stage1Config(**{**KW, "rawboost_mode": "gpu"}),
                      port_config(TINY), w, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Stage1Trainer(Stage1Config(**KW), port_config(TINY), w)


def test_remat_keeps_the_dropout_masks():
    """Dropout, SpecAugment and compression dropout on: the seeds are
    drawn outside the checkpointed layers, so remat (of the layers and of
    the conv tower) recomputes the same masks and changes no value."""
    from chip_smoke import random_jax_trees

    cfg = port_config(TINY).with_(
        apply_spec_augment=True, mask_time_prob=0.3, mask_time_length=2,
        hidden_dropout=0.1, attention_dropout=0.1, activation_dropout=0.1,
        feat_proj_dropout=0.1)
    weights = jax_params_to_torch(cfg, *random_jax_trees(cfg, comp_dim=16))
    batch = _batch()
    out = []
    for remat in (False, True):
        tr = Stage1Trainer(Stage1Config(**{**KW, "dropout": 0.1,
                                            "remat_encoder": remat,
                                            "remat_conv": remat}),
                           cfg, weights, device="cpu")
        losses = [float(tr.train_step(batch, 1.0)["loss"])
                  for _ in range(2)]
        out.append((losses, tr.compression.proj.weight.detach().clone()))
    assert out[0][0] == out[1][0]
    assert torch.equal(out[0][1], out[1][1])
