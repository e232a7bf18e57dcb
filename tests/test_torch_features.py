"""Stage 1 from precomputed encoder features, against the JAX package:
`supcon_multiclass_loss` and its gradient, `extract_encoder_features`
(the (N, F, 250) memmap: the 250-frame pad and crop, host RawBoost in
the same draw order, the skip), `Stage1Trainer.fit_from_features` in the
binary and the multiclass mode (no encoder built), `train_stage1
--features_dir` and `plot_umap --subspace`. fp32 on the CPU. ~30 s
alone."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wav2vec_contr_loss_tpu.cli import plot_umap as jax_plot_cli
from wav2vec_contr_loss_tpu.config import Stage1Config as JaxStage1Config
from wav2vec_contr_loss_tpu.data import AudioConfig as JaxAudioConfig
from wav2vec_contr_loss_tpu.data import BatchPipeline as JaxPipeline
from wav2vec_contr_loss_tpu.data import parse_asvspoof2019 as jax_parse
from wav2vec_contr_loss_tpu.data.rawboost import (
    RawBoostParams as JaxRawBoostParams)
from wav2vec_contr_loss_tpu.eval.extract import \
    extract_encoder_features as jax_extract
from wav2vec_contr_loss_tpu.losses.supcon import \
    supcon_multiclass_loss as jax_multiclass
from wav2vec_contr_loss_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from wav2vec_contr_loss_tpu.models.wav2vec2 import Wav2Vec2Encoder as JaxEncoder
from wav2vec_contr_loss_tpu.parallel.mesh import make_mesh
from wav2vec_contr_loss_tpu.train import Stage1Trainer as JaxTrainer
from wav2vec_contr_loss_tpu.train import checkpoint as jax_ckpt

from chip_smoke import write_corpus
from tests.test_torch_bridge import cap_torch_threads, port_config
from wav2vec_contr_loss_torch import (Stage1Config, Stage1Trainer,
                                      jax_params_to_torch)
from wav2vec_contr_loss_torch.bridge import dense_state_dict
from wav2vec_contr_loss_torch.cli import plot_umap, train_stage1
from wav2vec_contr_loss_torch.data import (AudioConfig, BalancedBatchSampler,
                                           BatchPipeline, RawBoostParams,
                                           parse_asvspoof2019)
from wav2vec_contr_loss_torch.eval.extract import (FIXED_TIME_DIM,
                                                   extract_encoder_features)
from wav2vec_contr_loss_torch.losses import supcon_multiclass_loss
from wav2vec_contr_loss_torch.models.wav2vec2 import Wav2Vec2Encoder
from wav2vec_contr_loss_torch.ops import attention, conv_ln, supcon
from wav2vec_contr_loss_torch.train import checkpoint as ckpt

cap_torch_threads()

TINY = JaxConfig(
    hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
    conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2),
    num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
    dtype=jnp.float32, apply_spec_augment=False)


# -------------------------------------------------------- multiclass loss
def _z(b, d=16, seed=0):
    z = np.random.default_rng(seed).normal(0, 1, (b, d)).astype(np.float32)
    return z / np.linalg.norm(z, axis=1, keepdims=True)


@pytest.mark.parametrize("labels", [
    [0, 1, 2, 1, 0, 3],                      # singleton class 2 and 3
    [0, 1, 2, 3, 4, 5],                      # all unique: the loss is 0
    list(np.random.default_rng(1).integers(0, 4, 32)),   # B = 32
], ids=["singletons", "all_unique", "b32"])
@pytest.mark.parametrize("temperature", [0.1, 0.07])
def test_multiclass_loss_and_grad_match_jax(labels, temperature):
    """Loss and dL/dz within 1e-5 (fp32 both sides, the Gram in full fp32
    precision on both)."""
    z = _z(len(labels))
    y = np.asarray(labels, np.int32)
    want, want_g = jax.value_and_grad(
        lambda zz: jax_multiclass(zz, jnp.asarray(y), temperature))(
            jnp.asarray(z))
    zt = torch.from_numpy(z).requires_grad_(True)
    got = supcon_multiclass_loss(zt, torch.from_numpy(y).long(), temperature)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(want_g),
                               atol=1e-5)
    if len(set(labels)) == len(labels):
        assert got.item() == 0.0 and not zt.grad.any()


# ------------------------------------------------------ feature extraction
@pytest.fixture(scope="module")
def encoders():
    """The JAX tiny encoder's params and the port encoder of the same
    weights (eval mode, fp32)."""
    params = JaxEncoder(TINY).init(jax.random.PRNGKey(0),
                                   jnp.zeros((1, 2000)))["params"]
    params = jax.device_get(params)
    cfg = port_config(TINY)
    enc = Wav2Vec2Encoder(cfg)
    enc.load_state_dict(jax_params_to_torch(cfg, params, {
        "proj": {"kernel": np.zeros((32, 16), np.float32),
                 "bias": np.zeros(16, np.float32)}}, {})["encoder"])
    enc.eval()
    jenc = JaxEncoder(TINY)
    jfn = jax.jit(lambda w: jenc.apply({"params": params}, w)["layer_mean"])

    @torch.no_grad()
    def port_fn(w):
        return enc(w, w != 0.0)["layer_mean"]

    return jfn, port_fn


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """Two 12-clip corpora of 1 s: at 2 kHz (199 frames, padded to 250)
    and at 4 kHz (399 frames, cropped to 250)."""
    out = {}
    for sr in (2000, 4000):
        root = str(tmp_path_factory.mktemp(f"features_{sr}"))
        out[sr] = (root, write_corpus(root, 12, seed=sr, seconds=1.0, sr=sr))
    return out


@pytest.mark.parametrize("sr", [2000, 4000], ids=["pad", "crop"])
@pytest.mark.parametrize("rawboost", [False, True])
def test_extract_encoder_features_matches_jax(encoders, corpora, tmp_path,
                                              sr, rawboost):
    """The memmap within 1e-5 of the JAX one (fp32 both sides), the same
    labels, (N, F, 250), batch 8 with a padded last batch; host RawBoost
    from the same seed gives the same augmented clips; a second call
    skips."""
    jfn, port_fn = encoders
    root, proto = corpora[sr]
    jds = jax_parse(proto, root, audio=JaxAudioConfig(sr, 1))
    ds = parse_asvspoof2019(proto, root, audio=AudioConfig(sr, 1))
    rb = dict(rawboost_prob=0.9, seed=3)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_extract(jfn, JaxPipeline(jds, 8, num_workers=2), jdir, "train",
                rawboost=JaxRawBoostParams() if rawboost else None,
                log_fn=lambda m: None, **rb)
    before = (attention.launches, conv_ln.launches)
    ep, lp = extract_encoder_features(
        port_fn, BatchPipeline(ds, 8, num_workers=2), pdir, "train",
        rawboost=RawBoostParams() if rawboost else None,
        log_fn=lambda m: None, device="cpu", **rb)
    assert (attention.launches, conv_ln.launches) == before
    want = np.load(os.path.join(jdir, "train_features.npy"))
    got = np.load(ep, mmap_mode="r")
    assert got.shape == want.shape == (12, 32, FIXED_TIME_DIM)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_array_equal(
        np.load(lp), np.load(os.path.join(jdir, "train_feature_labels.npy")))
    if sr == 2000:          # 199 frames: the pad is zeros
        assert not np.asarray(got[:, :, 199:]).any()
    logs = []
    extract_encoder_features(port_fn, BatchPipeline(ds, 8, num_workers=2),
                             pdir, "train", log_fn=logs.append, device="cpu")
    assert logs and logs[0].startswith("[SKIP]")


# ------------------------------------------------------ fit from features
KW = dict(epochs=2, batch_size=8, seed=5, input_dim=32, hidden_dim=16,
          head_lr=5e-3,
          dropout=0.0, adam_mu_dtype="float32", adam_nu_dtype="float32",
          warmup_epochs=1, alpha_ramp_epochs=2, alpha_end=0.5,
          use_rawboost=False)


def _features(n=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, 32, FIXED_TIME_DIM)).astype(np.float32)
    y = np.array([1, 0] * (n // 2), np.int64)
    multi = np.where(y == 1, 0, 1 + np.arange(n) % 3).astype(np.int64)
    return x, y, multi


@pytest.mark.parametrize("loss_mode", ["binary", "multiclass"])
def test_fit_from_features_matches_jax(tmp_path, loss_mode):
    """2 epochs: losses rtol 1e-4; the first step's gradients within 1e-5
    of the largest; the compression within 2e-5 of the JAX trainer's (fp32
    both sides; the bound of tests/test_torch_fit.py) in at least 98 % of
    its elements, and every element within 4 flipped AdamW steps (8 x
    head_lr). Adam's step m/sqrt(v) of an element whose gradients are
    within a few times the two sides' rounding of zero (they differ by up
    to ~1.4e-7, the largest is ~3e-2) can go either way; ~1 of the 512
    elements is expected to be one, more where the thread count reorders
    the sums. A wrong update moves every element by O(head_lr). No
    encoder kernel and no SupCon launch on the CPU; 'best' and 'latest'
    written (binary, with a dev set), or 'best' an alias of 'latest'
    (multiclass, no dev set)."""
    x, y, multi = _features()
    dx, dy, _ = _features(8, seed=1)
    dev = (dx, dy) if loss_mode == "binary" else (None, None)
    jt = JaxTrainer(JaxStage1Config(**KW), enc_config=TINY,
                    loss_mode=loss_mode, from_features=True,
                    mesh=make_mesh(devices=jax.devices()[:1]))
    state = jt.init_state(jax.random.PRNGKey(0))
    comp = jax.device_get(state.params["compression"])
    assert "encoder" not in state.params and not state.frozen
    first = next(iter(BalancedBatchSampler(y, 8, seed=KW["seed"])
                      .epoch_batches(1)))
    b1 = {"features": x[first].transpose(0, 2, 1), "labels": y[first],
          "multi_labels": multi[first]}
    jb1 = {k: jnp.asarray(v) for k, v in b1.items()}
    g1 = np.asarray(jax.grad(lambda p: jt._loss(
        jt._embed(p, state.frozen, jb1, True, jax.random.PRNGKey(0)), jb1,
        jnp.float32(0.0)))(state.params)["compression"]["proj"]["kernel"]).T
    jsave = str(tmp_path / "jax")
    state, want = jt.fit_from_features(state, x, y, *dev, multi_labels=multi,
                                       save_dir=jsave, log_fn=lambda m: None)

    proj0 = dense_state_dict(comp["proj"])
    port = Stage1Trainer(Stage1Config(**KW), port_config(TINY),
                         {"compression": {f"proj.{k}": v
                                          for k, v in proj0.items()}},
                         device="cpu", loss_mode=loss_mode,
                         from_features=True)
    assert port.encoder is None and "encoder" not in port.state_dict()
    probe = Stage1Trainer(Stage1Config(**KW), port_config(TINY),
                          {"compression": {f"proj.{k}": v
                                           for k, v in proj0.items()}},
                          device="cpu", loss_mode=loss_mode,
                          from_features=True)
    probe.train_step(b1, 0.0)
    np.testing.assert_allclose(probe.compression.proj.weight.grad.numpy(),
                               g1, rtol=0, atol=1e-5 * np.abs(g1).max())
    save = str(tmp_path / "port")
    counts = (attention.launches, conv_ln.launches, supcon.launches)
    got = port.fit_from_features(x, y, *dev,
                                 multi_labels=multi, save_dir=save,
                                 log_fn=lambda m: None)
    assert counts == (attention.launches, conv_ln.launches, supcon.launches)
    assert got["alpha"] == want["alpha"] == [0.0, 0.25]
    np.testing.assert_allclose(got["train_loss"], want["train_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(got["dev_loss"], want["dev_loss"], rtol=1e-4)
    proj = jax.device_get(state.params["compression"]["proj"])
    diff = np.abs(port.compression.proj.weight.detach().numpy()
                  - np.asarray(proj["kernel"]).T)
    assert (diff <= 2e-5).mean() >= 0.98
    assert (diff <= 4 * 2 * KW["head_lr"]).all()
    np.testing.assert_allclose(port.compression.proj.bias.detach().numpy(),
                               np.asarray(proj["bias"]), atol=2e-5)
    assert port.step == int(state.step) == 4
    for name in ("best", "latest"):
        assert ckpt.checkpoint_exists(save, name)
        assert jax_ckpt.checkpoint_exists(jsave, name)
    assert os.path.islink(os.path.join(save, "best.pt")) == (
        loss_mode == "multiclass")
    back = Stage1Trainer.from_checkpoint(save, "latest", device="cpu")
    assert back.from_features and back.loss_mode == loss_mode
    assert back.encoder is None


@pytest.fixture(scope="module")
def features_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("features_dir")
    for split, n, seed in (("train", 16, 0), ("dev", 8, 1)):
        x, y, _ = _features(n, seed)
        np.save(d / f"{split}_features.npy", x)
        np.save(d / f"{split}_feature_labels.npy", y)
    return str(d)


def test_train_stage1_from_features_dir(features_dir, tmp_path, capsys):
    """`train_stage1 --features_dir` trains the head alone (no encoder,
    no --encoder_init needed) and writes 'best' and 'latest'."""
    train_stage1.main(["--features_dir", features_dir, "--device", "cpu",
                       "--model_name", "test/tiny-wav2vec2",
                       "--save_dir", str(tmp_path), "--epochs", "2",
                       "--batch_size", "8", "--input_dim", "32",
                       "--hidden_dim", "16", "--loss_mode", "multiclass"])
    assert "(from features) complete" in capsys.readouterr().out
    save = os.path.join(str(tmp_path), "test__tiny-wav2vec2")
    tr = Stage1Trainer.from_checkpoint(save, "best", device="cpu")
    assert tr.from_features and tr.loss_mode == "multiclass"
    assert tr.encoder is None and tr.step == 4
    z = tr.embed_step({"features": torch.randn(2, FIXED_TIME_DIM, 32)})
    assert z.shape == (2, 16)


def test_plot_umap_subspace_matches_the_jax_cli(features_dir, tmp_path,
                                                monkeypatch):
    """The embedding `plot_umap --subspace` plots (time-mean, then L2, of
    the feature memmap) against the JAX CLI's, to 1e-6."""
    seen = {}

    def capture(tag):
        def fake(embs, labels, out_png, **kw):
            seen[tag] = (np.asarray(embs), np.asarray(labels))
        return fake

    monkeypatch.setattr(jax_plot_cli, "plot_embeddings_2d", capture("jax"))
    monkeypatch.setattr(plot_umap, "plot_embeddings_2d", capture("port"))
    args = ["--emb_dir", features_dir, "--split", "train", "--subspace",
            "--out_dir", str(tmp_path)]
    jax_plot_cli.main(args)
    plot_umap.main(args)
    (ge, gl), (we, wl) = seen["port"], seen["jax"]
    assert ge.shape == (16, 32)
    np.testing.assert_allclose(ge, we, atol=1e-6)
    np.testing.assert_array_equal(gl, wl)
    np.testing.assert_allclose(np.linalg.norm(ge, axis=1), 1.0, atol=1e-6)
