"""The port's int8 serving (ops/quant.py) against the JAX package's
(wav2vec_contr_loss_tpu/ops/quant.py), fp32 on the CPU: the int8
weights and scales bit for bit, `QuantLinear` against `QuantDense` on
the same int8 parameters, the quantized state dict against
`quantize_encoder_params` through the bridge, the quantized tiny encoder
against the JAX one, and a trained tiny scorer quantized both ways
keeping its ranking and EER (tests/test_quant.py's contract). Budget:
~30 s alone."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wav2vec_contr_loss_tpu.models.wav2vec2 import \
    Wav2Vec2Encoder as JaxEncoder
from wav2vec_contr_loss_tpu.ops.quant import (QuantDense, _quantize_dense,
                                              quantize_encoder_params)

from chip_smoke import write_corpus
from tests.test_torch_bridge import (cap_torch_threads, jax_config,
                                     jax_trees, port_config)
from wav2vec_contr_loss_torch import (BaselineConfig, BaselineTrainer,
                                      SpoofScorer, Stage1Config,
                                      Stage1Trainer, Stage2Config,
                                      jax_params_to_torch)
from wav2vec_contr_loss_torch.bridge import random_jax_trees
from wav2vec_contr_loss_torch.data import (AudioConfig, BatchPipeline,
                                           parse_asvspoof2019)
from wav2vec_contr_loss_torch.eval.metrics import compute_eer
from wav2vec_contr_loss_torch.models import Wav2Vec2Encoder
from wav2vec_contr_loss_torch.ops.quant import (QUANT_TARGETS, QuantLinear,
                                                quantize_encoder_state_dict,
                                                quantize_linear)
from wav2vec_contr_loss_torch.train import train_stage2

cap_torch_threads()

MODES = ["w8a8", "w8"]
SR = 16000


def _rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


@pytest.mark.parametrize("shape", [(48, 64), (1024, 1024), (40, 4096),
                                   (7, 3)])
def test_quantize_linear_is_bit_equal_to_jax(shape):
    rng = np.random.default_rng(sum(shape))
    w = rng.normal(0, 0.2, shape).astype(np.float32)     # (out, in)
    w[0] = 0.0                                            # the 1e-30 floor
    w[-1, 0] = 5.0                                        # an outlier
    b = rng.normal(0, 0.1, shape[0]).astype(np.float32)
    got = quantize_linear(torch.from_numpy(w), torch.from_numpy(b))
    want = _quantize_dense({"kernel": jnp.asarray(w.T),
                            "bias": jnp.asarray(b)})
    assert got["weight"].dtype == torch.int8
    np.testing.assert_array_equal(got["weight"].numpy().T,
                                  np.asarray(want["kernel"]))
    np.testing.assert_array_equal(got["scale"].numpy(),
                                  np.asarray(want["scale"]))
    np.testing.assert_array_equal(got["bias"].numpy(), b)


@pytest.mark.parametrize("mode", MODES)
def test_quant_linear_matches_jax_quant_dense(mode):
    rng = np.random.default_rng(0)
    w = rng.normal(size=(48, 64)).astype(np.float32) * 0.2   # (out, in)
    b = rng.normal(size=(48,)).astype(np.float32) * 0.1
    x = rng.normal(size=(4, 10, 64)).astype(np.float32)
    q = quantize_linear(torch.from_numpy(w), torch.from_numpy(b))
    lin = QuantLinear(64, 48, mode, torch.float32)
    lin.load_state_dict(q)
    with torch.no_grad():
        got = lin(torch.from_numpy(x)).numpy()
    want = QuantDense(48, dtype=jnp.float32, mode=mode).apply(
        {"params": {"kernel": jnp.asarray(q["weight"].numpy().T),
                    "scale": jnp.asarray(q["scale"].numpy()),
                    "bias": jnp.asarray(b)}}, jnp.asarray(x))
    assert got.shape == (4, 10, 48) and got.dtype == np.float32
    assert _rel_err(got, want) <= (1e-4 if mode == "w8a8" else 1e-5)
    # against the exact fp32 product: JAX's int8 bounds
    assert _rel_err(got, x @ w.T + b) < (0.03 if mode == "w8a8" else 0.015)


def test_quantize_encoder_state_dict_matches_jax_through_the_bridge():
    cfg = jax_config("xlsr")
    enc, comp, head = jax_trees(cfg)
    sd = jax_params_to_torch(port_config(cfg), enc, comp, head)["encoder"]
    q = quantize_encoder_state_dict(sd)
    jq = quantize_encoder_params(jax.tree_util.tree_map(jnp.asarray, enc))
    layers = jq["layers"]["layer"]
    n_int8 = 0
    for key, value in q.items():
        prefix, _, leaf = key.rpartition(".")
        name = prefix.rpartition(".")[2]
        if name not in QUANT_TARGETS:
            assert value is sd[key], key
            continue
        i = int(key.split(".")[2])
        group = "attention" if "attention" in key else "feed_forward"
        want = layers[group][name]
        if leaf == "weight":
            assert value.dtype == torch.int8
            np.testing.assert_array_equal(value.numpy().T,
                                          np.asarray(want["kernel"][i]))
            n_int8 += 1
        else:
            np.testing.assert_array_equal(value.numpy(),
                                          np.asarray(want[leaf][i]))
    assert n_int8 == 6 * cfg.num_layers
    assert set(q) == set(sd) | {k.replace(".weight", ".scale") for k in sd
                                if k.rpartition(".")[0].rpartition(".")[2]
                                in QUANT_TARGETS and k.endswith(".weight")}


@pytest.mark.parametrize("mode", MODES)
def test_quantized_encoder_matches_jax(mode):
    cfg = jax_config("xlsr")
    enc, comp, head = jax_trees(cfg)
    rng = np.random.default_rng(1)
    wave = rng.normal(0, 0.2, (2, 8000)).astype(np.float32)
    wave[:, 6000:] = 0.0
    attn = (wave != 0.0).astype(np.int32)
    want = JaxEncoder(cfg.with_(quant=mode)).apply(
        {"params": quantize_encoder_params(
            jax.tree_util.tree_map(jnp.asarray, enc))},
        jnp.asarray(wave), jnp.asarray(attn))["layer_mean"]
    pcfg = port_config(cfg).with_(quant=mode)
    model = Wav2Vec2Encoder(pcfg).eval()
    model.load_state_dict(quantize_encoder_state_dict(
        jax_params_to_torch(pcfg, enc, comp, head)["encoder"]), strict=True)
    assert sum(isinstance(m, QuantLinear) for m in model.modules()) == \
        6 * cfg.num_layers
    x = torch.from_numpy(wave)
    with torch.no_grad():
        got = model(x, x != 0.0)["layer_mean"].numpy()
    assert _rel_err(got, want) <= 1e-4


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny frozen-encoder stage 1 fitted one epoch on 16 tone/noise
    clips, a stage-2 head on its embeddings (tests/test_quant.py's
    recipe) -> (stage-1 dir, stage-2 dir, pipeline)."""
    root = tmp_path_factory.mktemp("torch_quant")
    proto = write_corpus(str(root), 16, seed=2, seconds=1.0)
    ds = parse_asvspoof2019(proto, str(root), audio=AudioConfig(SR, 1))
    cfg = port_config(jax_config("xlsr"))
    cfg1 = Stage1Config(epochs=1, batch_size=8, input_dim=32, hidden_dim=16,
                        max_duration_seconds=1, use_rawboost=False,
                        finetune_encoder=False, compute_dtype="float32",
                        seed=0)
    trainer = Stage1Trainer(cfg1, cfg, jax_params_to_torch(
        cfg, *random_jax_trees(cfg, comp_dim=16, seed=3)), device="cpu")
    pipe = BatchPipeline(ds, 8, seed=0, num_workers=2)
    s1, s2 = str(root / "s1"), str(root / "s2")
    trainer.fit(pipe, save_dir=s1, log_fn=lambda *a: None)
    embs, labels = trainer.embed_dataset(pipe)
    cfg2 = Stage2Config(in_dim=16, epochs=10, batch_size=16, lr=5e-2, seed=0)
    train_stage2(cfg2, embs, labels, embs, labels, save_dir=s2,
                 log_fn=lambda *a: None, device="cpu")
    return s1, s2, pipe


def test_quantized_scorer_preserves_scoring(trained):
    """A trained tiny scorer quantized to int8 keeps the score ranking
    (corr > 0.98) and the EER within one trial (tests/test_quant.py)."""
    s1, s2, pipe = trained
    f32 = SpoofScorer.from_checkpoints(s1, s2, device="cpu")
    sf, lab = f32.score_dataset(pipe)
    for mode in MODES:
        q = SpoofScorer.from_checkpoints(s1, s2, device="cpu", quantize=mode)
        assert q.enc_config.quant == mode and q.quantize == mode
        sq, labq = q.score_dataset(pipe)
        np.testing.assert_array_equal(lab, labq)
        assert np.corrcoef(sf, sq)[0, 1] > 0.98, mode
        eer_f = compute_eer(sf[lab == 1], sf[lab == 0])[0]
        eer_q = compute_eer(sq[lab == 1], sq[lab == 0])[0]
        assert abs(eer_q - eer_f) <= 0.125 + 1e-9, mode


def test_quant_is_inference_only():
    lin = QuantLinear(16, 8, "w8", torch.float32)
    x = torch.zeros(4, 16, requires_grad=True)
    with pytest.raises(ValueError, match="inference only"):
        lin(x)
    with pytest.raises(ValueError, match="unknown quant mode"):
        QuantLinear(16, 8, "w4", torch.float32)
    cfg = port_config(jax_config("xlsr")).with_(quant="w8a8")
    weights = jax_params_to_torch(cfg, *random_jax_trees(cfg, comp_dim=16))
    kw = dict(input_dim=32, hidden_dim=16, compute_dtype="float32")
    with pytest.raises(ValueError, match="serving only"):
        Stage1Trainer(Stage1Config(**kw), cfg, weights, device="cpu")
    with pytest.raises(ValueError, match="serving only"):
        BaselineTrainer(BaselineConfig(**kw), cfg,
                        dict(weights, classifier={
                            "weight": torch.zeros(1, 16),
                            "bias": torch.zeros(1)}), device="cpu")
    with pytest.raises(ValueError, match="quantize must be one of"):
        SpoofScorer(cfg, weights, Stage2Config(in_dim=16), device="cpu",
                    quantize="int4")
