"""The port's HF snapshot reader and writer (models/hf_convert.py,
models/export_hf.py) against the JAX package's and transformers' own, on
a tiny `transformers.Wav2Vec2Model` saved offline: a safetensors
snapshot, a `.bin` snapshot, a sharded one, and the three key layouts of
the positional conv's weight norm. fp32 on the CPU; ~10 s alone."""

import json
import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch
import transformers
from safetensors.numpy import load_file as st_numpy_load
from safetensors.torch import load_file as st_torch_load
from safetensors.torch import save_file as st_save

from wav2vec_contr_loss_tpu.models.hf_convert import \
    config_from_hf as jax_config_from_hf
from wav2vec_contr_loss_tpu.models.hf_convert import \
    load_local_hf_checkpoint as jax_load_local
from wav2vec_contr_loss_tpu.models.wav2vec2 import \
    Wav2Vec2Encoder as JaxEncoder

from tests.test_torch_bridge import cap_torch_threads
from wav2vec_contr_loss_torch.bridge import encoder_state_dict
from wav2vec_contr_loss_torch.models import Wav2Vec2Encoder
from wav2vec_contr_loss_torch.models.export_hf import save_hf_checkpoint
from wav2vec_contr_loss_torch.models.hf_convert import (
    config_from_hf, convert_hf_state_dict, load_encoder_init,
    load_local_hf_checkpoint, read_safetensors, save_encoder_init)

cap_torch_threads()

POS = "encoder.pos_conv_embed.conv"
TINY = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, conv_dim=(16, 16, 16),
            conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2),
            num_conv_pos_embeddings=8, num_conv_pos_embedding_groups=4,
            mask_time_prob=0.05)
VARIANTS = {
    "xlsr": dict(feat_extract_norm="layer", do_stable_layer_norm=True,
                 conv_bias=True),
    "large960h": dict(feat_extract_norm="group", do_stable_layer_norm=False,
                      conv_bias=False),
}


def _model(variant: str, seed: int = 0) -> transformers.Wav2Vec2Model:
    torch.manual_seed(seed)
    model = transformers.Wav2Vec2Model(
        transformers.Wav2Vec2Config(**TINY, **VARIANTS[variant])).eval()
    with torch.no_grad():   # weight norm's g away from ||v||, as trained
        for name, p in model.named_parameters():
            if "original0" in name or "weight_g" in name:
                p.mul_(torch.linspace(0.5, 1.5, p.numel()).reshape(p.shape))
    return model


def _wave():
    rng = np.random.default_rng(5)
    w = rng.normal(0, 0.2, (2, 3000)).astype(np.float32)
    w[1, 2000:] = 0.0
    return w


def _layouts(sd):
    """{layout: state dict}: weight_g/weight_v, parametrizations and a
    plain materialized weight, from one model's state dict."""
    sd = {k: v.clone() for k, v in sd.items()}
    if f"{POS}.weight_g" in sd:
        g, v = sd.pop(f"{POS}.weight_g"), sd.pop(f"{POS}.weight_v")
    else:
        g = sd.pop(f"{POS}.parametrizations.weight.original0")
        v = sd.pop(f"{POS}.parametrizations.weight.original1")
    w = torch._weight_norm(v, g, 2)
    return {
        "weight_g": {**sd, f"{POS}.weight_g": g, f"{POS}.weight_v": v},
        "parametrizations": {**sd, f"{POS}.parametrizations.weight.original0":
                             g, f"{POS}.parametrizations.weight.original1": v},
        "plain": {**sd, f"{POS}.weight": w},
    }


def _snapshot(d, config: dict, sd, kind: str) -> str:
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(config, f)
    sd = {k: v.contiguous() for k, v in sd.items()}
    if kind == "safetensors":
        st_save(sd, os.path.join(d, "model.safetensors"),
                metadata={"format": "pt"})
    elif kind == "bin":
        torch.save(sd, os.path.join(d, "pytorch_model.bin"))
    else:   # sharded: two safetensors files and their index
        keys = sorted(sd)
        shards = {"model-00001-of-00002.safetensors": keys[::2],
                  "model-00002-of-00002.safetensors": keys[1::2]}
        for name, ks in shards.items():
            st_save({k: sd[k] for k in ks}, os.path.join(d, name),
                    metadata={"format": "pt"})
        with open(os.path.join(d, "model.safetensors.index.json"), "w") as f:
            json.dump({"weight_map": {k: n for n, ks in shards.items()
                                      for k in ks}}, f)
    return d


@pytest.mark.parametrize("variant", ["xlsr", "large960h"])
def test_config_matches_jax_field_by_field(variant):
    hf = transformers.Wav2Vec2Config(**TINY, **VARIANTS[variant])
    for d in (hf.to_dict(), {}):   # {}: transformers' defaults throughout
        ours = config_from_hf(d)
        want = jax_config_from_hf(transformers.Wav2Vec2Config.from_dict(d))
        for f in ("hidden_size", "num_layers", "num_heads",
                  "intermediate_size", "conv_dim", "conv_kernel",
                  "conv_stride", "conv_bias", "feat_extract_norm",
                  "do_stable_layer_norm", "num_conv_pos_embeddings",
                  "num_conv_pos_embedding_groups", "layer_norm_eps",
                  "hidden_dropout", "attention_dropout",
                  "activation_dropout", "feat_proj_dropout",
                  "apply_spec_augment", "mask_time_prob",
                  "mask_time_length", "mask_time_min_masks"):
            assert getattr(ours, f) == getattr(want, f), f


@pytest.mark.parametrize("layout", ["weight_g", "parametrizations", "plain"])
@pytest.mark.parametrize("kind", ["safetensors", "bin", "sharded"])
def test_snapshot_converts_to_the_jax_weights_bit_for_bit(tmp_path, kind,
                                                          layout):
    model = _model("xlsr")
    sd = _layouts(model.state_dict())[layout]
    d = _snapshot(str(tmp_path / "snap"), model.config.to_dict(), sd, kind)
    cfg, got = load_local_hf_checkpoint(d)
    jax_cfg, params = jax_load_local(d)
    want = encoder_state_dict(cfg, params)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("variant", ["xlsr", "large960h"])
def test_encoder_output_matches_jax_and_transformers(tmp_path, variant):
    model = _model(variant, seed=1)
    model.save_pretrained(str(tmp_path / "snap"))
    cfg, sd = load_local_hf_checkpoint(str(tmp_path / "snap"))
    jax_cfg, params = jax_load_local(str(tmp_path / "snap"))
    port = Wav2Vec2Encoder(cfg.with_(dtype="float32")).eval()
    port.load_state_dict(sd, strict=True)
    wave = _wave()
    with torch.no_grad():
        got = port(torch.from_numpy(wave))["last_hidden"].numpy()
        hf = model(torch.from_numpy(wave)).last_hidden_state.numpy()
    want = np.asarray(JaxEncoder(jax_cfg.with_(dtype=jnp.float32)).apply(
        {"params": params}, wave)["last_hidden"])
    # fp32 on all sides; frame 0 of row 0 is the unpadded clip's
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got[0], hf[0], atol=1e-5)


def test_save_hf_checkpoint_loads_in_transformers(tmp_path):
    model = _model("xlsr", seed=2)
    model.save_pretrained(str(tmp_path / "snap"))
    cfg, sd = load_local_hf_checkpoint(str(tmp_path / "snap"))
    out = save_hf_checkpoint(str(tmp_path / "export"), cfg, sd)
    back = transformers.Wav2Vec2Model.from_pretrained(out).eval()
    with torch.no_grad():
        x = torch.from_numpy(_wave())
        np.testing.assert_allclose(back(x).last_hidden_state.numpy(),
                                   model(x).last_hidden_state.numpy(),
                                   atol=1e-5)
    # and back through the port's reader: the plain tensors bit for bit,
    # the positional conv within one ulp (g·v/||v|| in fp32)
    cfg2, sd2 = load_local_hf_checkpoint(out)
    assert cfg2 == cfg
    for k in sd:
        if k == f"{POS}.weight":
            np.testing.assert_array_max_ulp(sd2[k].numpy(), sd[k].numpy(), 1)
        else:
            assert torch.equal(sd2[k], sd[k]), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_safetensors_reader_matches_safetensors(tmp_path, dtype):
    g = torch.Generator().manual_seed(0)
    tensors = {"a": torch.randn(3, 5, generator=g).to(dtype),
               "b.c": torch.randn(7, generator=g).to(dtype),
               "scalar": torch.tensor(1.5).to(dtype)}
    path = str(tmp_path / "x.safetensors")
    st_save(tensors, path, metadata={"format": "pt"})
    got = read_safetensors(path)
    if dtype == torch.bfloat16:   # safetensors.numpy has no bf16
        want = {k: v.float().numpy() for k, v in st_torch_load(path).items()}
    else:
        want = st_numpy_load(path)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])


def test_keys_the_encoder_does_not_hold(tmp_path):
    model = _model("xlsr")
    sd = dict(model.state_dict())
    cfg = config_from_hf(model.config.to_dict())
    base = convert_hf_state_dict(sd, cfg)
    # a ForPreTraining / ForCTC snapshot: prefixed, with heads to drop
    pre = {f"wav2vec2.{k}": v for k, v in sd.items()}
    pre.update({"quantizer.codevectors": torch.zeros(1),
                "project_q.weight": torch.zeros(1),
                "project_hid.bias": torch.zeros(1),
                "lm_head.weight": torch.zeros(1)})
    got = convert_hf_state_dict(pre, cfg)
    assert all(torch.equal(got[k], base[k]) for k in base)
    with pytest.raises(KeyError, match="unexpected.*classifier"):
        convert_hf_state_dict({**sd, "classifier.weight": torch.zeros(1)},
                              cfg)
    with pytest.raises(KeyError, match="missing"):
        convert_hf_state_dict({k: v for k, v in sd.items()
                               if "layers.1." not in k}, cfg)


def test_encoder_init_round_trip(tmp_path):
    model = _model("xlsr")
    model.save_pretrained(str(tmp_path / "snap"))
    cfg, sd = load_local_hf_checkpoint(str(tmp_path / "snap"))
    save_encoder_init(str(tmp_path / "init"), cfg, sd, source="snap")
    for path in ("init", "init/encoder", "init/encoder.pt"):
        cfg2, sd2 = load_encoder_init(str(tmp_path / path))
        assert cfg2 == cfg
        assert all(torch.equal(sd2[k], sd[k]) for k in sd)
    with pytest.raises(FileNotFoundError):
        load_encoder_init(str(tmp_path / "nowhere"))
