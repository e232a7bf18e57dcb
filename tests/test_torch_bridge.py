"""Weight bridge and config of the PyTorch port against the JAX package.

JAX-initialized trees (perturbed with seeded numpy noise so no leaf is a
constant) go through `jax_params_to_torch`; the port's modules must load
them with strict=True, and the JAX package's own HF importer must turn
the port's state dict back into the original tree bit for bit, which
holds only if every port tensor is exactly its transposed source.
Also holds the helpers the other test_torch_* files share.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wav2vec_contr_loss_tpu.models.compression import \
    CompressionModule as JaxCompression
from wav2vec_contr_loss_tpu.models.heads import build_head as jax_build_head
from wav2vec_contr_loss_tpu.models.hf_convert import convert_hf_state_dict
from wav2vec_contr_loss_tpu.models.wav2vec2 import (
    LARGE_960H as JAX_LARGE_960H, XLSR_300M as JAX_XLSR_300M,
    Wav2Vec2Config as JaxConfig, Wav2Vec2Encoder as JaxEncoder,
    config_to_dict, feature_frame_length as jax_frame_length)

from wav2vec_contr_loss_torch import (LARGE_960H, XLSR_300M,
                                      config_from_dict, feature_frame_length,
                                      jax_params_to_torch)
from wav2vec_contr_loss_torch.models import (CompressionModule,
                                             Wav2Vec2Encoder, build_head)

# the widths of tests/test_wav2vec2_parity.py SMALL_KW, as a JAX config
SMALL = dict(hidden_size=32, num_layers=3, num_heads=4, intermediate_size=64,
             conv_dim=(24, 24, 24), conv_kernel=(10, 3, 3),
             conv_stride=(5, 2, 2), num_conv_pos_embeddings=16,
             num_conv_pos_embedding_groups=4, dtype=jnp.float32)
VARIANTS = {
    "xlsr": dict(feat_extract_norm="layer", do_stable_layer_norm=True,
                 conv_bias=True),
    "large960h": dict(feat_extract_norm="group", do_stable_layer_norm=False,
                      conv_bias=False),
}


def jax_config(variant: str, **kw) -> JaxConfig:
    return JaxConfig(**{**SMALL, **VARIANTS[variant], **kw})


def port_config(cfg: JaxConfig):
    """The port config of a JAX config, through the JSON sidecar dict."""
    return config_from_dict(config_to_dict(cfg))


def perturbed(tree, seed: int):
    """Numpy copy of a param tree with seeded noise on every leaf."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a, np.float32)
                   + rng.normal(0, 0.1, a.shape).astype(np.float32)), tree)


def jax_trees(cfg: JaxConfig, head_type: str = "linear", comp_dim: int = 16,
              seed: int = 0):
    """(encoder, compression, head) numpy trees for `cfg`."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    enc = JaxEncoder(cfg).init(k1, jnp.zeros((1, 2000)))["params"]
    comp = JaxCompression(input_dim=cfg.hidden_size, hidden_dim=comp_dim
                          ).init(k2, jnp.zeros((1, 1, cfg.hidden_size)))["params"]
    head = jax_build_head(head_type, 8).init(
        k3, jnp.zeros((1, comp_dim)))["params"]
    return (perturbed(enc, seed + 1), perturbed(comp, seed + 2),
            perturbed(head, seed + 3))


@pytest.mark.parametrize("fused_qkv", [False, True])
@pytest.mark.parametrize("variant", ["xlsr", "large960h"])
def test_bridge_loads_strict_and_round_trips(variant, fused_qkv):
    cfg = jax_config(variant, fused_qkv=fused_qkv)
    head_type = "linear" if variant == "xlsr" else "mlp"
    enc, comp, head = jax_trees(cfg, head_type)
    sds = jax_params_to_torch(port_config(cfg), enc, comp, head)

    modules = {"encoder": Wav2Vec2Encoder(port_config(cfg)),
               "compression": CompressionModule(32, 16),
               "head": build_head(head_type, 16, 8)}
    for name, mod in modules.items():
        mod.load_state_dict(sds[name], strict=True)   # every key consumed

    back = convert_hf_state_dict(
        {k: v.numpy() for k, v in modules["encoder"].state_dict().items()},
        cfg)
    want_leaves, want_def = jax.tree_util.tree_flatten(enc)
    got_leaves, got_def = jax.tree_util.tree_flatten(back)
    assert got_def == want_def
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(g, w)

    np.testing.assert_array_equal(
        modules["compression"].proj.weight.detach().numpy(), comp["proj"]["kernel"].T)
    np.testing.assert_array_equal(
        modules["compression"].proj.bias.detach().numpy(), comp["proj"]["bias"])
    for name, tree in head.items():
        lin = getattr(modules["head"], name)
        np.testing.assert_array_equal(lin.weight.detach().numpy(), tree["kernel"].T)
        np.testing.assert_array_equal(lin.bias.detach().numpy(), tree["bias"])


def test_config_presets_and_sidecar_dict():
    for jax_cfg, ours in ((JAX_XLSR_300M, XLSR_300M),
                          (JAX_LARGE_960H, LARGE_960H)):
        got = config_from_dict(config_to_dict(jax_cfg))
        assert got == ours                 # TPU knobs dropped, dtype kept
        assert feature_frame_length(80000, ours) == \
            jax_frame_length(80000, jax_cfg) == 249
    f32 = config_from_dict(config_to_dict(JAX_XLSR_300M.with_(
        dtype=jnp.float32)))
    assert f32.torch_dtype == torch.float32
    with pytest.raises(ValueError, match="compute dtype"):
        config_from_dict({"dtype": "float16"})
