"""The port's encoder (fp32, CPU, plain kernel versions) against the JAX
encoder on the same bridged weights, for both architecture variants, on
zero-padded input with an interior zero sample (which shortens the
length, since the length is the count of nonzero samples)."""

import numpy as np
import pytest

import torch

from wav2vec_contr_loss_tpu.models.wav2vec2 import \
    Wav2Vec2Encoder as JaxEncoder

from tests.test_torch_bridge import jax_config, jax_trees, port_config
from wav2vec_contr_loss_torch import jax_params_to_torch
from wav2vec_contr_loss_torch.models import Wav2Vec2Encoder

from tests.test_torch_bridge import cap_torch_threads

cap_torch_threads()


def _wave():
    rng = np.random.default_rng(11)
    wave = rng.normal(0, 0.2, (3, 2000)).astype(np.float32)
    wave[1, -700:] = 0.0          # zero padding
    wave[0, 500] = 0.0            # interior zero
    wave[2, 1000:] = 0.0
    return wave


def _port_outputs(cfg, enc):
    port = Wav2Vec2Encoder(port_config(cfg)).eval()
    port.load_state_dict(
        jax_params_to_torch(port_config(cfg), enc, *jax_trees(cfg)[1:])
        ["encoder"])
    with torch.no_grad():
        out = port(torch.from_numpy(_wave()), return_all_hidden_states=True)
    return {k: v.float().numpy() if v.dtype != torch.bool else v.numpy()
            for k, v in out.items()}


@pytest.mark.parametrize("variant", ["xlsr", "large960h"])
def test_encoder_matches_jax_xla(variant):
    cfg = jax_config(variant)
    enc = jax_trees(cfg)[0]
    want = JaxEncoder(cfg).apply({"params": enc}, _wave(),
                                 return_all_hidden_states=True)
    got = _port_outputs(cfg, enc)

    fm = np.asarray(want["frame_mask"])
    np.testing.assert_array_equal(got["frame_mask"], fm)
    assert not fm[0].all() and not fm[1].all() and fm[1].any()
    # fp32 on both sides; tolerance of tests/test_wav2vec2_parity.py
    for key in ("layer_mean", "last_hidden", "all_hidden"):
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                   atol=2e-4, rtol=1e-3, err_msg=key)


@pytest.mark.slow  # ~9 s: tracing the Pallas kernels in interpret mode
def test_encoder_matches_jax_pallas_kernels():
    """Against the JAX encoder running both Pallas kernels (interpret
    mode). Their bf16 rounding of q/k/v and p is absent from the fp32
    port, hence the tolerance of
    tests/test_attention_pallas.py::test_encoder_integration_parity."""
    cfg = jax_config("xlsr")
    enc = jax_trees(cfg)[0]
    want = JaxEncoder(cfg.with_(attention_impl="pallas",
                                conv_ln_impl="pallas")).apply(
        {"params": enc}, _wave())
    got = _port_outputs(cfg, enc)
    np.testing.assert_allclose(got["layer_mean"],
                               np.asarray(want["layer_mean"]),
                               atol=3e-3, rtol=3e-2)
