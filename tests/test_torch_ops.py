"""The port's kernel wrappers on the CPU (their plain PyTorch versions)
against the JAX package's Pallas kernels in interpret mode, and the int16
wire against the JAX wire. The CUDA and Triton kernels themselves run
only on the card (chip_smoke.py holds them against these plain
versions)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from wav2vec_contr_loss_tpu.ops import wire as jax_wire
from wav2vec_contr_loss_tpu.ops.attention_pallas import \
    fused_attention as jax_fused_attention
from wav2vec_contr_loss_tpu.ops.conv_ln_pallas import \
    fused_ln_gelu as jax_fused_ln_gelu

from wav2vec_contr_loss_torch.ops import attention, conv_ln, wire


def _bf16_valued(rng, shape):
    """Normal samples rounded to bf16, as numpy float32."""
    x = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
    return x.to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("case", ["masked_tail", "fully_masked_row",
                                  "ragged_t"])
def test_attention_plain_matches_pallas(case):
    rng = np.random.default_rng(3)
    b, h, t, d = 3, 2, (37 if case == "ragged_t" else 40), 16
    q, k, v = (_bf16_valued(rng, (b, h, t, d)) for _ in range(3))
    q = (torch.from_numpy(q) * d ** -0.5).to(torch.bfloat16).float().numpy()
    bias = np.zeros((b, t), np.float32)
    bias[1, -9:] = -1e30                 # padded key tail
    if case == "fully_masked_row":
        bias[2, :] = -1e30               # an all-zero clip: uniform weights
    want = np.asarray(jax_fused_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), jnp.asarray(bias), 0, 0.0, h),
        np.float32)

    before = attention.launches
    got = attention.fused_attention(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        torch.from_numpy(bias), 0, 0.0, h)
    assert attention.launches == before  # CPU tensors: plain version
    assert got.dtype == torch.bfloat16 and got.shape == (b, h, t, d)
    got = got.float().numpy()
    assert np.isfinite(got).all()
    # bf16 output rounding on both sides; tolerance of
    # tests/test_attention_pallas.py::test_forward_matches_xla
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=2e-2)
    if case == "fully_masked_row":
        np.testing.assert_allclose(
            got[2], np.broadcast_to(v[2].mean(axis=1, keepdims=True), got[2].shape),
            atol=2e-2)


def test_attention_wrapper_refuses_what_it_does_not_take():
    q = torch.zeros(1, 2, 4, 8)
    bias = torch.zeros(1, 4)
    with pytest.raises(NotImplementedError):
        attention.fused_attention(q, q, q, bias, 0, 0.1, 2)
    with pytest.raises(ValueError, match="heads"):
        attention.fused_attention(q, q, q, bias, 0, 0.0, 3)
    with pytest.raises(ValueError, match="bias"):
        attention.fused_attention(q, q, q, bias.double(), 0, 0.0, 2)
    with pytest.raises(ValueError, match="shape"):
        attention.fused_attention(q, q[:, :, :3], q, bias, 0, 0.0, 2)


@pytest.mark.parametrize("gelu", [True, False])
@pytest.mark.parametrize("shape", [(2, 300, 512), (3, 257, 128)])
def test_ln_gelu_plain_matches_pallas(shape, gelu):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 2, shape).astype(np.float32)
    scale = rng.normal(1, 0.2, shape[-1]).astype(np.float32)
    bias = rng.normal(0, 0.3, shape[-1]).astype(np.float32)
    want = np.asarray(jax_fused_ln_gelu(jnp.asarray(x), jnp.asarray(scale),
                                        jnp.asarray(bias), 1e-5, gelu))
    before = conv_ln.launches
    got = conv_ln.fused_ln_gelu(torch.from_numpy(x), torch.from_numpy(scale),
                                torch.from_numpy(bias), 1e-5, gelu)
    assert conv_ln.launches == before
    # fp32 both sides; the Pallas A&S erf is within 1.5e-7 of erf, so the
    # tolerance of tests/test_conv_ln_pallas.py::test_fwd_matches_xla holds
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_ln_gelu_wrapper_checks_shapes():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="shape"):
        conv_ln.fused_ln_gelu(x, torch.ones(7), torch.zeros(8))


def test_wire_matches_jax():
    rng = np.random.default_rng(5)
    w = rng.normal(0, 0.3, (3, 1000)).astype(np.float32)
    w[0, :10] = 0.0
    w[1, :10] = 1e-6                     # below half an LSB: kept nonzero
    w[2, :10] = 2.0                      # saturates
    q = wire.quantize_wire(w)
    np.testing.assert_array_equal(q, jax_wire.quantize_wire(w))
    np.testing.assert_array_equal((q != 0), (w != 0))
    got = wire.dequantize_wire(torch.from_numpy(q))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_wire.dequantize_wire(jnp.asarray(q))))
    f = torch.from_numpy(w)
    assert wire.dequantize_wire(f) is f
