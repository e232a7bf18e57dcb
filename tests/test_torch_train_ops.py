"""The training slice's kernel wrappers and helpers on the CPU (their plain
PyTorch versions, differentiated by autograd) against the JAX package:
the murmur hashes bit for bit, attention forward and backward with
dropout and the LN+GELU backward against the Pallas
kernels in interpret mode, and SpecAugment's spans on the same uniforms.
The loss and the optimizer are in test_torch_supcon_optim.py. The CUDA
and Triton kernels themselves run only on the card (chip_smoke.py holds
them against these plain versions)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wav2vec_contr_loss_tpu.models.wav2vec2 import _time_mask_spans
from wav2vec_contr_loss_tpu.ops.attention_pallas import (
    _random_bits, fused_attention as jax_fused_attention)
from wav2vec_contr_loss_tpu.ops.conv_ln_pallas import \
    fused_ln_gelu as jax_fused_ln_gelu
from wav2vec_contr_loss_tpu.ops.fast_dropout import \
    murmur_bits as jax_murmur_bits

from tests.test_torch_bridge import jax_config, port_config
from wav2vec_contr_loss_torch.models.wav2vec2 import (max_mask_spans,
                                                      time_mask_spans)
from wav2vec_contr_loss_torch.ops import attention, conv_ln, dropout

from tests.test_torch_bridge import cap_torch_threads

cap_torch_threads()


@pytest.mark.parametrize("shape,seed", [
    ((3, 1, 5, 7), 2 ** 31 - 2), ((1, 4), 0), ((2, 3, 1), 12345),
    ((4, 9, 16), 2 ** 31 - 1), ((1,), 7)])
def test_murmur_bits_bit_identical(shape, seed):
    want = np.asarray(jax_murmur_bits(shape, jnp.int32(seed))).astype(np.int64)
    got = dropout.murmur_bits(shape, seed)
    assert got.dtype == torch.int64 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_murmur_dropout_keeps_the_jax_elements():
    x = torch.ones(6, 50, 8, dtype=torch.bfloat16)
    got = dropout.murmur_dropout(x, 99, 0.3)
    bits = np.asarray(jax_murmur_bits(x.shape, jnp.int32(99)))
    keep = bits >= np.uint32(dropout.threshold(0.3))
    np.testing.assert_array_equal(got.float().numpy() != 0, keep)
    np.testing.assert_array_equal(got.float().numpy()[keep],
                                  (x / 0.7).float().numpy()[keep])
    assert dropout.murmur_dropout(x, 99, 0.0) is x


@pytest.mark.parametrize("seed,rate", [(7, 0.3), (2 ** 31 - 3, 0.1),
                                       (0, 0.5)])
def test_attention_mask_bit_identical(seed, rate):
    b, h, t = 2, 3, 19
    got = dropout.attention_dropout_mask(b, h, t, seed, rate).numpy()
    thr = np.uint32(dropout.threshold(rate))
    for bi in range(b):
        for hi in range(h):
            # _head_seed: seed + program_id * heads + h, in int32
            s = jnp.int32(seed) + jnp.int32(bi * h + hi)
            bits = np.asarray(_random_bits((t, t), s))
            want = np.where(bits >= thr, np.float32(1.0 / (1.0 - rate)),
                            np.float32(0.0))
            np.testing.assert_array_equal(got[bi, hi], want)


def _bf16_valued(rng, shape, scale=1.0):
    x = torch.from_numpy((rng.normal(0, 1, shape) * scale).astype(np.float32))
    return x.to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_attention_fwd_bwd_match_pallas(rate):
    rng = np.random.default_rng(4)
    b, h, t, d, seed = 2, 3, 40, 16, 1234
    q = _bf16_valued(rng, (b, h, t, d), d ** -0.5)
    k, v, g = (_bf16_valued(rng, (b, h, t, d)) for _ in range(3))
    bias = np.zeros((b, t), np.float32)
    bias[1, -9:] = -1e30                 # padded key tail
    j = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want, vjp = jax.vjp(lambda q_, k_, v_: jax_fused_attention(
        q_, k_, v_, jnp.asarray(bias), seed, rate, h), *j)
    want_grads = vjp(jnp.asarray(g, jnp.bfloat16))

    ts = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
          for a in (q, k, v)]
    before = attention.launches, attention.bwd_launches
    out = attention.fused_attention(*ts, torch.from_numpy(bias), seed, rate,
                                    h)
    grads = torch.autograd.grad(out, ts,
                                torch.from_numpy(g).to(torch.bfloat16))
    assert (attention.launches, attention.bwd_launches) == before
    # bf16 rounding at different places on the two sides; the tolerances
    # of tests/test_attention_pallas.py (forward, then gradients)
    np.testing.assert_allclose(out.float().detach().numpy(),
                               np.asarray(want, np.float32),
                               atol=2e-3, rtol=2e-2)
    for name, a, w in zip("qkv", grads, want_grads):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(w, np.float32),
                                   atol=5e-2, rtol=5e-2, err_msg=f"d{name}")


def test_attention_rate_changes_the_output():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(_bf16_valued(rng, (1, 2, 24, 8)))
               .to(torch.bfloat16) for _ in range(3))
    bias = torch.zeros(1, 24)
    a = attention.fused_attention(q, k, v, bias, 5, 0.5, 2)
    assert torch.equal(a, attention.fused_attention(q, k, v, bias, 5, 0.5, 2))
    assert not torch.equal(a, attention.fused_attention(q, k, v, bias, 6,
                                                        0.5, 2))


@pytest.mark.parametrize("gelu", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_gelu_bwd_matches_pallas(dtype, gelu):
    rng = np.random.default_rng(1)
    shape = (1, 300, 256)                # 300 rows: a ragged final block
    x = rng.normal(0, 2, shape).astype(np.float32)
    dy = rng.normal(0, 1, shape).astype(np.float32)
    scale = rng.normal(1, 0.2, shape[-1]).astype(np.float32)
    bias = rng.normal(0, 0.3, shape[-1]).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    _, vjp = jax.vjp(lambda x_, s_, b_: jax_fused_ln_gelu(x_, s_, b_, 1e-5,
                                                         gelu),
                     jnp.asarray(x, jdt), jnp.asarray(scale),
                     jnp.asarray(bias))
    want = vjp(jnp.asarray(dy, jdt))

    ins = [torch.from_numpy(x).to(tdt).requires_grad_(),
           torch.from_numpy(scale).requires_grad_(),
           torch.from_numpy(bias).requires_grad_()]
    before = conv_ln.launches, conv_ln.bwd_launches
    out = conv_ln.fused_ln_gelu(*ins, 1e-5, gelu)
    got = torch.autograd.grad(out, ins, torch.from_numpy(dy).to(tdt))
    assert (conv_ln.launches, conv_ln.bwd_launches) == before
    # the tolerances of tests/test_conv_ln_pallas.py::test_grads_match_xla
    tol = (dict(rtol=1e-4, atol=1e-4) if dtype == "float32"
           else dict(rtol=2e-2, atol=2e-2))
    for name, a, w in zip(("dx", "dscale", "dbias"), got, want):
        assert a.dtype == (tdt if name == "dx" else torch.float32)
        np.testing.assert_allclose(a.float().numpy(), np.asarray(w, np.float32),
                                   **tol, err_msg=name)


@pytest.mark.parametrize("t_frames,prob,length", [(249, 0.075, 10),
                                                  (49, 0.3, 4)])
def test_spec_augment_spans_match_jax(t_frames, prob, length):
    cfg = jax_config("xlsr", mask_time_prob=prob, mask_time_length=length)
    lengths = np.array([t_frames, t_frames // 2, 3, 0, 9], np.int32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(_time_mask_spans(key, jnp.asarray(lengths), t_frames,
                                       cfg))
    # the uniforms _time_mask_spans draws from its key, handed to the port
    k_eps, k_start = jax.random.split(key)
    s = max_mask_spans(t_frames, port_config(cfg))
    eps = np.array(jax.random.uniform(k_eps, (len(lengths),)))
    u = np.array(jax.random.uniform(k_start, (len(lengths), s)))
    got = time_mask_spans(torch.from_numpy(lengths).long(), t_frames,
                          port_config(cfg), torch.from_numpy(eps),
                          torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0].any() and not want[3].any()
