"""Murmur dropout through its autograd Function (ops/dropout.py
`MurmurDropout`) against the expression it replaced,
`torch.where(murmur_bits(...) >= threshold, x / (1 - rate), 0)` under
autograd, bit for bit: on the CPU (the plain version) here, and on the
card (csrc/murmur_dropout.cu) in the tests marked `card`, which skip
without one. The file imports neither JAX nor the JAX package, so the
card tests run on a machine without them:

    python3 -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_dropout.py
"""

import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from wav2vec_contr_loss_torch.ops import dropout

torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT",
                                                "1"))))

SEED = 2 ** 31 - 5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the chip")
    return torch.device("cuda")


def expression(x, seed, rate, offsets=None):
    """What `murmur_dropout` computed before it had a kernel."""
    keep = (dropout.murmur_bits(x.shape, seed, x.device, offsets)
            >= dropout.threshold(rate))
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bit patterns (so +0 and -0 differ)."""
    return t.contiguous().view({2: torch.int16, 4: torch.int32}[
        t.element_size()])


def assert_same_bits(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(bits(got), bits(want))


def forward_backward(fn, x, g):
    """fn(x) and the gradient of <fn(x), g> in x."""
    x = x.detach().clone().requires_grad_()
    y = fn(x)
    y.backward(g)
    return y.detach(), x.grad


def held_against_expression(x, seed, rate, offsets=None):
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(1)
                    ).to(x.device, x.dtype)
    got = forward_backward(
        lambda v: dropout.murmur_dropout(v, seed, rate, offsets), x, g)
    want = forward_backward(
        lambda v: expression(v, seed, rate, offsets), x, g)
    for a, b in zip(got, want):
        assert_same_bits(a, b)
    return got


def cpu_input(shape, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return (3.0 * torch.randn(shape, generator=gen)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(6, 37), (3, 19, 40), (2, 3, 5, 24)])
@pytest.mark.parametrize("rate", [0.1, 0.45])
def test_function_equals_the_expression_on_the_cpu(dtype, shape, rate):
    before = (dropout.launches, dropout.bwd_launches)
    y, dx = held_against_expression(cpu_input(shape, dtype), SEED, rate)
    dropped = (y == 0).float().mean().item()
    assert abs(dropped - rate) < 0.1
    # the plain version launches nothing
    assert (dropout.launches, dropout.bwd_launches) == before
    assert_same_bits(y, dropout.murmur_dropout_plain(
        cpu_input(shape, dtype), SEED, rate))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_offsets_draw_the_slice_of_the_larger_mask(dtype):
    full_x = cpu_input((6, 11, 32), dtype, seed=2)
    full = dropout.murmur_dropout(full_x, 77, 0.3)
    part_x = full_x[2:5, 3:11, 8:24]
    offsets = (2, 3, 8)
    y, _ = held_against_expression(part_x, 77, 0.3, offsets)
    assert_same_bits(y, full[2:5, 3:11, 8:24])


def test_a_non_contiguous_input_is_the_expression():
    x = cpu_input((4, 24, 16), torch.bfloat16).transpose(1, 2)
    held_against_expression(x, 5, 0.2)


@pytest.mark.parametrize("rate", [0.0, -0.1])
def test_rate_zero_returns_x_itself(rate):
    x = cpu_input((3, 8), torch.float32)
    assert dropout.murmur_dropout(x, 1, rate) is x


# ---- on the card ------------------------------------------------------

CARD_CASES = [
    # the step's activations, bf16
    ((32, 249, 1024), torch.bfloat16, None),
    # the compression head's input, fp32
    ((32, 249, 1024), torch.float32, None),
    # innermost sizes that are no multiple of the 16-byte vector
    ((3, 7, 1001), torch.bfloat16, None),
    ((5, 13), torch.float32, None),
    ((2, 3, 5, 7), torch.bfloat16, None),
    # a gang's shard: batch rows 8-15, frames from 100, features 512-1023
    ((8, 149, 512), torch.bfloat16, (8, 100, 512)),
    ((8, 149, 512), torch.float32, (8, 100, 512)),
    # unit axes, away from the origin and at it
    ((1, 249, 1024), torch.bfloat16, (5, 0, 0)),
    ((4, 1, 64), torch.bfloat16, None),
    ((1000,), torch.float32, (17,)),
]


@pytest.mark.card
@pytest.mark.parametrize("shape,dtype,offsets", CARD_CASES)
def test_kernel_equals_the_expression_on_the_card(card, shape, dtype,
                                                  offsets):
    gen = torch.Generator(device=card).manual_seed(3)
    x = (2.0 * torch.randn(shape, generator=gen, device=card)).to(dtype)
    for rate in (0.1, 0.3):
        n, m = dropout.launches, dropout.bwd_launches
        held_against_expression(x, SEED, rate, offsets)
        assert (dropout.launches - n, dropout.bwd_launches - m) == (1, 1)


@pytest.mark.card
@pytest.mark.parametrize("rate", [0.05, 0.1, 0.2, 0.5, 0.9])
def test_every_bf16_value_scales_as_the_division_does(card, rate):
    """All 65,536 bf16 bit patterns (NaNs as 0), and fp32 values of
    magnitudes 1e-20 to 1e12, in forward and backward."""
    every = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(
        torch.int16).view(torch.bfloat16).view(64, 1024)
    every = torch.where(torch.isnan(every), torch.zeros_like(every), every)
    held_against_expression(every.to(card), 11, rate)
    rng = np.random.default_rng(0)
    x32 = (rng.standard_normal((64, 1024))
           * 10.0 ** rng.uniform(-20, 12, (64, 1024))).astype(np.float32)
    held_against_expression(torch.from_numpy(x32).to(card), 11, rate)


@pytest.mark.card
def test_a_misaligned_or_strided_input_on_the_card(card):
    buf = torch.randn(1 + 6 * 64, device=card).to(torch.bfloat16)
    misaligned = buf[1:].view(6, 64)          # contiguous, 2 bytes off
    assert misaligned.data_ptr() % 16
    held_against_expression(misaligned, 9, 0.1)
    strided = torch.randn(4, 64, 24, device=card).transpose(1, 2)
    held_against_expression(strided, 9, 0.1)
    scalar = torch.tensor(3.0, device=card)
    held_against_expression(scalar, 9, 0.5)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_the_kernel_refuses_other_dtypes(card, dtype):
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        dropout.murmur_dropout(torch.ones(4, 8, dtype=dtype, device=card),
                               1, 0.1)


def _train_step_counts(remat: bool):
    """Launch counts and `w2v.dropout` ranges of one stage-1 step on the
    card, at full width and 2 layers, B = 4 clips of 1 s."""
    from chip_smoke import train_batch
    from wav2vec_contr_loss_torch import (XLSR_300M, Stage1Config,
                                          Stage1Trainer, jax_params_to_torch)
    from wav2vec_contr_loss_torch.bridge import random_jax_trees

    cfg = XLSR_300M.with_(num_layers=2)
    trainer = Stage1Trainer(
        Stage1Config(finetune_encoder=True, use_rawboost=False, batch_size=4,
                     remat_encoder=remat),
        cfg, jax_params_to_torch(cfg, *random_jax_trees(cfg, seed=3)),
        device="cuda")
    batch = train_batch(np.random.default_rng(0), 4, 16000)
    trainer.train_step(batch, 0.5)           # builds and warms up
    n, m = dropout.launches, dropout.bwd_launches
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_step(batch, 0.5)
    torch.cuda.synchronize()
    events = prof.events()
    drops = [e for e in events if e.name == "w2v.dropout"]
    forward = [e for e in events if e.name == "w2v.forward"]
    in_forward = [d for d in drops if any(
        f.time_range.start <= d.time_range.start
        and d.time_range.end <= f.time_range.end for f in forward)]
    return (dropout.launches - n, dropout.bwd_launches - m, len(drops),
            len(in_forward), cfg)


@pytest.mark.card
@pytest.mark.parametrize("remat", [False, True])
def test_a_train_step_launches_once_a_call(card, remat):
    fwd, bwd, drops, in_forward, cfg = _train_step_counts(remat)
    # feature projection, the encoder's input, the compression head, and
    # attention_out and ffn_out in each layer (activation dropout 0)
    assert in_forward == 3 + 2 * cfg.num_layers
    assert bwd == in_forward
    assert fwd == drops
    assert drops >= in_forward + (cfg.num_layers if remat else 0)
