"""The optimizer's update (train/optim.py `adamw`): on the CPU the plain
version, `adamw_plain`, against what `AdamWGroup.step` computed before the
update had a kernel, bit for bit (the digests below were taken from that
loop); `launch_tables`, which cuts a group into the kernel's launches; the
wrapper's checks. On the card (the tests marked `card`, which skip
without one) csrc/adamw.cu against `adamw_plain` on the same CUDA tensors,
bit for bit, and the launches of a train step. The file imports neither
JAX nor the JAX package, so the card tests run on a machine without them:

    python3 -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_adamw.py
"""

import hashlib
import os

import numpy as np
import pytest
import torch

from wav2vec_contr_loss_torch.train import optim
from wav2vec_contr_loss_torch.train.optim import AdamWGroup, GroupedAdamW

torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT",
                                                "1"))))

DTYPES = [(torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
          (torch.float32, torch.bfloat16), (torch.float32, torch.float32)]
HYPER = dict(lr=1e-2, weight_decay=3e-3, b1=0.9, b2=0.999, eps=1e-8)

# ---- on the CPU -------------------------------------------------------

SHAPES = [(7, 5), (5,), (0,), (3, 4, 2), (13,), (1,)]
MISSING = {0: 4, 1: 3, 2: 3}      # step -> the parameter left without gradient
GRAD_SCALE = (1.0, 0.3, 2.0)
# sha256 (first 16 hex digits) of the bits of every parameter, then every
# first and second moment, after `three_steps`, as the per-parameter loop
# of AdamWGroup.step computed them before `adamw` (clip 'none': no clip;
# 'group': the group's own clip at 0.5; 'all': GroupedAdamW's clip at 0.5
# over two groups)
PARENT = {
    ("bfloat16", "bfloat16", "none"): "19f95bfa69116c03",
    ("bfloat16", "bfloat16", "group"): "184daa03a5c5b72b",
    ("bfloat16", "bfloat16", "all"): "b49a2f1cd28d75b9",
    ("bfloat16", "float32", "none"): "f0b3e903a7083f58",
    ("bfloat16", "float32", "group"): "1e9ec0f87df8e566",
    ("bfloat16", "float32", "all"): "41eb23b1b2c9eeb1",
    ("float32", "bfloat16", "none"): "d285d5855c004500",
    ("float32", "bfloat16", "group"): "8302b0dbdbae3773",
    ("float32", "bfloat16", "all"): "2b15c452d9111442",
    ("float32", "float32", "none"): "8110fa1d49cb667f",
    ("float32", "float32", "group"): "6819e115e15c7926",
    ("float32", "float32", "all"): "fe940a51b1dd9c75",
}


def bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bit patterns (so +0 and -0, and NaNs, compare by
    their bits)."""
    t = t.detach().contiguous()
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def three_steps(mu_dtype, nu_dtype, clip: str) -> str:
    """Three steps of AdamWGroup / GroupedAdamW on the CPU over SHAPES (an
    empty parameter among them), one parameter a step left without a
    gradient, the gradients' scale changing -> the digest of the bits."""
    rng = np.random.default_rng(7)
    params = [torch.nn.Parameter(torch.from_numpy(
        rng.normal(0, 1, s).astype(np.float32))) for s in SHAPES]
    if clip == "all":
        groups = [AdamWGroup(params[:2], 1e-2, 3e-3, mu_dtype, nu_dtype),
                  AdamWGroup(params[2:], 5e-3, 1e-4, mu_dtype, nu_dtype)]
        opt = GroupedAdamW({"a": groups[0], "b": groups[1]}, clip=0.5)
    else:
        groups = [AdamWGroup(params, 1e-2, 3e-3, mu_dtype, nu_dtype,
                             clip=0.5 if clip == "group" else None)]
        opt = groups[0]
    for step, s in enumerate(GRAD_SCALE):
        for i, p in enumerate(params):
            p.grad = None if i == MISSING[step] else torch.from_numpy(
                rng.normal(0, s, p.shape).astype(np.float32))
        opt.step()
    h = hashlib.sha256()
    for t in params + [m for g in groups for m in g.mu + g.nu]:
        h.update(bits(t).numpy().tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("clip", ["none", "group", "all"])
@pytest.mark.parametrize("mu_dtype,nu_dtype", DTYPES)
def test_the_plain_update_is_the_loop_it_replaced(mu_dtype, nu_dtype, clip):
    key = (str(mu_dtype).split(".")[1], str(nu_dtype).split(".")[1], clip)
    assert three_steps(mu_dtype, nu_dtype, clip) == PARENT[key]


def test_the_plain_update_reads_a_missing_gradient_as_zeros():
    base = torch.from_numpy(
        np.random.default_rng(3).normal(0, 1, (6, 4)).astype(np.float32))
    p = [base.clone(), base.clone()]
    m = [torch.zeros(6, 4, dtype=torch.bfloat16) for _ in range(4)]
    scale = torch.tensor(0.25)
    optim.adamw(p[:1], [None], m[:1], m[1:2], count=2, scale=scale, **HYPER)
    optim.adamw(p[1:], [torch.zeros(6, 4)], m[2:3], m[3:], count=2,
                scale=scale, **HYPER)
    for a, b in zip(p[:1] + m[:2], p[1:] + m[2:]):
        assert torch.equal(bits(a), bits(b))


def kernel_blocks(tables, numels, chunk):
    """Each element's visits when every block of every table runs the
    kernel's search: the last tensor whose first block is <= the block,
    then `chunk` elements of it from (block - first) * chunk."""
    seen = [np.zeros(n, np.int64) for n in numels]
    for idx, firsts, blocks in tables:
        for b in range(blocks):
            lo, hi = 0, len(firsts) - 1
            while lo < hi:
                mid = (lo + hi + 1) // 2
                if firsts[mid] <= b:
                    lo = mid
                else:
                    hi = mid - 1
            n = numels[idx[lo]]
            start = (b - firsts[lo]) * chunk
            assert start < n            # no block without elements
            seen[idx[lo]][start:min(n, start + chunk)] += 1
    return seen


@pytest.mark.parametrize("capacity,chunk", [(5, 8), (3, 1), (640, 4096)])
def test_launch_tables_cover_every_element_once(capacity, chunk):
    rng = np.random.default_rng(capacity)
    numels = [int(n) for n in rng.integers(0, 40, 23)] + [0, 1, chunk,
                                                           chunk + 1]
    numels[3] = 0
    tables = optim.launch_tables(numels, capacity, chunk)
    nonempty = [i for i, n in enumerate(numels) if n]
    assert [i for idx, _, _ in tables for i in idx] == nonempty
    assert len(tables) == -(-len(nonempty) // capacity)
    assert all(len(idx) <= capacity for idx, _, _ in tables)
    for seen, n in zip(kernel_blocks(tables, numels, chunk), numels):
        assert seen.shape == (n,) and (seen == 1).all()


def test_a_group_of_empty_tensors_takes_no_launch():
    assert optim.launch_tables([0, 0], 640, 4096) == []


def refused(case: str, device="cpu"):
    """Tensors that the kernel's wrapper refuses, by case."""
    p, g = (torch.zeros(4, 6, device=device) for _ in range(2))
    m, v = (torch.zeros(4, 6, dtype=torch.bfloat16, device=device)
            for _ in range(2))
    if case == "bf16 parameter":
        p = p.bfloat16()
    elif case == "fp16 moment":
        m = m.half()
    elif case == "gapped parameter":
        p = torch.zeros(4, 12, device=device)[:, ::2]
        g, m, v = (torch.empty_strided(p.shape, p.stride(), dtype=t.dtype,
                                       device=device) for t in (g, m, v))
    elif case == "gradient in another layout":
        g = torch.zeros(6, 4, device=device).t()
    elif case == "moment of another shape":
        v = torch.zeros(24, dtype=torch.bfloat16, device=device)
    return [p], [g], [m], [v]


@pytest.mark.parametrize("case", ["bf16 parameter", "fp16 moment",
                                  "gapped parameter",
                                  "gradient in another layout",
                                  "moment of another shape"])
def test_the_kernel_wrapper_refuses_what_the_kernel_does_not_take(case):
    with pytest.raises(ValueError, match="AdamW kernel|another shape"):
        optim._check_cuda(*refused(case))


def test_the_kernel_wrapper_takes_a_transposed_parameter():
    """A transposed weight (as the weight bridge leaves it) is one dense
    block of memory; its gradient and moments share its strides."""
    p = torch.zeros(6, 4).t()
    g, m, v = (torch.zeros_like(p, dtype=d) for d in
               (torch.float32, torch.bfloat16, torch.float32))
    assert not p.is_contiguous() and g.stride() == p.stride()
    optim._check_cuda([p], [g], [m], [v])
    optim._check_cuda([p], [None], [m], [v])


def test_a_group_on_neither_cpu_nor_cuda_is_refused():
    p = [torch.zeros(3, device="meta")]
    with pytest.raises(ValueError, match="CPU tensors"):
        optim.adamw(p, [None], [p[0].bfloat16()], [p[0].bfloat16()],
                    count=1, **HYPER)


# ---- on the card ------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the chip")
    return torch.device("cuda")


def twin(t: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """A zeroed tensor of t's shape, strides and storage offset, so of
    its alignment, in `dtype`."""
    extent = t.storage_offset() + (1 + sum(
        (n - 1) * st for n, st in zip(t.shape, t.stride())) if t.numel() else 0)
    return torch.zeros(extent, dtype=dtype, device=t.device).as_strided(
        t.shape, t.stride(), t.storage_offset())


def card_state(tensors, mu_dtype, nu_dtype):
    """Two copies (kernel, plain) of `tensors` as parameters and zero
    moments, each in the layout of its tensor (views at any offset and
    strides: a view one element into a buffer is misaligned)."""
    return [([twin(t).copy_(t) for t in tensors],
             [twin(t, mu_dtype) for t in tensors],
             [twin(t, nu_dtype) for t in tensors]) for _ in range(2)]


def held_bit_for_bit(sides, grads_by_step, scales):
    """Steps of the kernel on sides[0] and the plain version on sides[1];
    every parameter and moment equal in its bits after each step."""
    for step, (gs, scale) in enumerate(zip(grads_by_step, scales), 1):
        for fn, (p, m, v) in zip((optim.adamw, optim.adamw_plain), sides):
            fn(p, gs, m, v, count=step, scale=scale, **HYPER)
        torch.cuda.synchronize()
        for a, b in zip(sum(sides[0], []), sum(sides[1], [])):
            assert torch.equal(bits(a), bits(b)), f"step {step}"


@pytest.mark.card
@pytest.mark.parametrize("mu_dtype,nu_dtype", DTYPES)
def test_the_kernel_is_the_plain_update_at_xlsr300m_shapes(card, mu_dtype,
                                                          nu_dtype):
    from chip_smoke import xlsr300m_param_shapes

    gen = torch.Generator(device=card).manual_seed(5)
    shapes = xlsr300m_param_shapes()
    first = [torch.randn(s, generator=gen, device=card) for s in shapes]
    sides = card_state(first, mu_dtype, nu_dtype)
    del first
    grads_by_step, scales = [], []
    for step in range(3):
        gs = [1e-2 * torch.randn(s, generator=gen, device=card)
              for s in shapes]
        scales.append(None if step == 1 else optim.clip_scale(gs, 1.0))
        if step == 1:
            gs[7] = None
        grads_by_step.append(gs)
    n0 = optim.launches
    held_bit_for_bit(sides, grads_by_step, scales)
    tables = optim.launch_tables([int(np.prod(s)) for s in shapes],
                                 *optim.kernel_limits())
    assert optim.launches - n0 == 3 * len(tables) == 3


def odd_tensors(card, gen, count: int):
    """Tensors of ragged sizes, misaligned starts (views one element into
    a buffer), transposed and empty ones, `count` in all."""
    rng = np.random.default_rng(count)
    out = []
    for i in range(count):
        kind = i % 5
        if kind == 0:     # ragged, aligned
            out.append(torch.randn(int(rng.integers(1, 9000)),
                                   generator=gen, device=card))
        elif kind == 1:   # misaligned by one element
            n = int(rng.integers(1, 9000))
            out.append(torch.randn(n + 1, generator=gen, device=card)[1:])
        elif kind == 2:   # transposed (dense, not contiguous)
            out.append(torch.randn(int(rng.integers(1, 70)), 33,
                                   generator=gen, device=card).t())
        elif kind == 3:   # whole vectors and a whole chunk
            out.append(torch.randn(4096 * int(rng.integers(1, 3)),
                                   generator=gen, device=card))
        else:
            out.append(torch.empty(0, device=card))
    return out


@pytest.mark.card
@pytest.mark.parametrize("mu_dtype,nu_dtype", DTYPES)
def test_the_kernel_is_the_plain_update_on_odd_tensors(card, mu_dtype,
                                                       nu_dtype):
    """Ragged, misaligned, transposed and empty tensors, more than one
    launch holds, with and without a scale, gradients missing."""
    capacity, _ = optim.kernel_limits()
    gen = torch.Generator(device=card).manual_seed(9)
    tensors = odd_tensors(card, gen, capacity + capacity // 2 + 7)
    sides = card_state(tensors, mu_dtype, nu_dtype)
    grads_by_step, scales = [], []
    for step in range(3):
        gs = [None if (i + step) % 11 == 0 else
              twin(t).normal_(generator=gen) for i, t in enumerate(tensors)]
        grads_by_step.append(gs)
        scales.append(torch.tensor(0.37 + step, device=card)
                      if step != 1 else None)
    n0, t0 = optim.launches, optim.tensors
    held_bit_for_bit(sides, grads_by_step, scales)
    tables = optim.launch_tables([t.numel() for t in tensors],
                                 *optim.kernel_limits())
    assert len(tables) == 2
    assert optim.launches - n0 == 3 * len(tables)
    assert optim.tensors - t0 == 3 * sum(1 for t in tensors if t.numel())


@pytest.mark.card
@pytest.mark.parametrize("case", ["bf16 parameter", "fp16 moment",
                                  "gapped parameter",
                                  "gradient in another layout"])
def test_the_kernel_refuses_on_the_card(card, case):
    p, g, m, v = refused(case, card)
    with pytest.raises(ValueError, match="AdamW kernel"):
        optim.adamw(p, g, m, v, count=1, **HYPER)


def step_counts(layers: int):
    """One stage-1 step on the card at full width, `layers` layers, B = 4
    clips of 1 s: (optim.launches, the launches its tables need, device
    operations attributed to `w2v.optimizer`)."""
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import optimizer_tables, train_batch
    from h100bench import spans
    from wav2vec_contr_loss_torch import (XLSR_300M, Stage1Config,
                                          Stage1Trainer, jax_params_to_torch)
    from wav2vec_contr_loss_torch.bridge import random_jax_trees

    cfg = XLSR_300M.with_(num_layers=layers)
    trainer = Stage1Trainer(
        Stage1Config(finetune_encoder=True, use_rawboost=False, batch_size=4),
        cfg, jax_params_to_torch(cfg, *random_jax_trees(cfg, seed=3)),
        device="cuda")
    batch = train_batch(np.random.default_rng(0), 4, 16000)
    trainer.train_step(batch, 0.5)           # builds and warms up
    torch.cuda.synchronize()
    n0 = optim.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.train_step(batch, 0.5)
        torch.cuda.synchronize()
    names = spans.attribute(spans.stretch(prof))
    return (optim.launches - n0, optimizer_tables(trainer.optimizer),
            names.count("w2v.optimizer"))


@pytest.mark.card
def test_a_train_step_updates_in_a_few_launches(card):
    few, many = step_counts(1), step_counts(3)
    for launches, tables, _ in (few, many):
        assert launches == tables == 2       # the head, the encoder
    # the optimizer's device operations (the head's clip, the kernel)
    # do not grow with the parameters
    assert few[2] == many[2] < 20
