"""The positional conv of ops/pos_conv.py: its plain path against
F.conv1d on the CPU, the index arithmetic its kernels rely on (the
tap-major weight read forward, transposed and flipped; the chunk-major
operands of the weight gradient), the routing, the benchmark's bound and
reader; and, marked `card`, the kernels (csrc/pos_conv.cu) on the card
against an fp64 F.conv1d of the same bf16 values.

Card tolerances: the kernels multiply bf16 values exactly and sum in
fp32 (15,360 products an output at 2B; 7,968 frames a weight) in another
order than fp64, and round each conv output once to bf16: an output is
held to 2^-8 of its value (one bf16 rounding, with room) plus 1e-4 of the
largest (fp32 sums in another order); the weight gradient, fp32 with no
rounding to bf16, to 1e-4 of its value plus 1e-5 of the largest.

The file imports neither JAX nor the JAX package, so on the card:

    python3 -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_pos_conv.py
"""

import os
import types

import pytest
import torch
import torch.nn.functional as F

from h100bench import spec
from wav2vec_contr_loss_torch.ops import pos_conv as pc

BF16 = torch.bfloat16


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the chip")
    return torch.device("cuda")


def _inputs(b, t, d, groups, k, dtype=torch.float32, device="cpu", seed=0):
    gen = torch.Generator().manual_seed(seed)
    c = d // groups
    x = torch.randn(b, t, d, generator=gen).to(dtype)
    w = torch.randn(d, c, k, generator=gen) * (c * k) ** -0.5
    bias = torch.randn(d, generator=gen)
    return x.to(device), w.to(device), bias.to(device)


@pytest.mark.parametrize("d, groups, k, t", [
    (240, 2, 16, 37),     # groups of 120, even kernel
    (160, 2, 7, 37),      # groups of 80, odd kernel
    (128, 2, 16, 37),     # groups of 64
    (240, 2, 128, 37),    # fewer frames than taps, XLS-R's kernel
])
def test_plain_path_is_the_grouped_conv(d, groups, k, t):
    """On the CPU the Function's plain forward and backward, the input
    gradient a forward conv of the flipped weight, equal F.conv1d's output
    and gradients in fp32."""
    x, w, bias = _inputs(2, t, d, groups, k)
    x.requires_grad_()
    w.requires_grad_()
    bias.requires_grad_()
    got = pc.pos_conv(x, w, bias, k // 2, groups)
    want = F.conv1d(x.transpose(1, 2), w, bias, 1, k // 2,
                    groups=groups).transpose(1, 2)
    assert got.shape == want.shape == (2, t + 2 * (k // 2) - k + 1, d)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    g = torch.randn_like(want)
    leaves = [x, w, bias]
    for a, b in zip(torch.autograd.grad((got * g).sum(), leaves),
                    torch.autograd.grad((want * g).sum(), leaves)):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-5)


def _tap_block(wt, g, k):
    """The kernel's C x C block of tap k, [o, i], from the tap-major
    weight's (C/8, C, 8) rows."""
    blk = wt[g, k]
    return blk.permute(1, 0, 2).reshape(blk.shape[1], -1)


@pytest.mark.parametrize("c", [64, 80, 120])
def test_tap_major_products_are_the_conv_and_its_input_gradient(c):
    """The kernel's arithmetic on the tap-major weight, emulated: the
    forward sums the window shifted by each tap times that tap's block;
    the input gradient reads tap K - 1 - k of the same blocks transposed,
    padded K - 1 - padding. Both equal F.conv1d and autograd's input
    gradient."""
    b, t, groups, k, pad = 2, 19, 2, 9, 4
    x, w, _ = _inputs(b, t, groups * c, groups, k, torch.float64)
    w = w.double()
    wt = pc.tap_major(w, groups, torch.float64)
    assert wt.shape == (groups, k, c // 8, c, 8)
    for gi, ki, i, o in ((0, 0, 0, 0), (1, k - 1, c - 1, 3), (1, 4, 17, c - 1)):
        assert wt[gi, ki, i // 8, o, i % 8] == w[gi * c + o, i, ki]

    def conv(a, pad, flip):
        t_out = a.shape[1] + 2 * pad - k + 1
        ap = F.pad(a, (0, 0, pad, pad))
        out = torch.zeros(b, t_out, groups * c, dtype=a.dtype)
        for gi in range(groups):
            cols = slice(gi * c, (gi + 1) * c)
            for tap in range(k):
                blk = _tap_block(wt, gi, k - 1 - tap if flip else tap)
                out[:, :, cols] += ap[:, tap:tap + t_out, cols] @ (
                    blk if flip else blk.T)
        return out

    y = conv(x, pad, False)
    want = F.conv1d(x.transpose(1, 2), w, None, 1, pad,
                    groups=groups).transpose(1, 2)
    torch.testing.assert_close(y, want, atol=1e-12, rtol=1e-12)
    gy = torch.randn_like(y)
    xg = x.clone().requires_grad_()
    (F.conv1d(xg.transpose(1, 2), w, None, 1, pad, groups=groups)
     .transpose(1, 2) * gy).sum().backward()
    torch.testing.assert_close(conv(gy, k - 1 - pad, True), xg.grad,
                               atol=1e-12, rtol=1e-12)


def test_chunk_major_operands_give_the_weight_gradient():
    """The weight-gradient kernel's operands, (B, D/8, T, 8) columns of 8
    channels: [b, j, t, e] = a[b, t, 8 j + e]; the products of gy's
    columns with x's rows shifted by each tap are autograd's dW."""
    b, t, groups, c, k, pad = 2, 13, 2, 16, 5, 2
    x, w, _ = _inputs(b, t, groups * c, groups, k, torch.float64)
    w = w.double().requires_grad_()
    y = F.conv1d(x.transpose(1, 2), w, None, 1, pad, groups=groups)
    gy = torch.randn_like(y).transpose(1, 2).contiguous()
    (y.transpose(1, 2) * gy).sum().backward()
    xc, gc = pc.chunk_major(x), pc.chunk_major(gy)
    assert xc.shape == (b, groups * c // 8, t, 8)
    assert xc[1, 3, 5, 6] == x[1, 5, 30]
    dw = torch.zeros_like(w)
    t_out = gy.shape[1]
    xp = F.pad(xc, (0, 0, pad, pad))       # frames out of range are zeros
    for gi in range(groups):
        g_cols = gc[:, gi * c // 8:(gi + 1) * c // 8].permute(0, 2, 1, 3)
        for tap in range(k):
            x_rows = xp[:, gi * c // 8:(gi + 1) * c // 8,
                        tap:tap + t_out].permute(0, 2, 1, 3)
            dw[gi * c:(gi + 1) * c, :, tap] = torch.einsum(
                "bto,bti->oi", g_cols.reshape(b, t_out, c),
                x_rows.reshape(b, t_out, c))
    torch.testing.assert_close(dw, w.grad, atol=1e-12, rtol=1e-12)


@pytest.mark.parametrize("device, dtype, width, takes", [
    ("cuda", BF16, 120, True),            # XLS-R 2B
    ("cuda", BF16, 80, True),             # XLS-R 1B
    ("cuda", torch.float16, 120, False),  # not a compute dtype: cuDNN
    ("cuda", BF16, 64, False),            # XLS-R 300M: cuDNN
    ("cuda", BF16, 48, False),            # wav2vec2-base: cuDNN
    ("cuda", BF16, 32, False),            # doctor's tiny encoder: cuDNN
    ("cuda", torch.float32, 120, False),  # fp32 compute: cuDNN in fp32
    ("cpu", BF16, 120, False),
])
def test_routing(device, dtype, width, takes):
    """A bf16 tensor on the card at a width the kernels are built for
    takes them; nothing else does, so no width that ran before the
    kernels raises now."""
    x = types.SimpleNamespace(device=torch.device(device), dtype=dtype)
    assert pc.routed(x, width) is takes


@pytest.mark.parametrize("dtype, d, width, k, t, match", [
    (torch.float16, 1920, 120, 128, 249, "bfloat16"),
    (torch.float32, 1920, 120, 128, 249, "bfloat16"),
    (BF16, 1920, 96, 128, 249, "groups"),
    (BF16, 1920, 64, 128, 249, "groups"),
    (BF16, 1920, 120, 130, 249, "taps"),
    (BF16, 1920, 120, 128, 0, "output frame"),
    (BF16, 1024, 120, 128, 249, "x"),
])
def test_launch_refuses_what_the_kernels_do_not_take(dtype, d, width, k, t,
                                                     match):
    x = torch.zeros(1, 4, 1920, dtype=dtype)
    with pytest.raises(ValueError, match=match):
        pc.check_launch(x, d, width, k, t)


def _reader():
    return spec.metric_reader(spec.HERE, "pos_conv_roofline.train")


def test_bound_of_one_conv_at_2b():
    """One conv at (32, 249, 1920, 16 groups, kernel 128) in bf16:
    470 GFLOP at 989 TFLOP/s, 0.4752 ms; its ~120 MB take 36 us."""
    read = _reader()
    fn = read.__globals__["pos_conv"]
    assert round(fn(32, 249, 1920, 16, 128, "bfloat16") * 1e3, 4) == 0.4752
    assert read.__globals__["geometry"](1920, 16, "bfloat16") == (16, 128)


def test_reader_refuses_configurations_that_disagree(tmp_path):
    """Two configurations of the traced width, heads and dtype with
    different positional convs: the reader cannot tell which ran, and
    raises; with none, there is nothing to read."""
    read = _reader()
    cfgs = []
    for i, (groups, k) in enumerate(((16, 128), (16, 64))):
        (tmp_path / f"c{i}.json").write_text(
            '{"hidden_size": 1920, "num_attention_heads": 16, '
            '"compute_dtype": "bfloat16", "num_conv_pos_embedding_groups": '
            f'{groups}, "num_conv_pos_embeddings": {k}}}')
        cfgs.append({"file": f"c{i}.json"})
    fake = types.SimpleNamespace(ROOT=str(tmp_path),
                                 benchmark=lambda: {"configs": cfgs})
    geometry = read.__globals__["geometry"]
    real = read.__globals__["spec"]
    read.__globals__["spec"] = fake
    try:
        with pytest.raises(ValueError, match="disagree"):
            geometry(1920, 16, "bfloat16")
        assert geometry(1280, 16, "bfloat16") is None
    finally:
        read.__globals__["spec"] = real


def _ctx(trace):
    class Traced:
        counters = {}

    return {"kind": "train", "batch": 32, "heads": 16, "head_dim": 120,
            "frames": 249, "dtype": "bfloat16", "trace": trace,
            "traced": Traced()}


def test_reader_needs_the_function_ranges():
    """Nothing to read in a trace without the Function's ranges (a cell
    whose positional conv runs cuDNN) or without a trace; with them, the
    three convs' bound over the device time they launched."""
    from h100bench import trace as tr

    read = _reader()
    assert read(_ctx(None)) is None
    other = tr.Trace([("kernel", 20.0, 900.0, 0)], {0: (1, 10.0)},
                     [("FusedAttention", 1, 0.0, 100.0)])
    assert read(_ctx(other)) is None
    ranges = tr.Trace([("kernel", 20.0, 1000.0, 0), ("kernel", 1020.0, 2000.0, 1)],
                      {0: (1, 10.0), 1: (1, 1010.0)},
                      [("_GroupConv", 1, 0.0, 100.0),
                       ("_GroupConvBackward", 1, 1000.0, 100.0)])
    bound = read.__globals__["pos_conv"](32, 249, 1920, 16, 128)
    assert read(_ctx(ranges)) == pytest.approx(100.0 * 3 * bound / 3e-3)


# ---- on the card ----

def _held(got, want, rtol, atol_share):
    err = (got.double() - want).abs()
    limit = rtol * want.abs() + atol_share * want.abs().max()
    assert bool((err <= limit).all()), (
        f"worst excess {float((err - limit).max()):.3e}, max error "
        f"{float(err.max()):.3e}")


def _fp64_reference(x, w, bias, pad, groups, gy):
    """Output, input gradient, weight gradient and bias gradient of an
    fp64 F.conv1d of the bf16 values, on the card."""
    xd = x.double().requires_grad_()
    wd = w.to(BF16).double().requires_grad_()
    bd = bias.to(BF16).double().requires_grad_()
    y = F.conv1d(xd.transpose(1, 2), wd, bd, 1, pad,
                 groups=groups).transpose(1, 2)
    dx, dw, db = torch.autograd.grad(y, [xd, wd, bd], gy.double())
    return y.detach(), dx, dw, db


@pytest.mark.card
@pytest.mark.parametrize("b, t, d, groups", [
    (32, 249, 1920, 16),    # XLS-R 2B at the training shape
    (3, 37, 1920, 16),      # ragged: fewer frames than taps
    (3, 300, 1280, 16),     # XLS-R 1B's groups of 80, two frame tiles
    (2, 37, 240, 2),        # two groups of 120: the first group's zero
    (2, 300, 160, 2),       # chunk and the last's are at the tensor's edge
])
def test_card_kernels_against_fp64(card, b, t, d, groups):
    k, pad = 128, 64
    x, w, bias = _inputs(b, t, d, groups, k, BF16, card, seed=b + t)
    x.requires_grad_()
    w.requires_grad_()
    bias.requires_grad_()
    y = pc.pos_conv(x, w, bias, pad, groups)
    gy = torch.randn(y.shape, device=card).to(BF16)
    dx, dw, db = torch.autograd.grad(y, [x, w, bias], gy)
    torch.cuda.synchronize()
    ry, rdx, rdw, rdb = _fp64_reference(x.detach(), w.detach(),
                                        bias.detach(), pad, groups, gy)
    assert y.dtype == dx.dtype == BF16 and dw.dtype == torch.float32
    _held(y, ry, 2 ** -8, 1e-4)
    _held(dx, rdx, 2 ** -8, 1e-4)
    _held(dw, rdw, 1e-4, 1e-5)
    _held(db, rdb, 1e-4, 1e-5)


@pytest.mark.card
def test_card_weight_gradient_is_bit_identical(card):
    x, w, _ = _inputs(32, 249, 1920, 16, 128, BF16, card, seed=7)
    w.requires_grad_()
    gy = torch.randn(32, 250, 1920, device=card).to(BF16)
    grads = [torch.autograd.grad(pc.pos_conv(x, w, None, 64, 16), w, gy)[0]
             for _ in range(2)]
    assert torch.equal(grads[0], grads[1])


@pytest.mark.card
@pytest.mark.parametrize("d, groups, k, launches", [
    (1920, 16, 128, (2, 1)),   # XLS-R 2B: the kernels
    (1280, 16, 128, (2, 1)),   # XLS-R 1B
    (1024, 16, 128, (0, 0)),   # XLS-R 300M: cuDNN at 64-wide groups
    (768, 16, 128, (0, 0)),    # wav2vec2-base: cuDNN at 48
    (128, 4, 16, (0, 0)),      # doctor's tiny encoder: cuDNN at 32
])
def test_card_launches_of_a_forward_and_backward(card, d, groups, k,
                                                 launches):
    """Two `pos_conv_fwd` launches (the forward, the input gradient) and
    one `pos_conv_wgrad` at the kernels' widths; other widths take none,
    and run."""
    from wav2vec_contr_loss_torch.config import Wav2Vec2Config
    from wav2vec_contr_loss_torch.models.wav2vec2 import \
        PositionalConvEmbedding

    cfg = Wav2Vec2Config(hidden_size=d, num_conv_pos_embeddings=k,
                         num_conv_pos_embedding_groups=groups)
    m = PositionalConvEmbedding(cfg).to(card)
    x = torch.randn(2, 50, d, device=card).to(BF16).requires_grad_()
    before = (pc.launches, pc.bwd_launches)
    y = m(x)
    y.float().sum().backward()
    torch.cuda.synchronize()
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    assert (pc.launches - before[0],
            pc.bwd_launches - before[1]) == launches


@pytest.mark.card
def test_card_doctor_forward(card):
    """doctor's eval forward of its tiny bf16 encoder (groups 32 wide)
    passes on the card."""
    from wav2vec_contr_loss_torch.cli import doctor

    assert "layer_mean" in doctor._forward(card)
