"""The bf16 attention kernels (csrc/attention_fwd.cu, attention_bwd.cu) on
the card at XLS-R 1B's and 2B's head dims, 80 and 120: forward and
backward at T = 7, 64, 249 and 300, dropout rate 0 and 0.1, a clip with
no valid frame, on contiguous tensors and on the (B, H, T, D) view of a
(B, T, H, D) projection; the dropout mask bit for bit that of the
head-dim-64 kernels; no element past the D-th of a row read (NaNs there
change nothing) or written (a sentinel there stays). Error rule of
PERF.md's kernel table for bf16: |kernel - plain| <= 5e-2 + 5e-2 |plain|.

The forward is held against `fused_attention_plain`, whose arithmetic it
is. The backward is held against chip_smoke.py's `rounded_plain`, the
same function with the kernels' (and the Pallas kernel's) roundings: dS
rounded to bf16 before dq = dS . k and dk = dS^T . q, where
`fused_attention_plain`'s
autograd rounds dP instead. dS grows with the head dim (dP = g . v^T
sums D products), and at D = 120 the two roundings alone differ by more
than the rule on a few elements of dq (0.125 at a value of 1.49, on the
card), so the kernels' own rounding is what the rule can hold them to.
Against `fused_attention_plain`'s gradients the backward is held to the
rule plus PLAIN_MARGIN: the worst excess measured over these cases on
the H100 was 4.9e-4.

The tests are marked `card` and skip without one. The file imports
neither JAX nor the JAX package, so they run on a machine without them:

    python3 -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_attention_card.py
"""

import pytest
import torch

from chip_smoke import rounded_plain
from wav2vec_contr_loss_torch.ops import attention
from wav2vec_contr_loss_torch.ops.dropout import attention_dropout_mask

SEED = 2 ** 31 - 77
BF16 = torch.bfloat16
# added to the rule's 5e-2 where the backward is held to
# `fused_attention_plain`'s autograd, which rounds dP where the kernels
# round dS
PLAIN_MARGIN = 1e-3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the chip")
    return torch.device("cuda")


def _bias(b, t, dev):
    """Key bias: batch row 0 whole, row 1 with its last third padded, the
    last row a clip with no valid frame."""
    bias = torch.zeros(b, t, device=dev)
    bias[1, t - max(1, t // 3):] = -1e30
    bias[-1] = -1e30
    return bias


def _inputs(b, h, t, d, dev, strided, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed + 1000 * d + t)

    def draw(scale=1.0):
        shape = (b, t, h, d) if strided else (b, h, t, d)
        x = (scale * torch.randn(shape, generator=gen, device=dev)).to(BF16)
        return x.transpose(1, 2) if strided else x

    return draw(d ** -0.5), draw(), draw(), draw()


def _grads(fn, q, k, v, g, *args):
    ins = [x.detach().requires_grad_() for x in (q, k, v)]
    out = fn(*ins, *args)
    return out.detach(), torch.autograd.grad(out, ins, g)


def _assert_bf16_close(got, want, what, margin=0.0):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bound = 5e-2 + margin + 5e-2 * want.abs()
    assert torch.isfinite(got).all(), what
    assert (err <= bound).all(), (
        f"{what}: max |kernel - plain| {err.max().item():.3e}, worst "
        f"excess {(err - bound).max().item():.3e}")


@pytest.mark.card
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("t", [7, 64, 249, 300])
@pytest.mark.parametrize("d", [80, 120])
def test_kernels_match_the_plain_version(card, d, t, rate, strided):
    b, h = 3, 4
    q, k, v, g = _inputs(b, h, t, d, card, strided)
    bias = _bias(b, t, card)
    fwd0, bwd0 = (attention.head_dim_launches[d],
                  attention.head_dim_bwd_launches[d])
    out, grads = _grads(attention.fused_attention, q, k, v, g, bias, SEED,
                        rate, h)
    want = attention.fused_attention_plain(q, k, v, bias, SEED, rate)
    _, plain_grads = _grads(attention.fused_attention_plain, q, k, v, g,
                            bias, SEED, rate)
    rounded, want_grads = rounded_plain(q, k, v, g, bias, SEED, rate)
    torch.cuda.synchronize()
    assert (attention.head_dim_launches[d] - fwd0,
            attention.head_dim_bwd_launches[d] - bwd0) == (1, 1)
    assert out.stride() == q.stride()
    _assert_bf16_close(out, want, f"out d={d} t={t} rate={rate}")
    _assert_bf16_close(rounded, want, f"rounded_plain out d={d} t={t}")
    for name, a, w, pw in zip(("dq", "dk", "dv"), grads, want_grads,
                              plain_grads):
        _assert_bf16_close(a, w, f"{name} d={d} t={t} rate={rate}")
        _assert_bf16_close(a, pw, f"{name} against fused_attention_plain "
                           f"d={d} t={t} rate={rate}", PLAIN_MARGIN)
        print(f"{name} d={d} t={t} rate={rate} strided={strided}: max "
              f"|kernel - rounded_plain| "
              f"{(a.float() - w.float()).abs().max().item():.3e}, max "
              f"|kernel - fused_attention_plain| "
              f"{(a.float() - pw.float()).abs().max().item():.3e}")
    # the fully masked clip: a uniform softmax, as in the plain version
    assert torch.isfinite(out[-1].float()).all()
    # no gradient: the forward alone, without residuals, as serving runs it
    with torch.no_grad():
        served = attention.fused_attention(q, k, v, bias, SEED, rate, h)
    assert torch.equal(served, out)


@pytest.mark.card
@pytest.mark.parametrize("d", [80, 120])
@pytest.mark.parametrize("t", [64, 249])
def test_dropout_mask_is_the_head_dim_64_kernels(card, d, t):
    """With q = k = 0 and the keys of one 64-key tile alone valid, p is
    uniform over that tile, and v = the one-hot rows of the tile's keys
    makes out[i, c] = bf16(p * mask[i, key c]): the mask read back from
    the kernels at head dim d and 64, bit for bit, and kept where
    `attention_dropout_mask` keeps."""
    b, h, rate = 2, 3, 0.1
    mask = attention_dropout_mask(b, h, t, SEED, rate, card) != 0
    for tile in range(-(-t // 64)):
        keys = torch.arange(64 * tile, min(t, 64 * tile + 64), device=card)
        bias = torch.full((b, t), -1e30, device=card)
        bias[:, keys] = 0.0
        outs = {}
        for dd in (64, d):
            q = torch.zeros(b, h, t, dd, dtype=BF16, device=card)
            v = torch.zeros(b, h, t, dd, dtype=BF16, device=card)
            v[:, :, keys, keys - 64 * tile] = 1.0
            with torch.no_grad():
                outs[dd] = attention.fused_attention(q, q, v, bias, SEED,
                                                     rate, h)[..., :64]
        assert torch.equal(outs[d], outs[64]), tile
        kept = outs[d][..., :len(keys)] != 0
        assert torch.equal(kept, mask[..., keys]), tile


@pytest.mark.card
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("d", [80, 120])
def test_nothing_past_the_head_dim_is_read_or_written(card, monkeypatch, d,
                                                      rate):
    """q, k, v and g are views of rows 128 wide whose columns past d hold
    NaN, and every output the kernels write (out, out_exact, dq, dk, dv)
    is a view of such a row holding a sentinel there: the results equal
    those from dense tensors, and every sentinel stays."""
    b, h, t = 2, 4, 249
    q, k, v, g = _inputs(b, h, t, d, card, strided=False, seed=5)
    bias = _bias(b, t, card)
    sentinel = -1536.0          # a bf16 number
    rows = []                   # the outputs' whole rows

    def wide(x, fill):
        buf = torch.full((*x.shape[:-1], 128), fill, dtype=x.dtype,
                         device=x.device)
        buf[..., :d] = x
        if fill == sentinel:
            rows.append(buf)
        return buf[..., :d]

    dense = _grads(attention.fused_attention, q, k, v, g, bias, SEED, rate,
                   h)
    empty_like = torch.empty_like

    def padded_empty_like(x, *args, **kw):
        if x.dim() == 4 and x.dtype == BF16 and x.shape[-1] == d:
            return wide(empty_like(x, *args, **kw), sentinel)
        return empty_like(x, *args, **kw)

    qn, kn, vn, gn = (wide(x, float("nan")) for x in (q, k, v, g))
    monkeypatch.setattr(torch, "empty_like", padded_empty_like)
    padded = _grads(attention.fused_attention, qn, kn, vn, gn, bias, SEED,
                    rate, h)
    monkeypatch.undo()
    torch.cuda.synchronize()
    # out, out_exact, dq, dk, dv
    assert len(rows) == 5
    for buf in rows:
        assert (buf[..., d:] == sentinel).all()
    assert torch.equal(padded[0], dense[0])
    for a, w in zip(padded[1], dense[1]):
        assert torch.equal(a, w)

