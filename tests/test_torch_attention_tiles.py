"""The tiled algorithm of the port's attention kernels
(wav2vec_contr_loss_torch/csrc/attention_fwd.cu and attention_bwd.cu),
emulated in plain PyTorch on the CPU, against the JAX Pallas
`fused_attention` and its `jax.vjp` (interpret mode, as
tests/test_attention_pallas.py runs it).

The emulation keeps the kernels' structure: 64-row query and key tiles,
rows past T zero and keys past T at a -inf bias; the forward's two passes
(the row max m and sum l folded tile by tile, then p = exp(s - m) / l
normalized before the dropout mask and its bf16 rounding, the last key
tile kept from pass 1); its residuals (m, log l) and out_exact, the
output with p not rounded to bf16; the backward's D = rowsum(g *
out_exact) and its two loops, dq over the key tiles of a query tile, dk
and dv over the query tiles of a key tile, with p recomputed from the
residuals.

Tolerances, those of tests/test_attention_pallas.py: forward atol 2e-3,
rtol 2e-2 (bf16 outputs, p rounded to bf16 on both sides); gradients
atol = rtol = 5e-2 (ds rounded to bf16 on both sides, in sums taken in
another order).
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wav2vec_contr_loss_tpu.ops.attention_pallas import \
    fused_attention as jax_fused_attention

from wav2vec_contr_loss_torch.models.wav2vec2 import SelfAttention
from wav2vec_contr_loss_torch.ops import attention
from wav2vec_contr_loss_torch.ops.dropout import attention_dropout_mask

from tests.test_torch_bridge import cap_torch_threads

cap_torch_threads()

FWD_TOL = dict(atol=2e-3, rtol=2e-2)
GRAD_TOL = dict(atol=5e-2, rtol=5e-2)
TILE = 64
BF16 = torch.bfloat16


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(BF16).float()


def _padded(x: torch.Tensor, tp: int) -> torch.Tensor:
    """(B, H, T, D) -> (B, H, Tp, D), rows past T zero (TMA's fill)."""
    return torch.nn.functional.pad(x.float(), (0, 0, 0, tp - x.shape[2]))


def emulate_fwd(q, k, v, bias, seed, rate):
    """-> (out bf16 (B, H, T, D), out_exact, m, log l), as
    attention_fwd.cu."""
    b, h, t, _ = q.shape
    n = -(-t // TILE)
    tp = n * TILE
    qf, kf, vf = (_padded(x, tp) for x in (q, k, v))
    kb = torch.full((b, tp), -math.inf)
    kb[:, :t] = bias
    mask = torch.ones(b, h, tp, tp)
    if rate > 0.0:
        mask[:, :, :t, :t] = attention_dropout_mask(b, h, t, seed, rate)
    tiles = [slice(j * TILE, (j + 1) * TILE) for j in range(n)]

    def scores(j):
        return qf @ kf[:, :, tiles[j]].transpose(-1, -2) \
            + kb[:, None, None, tiles[j]]

    m = torch.full((b, h, tp, 1), -math.inf)
    l = torch.zeros(b, h, tp, 1)
    for j in range(n):                      # pass 1: statistics
        s = scores(j)
        mt = s.amax(-1, keepdim=True)
        e = torch.exp(s - mt)
        m_new = torch.maximum(m, mt)
        l = l * torch.exp(m - m_new) + e.sum(-1, keepdim=True) \
            * torch.exp(mt - m_new)
        m = m_new
    o = torch.zeros(b, h, tp, q.shape[-1])
    o_lo = torch.zeros_like(o)
    order = [n - 1] + list(range(n - 1))   # pass 2: the kept tile first
    for j in order:
        if j == n - 1:                      # e of pass 1, rescaled
            p = e * (torch.exp(mt - m) / l)
        else:
            p = torch.exp(scores(j) - m) / l
        p = p * mask[:, :, :, tiles[j]]
        p_hi = _bf16(p)
        o = o + p_hi @ vf[:, :, tiles[j]]
        o_lo = o_lo + _bf16(p - p_hi) @ vf[:, :, tiles[j]]
    out, out_exact = o.to(BF16), (o + o_lo).to(BF16)
    return (out[:, :, :t], out_exact[:, :, :t], m[..., 0],
            torch.log(l[..., 0]))


def emulate_bwd(q, k, v, g, bias, seed, rate, out_exact, m, log_l):
    """-> (dq, dk, dv) in bf16, as attention_bwd.cu's two kernels."""
    b, h, t, _ = q.shape
    n = -(-t // TILE)
    tp = n * TILE
    qf, kf, vf, gf = (_padded(x, tp) for x in (q, k, v, g))
    kb = torch.full((b, tp), -math.inf)
    kb[:, :t] = bias
    mask = torch.ones(b, h, tp, tp)
    if rate > 0.0:
        mask[:, :, :t, :t] = attention_dropout_mask(b, h, t, seed, rate)
    d_row = (gf[:, :, :t] * out_exact.float()).sum(-1)
    d_row = torch.nn.functional.pad(d_row, (0, tp - t))
    tiles = [slice(j * TILE, (j + 1) * TILE) for j in range(n)]
    dq = torch.zeros_like(qf)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for i in range(n):                      # dq kernel: a query tile
        qi, gi = qf[:, :, tiles[i]], gf[:, :, tiles[i]]
        mi, li = m[:, :, tiles[i], None], log_l[:, :, tiles[i], None]
        for j in range(n):
            s = qi @ kf[:, :, tiles[j]].transpose(-1, -2) \
                + kb[:, None, None, tiles[j]]
            p = torch.exp((s - mi) - li)
            dp = (gi @ vf[:, :, tiles[j]].transpose(-1, -2)) \
                * mask[:, :, tiles[i], tiles[j]]
            ds = p * (dp - d_row[:, :, tiles[i], None])
            dq[:, :, tiles[i]] += _bf16(ds) @ kf[:, :, tiles[j]]
    valid = torch.arange(tp) < t
    for j in range(n):                      # dk/dv kernel: a key tile
        kj, vj = kf[:, :, tiles[j]], vf[:, :, tiles[j]]
        for i in range(n):
            st = kj @ qf[:, :, tiles[i]].transpose(-1, -2) \
                + kb[:, None, tiles[j], None]
            pt = torch.exp((st - m[:, :, None, tiles[i]])
                           - log_l[:, :, None, tiles[i]])
            pt = torch.where(valid[tiles[i]], pt, 0.0)
            mt = mask[:, :, tiles[i], tiles[j]].transpose(-1, -2)
            dpt = (vj @ gf[:, :, tiles[i]].transpose(-1, -2)) * mt
            dv[:, :, tiles[j]] += _bf16(pt * mt) @ gf[:, :, tiles[i]]
            dst = pt * (dpt - d_row[:, :, None, tiles[i]])
            dk[:, :, tiles[j]] += _bf16(dst) @ qf[:, :, tiles[i]]
    return tuple(x[:, :, :t].to(BF16) for x in (dq, dk, dv))


def _inputs(t, empty_clip, seed=0):
    rng = np.random.default_rng(seed + t)
    b, h, d = 2, 2, 64

    def bf16_valued(scale=1.0):
        x = rng.normal(0, 1, (b, h, t, d)).astype(np.float32) * scale
        return torch.from_numpy(x).to(BF16).float().numpy()

    q = bf16_valued(d ** -0.5)
    k, v, g = (bf16_valued() for _ in range(3))
    bias = np.zeros((b, t), np.float32)
    if empty_clip:
        bias[1] = -1e30                     # a clip with no valid frame
    else:
        bias[1, t - max(1, t // 3):] = -1e30
    return q, k, v, g, bias


@pytest.mark.parametrize("empty_clip", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("t", [7, 64, 249, 300, 600])
def test_tiled_algorithm_matches_pallas(t, rate, empty_clip):
    q, k, v, g, bias = _inputs(t, empty_clip)
    seed, h = 1234, q.shape[1]
    j = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want, vjp = jax.vjp(lambda q_, k_, v_: jax_fused_attention(
        q_, k_, v_, jnp.asarray(bias), seed, rate, h), *j)
    want_grads = vjp(jnp.asarray(g, jnp.bfloat16))

    tq, tk, tv, tg = (torch.from_numpy(a).to(BF16) for a in (q, k, v, g))
    tb = torch.from_numpy(bias)
    out, out_exact, m, log_l = emulate_fwd(tq, tk, tv, tb, seed, rate)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32), **FWD_TOL)
    # m + log l is the row's log-sum-exp of the logits
    logits = tq.float() @ tk.float().transpose(-1, -2) + tb[:, None, None, :]
    np.testing.assert_allclose((m + log_l)[:, :, :t].numpy(),
                               torch.logsumexp(logits, -1).numpy(),
                               rtol=1e-6, atol=1e-5)
    grads = emulate_bwd(tq, tk, tv, tg, tb, seed, rate, out_exact, m, log_l)
    for name, a, w in zip("qkv", grads, want_grads):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(w, np.float32), **GRAD_TOL,
                                   err_msg=f"d{name}")


def test_cpu_path_takes_strided_views():
    """fused_attention takes the (B, H, T, D) view of a (B, T, H, D)
    tensor, as SelfAttention now passes it, with the result of the
    contiguous copy, forward and backward."""
    rng = np.random.default_rng(3)
    b, t, h, d = 2, 50, 3, 64
    x = [torch.from_numpy(rng.normal(0, 1, (b, t, h, d)).astype(np.float32))
         .to(BF16) for _ in range(4)]
    bias = torch.zeros(b, t)
    bias[1, 40:] = -1e30
    views = [a.transpose(1, 2) for a in x]
    assert not views[0].is_contiguous()
    copies = [a.contiguous() for a in views]
    outs, grads = [], []
    for ins in (views[:3], copies[:3]):
        ins = [a.detach().requires_grad_() for a in ins]
        out = attention.fused_attention(*ins, bias, 9, 0.1, h)
        outs.append(out)
        grads.append(torch.autograd.grad(out, ins, views[3]))
    assert torch.equal(outs[0], outs[1])
    for a, w in zip(*grads):
        assert torch.equal(a, w)


def test_self_attention_without_copies_matches_the_copying_form():
    """SelfAttention's output equals the former formulation that made
    contiguous (B, H, T, D) copies of q, k and v around the kernel."""
    from wav2vec_contr_loss_torch.config import XLSR_300M

    cfg = XLSR_300M.with_(hidden_size=128, num_heads=2, dtype="float32")
    torch.manual_seed(0)
    attn = SelfAttention(cfg).eval()
    x = torch.randn(2, 30, 128)
    key_bias = torch.zeros(2, 30)
    key_bias[0, 25:] = -1e30
    b, t, d = x.shape
    hd = d // cfg.num_heads

    def heads(a):
        return a.view(b, t, cfg.num_heads, hd).transpose(1, 2).contiguous()

    with torch.no_grad():
        got = attn(x, key_bias, 11)
        q = attn.q_proj(x) * hd ** -0.5
        out = attention.fused_attention(heads(q), heads(attn.k_proj(x)),
                                        heads(attn.v_proj(x)), key_bias, 11,
                                        attn.rate, cfg.num_heads)
        want = attn.out_proj(out.transpose(1, 2).reshape(b, t, d))
    assert torch.equal(got, want)


def test_cuda_checks_refuse_what_tma_cannot_take():
    """The CUDA path's checks (run here on CPU tensors: they read only
    dtypes, shapes, strides and addresses) take the model's strided views
    and refuse what a TMA tensor map cannot describe."""
    x = torch.zeros(2, 10, 3, 64, dtype=BF16)
    view = x.transpose(1, 2)                     # (B, H, T, 64) view
    attention._check_cuda((view, view.contiguous()), 64)
    bad = {
        # fp32 goes to the fp32 kernels (tests/test_torch_fp32.py); no
        # kernel takes fp16
        "dtype": view.half(),
        "head dim not contiguous": torch.zeros(2, 3, 64, 10,
                                               dtype=BF16).transpose(2, 3),
        "row stride not a multiple of 8": torch.zeros(
            2, 3, 10, 68, dtype=BF16)[..., :64],
        "misaligned": torch.zeros(2 * 3 * 10 * 64 + 4,
                                  dtype=BF16)[4:].view(2, 3, 10, 64),
    }
    for t in bad.values():
        with pytest.raises(ValueError):
            attention._check_cuda((t,), 64)
    with pytest.raises(ValueError):
        attention._check_cuda((view,), 32)
