"""The 3xTF32 arithmetic of the port's fp32 attention kernels
(wav2vec_contr_loss_torch/csrc/attention_fwd_f32.cu, attention_bwd_f32.cu
and f32_tiles.cuh), emulated in plain PyTorch on the CPU, against JAX's
default fp32 XLA attention and its `jax.vjp`, with the port's
`attention_dropout_mask` fed to both.

The emulation keeps what the kernels do to the numbers:
* `tf32_rna`: cvt.rna.tf32.f32 on the fp32 bits, 10 mantissa bits kept,
  round to nearest with ties away from zero;
* every product operand split into hi = tf32(x) and lo = tf32(x - hi),
  each product lo.hi + hi.lo + hi.hi in fp32 (lo.lo left out);
* the forward's one pass over 64-key tiles: an online softmax (the
  running row max and sum, the accumulator rescaled tile by tile), the
  dropout mask on the unnormalized exp(s - m) before p . v, one division
  by l at the end, rows past T zero and keys past T at a -inf bias;
* the backward's D = rowsum(g * out) and its two loops, dq over the key
  tiles of a query tile and dk/dv over the query tiles of a key tile, p
  recomputed from the row statistics (m, log l).

Tolerance: chip_smoke.py's ATT32_TOL, atol = rtol = 1e-4, which holds the
kernels to the plain fp32 version on the card. The measured errors are
printed (`pytest -s`); one TF32 product (hi.hi alone) misses it, which is
why the kernels pay for three.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wav2vec_contr_loss_torch.ops.dropout import attention_dropout_mask

from tests.test_torch_bridge import cap_torch_threads

cap_torch_threads()

ATT32_TOL = dict(atol=1e-4, rtol=1e-4)
TILE = 64
SEED = 4242


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> tf32 as cvt.rna.tf32.f32: add half of the 13 dropped bits
    to the magnitude (a carry may reach the exponent), then clear them."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def product(a: torch.Tensor, b: torch.Tensor, terms: int = 3):
    """a @ b from tf32 operands: lo.hi + hi.lo + hi.hi (terms=3), or
    hi.hi alone (terms=1), fp32 sums."""
    ah, al = split(a)
    bh, bl = split(b)
    if terms == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def _padded(x: torch.Tensor, tp: int) -> torch.Tensor:
    """(B, H, T, D) -> (B, H, Tp, D), rows past T zero (TMA's fill)."""
    return torch.nn.functional.pad(x, (0, 0, 0, tp - x.shape[2]))


def _layout(q, bias, seed, rate):
    b, h, t, _ = q.shape
    n = -(-t // TILE)
    tp = n * TILE
    kb = torch.full((b, tp), -math.inf)
    kb[:, :t] = bias
    mask = torch.ones(b, h, tp, tp)
    if rate > 0.0:
        mask[:, :, :t, :t] = attention_dropout_mask(b, h, t, seed, rate)
    return n, tp, kb, mask, [slice(j * TILE, (j + 1) * TILE)
                             for j in range(n)]


def emulate_fwd(q, k, v, bias, seed, rate, terms=3):
    """-> (out (B, H, T, D), m, log l (B, H, Tp)), as attention_fwd_f32.cu."""
    b, h, t, d = q.shape
    n, tp, kb, mask, tiles = _layout(q, bias, seed, rate)
    qf, kf, vf = (_padded(x, tp) for x in (q, k, v))
    m = torch.full((b, h, tp, 1), -math.inf)
    l = torch.zeros(b, h, tp, 1)
    o = torch.zeros(b, h, tp, d)
    for j in range(n):
        s = product(qf, kf[:, :, tiles[j]].transpose(-1, -2), terms) \
            + kb[:, None, None, tiles[j]]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        m_sub = torch.where(m_new == -math.inf, 0.0, m_new)
        corr = torch.exp(m - m_sub)         # 0 on the first tile
        p = torch.exp(s - m_sub)
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr + product(p * mask[:, :, :, tiles[j]],
                               vf[:, :, tiles[j]], terms)
        m = m_new
    return (o / l)[:, :, :t], m[..., 0], torch.log(l[..., 0])


def emulate_bwd(q, k, v, g, bias, seed, rate, out, m, log_l, terms=3):
    """-> (dq, dk, dv), as attention_bwd_f32.cu's two kernels."""
    b, h, t, _ = q.shape
    n, tp, kb, mask, tiles = _layout(q, bias, seed, rate)
    qf, kf, vf, gf = (_padded(x, tp) for x in (q, k, v, g))
    d_row = torch.nn.functional.pad((g * out).sum(-1), (0, tp - t))
    dq = torch.zeros_like(qf)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for i in range(n):                      # dq kernel: a query tile
        qi, gi = qf[:, :, tiles[i]], gf[:, :, tiles[i]]
        mi, li = m[:, :, tiles[i], None], log_l[:, :, tiles[i], None]
        for j in range(n):
            s = product(qi, kf[:, :, tiles[j]].transpose(-1, -2), terms) \
                + kb[:, None, None, tiles[j]]
            p = torch.exp((s - mi) - li)
            dp = product(gi, vf[:, :, tiles[j]].transpose(-1, -2), terms) \
                * mask[:, :, tiles[i], tiles[j]]
            ds = p * (dp - d_row[:, :, tiles[i], None])
            dq[:, :, tiles[i]] += product(ds, kf[:, :, tiles[j]], terms)
    valid = torch.arange(tp) < t
    for j in range(n):                      # dk/dv kernel: a key tile
        kj, vj = kf[:, :, tiles[j]], vf[:, :, tiles[j]]
        for i in range(n):
            st = product(kj, qf[:, :, tiles[i]].transpose(-1, -2), terms) \
                + kb[:, None, tiles[j], None]
            pt = torch.exp((st - m[:, :, None, tiles[i]])
                           - log_l[:, :, None, tiles[i]])
            pt = torch.where(valid[tiles[i]], pt, 0.0)
            mt = mask[:, :, tiles[i], tiles[j]].transpose(-1, -2)
            dpt = product(vj, gf[:, :, tiles[i]].transpose(-1, -2), terms) \
                * mt
            dv[:, :, tiles[j]] += product(pt * mt, gf[:, :, tiles[i]], terms)
            dst = pt * (dpt - d_row[:, :, None, tiles[i]])
            dk[:, :, tiles[j]] += product(dst, qf[:, :, tiles[i]], terms)
    return tuple(x[:, :, :t] for x in (dq, dk, dv))


def _jax_xla_attention(q, k, v, bias, mask):
    """JAX's default attention program under fp32 compute (fp32 logits
    plus the key bias, fp32 softmax, the dropped probabilities times v;
    wav2vec_contr_loss_tpu/models/wav2vec2.py, 'bhqk' layout), with the
    given dropout mask."""
    logits = jnp.einsum("bhqd,bhkd->bhqk", q, k) + bias[:, None, None, :]
    p = jax.nn.softmax(logits, axis=-1) * mask
    return jnp.einsum("bhqk,bhkd->bhqd", p, v)


def _inputs(t):
    """q (pre-scaled), k, v, g and a key bias: clip 0 whole, clip 1 with
    a padded tail, clip 2 with no valid frame."""
    rng = np.random.default_rng(t)
    b, h, d = 3, 2, 64
    q, k, v, g = (rng.normal(0, 1, (b, h, t, d)).astype(np.float32)
                  for _ in range(4))
    q *= d ** -0.5
    bias = np.zeros((b, t), np.float32)
    bias[1, t - t // 3:] = -1e30
    bias[2] = -1e30
    return q, k, v, g, bias


def _reference(q, k, v, g, bias, rate):
    b, h, t, _ = q.shape
    mask = (attention_dropout_mask(b, h, t, SEED, rate).numpy()
            if rate > 0.0 else np.ones((b, h, t, t), np.float32))
    out, vjp = jax.vjp(
        lambda *a: _jax_xla_attention(*a, jnp.asarray(bias),
                                      jnp.asarray(mask)),
        *(jnp.asarray(a) for a in (q, k, v)))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _emulate(q, k, v, g, bias, rate, terms=3):
    tq, tk, tv, tg, tb = (torch.from_numpy(a) for a in (q, k, v, g, bias))
    out, m, log_l = emulate_fwd(tq, tk, tv, tb, SEED, rate, terms)
    grads = emulate_bwd(tq, tk, tv, tg, tb, SEED, rate, out, m, log_l, terms)
    return out, m, log_l, grads


def _max_err(a, w) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(w)).max())


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("t", [130, 249])
def test_3xtf32_online_softmax_matches_jax_xla(t, rate):
    q, k, v, g, bias = _inputs(t)
    want, want_g = _reference(q, k, v, g, bias, rate)
    out, m, log_l, grads = _emulate(q, k, v, g, bias, rate)
    errs = [_max_err(out, want)] + [_max_err(a, w)
                                   for a, w in zip(grads, want_g)]
    print(f"\nT={t} rate {rate}: 3xTF32 emulation vs JAX fp32 XLA max abs "
          f"err out {errs[0]:.2e}, dq {errs[1]:.2e}, dk {errs[2]:.2e}, "
          f"dv {errs[3]:.2e}")
    np.testing.assert_allclose(out.numpy(), want, **ATT32_TOL)
    for name, a, w in zip(("dq", "dk", "dv"), grads, want_g):
        np.testing.assert_allclose(a.numpy(), w, **ATT32_TOL, err_msg=name)
    # m + log l is each row's log-sum-exp of the logits; the clip with no
    # valid frame attends uniformly (log-sum-exp -1e30 + log T)
    logits = torch.from_numpy(q) @ torch.from_numpy(k).transpose(-1, -2) \
        + torch.from_numpy(bias)[:, None, None, :]
    np.testing.assert_allclose((m + log_l)[:, :, :t].numpy(),
                               torch.logsumexp(logits, -1).numpy(),
                               rtol=1e-6, atol=1e-5)
    if rate == 0.0:
        np.testing.assert_allclose(
            out[2].numpy(), np.broadcast_to(v[2].mean(axis=1, keepdims=True),
                                            out[2].shape), **ATT32_TOL)


def test_single_tf32_product_misses_the_tolerance():
    """hi.hi alone (plain TF32, 10 mantissa bits an operand) lands
    outside ATT32_TOL where 3xTF32 lands inside: the reason the kernels
    run three products."""
    q, k, v, g, bias = _inputs(249)
    want, want_g = _reference(q, k, v, g, bias, 0.1)
    errs = {}
    for terms in (1, 3):
        out, _, _, grads = _emulate(q, k, v, g, bias, 0.1, terms)
        errs[terms] = [_max_err(out, want)] + [
            _max_err(a, w) for a, w in zip(grads, want_g)]
    print(f"\nT=249 rate 0.1 max abs err (out, dq, dk, dv): one TF32 "
          f"product {['%.2e' % e for e in errs[1]]}, 3xTF32 "
          f"{['%.2e' % e for e in errs[3]]}")
    assert max(errs[3]) < ATT32_TOL["atol"]
    assert max(errs[1]) > 10 * max(errs[3])
    out1, _, _, _ = _emulate(q, k, v, g, bias, 0.1, terms=1)
    assert not np.allclose(out1.numpy(), want, **ATT32_TOL)


def test_tf32_rna_hand_picked_values():
    one_ulp = 2.0 ** -23
    cases = {
        1.0: 1.0,
        # a tie, halfway between 1 and 1 + 2^-10: away from zero
        1.0 + 2.0 ** -11: 1.0 + 2.0 ** -10,
        -(1.0 + 2.0 ** -11): -(1.0 + 2.0 ** -10),
        # just below the tie: down
        1.0 + 2.0 ** -11 - one_ulp: 1.0,
        # 2 - 2^-23 rounds up across the exponent to 2
        2.0 - 2.0 * one_ulp: 2.0,
        # a negative value: -3.14159274 -> -3.140625 (1.1001001000b x 2)
        -3.14159274: -3.140625,
        0.0: 0.0,
        float("inf"): float("inf"),
    }
    x = torch.tensor(list(cases), dtype=torch.float32)
    want = torch.tensor(list(cases.values()), dtype=torch.float32)
    got = tf32_rna(x)
    assert torch.equal(got, want), (got.tolist(), want.tolist())
    # the low 13 bits are clear on random values, and the rounding is to
    # the nearest multiple of 2^-10 of the binade
    r = torch.from_numpy(np.random.default_rng(0).normal(
        0, 10, 10000).astype(np.float32))
    t = tf32_rna(r)
    assert int((t.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    binade = torch.exp2(torch.floor(torch.log2(r.abs())))
    assert bool(((t - r).abs() <= binade * 2.0 ** -11).all())


def test_hi_plus_lo_gives_x_back():
    """hi + lo is x within 2^-21 relative, on values over many binades."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.normal(0, 1, 100000)
                          * np.exp2(rng.integers(-30, 30, 100000))
                          ).astype(np.float32))
    hi, lo = split(x)
    assert int((lo.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    rel = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs())
    assert float(rel.max()) <= 2.0 ** -21
    # one TF32 rounding alone is ~2^-12 relative on average, up to 2^-11
    assert float(((hi.double() - x.double()).abs()
                  / x.double().abs()).max()) > 2.0 ** -13
