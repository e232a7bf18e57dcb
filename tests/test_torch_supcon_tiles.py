"""The algorithm of the port's SupCon kernels
(wav2vec_contr_loss_torch/csrc/supcon.cu), emulated in plain PyTorch on
the CPU, against the JAX package: `supcon_binary_loss_pallas` in
interpret mode up to B = 96, and the XLA loss at B = 600, the path the
JAX package takes above its kernel's VMEM limit of 512.

The emulation keeps the kernels' structure:
  * rows kernel: z padded to a multiple of 4 columns, the Gram matrix
    and the squared norms with the reduction over D split into the
    kernel's groups of column quads, added by the kernel's butterfly,
    and made symmetric as the kernel's is; one row at a time the masks, the full
    log-sum-exp, the top-k of the negatives as the threshold walk (each
    round the largest negative below the last pick in (value, lower
    index) order), the mined log-sum-exp, the row terms and the
    selection packed into 32-bit words;
  * dz kernel: the row terms added as 256 strided partials, a
    butterfly in each warp and the warps in order, A = g_c + g_c^T - lambda 2c W rebuilt from the
    symmetric Gram, both rows' terms and the unpacked selection bits,
    and dz = A z + lambda 2c rowsum(W) z with the reduction over j split
    into the kernel's groups and added by its butterfly.

Tolerances, those of tests/test_supcon_pallas.py: loss 2e-5 (relative
and absolute), dz and dL/dalpha rtol 5e-4, atol 5e-6 (fp32 on both
sides, sums in another order).
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wav2vec_contr_loss_tpu.losses import SupConConfig as JaxSupConConfig
from wav2vec_contr_loss_tpu.losses import supcon_binary_loss as jax_supcon
from wav2vec_contr_loss_tpu.ops.supcon_pallas import supcon_binary_loss_pallas

from tests.test_supcon_pallas import CASES, make_labels, normed
from wav2vec_contr_loss_torch.config import SupConConfig
from wav2vec_contr_loss_torch.ops import supcon

from tests.test_torch_bridge import cap_torch_threads

cap_torch_threads()

THREADS = 256
NEG = -1e30
LOSS_TOL = dict(rel=2e-5, abs=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-6)


def quads_for(n: int, most: int) -> int:
    """Column quads of a tile pass (`quads_for`): the power of two
    covering n / 4, at least 8 (a quad's groups lie in one warp) and at
    most `most`."""
    nq = 8
    while nq < most and 4 * nq < n:
        nq *= 2
    return nq


def butterfly(parts):
    """(..., 32 lanes) -> (...): the xor butterfly of a warp, lane 0's
    sum (every lane ends with the same bits)."""
    lanes = torch.arange(parts.shape[-1])
    o = parts.shape[-1] // 2
    while o:
        parts = parts + parts[..., lanes ^ o]
        o //= 2
    return parts[..., 0]


def group_tree(terms, n, ks):
    """The kernels' sum of their ks <= 32 reduction groups (group g
    taking g, g + ks, ... of range(n)): a butterfly over the lanes that
    hold them."""
    parts = [terms(torch.arange(g, n, ks)) if g < n else None
             for g in range(ks)]
    zero = torch.zeros_like(next(p for p in parts if p is not None))
    return butterfly(torch.stack([zero if p is None else p for p in parts],
                                 -1))


def gram_and_norms(z):
    b, d = z.shape
    zq = z.reshape(b, d // 4, 4)
    ks = THREADS // quads_for(b, 64)

    def part(idx):
        zz = zq[:, idx].reshape(b, -1)
        return torch.cat([zz @ zz.T, (zz * zz).sum(1, keepdim=True)], 1)

    out = group_tree(part, d // 4, ks)
    g = out[:, :b]
    # G[i, j] and G[j, i] are the same sums in the kernel
    g = torch.triu(g) + torch.triu(g, 1).T
    return g, out[:, b]


def similarity(dot, cfg):
    if cfg.similarity == "cosine":
        return dot, torch.ones_like(dot)
    eps = 1e-7
    c = dot.clamp(-1.0 + eps, 1.0 - eps)
    sim = 2.0 * (1.0 - torch.arccos(c) / math.pi) - 1.0
    grad = torch.where(dot.abs() < 1.0 - eps,
                       (2.0 / math.pi) * torch.rsqrt((1.0 - c * c)
                                                     .clamp_min(1e-12)),
                       0.0)
    return sim, grad


def walk_pick(lg, neg, k):
    """The top-k of each row's negatives as the threshold walk: k rounds,
    each the largest negative below the last pick in (value, then lower
    index) order; every negative where fewer than k are left."""
    b = lg.shape[0]
    col = torch.arange(b)
    tv, tj = torch.full((b,), math.inf), torch.full((b,), -1)
    picked = torch.zeros(b, dtype=torch.long)
    going = torch.ones(b, dtype=torch.bool)
    for _ in range(k):
        ok = neg & ((lg < tv[:, None])
                    | ((lg == tv[:, None]) & (col > tj[:, None])))
        cand = torch.where(ok, lg, NEG)
        bv = cand.amax(1)
        bj = torch.where(ok & (cand == bv[:, None]), col, 2 ** 31 - 1).amin(1)
        going = going & (bv > NEG / 2)
        tv, tj = torch.where(going, bv, tv), torch.where(going, bj, tj)
        picked = picked + going
    tv = torch.where(picked < k, -math.inf, tv)        # every negative
    return neg & ((lg > tv[:, None])
                  | ((lg == tv[:, None]) & (col <= tj[:, None])))


def rank_pick(lg, neg, k):
    """The same selection as the kernel takes it for B <= 32, one column
    a lane: a negative is picked iff fewer than k negatives come before
    it in (value, then lower index) order."""
    col = torch.arange(lg.shape[0])
    # before[i, j, o]: negative o comes before column j in row i
    before = neg[:, None, :] & (
        (lg[:, None, :] > lg[:, :, None])
        | ((lg[:, None, :] == lg[:, :, None])
           & (col[None, None, :] < col[None, :, None])))
    return neg & (before.sum(-1) < k)


def argmax_pick(lg, neg, k):
    """The Pallas loop's top-k (supcon_pallas.py:94-102): k rounds, each
    taking the first-occurrence argmax of the negatives not yet taken."""
    col = torch.arange(lg.shape[0])
    cand = torch.where(neg, lg, NEG)
    sel = torch.zeros_like(neg)
    for _ in range(k):
        row_max = cand.amax(1, keepdim=True)
        arg = torch.where(cand == row_max, col, 2 ** 30).amin(1, keepdim=True)
        hit = (col == arg) & (row_max > NEG / 2)
        sel = sel | hit
        cand = torch.where(hit, NEG, cand)
    return sel


def rows_kernel(z, labels, cfg):
    """-> (gram, row terms dict, selection words (B, ceil(B/32)) int64)"""
    b = z.shape[0]
    k = max(1, min(cfg.topk_neg, b - 1))
    gram, sq = gram_and_norms(z)
    sim, _ = similarity(gram, cfg)
    eye = torch.eye(b, dtype=torch.bool)
    lg = torch.where(eye, NEG, sim / cfg.temperature)
    same = labels[:, None] == labels[None, :]
    pos, neg = same & ~eye, ~same & ~eye
    n_pos, n_neg = pos.sum(1).float(), neg.sum(1).float()
    sum_pos = torch.where(pos, lg, 0.0).sum(1)
    m_all = torch.where(~eye, lg, NEG).amax(1).clamp_min(-1e30)
    s_all = torch.where(~eye, torch.exp(lg - m_all[:, None]), 0.0).sum(1)

    chosen = (rank_pick if b <= 32 else walk_pick)(lg, neg, k)
    words = -(-b // 32)
    bits = torch.nn.functional.pad(chosen, (0, 32 * words - b))
    sel = (bits.reshape(b, words, 32).long()
           << torch.arange(32)).sum(-1)

    in_m = pos | chosen
    m_m = torch.where(in_m, lg, NEG).amax(1).clamp_min(-1e30)
    s_m = torch.where(in_m, torch.exp(lg - m_m[:, None]), 0.0).sum(1)
    inv_pos = 1.0 / n_pos.clamp_min(1.0)
    mean_pos = sum_pos * inv_pos
    if cfg.uniformity_weight > 0.0 and b > 1:
        d2 = (sq[:, None] + sq[None, :] - 2.0 * gram).clamp_min(0.0)
        row_w = torch.where(eye, 0.0, torch.exp(-cfg.uniformity_t * d2)).sum(1)
    else:
        row_w = torch.zeros(b)
    terms = dict(
        m_all=m_all, s_all=s_all, m_m=m_m, s_m=s_m, inv_pos=inv_pos,
        has_pos=(n_pos > 0).float(), valid_m=((n_pos > 0) & (n_neg > 0)).float(),
        term_full=m_all + torch.log(s_all.clamp_min(1e-38)) - mean_pos,
        term_mined=m_m + torch.log(s_m.clamp_min(1e-38)) - mean_pos,
        sq=sq, row_w=row_w)
    return gram, terms, sel


def fixed_tree(v):
    """The dz kernel's sum of B row values: 256 strided partials in
    index order, a butterfly in each warp of 32, the 8 warps' sums in
    order."""
    part = torch.zeros(THREADS)
    for m in range(0, v.shape[0], THREADS):
        seg = v[m:m + THREADS]
        part[:len(seg)] = part[:len(seg)] + seg
    total = torch.tensor(0.0)
    for w in butterfly(part.reshape(THREADS // 32, 32)):
        total = total + w
    return total


def dz_kernel(z, labels, alpha, cfg, gram, t, sel):
    """-> (loss, dz, dL/dalpha) as supcon_dz_kernel."""
    b, d = z.shape
    hp, vm = t["has_pos"], t["valid_m"]
    nf, nm = fixed_tree(hp), fixed_tree(vm)
    lf = fixed_tree(torch.where(hp > 0, t["term_full"], 0.0))
    lm = fixed_tree(torch.where(vm > 0, t["term_mined"], 0.0))
    loss_full = lf / nf.clamp_min(1.0)
    loss_mined = lm / nm.clamp_min(1.0) if nm > 0 else loss_full
    loss = (1 - alpha) * loss_full + alpha * loss_mined if nf > 0 \
        else torch.tensor(0.0)
    uniform = cfg.uniformity_weight > 0.0 and b > 1
    ucoef = 0.0
    if uniform:
        n_pairs = float(b * (b - 1))
        mean_w = fixed_tree(t["row_w"]) / n_pairs
        loss = loss + cfg.uniformity_weight * torch.log(mean_w + 1e-8)
        ucoef = cfg.uniformity_weight * 2.0 * (
            -2.0 * cfg.uniformity_t / ((mean_w + 1e-8) * n_pairs))
    dalpha = loss_mined - loss_full if nf > 0 else torch.tensor(0.0)

    eye = torch.eye(b, dtype=torch.bool)
    sim, dg = similarity(gram, cfg)
    lg = sim / cfg.temperature
    same = labels[:, None] == labels[None, :]
    col = torch.arange(b)
    picked = ((sel[:, col // 32] >> (col % 32)) & 1).bool()
    c_full = (1 - alpha) + alpha * (0.0 if nm > 0 else 1.0)
    c_mined = alpha * (1.0 if nm > 0 else 0.0)
    t_full = (1 / cfg.temperature) / nf.clamp_min(1.0)
    t_mined = (1 / cfg.temperature) / nm.clamp_min(1.0)

    def row(name):
        return t[name][:, None]

    posf = torch.where(same, row("inv_pos"), 0.0)
    sm_all = torch.exp(lg - row("m_all")) / row("s_all").clamp_min(1e-38)
    sm_m = torch.where((posf > 0) | picked,
                       torch.exp(lg - row("m_m"))
                       / row("s_m").clamp_min(1e-38), 0.0)
    gf = torch.where(row("has_pos") > 0, sm_all - posf, 0.0)
    gm = torch.where(row("valid_m") > 0, sm_m - posf, 0.0)
    gd = (c_full * (t_full * gf) + c_mined * (t_mined * gm)) * dg
    a = torch.where(eye | ~(nf > 0), 0.0, gd + gd.T)
    if uniform:
        d2 = (row("sq") + t["sq"][None, :] - 2.0 * gram).clamp_min(0.0)
        a = a - ucoef * torch.where(eye, 0.0,
                                    torch.exp(-cfg.uniformity_t * d2))
    dz = group_tree(lambda idx: a[:, idx] @ z[idx], b,
                    THREADS // quads_for(d, 256))
    if uniform:
        dz = dz + ucoef * t["row_w"][:, None] * z
    return loss, dz, dalpha


def emulate(z, labels, alpha, cfg):
    d = z.shape[1]
    zp = torch.nn.functional.pad(z, (0, -d % 4))     # the wrapper's padding
    gram, terms, sel = rows_kernel(zp, labels, cfg)
    loss, dz, dalpha = dz_kernel(zp, labels, alpha, cfg, gram, terms, sel)
    return loss, dz[:, :d], dalpha


def _check(got, want):
    (loss, dz, dalpha), (w_loss, (w_dz, w_da)) = got, want
    assert float(loss) == pytest.approx(float(w_loss), **LOSS_TOL)
    np.testing.assert_allclose(dz.numpy(), np.asarray(w_dz), **GRAD_TOL)
    np.testing.assert_allclose(float(dalpha), float(w_da), **GRAD_TOL)


@pytest.mark.parametrize("b", [8, 12, 16, 40, 96])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_row_and_dz_kernels_match_pallas(case, b):
    """CASES' configurations at B = 8 to 96 (B = 12 leaves the kernels'
    last block of 8 rows ragged on the card)."""
    _, d, lk, tau, sim, topk, alpha, lam = case
    rng = np.random.default_rng(b * 1000 + topk)
    z = normed(rng, b, d)
    labels = make_labels(lk, b, rng)
    kw = dict(temperature=tau, similarity=sim, topk_neg=topk,
              uniformity_weight=lam, uniformity_t=2.0)
    want = jax.value_and_grad(
        lambda z_, a_: supcon_binary_loss_pallas(z_, labels, a_,
                                                 JaxSupConConfig(**kw)),
        argnums=(0, 1))(z, jnp.float32(alpha))
    got = emulate(torch.from_numpy(z), torch.from_numpy(labels), alpha,
                  SupConConfig(**kw))
    _check(got, want)


def test_batch_past_the_pallas_limit_matches_xla():
    """B = 600: the JAX package runs its XLA loss there; the port's
    kernels take it."""
    rng = np.random.default_rng(600)
    z = normed(rng, 600, 32)
    labels = make_labels("balanced", 600, rng)
    kw = dict(temperature=0.2, topk_neg=15, uniformity_weight=0.1,
              uniformity_t=2.0)
    want = jax.value_and_grad(
        lambda z_, a_: jax_supcon(z_, labels, a_, JaxSupConConfig(**kw)),
        argnums=(0, 1))(z, jnp.float32(0.3))
    got = emulate(torch.from_numpy(z), torch.from_numpy(labels), 0.3,
                  SupConConfig(**kw))
    _check(got, want)


def test_selection_is_the_first_occurrence_topk():
    """Ties: equal negatives are picked by lower index first, as the
    Pallas loop's first-occurrence argmax does, and every negative where
    fewer than k are left; by the walk and by the rows kernel (which
    ranks at this B)."""
    b = 10
    z = torch.zeros(b, 4)
    z[:, 0] = 1.0                                 # every dot product 1
    labels = torch.tensor([0, 1, 1, 1, 1, 1, 1, 0, 1, 0])
    lg = torch.ones(b, b).fill_diagonal_(NEG)
    neg = labels[:, None] != labels[None, :]
    for topk, want_row0 in ((3, [1, 2, 3]), (20, [1, 2, 3, 4, 5, 6, 8])):
        k = min(topk, b - 1)
        walked = walk_pick(lg, neg, k)[0].nonzero().flatten().tolist()
        _, _, sel = rows_kernel(z, labels, SupConConfig(topk_neg=topk))
        bits = [j for j in range(b) if (int(sel[0, 0]) >> j) & 1]
        assert walked == bits == want_row0


@pytest.mark.parametrize("b", [2, 5, 17, 32])
def test_rank_pick_is_the_threshold_walk(b):
    """For B <= 32 the kernel ranks each negative against the others in
    one step; it picks what the walk picks, and both pick what the Pallas
    loop's first-occurrence argmax picks, ties (repeated values) and rows
    with fewer than k negatives included."""
    rng = np.random.default_rng(b)
    lg = torch.from_numpy(rng.integers(-3, 4, (b, b)).astype(np.float32))
    lg.fill_diagonal_(NEG)
    labels = torch.from_numpy(rng.integers(0, 2, b))
    neg = (labels[:, None] != labels[None, :])
    for k in sorted({1, 3, max(1, b - 1), 15}):
        k = min(k, max(1, b - 1))
        walked = walk_pick(lg, neg, k)
        assert torch.equal(rank_pick(lg, neg, k), walked)
        assert torch.equal(argmax_pick(lg, neg, k), walked)


@pytest.mark.parametrize("b", [1, 2, 32, 33, 64, 1024, 4096])
def test_tile_passes_cover_the_batch(b):
    """Every Gram column lies in one tile pass: passes of 4 * nq columns
    with 256 / nq groups over D, nq a power of two, and a quad's groups
    in one warp."""
    nq = quads_for(b, 64)
    assert nq & (nq - 1) == 0 and THREADS % nq == 0
    assert THREADS // nq <= 32
    assert 4 * nq >= min(b, 256)
    passes = -(-b // (4 * nq))
    assert passes * 4 * nq >= b > (passes - 1) * 4 * nq


def test_python_and_tensor_alpha_agree():
    """A Python alpha and a tensor alpha give the same loss and gradients
    (on the card the wrapper fills a Python alpha in on the device)."""
    rng = np.random.default_rng(7)
    z = torch.from_numpy(normed(rng, 16, 8))
    labels = torch.from_numpy(make_labels("balanced", 16, rng))
    outs = []
    for alpha in (0.4, torch.tensor(0.4, requires_grad=True)):
        zk = z.clone().requires_grad_()
        loss = supcon.supcon_binary_loss_fused(zk, labels, alpha)
        outs.append((loss, torch.autograd.grad(loss, zk)[0]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    a = torch.tensor(0.4, requires_grad=True)
    ga = torch.autograd.grad(supcon.supcon_binary_loss_fused(
        z, labels, a), a)[0]
    assert ga.shape == a.shape and torch.isfinite(ga)


def test_alpha_reaches_the_device_without_a_copy():
    """`_alpha_on` fills a Python number in on the device (torch.full)
    and takes a tensor as it is."""
    t = torch.tensor(0.25)
    assert supcon._alpha_on(t, torch.device("cpu")) is t
    a = supcon._alpha_on(0.25, torch.device("cpu"))
    assert a.dtype == torch.float32 and a.shape == () and float(a) == 0.25
