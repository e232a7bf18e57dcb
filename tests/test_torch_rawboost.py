"""RawBoost in the port against the JAX package: the host module bit for
bit on the same numpy generator, and the device module's pieces and whole
batch on the same random numbers (the JAX key schedule replicated here),
at T = 16,000 with one zero-padded and one all-zero clip."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wav2vec_contr_loss_tpu.data import rawboost as jax_host
from wav2vec_contr_loss_tpu.ops import rawboost as jax_dev

from wav2vec_contr_loss_torch.data import rawboost as host
from wav2vec_contr_loss_torch.ops import rawboost as dev

from tests.test_torch_bridge import cap_torch_threads

cap_torch_threads()

B, T = 3, 16000
FS = 16000.0


def _clips():
    rng = np.random.default_rng(5)
    w = (0.3 * rng.standard_normal((B, T))).astype(np.float32)
    w[1, 11000:] = 0.0                 # zero-padded
    w[2] = 0.0                         # all zero
    return w


def _params(**kw):
    return jax_host.RawBoostParams(**kw), host.RawBoostParams(**kw)


def _u(key, shape=()):
    return np.array(jax.random.uniform(key, shape))


def _chain_uniforms(key, p):
    """The uniforms `_notch_chain` draws from `key`: (n_bands, 3), gain."""
    keys = jax.random.split(key, p.n_bands + 1)
    return (np.stack([_u(keys[i], (3,)) for i in range(p.n_bands)]),
            _u(keys[-1]))


def jax_draws(key, batch, t, p) -> dev.RawBoostDraws:
    """Every number `rawboost_batch_device(batch, key, ...)` draws, by its
    key schedule (ops/rawboost.py:157-267 of the JAX package)."""
    cols = {f: [] for f in ("gate", "c_ssi", "c_isd", "bands", "gains",
                            "noise", "snr", "beta", "pos", "f1", "f2")}
    for k in jax.random.split(key, batch):
        k_gate, k_lnl, k_cssi, k_ssi, k_cisd, k_isd = jax.random.split(k, 6)
        k_noise, k_chain, k_snr = jax.random.split(k_ssi, 3)
        chains = [_chain_uniforms(ck, p) for ck in
                  list(jax.random.split(k_lnl, p.n_f)) + [k_chain]]
        k_beta, k_pos, k_f1, k_f2 = jax.random.split(k_isd, 4)
        pos = (np.asarray(jax.random.bits(k_pos, (t,), jnp.uint16)).astype(
            np.int32) if p.isd_mode == "exact" else _u(k_pos, (t,)))
        for name, v in (
                ("gate", _u(k_gate)), ("c_ssi", _u(k_cssi)),
                ("c_isd", _u(k_cisd)),
                ("bands", np.stack([c[0] for c in chains])),
                ("gains", np.stack([c[1] for c in chains])),
                ("noise", jax.random.normal(k_noise, (t,), jnp.float32)),
                ("snr", _u(k_snr)), ("beta", _u(k_beta)), ("pos", pos),
                ("f1", _u(k_f1, (t,))), ("f2", _u(k_f2, (t,)))):
            cols[name].append(np.asarray(v))
    return dev.RawBoostDraws(**{k: torch.from_numpy(np.stack(v))
                                for k, v in cols.items()})


@pytest.mark.parametrize("seed,prob", [(0, 0.7), (1, 1.0), (2, 0.7)])
def test_host_rawboost_is_the_jax_module_bit_for_bit(seed, prob):
    jp, pp = _params()
    w = _clips()
    want = jax_host.apply_rawboost_batch(w, np.random.default_rng(seed), jp,
                                         prob=prob)
    got = host.apply_rawboost_batch(w, np.random.default_rng(seed), pp,
                                    prob=prob)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_firwin_bandstop_matches_jax():
    """Within 1e-6 of the largest tap, times the design's condition
    Σ|h| / |Σh| = Σ|h| (the taps sum to 1): the DC normalization divides
    by Σh, which short filters with wide stop bands make small (taps up to
    ~460 here, where JAX's own fp32 design is 5e-5 of its peak off
    scipy's float64 one). Measured at most half that bound over 200
    designs."""
    n = 64
    rng = np.random.default_rng(0)
    c = (2 * rng.integers(5, 50, n) + 1).astype(np.int32)
    fc = rng.uniform(20.0, 8000.0, n).astype(np.float32)
    bw = rng.uniform(100.0, 1000.0, n).astype(np.float32)
    f1 = np.maximum(fc - bw / 2, 1e-3).astype(np.float32)
    f2 = np.minimum(fc + bw / 2, FS / 2 - 1e-3).astype(np.float32)
    got = dev._firwin_bandstop(torch.from_numpy(c), torch.from_numpy(f1),
                               torch.from_numpy(f2), FS).numpy()
    want = np.asarray(jax.vmap(
        lambda *a: jax_dev._firwin_bandstop(*a, FS))(
            jnp.asarray(c), jnp.asarray(f1), jnp.asarray(f2)))
    assert (got[np.arange(dev.MAX_TAPS) >= c[:, None]] == 0.0).all()
    peak, cond = np.abs(want).max(1), np.abs(want).sum(1)
    assert (np.abs(got - want).max(1) <= 1e-6 * peak * cond).all()


@pytest.mark.parametrize("min_g,max_g", [(0.0, 0.0), (-5.0, -20.0)])
def test_notch_chain_matches_jax(min_g, max_g):
    """Given the same uniforms: equal tap counts and lengths, taps within
    1e-6 of the chain's largest."""
    jp, pp = _params()
    keys = jax.random.split(jax.random.PRNGKey(7), 6)
    bands, gains = zip(*(_chain_uniforms(k, jp) for k in keys))
    bands = torch.from_numpy(np.stack(bands))
    gains = torch.from_numpy(np.stack(gains))
    lo = torch.full((6,), min_g)
    got_b, got_len = dev._notch_chains(bands, gains, lo,
                                       torch.full((6,), max_g - min_g), pp)
    counts = dev._odd_tap_count(bands[..., 2], pp)
    assert got_b.shape == (6, dev.CHAIN)
    for i, k in enumerate(keys):
        want_c = jax_dev._odd_tap_count(jnp.asarray(bands[i, :, 2].numpy()),
                                        jp)
        np.testing.assert_array_equal(counts[i].numpy(), np.asarray(want_c))
        want_b, want_len = jax_dev._notch_chain(k, jp, min_g, max_g)
        assert int(got_len[i]) == int(want_len)
        want_b = np.asarray(want_b)
        np.testing.assert_allclose(got_b[i].numpy(), want_b, rtol=0,
                                   atol=1e-6 * np.abs(want_b).max())


@pytest.mark.parametrize("impl", ["direct", "fft"])
def test_filter_centered_matches_jax(impl):
    jp, pp = _params()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, T)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(11), 2)
    chains = [jax_dev._notch_chain(k, jp, 0.0, 0.0) for k in keys]
    b = np.stack([np.asarray(c[0]) for c in chains])
    length = np.array([int(c[1]) for c in chains], np.int32)
    got = dev._filter_centered(torch.from_numpy(x), torch.from_numpy(b),
                               torch.from_numpy(length), impl).numpy()
    for i in range(2):
        want = np.asarray(jax_dev._filter_centered(
            jnp.asarray(x[i]), jnp.asarray(b[i]), jnp.int32(length[i]), impl))
        assert np.abs(got[i] - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("beta", [0.0, 10.0, 3.7])
@pytest.mark.parametrize("mode", ["exact", "bernoulli"])
def test_isd_hit_mask_matches_jax(beta, mode):
    key = jax.random.PRNGKey(int(beta * 10) + 1)
    want = np.asarray(jax_dev._isd_hit_mask(key, T, jnp.float32(beta), mode))
    if mode == "exact":
        pos = np.asarray(jax.random.bits(key, (T,), jnp.uint16)).astype(
            np.int32)
    else:
        pos = _u(key, (T,))
    got = dev._isd_hit_mask(torch.from_numpy(pos)[None],
                            torch.tensor([beta], dtype=torch.float32), mode)
    np.testing.assert_array_equal(got[0].numpy(), want)
    if mode == "exact":
        assert int(got.sum()) == int(np.floor(np.float32(T * beta) / 100))


def test_isd_exact_mask_breaks_ties_by_position():
    """Keys with 8 levels only: the mask is the n smallest keys, ties in
    position order, exactly as a stable sort picks them."""
    rng = np.random.default_rng(4)
    pos = rng.integers(0, 8, (4, 1000)).astype(np.int32) * 8191
    beta = torch.tensor([10.0, 0.05, 7.3, 0.0])
    got = dev._isd_hit_mask(torch.from_numpy(pos), beta, "exact").numpy()
    for row, b in zip(range(4), beta.numpy()):
        n = int(np.floor(np.float32(1000 * b) / 100))
        want = np.zeros(1000, bool)
        want[np.argsort(pos[row], kind="stable")[:n]] = True
        np.testing.assert_array_equal(got[row], want)


@pytest.mark.parametrize("impl,mode,tol", [("direct", "exact", 1e-4),
                                           ("direct", "bernoulli", 1e-4),
                                           ("fft", "exact", 5e-4),
                                           ("fft", "bernoulli", 5e-4)])
def test_rawboost_batch_matches_jax(impl, mode, tol):
    """The whole batch on the JAX key's numbers, max |d| / peak within the
    JAX file's own bounds (5e-4 is its fft-vs-direct bound)."""
    jp, pp = _params(fir_impl=impl, isd_mode=mode)
    key = jax.random.PRNGKey(3)
    w = _clips()
    draws = jax_draws(key, B, T, jp)
    # the key takes both branches of the SSI and ISD gates
    for gate in (draws.c_ssi, draws.c_isd):
        assert (gate < 0.5).any() and (gate >= 0.5).any()
    got = dev.rawboost_batch(torch.from_numpy(w), draws, 1.0, pp).numpy()
    want = np.asarray(jax_dev.rawboost_batch_device(jnp.asarray(w), key, 1.0,
                                                    params=jp))
    assert got.shape == want.shape == (B, T)
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_pad_mask_and_prob_zero():
    pp = host.RawBoostParams(fir_impl="fft")
    w = torch.from_numpy(_clips())
    gen = torch.Generator().manual_seed(0)
    draws = dev.rawboost_draws(gen, B, T, pp)
    assert draws.pos.dtype == torch.int32 and draws.noise.shape == (B, T)
    assert draws.bands.shape == (B, pp.n_f + 1, pp.n_bands, 3)
    out = dev.rawboost_batch(w, draws, 1.0, pp)
    assert torch.isfinite(out).all()
    assert torch.equal(out[w == 0.0], torch.zeros_like(out[w == 0.0]))
    assert not torch.equal(out[0], w[0])
    assert torch.equal(dev.rawboost_batch(w, draws, 0.0, pp), w)
    assert torch.equal(dev.rawboost_batch(w, draws, torch.tensor(0.0), pp), w)
