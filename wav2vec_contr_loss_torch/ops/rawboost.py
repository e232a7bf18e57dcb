"""RawBoost on the device, inside the train step.

The port of `rawboost_batch_device` (wav2vec_contr_loss_tpu/ops/rawboost.py
:254-268). The JAX module is plain XLA, with no Pallas kernel, so this is
plain PyTorch on tensors. It comes in two parts:

  * `rawboost_draws(gen, B, T, params)` draws every random number of one
    batch (`RawBoostDraws`) from one generator, on that generator's device:
    the large (B, T) arrays are drawn on the card, never copied there.
  * `rawboost_batch(batch, draws, prob, params)` is deterministic: the
    same draws give the JAX function's output for the same numbers
    (tests/test_torch_rawboost.py builds the draws from the JAX key
    schedule and holds the two together).

Where the JAX module vmaps over clips and unrolls the 5 LnL passes and
SSI, each with a 5-band notch chain, this module batches over clips and
the 6 chains and loops in Python only over the 5 bands: every FIR design
and every centred filter of a batch is one tensor operation. The same
static-shape forms as the JAX module:

  * tap counts c ~ U[10, 100], made odd, in fp32 as JAX computes them;
    each band filter in a MAX_TAPS buffer, zero past c taps;
  * the 5-band chain in a CHAIN buffer, with its true length;
  * the group-delay centring as a per-row gather at (length + 1) // 2,
    never a host read;
  * ISD positions 'exact' (the n = floor(T beta / 100) smallest 16-bit
    keys, ties by position: a 16-step threshold search and a cumsum) or
    'bernoulli' (i.i.d. at beta / 100).

Every filter runs in fp32. `conv1d` is a cross-correlation, so the direct
form flips the taps to give `jnp.convolve`'s true convolution, and it runs
with cuDNN's TF32 off: a 10-bit mantissa would raise the notch filters'
noise floor the way the JAX module's docstring rejects for bf16. 'fft' is
the same linear convolution through rfft/irfft at `_fft_size`'s length
(81,920 at T = 80,000). Nothing reads a device value on the host: the
gates, normalizations and the ISD count are tensor `where`s.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields

import torch
import torch.nn.functional as F

from ..data.rawboost import RawBoostParams
from ..device import fp32_convs

__all__ = ["RawBoostDraws", "rawboost_draws", "rawboost_batch", "MAX_TAPS",
           "CHAIN"]

MAX_TAPS = 101   # c <= 100 odd-forced -> 99; headroom to 101
CHAIN = 512      # >= 5 * 99 - 4 = 491
_FREQZ_N = 1024  # rfft length reproducing scipy.signal.freqz's 512-pt grid
_KEY_LEVELS = 1 << 16


@dataclass
class RawBoostDraws:
    """Every random number of one batch, in the JAX module's terms. Chain
    index 0..n_f-1 are the LnL passes, index n_f the SSI chain.

      gate, c_ssi, c_isd: (B,) uniforms of the three probability gates;
      bands:  (B, n_f + 1, n_bands, 3) uniforms of each band (centre,
              bandwidth, tap count);
      gains:  (B, n_f + 1) uniforms of each chain's dB gain;
      noise:  (B, T) standard normal SSI noise;
      snr:    (B,) uniform of the SSI SNR;
      beta:   (B,) uniform of the ISD share (beta = uniform * isd_p);
      pos:    (B, T) ISD position draws: int32 16-bit keys for
              isd_mode='exact', fp32 uniforms for 'bernoulli';
      f1, f2: (B, T) uniforms of the ISD noise factor.
    """

    gate: torch.Tensor
    c_ssi: torch.Tensor
    c_isd: torch.Tensor
    bands: torch.Tensor
    gains: torch.Tensor
    noise: torch.Tensor
    snr: torch.Tensor
    beta: torch.Tensor
    pos: torch.Tensor
    f1: torch.Tensor
    f2: torch.Tensor

    def to(self, device) -> "RawBoostDraws":
        return RawBoostDraws(**{f.name: getattr(self, f.name).to(device)
                                for f in fields(self)})


def rawboost_draws(gen: torch.Generator, batch: int, t: int,
                   params: RawBoostParams = RawBoostParams()
                   ) -> RawBoostDraws:
    """Draw one batch's numbers from `gen`, on `gen.device`, in a fixed
    order."""
    dev = gen.device
    p = params

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    gate, c_ssi, c_isd = uniform(batch), uniform(batch), uniform(batch)
    bands = uniform(batch, p.n_f + 1, p.n_bands, 3)
    gains = uniform(batch, p.n_f + 1)
    noise = torch.randn((batch, t), generator=gen, device=dev)
    snr, beta = uniform(batch), uniform(batch)
    if p.isd_mode == "exact":
        pos = torch.randint(0, _KEY_LEVELS, (batch, t), generator=gen,
                            device=dev, dtype=torch.int32)
    elif p.isd_mode == "bernoulli":
        pos = uniform(batch, t)
    else:
        raise ValueError(f"isd_mode must be 'exact' or 'bernoulli'; got "
                         f"{p.isd_mode!r}")
    return RawBoostDraws(gate, c_ssi, c_isd, bands, gains, noise, snr, beta,
                         pos, uniform(batch, t), uniform(batch, t))


def _convolve_full(a: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Row-wise `jnp.convolve(a, h, mode='full')` over the leading dims:
    (..., L) and (..., K) -> (..., L + K - 1), one grouped conv1d."""
    lead, k = a.shape[:-1], h.shape[-1]
    rows = math.prod(lead)
    x = F.pad(a.reshape(1, rows, -1), (k - 1, k - 1))
    w = h.reshape(rows, 1, k).flip(-1)
    with fp32_convs():
        out = F.conv1d(x, w, groups=rows)
    return out.reshape(*lead, -1)


def _firwin_bandstop(c: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor,
                     fs: float) -> torch.Tensor:
    """scipy.signal.firwin(c, [f1, f2], window='hamming', fs=fs) with
    pass_zero=True (band-stop) for odd c <= MAX_TAPS, elementwise over
    the leading dims: (..., MAX_TAPS), zero past c taps."""
    nyq = fs / 2.0
    left = (f1 / nyq)[..., None]
    right = (f2 / nyq)[..., None]
    idx = torch.arange(MAX_TAPS, dtype=torch.float32, device=c.device)
    cf = c.to(torch.float32)[..., None]
    m = idx - (cf - 1.0) / 2.0
    live = idx < cf
    # sum over the passbands (0, left) and (right, 1)
    h = left * torch.sinc(left * m) + torch.sinc(m) - right * torch.sinc(
        right * m)
    window = 0.54 - 0.46 * torch.cos(2.0 * math.pi * idx
                                     / torch.clamp(cf - 1.0, min=1.0))
    h = torch.where(live, h * window, 0.0)
    # scale=True: unit response at DC
    return h / h.sum(-1, keepdim=True)


def _odd_tap_count(u: torch.Tensor, p: RawBoostParams) -> torch.Tensor:
    """c = floor(min + u (max - min)) in fp32; even -> c + 1."""
    c = torch.floor(p.min_coeff + u * (p.max_coeff - p.min_coeff)).to(
        torch.int32)
    return torch.where(c % 2 == 0, c + 1, c)


def _gain_ranges(p: RawBoostParams, device):
    """(min_g, max_g - min_g) of each of the n_f + 1 chains: the LnL gain
    bias starts at pass 1 and persists for every later pass; the SSI chain
    has none. Made on the device, without a copy from the host."""
    i = torch.arange(p.n_f + 1, device=device)
    biased = (i >= 1) & (i < p.n_f)
    lo = torch.where(biased, p.min_g - p.min_bias_lin_nonlin, p.min_g)
    hi = torch.where(biased, p.max_g - p.max_bias_lin_nonlin, p.max_g)
    return lo.to(torch.float32), (hi - lo).to(torch.float32)


def _notch_chains(bands: torch.Tensor, gains: torch.Tensor,
                  min_g: torch.Tensor, g_span: torch.Tensor,
                  p: RawBoostParams):
    """Random n_bands-filter notch chains, one per leading index:
    bands (..., n_bands, 3) and gains (...) -> the chain taps (..., CHAIN)
    and their true lengths (...) int32."""
    fs = float(p.sample_rate)
    fc = p.min_f + bands[..., 0] * (p.max_f - p.min_f)
    bw = p.min_bw + bands[..., 1] * (p.max_bw - p.min_bw)
    c = _odd_tap_count(bands[..., 2], p)
    f1 = torch.clamp(fc - bw / 2.0, min=1e-3)
    f2 = torch.clamp(fc + bw / 2.0, max=fs / 2.0 - 1e-3)
    h = _firwin_bandstop(c, f1, f2, fs)             # (..., n_bands, MAX_TAPS)

    b = torch.zeros(*gains.shape, CHAIN, dtype=torch.float32,
                    device=gains.device)
    b[..., 0] = 1.0
    for i in range(p.n_bands):
        b = _convolve_full(b, h[..., i, :])[..., :CHAIN]
    length = 1 + (c - 1).sum(-1, dtype=torch.int32)

    g = min_g + gains * g_span
    # peak-gain normalization on scipy.signal.freqz's 512-point grid
    spec = torch.fft.rfft(b, n=_FREQZ_N).abs()[..., :512]
    b = (10.0 ** (g / 20.0))[..., None] * b / spec.amax(-1, keepdim=True)
    return b, length


def _fft_size(m: int) -> int:
    """Smallest 2^a * b (b in {1, 3, 5}) >= m, the JAX module's length."""
    best = None
    for b in (1, 3, 5):
        p = 1
        while b * p < m:
            p <<= 1
        n = b * p
        best = n if best is None or n < best else best
    return best


def _filter_centered(x: torch.Tensor, b: torch.Tensor, length: torch.Tensor,
                     impl: str) -> torch.Tensor:
    """Group-delay-centred FIR filtering over the leading dims, output
    length == input length: the full convolution of x (..., T) with the
    chain b (..., CHAIN), sliced at (length + 1) // 2 row by row."""
    t = x.shape[-1]
    if impl == "fft":
        n = _fft_size(t + CHAIN - 1)
        full = torch.fft.irfft(torch.fft.rfft(x, n=n) * torch.fft.rfft(b, n=n),
                               n=n)
    elif impl == "direct":
        full = _convolve_full(x, b)
    else:
        raise ValueError(f"fir_impl must be 'direct' or 'fft'; got {impl!r}")
    rows = full.reshape(-1, full.shape[-1])
    start = ((length + 1) // 2).reshape(-1).to(torch.int64)
    out = rows.unfold(-1, t, 1)[torch.arange(rows.shape[0],
                                             device=x.device), start]
    return out.reshape(x.shape)


def _norm_wav(x: torch.Tensor, always: bool) -> torch.Tensor:
    """Row-wise peak normalization (always, or where the peak exceeds 1)."""
    peak = x.abs().amax(-1, keepdim=True)
    y = x / torch.clamp(peak, min=1e-30)
    return y if always else torch.where(peak > 1.0, y, x)


def _isd_hit_mask(pos: torch.Tensor, beta: torch.Tensor,
                  mode: str) -> torch.Tensor:
    """(B, T) bool noise positions. 'exact': exactly n = floor(T beta/100)
    positions per row, those of the n smallest keys with ties taken by
    position: the largest threshold with fewer than n keys below it, by a
    16-step bit search, then the tied keys in position order.
    'bernoulli': position uniforms below beta / 100."""
    if mode == "bernoulli":
        return pos < (beta / 100.0)[:, None]
    if mode != "exact":
        raise ValueError(f"isd_mode must be 'exact' or 'bernoulli'; got "
                         f"{mode!r}")
    n = torch.floor(pos.shape[-1] * beta / 100.0).to(torch.int32)
    thr = torch.zeros_like(n)
    for i in range(16):
        cand = thr | (1 << (15 - i))
        cnt = (pos < cand[:, None]).sum(-1, dtype=torch.int32)
        thr = torch.where(cnt < n, cand, thr)
    less = pos < thr[:, None]
    eq = pos == thr[:, None]
    need = n - less.sum(-1, dtype=torch.int32)
    eq_rank = eq.to(torch.int32).cumsum(-1)   # inclusive rank among ties
    mask = less | (eq & (eq_rank <= need[:, None]))
    return mask & (n > 0)[:, None]


def rawboost_batch(batch: torch.Tensor, draws: RawBoostDraws, prob,
                   params: RawBoostParams = RawBoostParams()) -> torch.Tensor:
    """RawBoost over a (B, T) batch of zero-padded clips with the numbers
    of `draws` (on the batch's device): per clip, with probability `prob`
    (float or tensor), LnL, then SSI w.p. ssi_prob, then ISD w.p.
    isd_prob; the result is re-masked by the clips' original zero pad."""
    p = params
    x = batch.to(torch.float32)
    if x.dim() != 2 or draws.noise.shape != x.shape:
        raise ValueError(f"batch {tuple(x.shape)} and draws "
                         f"{tuple(draws.noise.shape)} must be one (B, T)")
    pad_mask = (x != 0.0).to(torch.float32)

    min_g, g_span = _gain_ranges(p, x.device)
    chains, lengths = _notch_chains(draws.bands, draws.gains, min_g, g_span,
                                    p)
    # the n_f LnL passes filter x, x^2, ..., x^n_f; the SSI chain its noise
    inputs = torch.stack([x ** (i + 1) for i in range(p.n_f)]
                         + [draws.noise], dim=1)
    filtered = _filter_centered(inputs, chains, lengths, p.fir_impl)

    # LnL
    y = filtered[:, :p.n_f].sum(1)
    y = _norm_wav(y - y.mean(-1, keepdim=True), always=False)
    # SSI
    noise = _norm_wav(filtered[:, p.n_f], always=True)
    snr = p.snr_min + draws.snr * (p.snr_max - p.snr_min)
    scale = (torch.linalg.vector_norm(y, dim=-1)
             / torch.clamp(torch.linalg.vector_norm(noise, dim=-1), min=1e-30)
             / 10.0 ** (0.05 * snr))
    y = torch.where((draws.c_ssi < p.ssi_prob)[:, None],
                    y + noise * scale[:, None], y)
    # ISD
    hit = _isd_hit_mask(draws.pos, draws.beta * p.isd_p, p.isd_mode)
    f_r = (2.0 * draws.f1 - 1.0) * (2.0 * draws.f2 - 1.0)
    isd = _norm_wav(torch.where(hit, y + p.isd_g_sd * y * f_r, y),
                    always=False)
    y = torch.where((draws.c_isd < p.isd_prob)[:, None], isd, y)

    out = torch.where((draws.gate < prob)[:, None], y, x)
    return out * pad_mask
