"""RawBoost waveform augmentation, host (numpy + scipy) implementation.

The port's copy of wav2vec_contr_loss_tpu/data/rawboost.py. RawBoost
(Tak et al., ICASSP 2022), as the reference applies it per clip:

  1. LnL convolutive noise: N_f passes of a multi-band FIR notch chain
     applied to successive signal powers x^(i+1), with a linear/non-linear
     gain bias from pass i == 1 on, summed, mean-removed, peak-normalized.
  2. ISD impulsive signal-dependent noise on a random beta% of samples.
  3. SSI stationary signal-independent additive noise, band-filtered
     Gaussian at a uniform SNR in [SNRmin, SNRmax] dB.

It serves `rawboost_mode='host'` in the data pipeline (data/pipeline.py).
Given the same `np.random.Generator` it gives the JAX module's output bit
for bit. The in-step device form is ops/rawboost.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
from scipy import signal as sp_signal

__all__ = [
    "RawBoostParams",
    "norm_wav",
    "gen_notch_coeffs",
    "filter_fir",
    "lnl_convolutive_noise",
    "isd_additive_noise",
    "ssi_additive_noise",
    "apply_rawboost",
    "apply_rawboost_batch",
]


@dataclass(frozen=True)
class RawBoostParams:
    """The reference's hard-coded parameterization."""

    sample_rate: int = 16000
    # LnL / notch-chain design
    n_f: int = 5
    n_bands: int = 5
    min_f: float = 20.0
    max_f: float = 8000.0
    min_bw: float = 100.0
    max_bw: float = 1000.0
    min_coeff: int = 10
    max_coeff: int = 100
    min_g: float = 0.0
    max_g: float = 0.0
    min_bias_lin_nonlin: float = 5.0
    max_bias_lin_nonlin: float = 20.0
    # ISD
    isd_p: float = 10.0
    isd_g_sd: float = 2.0
    # SSI
    snr_min: float = 10.0
    snr_max: float = 40.0
    # batch policy
    prob: float = 0.7
    ssi_prob: float = 0.5
    isd_prob: float = 0.5
    # device FIR algorithm (ops/rawboost.py only; the host path is always
    # scipy's direct form): 'direct' | 'fft' (the same linear convolution
    # through padded rfft/irfft, ~1e-6 relative rounding apart)
    fir_impl: str = "direct"
    # device ISD noise positions (ops/rawboost.py only; the host path
    # always takes the reference's exact permutation subset): 'exact'
    # (exactly floor(T*beta/100) uniformly random positions) | 'bernoulli'
    # (i.i.d. with p = beta/100)
    isd_mode: str = "exact"


def norm_wav(x: np.ndarray, always: bool) -> np.ndarray:
    """Peak-normalize; if not `always`, only when the peak exceeds 1."""
    peak = np.max(np.abs(x))
    if peak == 0:
        return x
    if always or peak > 1:
        return x / peak
    return x


def gen_notch_coeffs(rng: np.random.Generator, p: RawBoostParams,
                     min_g: float, max_g: float) -> np.ndarray:
    """Random multi-band FIR notch chain: nBands Hamming band-stop firwin
    filters convolved together, peak-gain-normalized with a random dB
    gain."""
    b = np.ones(1)
    fs = p.sample_rate
    for _ in range(p.n_bands):
        fc = rng.uniform(p.min_f, p.max_f)
        bw = rng.uniform(p.min_bw, p.max_bw)
        c = int(rng.uniform(p.min_coeff, p.max_coeff))
        if c % 2 == 0:
            c += 1
        f1 = max(fc - bw / 2, 1 / 1000)
        f2 = min(fc + bw / 2, fs / 2 - 1 / 1000)
        b = np.convolve(
            sp_signal.firwin(c, [float(f1), float(f2)], window="hamming", fs=fs), b
        )
    # on the biased LnL passes the range is reversed (min_g > max_g);
    # np.random.Generator.uniform refuses that, so the raw uniform is
    # mapped by hand
    g = min_g + (max_g - min_g) * rng.uniform(0.0, 1.0)
    _, h = sp_signal.freqz(b, 1, fs=fs)
    return (10 ** (g / 20)) * b / np.max(np.abs(h))


def filter_fir(x: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Zero-padded FIR filtering with group-delay centering."""
    n = b.shape[0] + 1
    y = sp_signal.lfilter(b, 1, np.pad(x, (0, n)))
    return y[n // 2: y.shape[0] - n // 2]


def lnl_convolutive_noise(
    x: np.ndarray, rng: np.random.Generator, p: RawBoostParams
) -> np.ndarray:
    """Linear and non-linear convolutive noise: the sum over N_f passes of
    notch-filtered signal powers x^(i+1), the gain bias from pass 1 on,
    mean-removed and normalized."""
    y = np.zeros_like(x, dtype=np.float64)
    min_g, max_g = p.min_g, p.max_g
    for i in range(p.n_f):
        if i == 1:
            min_g = p.min_g - p.min_bias_lin_nonlin
            max_g = p.max_g - p.max_bias_lin_nonlin
        b = gen_notch_coeffs(rng, p, min_g, max_g)
        y = y + filter_fir(np.power(x, i + 1), b)
    y = y - np.mean(y)
    return norm_wav(y, always=False)


def isd_additive_noise(
    x: np.ndarray, rng: np.random.Generator, p: RawBoostParams
) -> np.ndarray:
    """Impulsive signal-dependent noise: r = g_sd * x[pos] * (2u-1)(2u'-1)
    on a random beta% of samples."""
    beta = rng.uniform(0, p.isd_p)
    n = int(x.shape[0] * beta / 100)
    pos = rng.permutation(x.shape[0])[:n]
    f_r = (2 * rng.random(n) - 1) * (2 * rng.random(n) - 1)
    y = x.copy()
    y[pos] = x[pos] + p.isd_g_sd * x[pos] * f_r
    return norm_wav(y, always=False)


def ssi_additive_noise(
    x: np.ndarray, rng: np.random.Generator, p: RawBoostParams
) -> np.ndarray:
    """Stationary signal-independent noise: notch-filtered unit Gaussian
    scaled to a uniform SNR in dB."""
    noise = rng.standard_normal(x.shape[0])
    b = gen_notch_coeffs(rng, p, p.min_g, p.max_g)
    noise = norm_wav(filter_fir(noise, b), always=True)
    snr = rng.uniform(p.snr_min, p.snr_max)
    noise = (
        noise / np.linalg.norm(noise, 2) * np.linalg.norm(x, 2) / 10.0 ** (0.05 * snr)
    )
    return x + noise


def apply_rawboost(
    x: np.ndarray, rng: np.random.Generator, p: RawBoostParams = RawBoostParams()
) -> np.ndarray:
    """One utterance: LnL always, then SSI with prob ssi_prob, then ISD with
    prob isd_prob."""
    y = lnl_convolutive_noise(x.astype(np.float64), rng, p)
    if rng.random() < p.ssi_prob:
        y = ssi_additive_noise(y, rng, p)
    if rng.random() < p.isd_prob:
        y = isd_additive_noise(y, rng, p)
    return y.astype(np.float32)


def apply_rawboost_batch(
    batch: np.ndarray,
    rng: np.random.Generator,
    p: RawBoostParams = RawBoostParams(),
    prob: Optional[float] = None,
) -> np.ndarray:
    """Per-utterance stochastic policy over a (B, T) batch; augmented clips
    are re-masked by their original zero-pad mask."""
    prob = p.prob if prob is None else prob
    out = np.array(batch, dtype=np.float32, copy=True)
    pad_mask = (out != 0.0).astype(np.float32)
    for i in range(out.shape[0]):
        if rng.random() < prob:
            out[i] = apply_rawboost(out[i], rng, p)
    return out * pad_mask
