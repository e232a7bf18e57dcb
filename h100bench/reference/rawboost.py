"""Plain PyTorch RawBoost (Tak et al., ICASSP 2022) over a batch, with
every random number drawn from one generator in a fixed order.

The reference's own copy of the batch form the project trains with:
LnL convolutive noise (5 passes of a 5-band FIR notch chain over x,
x^2, ..., x^5, a gain bias from pass 1 on), then SSI (band-filtered
Gaussian noise at a uniform SNR) with probability 0.5, then ISD
(impulsive noise at exactly floor(T beta / 100) positions) with
probability 0.5; each clip takes the chain with probability `prob` and
is re-masked by its zero padding. The filters run as FFT convolutions in
fp32. The draws are made on the generator's device in the order and
shapes the program draws them, so one seed gives the same numbers here.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

# the reference recipe's fixed parameters
P = dict(sample_rate=16000, n_f=5, n_bands=5, min_f=20.0, max_f=8000.0,
         min_bw=100.0, max_bw=1000.0, min_coeff=10, max_coeff=100,
         min_g=0.0, max_g=0.0, min_bias=5.0, max_bias=20.0, isd_p=10.0,
         isd_g_sd=2.0, snr_min=10.0, snr_max=40.0, ssi_prob=0.5,
         isd_prob=0.5)
MAX_TAPS = 101
CHAIN = 512
_FREQZ_N = 1024


def draws(gen: torch.Generator, batch: int, t: int) -> Dict[str, torch.Tensor]:
    dev = gen.device

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    d = {"gate": uniform(batch), "c_ssi": uniform(batch),
         "c_isd": uniform(batch),
         "bands": uniform(batch, P["n_f"] + 1, P["n_bands"], 3),
         "gains": uniform(batch, P["n_f"] + 1),
         "noise": torch.randn((batch, t), generator=gen, device=dev)}
    d["snr"], d["beta"] = uniform(batch), uniform(batch)
    d["pos"] = torch.randint(0, 1 << 16, (batch, t), generator=gen,
                             device=dev, dtype=torch.int32)
    d["f1"], d["f2"] = uniform(batch, t), uniform(batch, t)
    return d


def _bandstop(c, f1, f2, fs):
    nyq = fs / 2.0
    left, right = (f1 / nyq)[..., None], (f2 / nyq)[..., None]
    idx = torch.arange(MAX_TAPS, dtype=torch.float32, device=c.device)
    cf = c.to(torch.float32)[..., None]
    m = idx - (cf - 1.0) / 2.0
    h = left * torch.sinc(left * m) + torch.sinc(m) - right * torch.sinc(
        right * m)
    window = 0.54 - 0.46 * torch.cos(2.0 * math.pi * idx
                                     / torch.clamp(cf - 1.0, min=1.0))
    h = torch.where(idx < cf, h * window, 0.0)
    return h / h.sum(-1, keepdim=True)


def _fft_conv_full(a, h):
    """Row-wise full linear convolution by FFT."""
    n = a.shape[-1] + h.shape[-1] - 1
    m = 1 << (n - 1).bit_length()
    out = torch.fft.irfft(torch.fft.rfft(a, n=m) * torch.fft.rfft(h, n=m),
                          n=m)
    return out[..., :n]


def _chains(bands, gains):
    fs = float(P["sample_rate"])
    fc = P["min_f"] + bands[..., 0] * (P["max_f"] - P["min_f"])
    bw = P["min_bw"] + bands[..., 1] * (P["max_bw"] - P["min_bw"])
    c = torch.floor(P["min_coeff"] + bands[..., 2]
                    * (P["max_coeff"] - P["min_coeff"])).to(torch.int32)
    c = torch.where(c % 2 == 0, c + 1, c)
    f1 = torch.clamp(fc - bw / 2.0, min=1e-3)
    f2 = torch.clamp(fc + bw / 2.0, max=fs / 2.0 - 1e-3)
    h = _bandstop(c, f1, f2, fs)
    b = torch.zeros(*gains.shape, CHAIN, dtype=torch.float32,
                    device=gains.device)
    b[..., 0] = 1.0
    for i in range(P["n_bands"]):
        b = _fft_conv_full(b, h[..., i, :])[..., :CHAIN]
    length = 1 + (c - 1).sum(-1, dtype=torch.int32)
    i = torch.arange(P["n_f"] + 1, device=gains.device)
    biased = (i >= 1) & (i < P["n_f"])
    lo = torch.where(biased, P["min_g"] - P["min_bias"], P["min_g"])
    hi = torch.where(biased, P["max_g"] - P["max_bias"], P["max_g"])
    g = lo + gains * (hi - lo)
    spec = torch.fft.rfft(b, n=_FREQZ_N).abs()[..., :512]
    return (10.0 ** (g / 20.0))[..., None] * b / spec.amax(-1, keepdim=True), \
        length


def _centred(x, b, length):
    t = x.shape[-1]
    full = _fft_conv_full(x, b)
    rows = full.reshape(-1, full.shape[-1])
    start = ((length + 1) // 2).reshape(-1).to(torch.int64)
    idx = start[:, None] + torch.arange(t, device=x.device)[None, :]
    return torch.gather(rows, 1, idx).reshape(x.shape)


def _norm(x, always):
    peak = x.abs().amax(-1, keepdim=True)
    y = x / torch.clamp(peak, min=1e-30)
    return y if always else torch.where(peak > 1.0, y, x)


def _isd_positions(pos, beta):
    """Exactly n = floor(T beta / 100) positions a row: those of the n
    smallest 16-bit keys, ties taken in position order."""
    t = pos.shape[-1]
    n = torch.floor(t * beta / 100.0).to(torch.int64)
    key = pos.to(torch.int64) * t + torch.arange(t, device=pos.device)
    rank = torch.argsort(torch.argsort(key, dim=-1), dim=-1)
    return rank < n[:, None]


def rawboost(x: torch.Tensor, d: Dict[str, torch.Tensor],
             prob: float) -> torch.Tensor:
    pad = (x != 0.0).to(torch.float32)
    chains, lengths = _chains(d["bands"], d["gains"])
    inputs = torch.stack([x ** (i + 1) for i in range(P["n_f"])]
                         + [d["noise"]], dim=1)
    filt = _centred(inputs, chains, lengths)
    y = filt[:, :P["n_f"]].sum(1)
    y = _norm(y - y.mean(-1, keepdim=True), always=False)
    noise = _norm(filt[:, P["n_f"]], always=True)
    snr = P["snr_min"] + d["snr"] * (P["snr_max"] - P["snr_min"])
    scale = (torch.linalg.vector_norm(y, dim=-1)
             / torch.clamp(torch.linalg.vector_norm(noise, dim=-1), min=1e-30)
             / 10.0 ** (0.05 * snr))
    y = torch.where((d["c_ssi"] < P["ssi_prob"])[:, None],
                    y + noise * scale[:, None], y)
    hit = _isd_positions(d["pos"], d["beta"] * P["isd_p"])
    f_r = (2.0 * d["f1"] - 1.0) * (2.0 * d["f2"] - 1.0)
    isd = _norm(torch.where(hit, y + P["isd_g_sd"] * y * f_r, y),
                always=False)
    y = torch.where((d["c_isd"] < P["isd_prob"])[:, None], isd, y)
    return torch.where((d["gate"] < prob)[:, None], y, x) * pad
