"""The general generator: clips and labels from a traffic file's
parameters and a seed.

Every seed gets the same set of sizes in another order: clip lengths are
the log-normal's quantiles at (i + 0.5) / n, permuted by the seed. So
seeds change the data and the order, never the amount of work. Clips
are speech-band tones with harmonics and noise, never zero inside the
clip, zero-padded after it.
"""

from __future__ import annotations

from statistics import NormalDist
from typing import Dict

import numpy as np

SAMPLE_RATE = 16000


def clip_lengths(spec: Dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """n lengths in samples from spec['lengths'] = {'median_s', 'sigma',
    'min_s', 'max_s'}: the log-normal's quantiles, clipped, permuted."""
    nd, spec = NormalDist(), spec["lengths"]
    q = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    sec = np.clip(spec["median_s"] * np.exp(spec["sigma"] * q),
                  spec["min_s"], spec["max_s"])
    return rng.permutation(np.round(sec * SAMPLE_RATE).astype(np.int64))


def synth(rng: np.random.Generator, n: int) -> np.ndarray:
    """(n,) float32 in (-1, 1), no zero sample: a voiced tone (f0 in
    90-300 Hz, four harmonics, a slow amplitude envelope) plus noise."""
    t = np.arange(n) / SAMPLE_RATE
    f0 = rng.uniform(90.0, 300.0)
    x = sum(rng.uniform(0.2, 1.0) / k * np.sin(2 * np.pi * k * f0 * t
                                               + rng.uniform(0, 2 * np.pi))
            for k in range(1, 5))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(0.5, 3.0) * t) ** 2
    x = rng.uniform(0.05, 0.3) * x * env + rng.uniform(0.002, 0.02) \
        * rng.standard_normal(n)
    x = np.clip(x, -0.95, 0.95).astype(np.float32)
    x[x == 0.0] = 1e-4
    return x


def train_pool(spec: Dict, seed: int, samples: int):
    """-> ((N, samples) float32 zero-padded clips, (N,) int labels, half
    bonafide) for spec['pool_clips'] = N."""
    rng = np.random.default_rng(seed)
    n = spec["pool_clips"]
    lengths = clip_lengths(spec, n, rng)
    waves = np.zeros((n, samples), np.float32)
    for i, ln in enumerate(lengths):
        m = min(int(ln), samples)
        waves[i, :m] = synth(rng, m)
    labels = rng.permutation(np.arange(n) % 2).astype(np.int64)
    return waves, labels
