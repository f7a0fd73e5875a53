"""The pieces every traffic driver draws from the seed: prompt texts and
stratified lengths and gaps.

Lengths and inter-arrival gaps are the quantiles of their distribution at
(i + 0.5) / n, shuffled by the seed: every seed gets the same multiset of
sizes and arrivals in another order, so that the seed changes which
request is which and not how much work a window holds.
"""

from __future__ import annotations

import statistics

import numpy as np

# no "<" or "|", so no text scans as a special token; one byte a token
ALPHABET = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789.,",
                         dtype=np.uint8)


def text(rng: np.random.Generator, n: int) -> str:
    return ALPHABET[rng.integers(0, len(ALPHABET), int(n))].tobytes().decode()


def _quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def lognormal(n: int, median: float, sigma: float, lo: int, hi: int) -> np.ndarray:
    """n stratified lognormal sizes, clipped to [lo, hi], in ascending order."""
    z = np.array([statistics.NormalDist().inv_cdf(q) for q in _quantiles(n)])
    return np.clip(np.rint(median * np.exp(sigma * z)), lo, hi).astype(np.int64)


def exponential(n: int, rate: float) -> np.ndarray:
    """n stratified Poisson inter-arrival gaps (s) at ``rate`` a second."""
    return -np.log1p(-_quantiles(n)) / rate


def shuffled(rng: np.random.Generator, a: np.ndarray) -> np.ndarray:
    return a[rng.permutation(len(a))]
