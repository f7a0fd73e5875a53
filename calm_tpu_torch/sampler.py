"""Token sampling: greedy argmax and min-p (cutoff) sampling.

Functional contract mirrors the reference sampler (src/sampler.c):

- xorshift64* RNG producing float32 coins in [0, 1) (src/sampler.c:7-17)
- temperature == 0 (or minp >= 1) selects greedy argmax, first-max-wins
- min-p works in logit space: since min-p is scale-invariant wrt softmax,
  the cutoff is ``max_logit + log(minp) * temperature`` and only surviving
  logits are exponentiated (src/sampler.c:44-78)
- ``sample_prob`` returns the softmax probability of one index, used by the
  perplexity harness (src/sampler.c:19-32)

Host-side numpy: logits arrive on host once per token; sampling cost is
negligible next to the forward pass. Copy of ``calm_tpu.sampler`` without
the JAX device sampler.
"""

from __future__ import annotations

import math

import numpy as np

_MASK64 = (1 << 64) - 1


class XorshiftRng:
    """xorshift64* generator, bit-compatible with the reference."""

    def __init__(self, seed: int):
        self.state = seed & _MASK64
        if self.state == 0:
            self.state = 1

    def next_u32(self) -> int:
        s = self.state
        s ^= s >> 12
        s ^= (s << 25) & _MASK64
        s ^= s >> 27
        self.state = s
        return ((s * 0x2545F4914F6CDD1D) & _MASK64) >> 32

    def next_f32(self) -> float:
        return (self.next_u32() >> 8) / 16777216.0


def softmax_prob(idx: int, logits: np.ndarray) -> float:
    """Softmax probability of one index (for perplexity)."""
    logits = np.asarray(logits, dtype=np.float32)
    m = float(logits.max())
    e = np.exp(logits - m, dtype=np.float32)
    return float(e[idx]) / float(e.sum(dtype=np.float32))


class Sampler:
    def __init__(self, vocab_size: int, seed: int = 42,
                 temperature: float = 1.0, minp: float = 0.1):
        self.vocab_size = vocab_size
        self.temperature = float(temperature)
        self.minp = float(minp)
        self.rng = XorshiftRng(seed)

    def sample(self, logits: np.ndarray) -> int:
        logits = np.asarray(logits, dtype=np.float32)[: self.vocab_size]
        if self.temperature == 0.0 or self.minp >= 1.0:
            return int(np.argmax(logits))  # first max wins, like the reference
        coin = self.rng.next_f32()
        return self._sample_minp(logits, coin)

    def _sample_minp(self, logits: np.ndarray, coin: float) -> int:
        max_logit = float(logits.max())
        # exp(l/T) <= exp(max/T) * minp  <=>  l <= max + log(minp) * T
        cutoff = max_logit + math.log(self.minp) * self.temperature

        keep = logits >= cutoff
        probs = np.where(keep,
                         np.exp((logits - max_logit) / self.temperature,
                                dtype=np.float32),
                         np.float32(0.0))
        cumulative = float(probs.sum(dtype=np.float32))
        r = coin * cumulative
        cdf = np.cumsum(probs, dtype=np.float32)
        hits = np.nonzero(r < cdf)[0]
        if hits.size:
            return int(hits[0])
        # rounding-error fallback: last surviving index (reference behavior)
        return int(np.nonzero(keep)[0][-1])
