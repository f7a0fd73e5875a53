"""The benchmark's own count of the bytes and operations that the
window's work needs, and the least time an H100 could take for it.

Counted from the configuration's shapes and the tokens the traffic fed,
never from the program:

- weights at their stored width (fp8: one byte), read once per decode
  step or prefill, whatever the number of rows; norms in f32, and one
  embedding row a token;
- a MoE token reads the router and the 2 experts it selects. A step or
  prefill of R rows reads E * (1 - ((E - k) / E)^R) distinct experts: a
  row misses a given expert with probability C(E-1, k) / C(E, k) =
  (E - k) / E, 0.75 for Mixtral's 2 of 8, and routing on seeded random
  weights is taken as uniform. That is exactly 2 at one row and within
  0.01 of 8 from 24 rows;
- KV (bf16) at each position up to the token's: the rows before it
  read, its own written. A prefill of T rows from pos0 reads the pos0
  rows before it and writes T;
- 2 operations per multiply-add: the products, the routed experts' (k a
  token), and attention's two products over each row's KV length. A
  prefill's lm-head runs on its last row only.

Each step's bound is max(bytes / 3350 GB/s, operations / 989.5 TFLOP/s),
the H100 SXM data sheet's HBM rate and dense bf16 tensor rate.

Per decode token at fp8 (one row), matrices only:

- Mistral-7B: attention 41,943,040 B + FFN 176,160,768 B a layer, times
  32, plus the lm-head's 131,072,000: 7,110,393,856 B (7.110 GB); with
  norms and the embedding row 7,111,462,912 B. KV adds 131,072 B a
  position: at position 1280, 7,279,366,144 B, a bound of 2.173 ms.
- Mixtral 8x7B: attention + router (32,768 B) + 2 x 176,160,768 B a
  layer, times 32, plus the lm-head: 12,748,587,008 B (12.75 GB); at
  position 1280, 12.92 GB, 3.856 ms. All its weights: 46,702,526,464 B.
"""

from __future__ import annotations

import dataclasses

from benchmark.weights import Dims

HBM_BYTES_S = 3350e9
PEAK_FLOPS = 989.5e12
WEIGHT_BYTES = {"fp8": 1}
KV_BYTES = {"bf16": 2, "fp8": 1}


def attn_bytes(d: Dims) -> int:
    """One layer's q, k, v and o projections."""
    return WEIGHT_BYTES[d.format] * ((d.q_dim + 2 * d.kv_dim) * d.dim + d.dim * d.q_dim)


def expert_bytes(d: Dims) -> int:
    """One FFN (one expert of a MoE layer): w1, w3 and w2."""
    return WEIGHT_BYTES[d.format] * 3 * d.hidden * d.dim


def router_bytes(d: Dims) -> int:
    return WEIGHT_BYTES[d.format] * d.experts * d.dim


def head_bytes(d: Dims) -> int:
    return WEIGHT_BYTES[d.format] * d.vocab * d.dim


def vector_bytes(d: Dims) -> int:
    """The norms (f32): two a layer and the final one."""
    return 4 * (2 * d.layers * d.dim + d.dim)


def experts_read(d: Dims, rows: int) -> float:
    """Expected distinct experts a step of ``rows`` rows reads (1 if dense)."""
    if not d.experts:
        return 1.0
    miss = (d.experts - d.experts_per_token) / d.experts
    return d.experts * (1.0 - miss ** rows)


def token_weight_bytes(d: Dims) -> int:
    """The matrices one decode token reads: the figures in the docstring."""
    ffn = (router_bytes(d) + d.experts_per_token * expert_bytes(d)
           if d.experts else expert_bytes(d))
    return d.layers * (attn_bytes(d) + ffn) + head_bytes(d)


def all_weight_bytes(d: Dims) -> int:
    """Every matrix of the model, embedding included."""
    ffn = router_bytes(d) + d.experts * expert_bytes(d) if d.experts else expert_bytes(d)
    return d.layers * (attn_bytes(d) + ffn) + 2 * head_bytes(d)


def kv_position_bytes(d: Dims) -> int:
    """K and V of one position in every layer."""
    return 2 * d.layers * d.kv_dim * KV_BYTES[d.kv_dtype]


def _weights_once(d: Dims, rows: int) -> float:
    return (d.layers * (attn_bytes(d) + router_bytes(d) + experts_read(d, rows) * expert_bytes(d))
            + head_bytes(d) + vector_bytes(d) + rows * d.dim * WEIGHT_BYTES[d.format])


def _row_macs(d: Dims) -> int:
    """Multiply-adds of one row through the layers' products (lm-head apart)."""
    ffn_macs = 3 * d.hidden * d.dim * (d.experts_per_token if d.experts else 1)
    return d.layers * ((d.q_dim + 2 * d.kv_dim) * d.dim + d.dim * d.q_dim
                       + d.experts * d.dim + ffn_macs)


def _attn_macs(d: Dims, kv_total: int) -> int:
    """Scores and mix over ``kv_total`` (row, KV position) pairs."""
    return 2 * d.layers * d.q_dim * kv_total


@dataclasses.dataclass
class Work:
    """Bytes and operations of some steps, and their summed bound."""

    bytes: float = 0.0
    flops: float = 0.0
    bound_s: float = 0.0
    bytes_bound_s: float = 0.0  # the part of bound_s where bytes govern
    decode_steps: int = 0
    prefills: int = 0

    def add(self, nbytes: float, flops: float) -> None:
        tb, tf = nbytes / HBM_BYTES_S, flops / PEAK_FLOPS
        self.bytes += nbytes
        self.flops += flops
        self.bound_s += max(tb, tf)
        if tb >= tf:
            self.bytes_bound_s += tb

    def decode(self, d: Dims, kv_lens: list[int]) -> None:
        """One decode step of len(kv_lens) rows, row i at position
        kv_lens[i] - 1."""
        if not kv_lens:
            return
        rows = len(kv_lens)
        kv = sum(kv_lens)
        self.decode_steps += 1
        self.add(_weights_once(d, rows) + kv * kv_position_bytes(d),
                 2 * (rows * (_row_macs(d) + d.vocab * d.dim) + _attn_macs(d, kv)))

    def prefill(self, d: Dims, t: int, pos0: int = 0) -> None:
        """A prefill of ``t`` rows at positions pos0 .. pos0 + t - 1."""
        if t <= 0:
            return
        kv = t * pos0 + t * (t + 1) // 2
        self.prefills += 1
        self.add(_weights_once(d, t) + (pos0 + t) * kv_position_bytes(d),
                 2 * (t * _row_macs(d) + d.vocab * d.dim + _attn_macs(d, kv)))

    def governs(self) -> str:
        if not self.bound_s:
            return "none"
        share = self.bytes_bound_s / self.bound_s
        return f"bytes {100 * share:.1f}%, operations {100 * (1 - share):.1f}% of the bound"
