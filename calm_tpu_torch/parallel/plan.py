"""Sharding plan: which mesh axes the model is partitioned over (a copy of
``calm_tpu.parallel.plan``; the port imports nothing of the JAX package).

Fixed conventions (the "megatron" layout adapted to decode):

- ``tp``: attention heads and ffn hidden dim are column-sharded
  (wq/wk/wv/w1/w3 on their output axis), wo/w2 row-sharded on the
  contraction axis with a psum to reassemble the residual; the KV cache is
  sharded over kv-heads so decode attention is fully local; embed/output are
  vocab-sharded (embed lookups are masked + psum'd, logits reassemble by
  concatenation).
- ``ep``: MoE expert axis. Each shard owns E/ep experts; routing is computed
  replicated, each shard evaluates only its resident active experts (masked),
  and expert outputs reassemble in the same psum that closes the ffn.
- ``dp``: data/batch axis for continuous batching — sequence slots are
  spread over the axis; the layer code is batch-local so dp needs no
  collectives (logits/cache come back batch-sharded).
- ``sp``: sequence parallelism over the KV rows. Prefill: prompt tokens are
  sharded along T, each shard projects QKV for its chunk, fresh K/V are
  all-gathered for the causal attention, and each shard writes its chunk's
  rows of the S-sharded cache (long-context ingestion, pos0 == 0, T == S).
  Decode (T == 1): each shard attends its local cache rows and the exact
  softmax merges with a (pmax, psum, psum) of the partial (max, sum,
  numerator) — flash-decoding style; the new row is written by its owning
  shard. sp decode scales KV capacity/bandwidth with the axis. For
  prefill-only use sp may name the same mesh axis as dp; sp decode requires
  a distinct axis (the cache cannot shard the same axis by batch and rows).

Requirements: n_kv_heads % tp == 0, hidden_dim % tp == 0 (with gf4:
(hidden/tp) % 8 == 0), vocab % tp == 0, n_experts % ep == 0, batch % dp == 0
for decode, seq_len % sp == 0 for prefill.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    tp: str | None = None   # tensor-parallel mesh axis name
    ep: str | None = None   # expert-parallel mesh axis name
    dp: str | None = None   # data/batch-parallel mesh axis name
    sp: str | None = None   # sequence-parallel (prefill) mesh axis name
    pp: str | None = None   # pipeline-parallel mesh axis name (layer stages;
                            # see calm_tpu/parallel/pipeline.py)
    ring: bool = False      # sp prefill attention as BLOCKWISE RING
                            # (ring attention / blockwise context
                            # parallelism): K/V chunks rotate over the sp
                            # axis via collective-permute while each shard
                            # folds one chunk per hop into a running
                            # online softmax — peak per-shard memory stays
                            # O(T_local) (the all-gather path transiently
                            # holds the FULL prompt's K/V per shard), and
                            # each hop's ppermute can overlap the previous
                            # chunk's attention under XLA's scheduler.
                            # Exact same softmax, different association.
    rs_ag: bool = False     # close the wo/w2 residual psum as
                            # reduce-scatter + all-gather instead of one
                            # all-reduce: the two phases each move half an
                            # all-reduce's ring bytes and give XLA's
                            # latency-hiding scheduler two independent
                            # collectives to overlap with neighboring
                            # compute (BASELINE: "all-reduce/reduce-scatter
                            # over ICI overlapped with matmul compute").
                            # Numerically identical reduction; requires
                            # dim % tp == 0.

    @property
    def axes(self) -> tuple[str, ...]:
        return tuple(a for a in (self.tp, self.ep) if a)

    def validate(self, cfg, tp_size: int, ep_size: int):
        if self.tp and tp_size > 1:
            assert cfg.n_kv_heads % tp_size == 0, \
                f"n_kv_heads {cfg.n_kv_heads} not divisible by tp={tp_size}"
            assert cfg.hidden_dim % tp_size == 0
            assert cfg.vocab_size % tp_size == 0
            if cfg.dtype == "gf4":
                assert (cfg.hidden_dim // tp_size) % 8 == 0
                assert (cfg.q_dim // tp_size) % 8 == 0
        if self.ep and ep_size > 1:
            assert cfg.n_experts and cfg.n_experts % ep_size == 0

    def validate_pp(self, cfg, pp_size: int):
        if self.pp and pp_size > 1:
            assert cfg.n_layers % pp_size == 0, \
                f"n_layers {cfg.n_layers} not divisible by pp={pp_size}"


NO_SHARDING = ShardingPlan()
