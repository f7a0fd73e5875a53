"""The system under test, ``calm_tpu_torch``, as the benchmark builds it:
every call into the port goes through here.

The benchmark's weights (``benchmark.weights.stacks``) are handed to the
port as they are, as ``model.Weights`` of fp8 ``QTensor`` stacks, through
``Engine.from_weights``; the vocabulary is the benchmark's byte-level one
in the port's ``Tokenizer``. The byte counts given to the Engine feed
only its banner and perf line.
"""

from __future__ import annotations

import torch

from benchmark import weights as W
from benchmark.roofline import all_weight_bytes, token_weight_bytes


def model_config(d: W.Dims):
    from calm_tpu_torch.config import ModelConfig
    return ModelConfig(dim=d.dim, hidden_dim=d.hidden, head_dim=d.head_dim,
                       n_layers=d.layers, n_heads=d.heads, n_kv_heads=d.kv_heads,
                       vocab_size=d.vocab, seq_len=d.seq_len, rope_theta=d.rope_theta,
                       rotary_dim=d.head_dim, n_experts=d.experts,
                       n_experts_ac=d.experts_per_token, norm_eps=d.norm_eps,
                       norm_ln=False, arch="mixtral" if d.experts else "llama",
                       dtype=d.format, bos_token_id=W.BOS, eos_token_id=W.EOS)


def tokenizer(d: W.Dims):
    import numpy as np

    from calm_tpu_torch.tokenizer import Tokenizer
    return Tokenizer(W.byte_pieces(d.vocab), np.zeros(d.vocab, np.float32), W.BOS, W.EOS)


def engine(d: W.Dims, w: dict, device, batch: int = 1):
    """An Engine of ``batch`` slots on the weights ``w``
    (``weights.stacks``)."""
    from calm_tpu_torch.engine import Engine
    from calm_tpu_torch.model import LayerWeights, Weights
    from calm_tpu_torch.ops.qmm import QTensor

    q = {k: QTensor(v, d.format) if v.dtype != torch.float32 else v for k, v in w.items()}
    layers = LayerWeights(attn_norm=q["attn_norm"], ffn_norm=q["ffn_norm"], wq=q["wq"],
                          wk=q["wk"], wv=q["wv"], wo=q["wo"], w1=q["w1"], w2=q["w2"],
                          w3=q["w3"], moegate=q.get("moegate"))
    weights = Weights(embed=q["embed"], layers=layers, final_norm=q["final_norm"],
                      output=q["output"])
    return Engine.from_weights(model_config(d), weights, tokenizer(d),
                               n_bytes=all_weight_bytes(d), n_params=all_weight_bytes(d),
                               n_bandwidth=token_weight_bytes(d),
                               kv_dtype=d.kv_dtype, device=device, batch=batch)


def server(eng, batch: int, prefix_cache_tokens: int = 0):
    """A continuous-batching Server of ``batch`` slots on ``eng``: dense
    cache, host sampling (``httpd``'s default)."""
    from calm_tpu_torch.serve import Server
    return Server(engine=eng, batch=batch, prefix_cache_tokens=prefix_cache_tokens,
                  device=eng.device)
