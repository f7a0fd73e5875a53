"""Tiny random models for tests and tools (the port's copy of
``tests/modelgen.py``), and HF-format checkpoints written with torch
alone.

:func:`write_tiny_model` writes, from one seed, the container that
``tests/modelgen.write_tiny_model`` writes, byte for byte: the same numpy
draws in the same order, quantized by the port's ``quant`` (fp8 codes
tagged ``F8_E5M2``/``F8_E4M3`` through ``quant.container_codes``).

:func:`write_hf_checkpoint` writes what a download of a Llama or Mixtral
checkpoint holds (``config.json``, ``model.safetensors`` under the HF
tensor names, a byte-fallback ``tokenizer.json``) from seeded normal
weights, in bf16 by default as real downloads are, without
``transformers``: the converter's input on a machine that has no
network and no ``transformers``.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

from calm_tpu_torch import container, quant
from calm_tpu_torch.config import ModelConfig
from calm_tpu_torch.utils.synth import byte_vocab

__all__ = ["byte_vocab", "tiny_config", "write_tiny_model", "hf_tokenizer_json",
           "write_hf_checkpoint"]


def tiny_config(dtype="fp16", seq_len=32, moe=False, **kw) -> ModelConfig:
    base = dict(dim=48, hidden_dim=64, head_dim=12, n_layers=2, n_heads=4,
                n_kv_heads=2, vocab_size=268, seq_len=seq_len,
                rope_theta=10000.0, rotary_dim=12, norm_eps=1e-5,
                norm_ln=False, dtype=dtype, bos_token_id=1, eos_token_id=2)
    if moe:
        base.update(n_experts=4, n_experts_ac=2)
    base.update(kw)
    return ModelConfig(**base)


def write_tiny_model(path: str, cfg: ModelConfig, seed: int = 0,
                     tied: bool = False, bias: bool = False) -> ModelConfig:
    rng = np.random.default_rng(seed)
    fmt = cfg.dtype
    D, Hd, Q, KV, V, E, L = (cfg.dim, cfg.hidden_dim, cfg.q_dim, cfg.kv_dim,
                             cfg.vocab_size, cfg.n_experts, cfg.n_layers)

    def rand(*shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[-1])
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    t = {}

    def put(name, arr, per_expert=False):
        """Quantize into the container; fp8e4 writes a side .scale tensor
        (one a expert for MoE stacks, as the converter does)."""
        if per_expert:
            qs, ss = zip(*[quant.quantize_scaled(a, fmt) for a in arr])
            t[name] = quant.container_codes(np.stack(qs), fmt)
            if ss[0] is not None:
                t[name + ".scale"] = np.stack(ss)
        else:
            qd, s = quant.quantize_scaled(arr, fmt)
            t[name] = quant.container_codes(qd, fmt)
            if s is not None:
                t[name + ".scale"] = s

    put("model.embed.weight", rand(V, D, scale=0.4))
    for l in range(L):
        p = f"model.layers.{l}"
        t[f"{p}.attn.norm.weight"] = 1.0 + rand(D, scale=0.05)
        put(f"{p}.attn.wq.weight", rand(Q, D))
        put(f"{p}.attn.wk.weight", rand(KV, D))
        put(f"{p}.attn.wv.weight", rand(KV, D))
        put(f"{p}.attn.wo.weight", rand(D, Q))
        if bias:
            t[f"{p}.attn.wqkv.bias"] = rand(Q + 2 * KV, scale=0.05)
        if not cfg.norm_par:
            t[f"{p}.mlp.norm.weight"] = 1.0 + rand(D, scale=0.05)
        if E:
            put(f"{p}.moegate.weight", rand(E, D))
            put(f"{p}.mlp.w1.weight", rand(E, Hd, D), per_expert=True)
            put(f"{p}.mlp.w2.weight", rand(E, D, Hd), per_expert=True)
            put(f"{p}.mlp.w3.weight", rand(E, Hd, D), per_expert=True)
        else:
            put(f"{p}.mlp.w1.weight", rand(Hd, D))
            put(f"{p}.mlp.w2.weight", rand(D, Hd))
            put(f"{p}.mlp.w3.weight", rand(Hd, D))
    t["model.norm.weight"] = 1.0 + rand(D, scale=0.05)
    if not tied:
        put("model.output.weight", rand(V, D, scale=0.4))

    tokens, scores = byte_vocab(V)
    t["tokenizer.tokens"] = tokens
    t["tokenizer.scores"] = scores

    container.write_tensors(path, t, cfg.to_metadata())
    return cfg


def hf_tokenizer_json(d: str, vocab_size: int) -> None:
    """A byte-fallback ``tokenizer.json`` (specials, the 256 ``<0xNN>``
    pieces, fillers) of ``vocab_size`` pieces, as ``tools/accept.py``
    writes its checkpoints'."""
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    for b in range(256):
        vocab[f"<0x{b:02X}>"] = 3 + b
    for i in range(259, vocab_size):
        vocab[f"<fill{i}>"] = i
    with open(os.path.join(d, "tokenizer.json"), "w") as f:
        json.dump({"model": {"vocab": vocab, "merges": [], "byte_fallback": True},
                   "added_tokens": []}, f)


def write_hf_checkpoint(d: str, config: dict, seed: int = 0,
                        dtype: torch.dtype = torch.bfloat16, device="cpu",
                        std: float = 0.02) -> None:
    """An HF checkpoint directory of ``config`` (a ``config.json`` dict
    naming ``LlamaForCausalLM``/``MistralForCausalLM`` or
    ``MixtralForCausalLM``): normal weights of spread ``std`` (HF's
    ``initializer_range``) drawn on ``device`` from a generator seeded
    with ``seed``, norms at 1, every tensor stored as ``dtype`` under the
    HF names in ``model.safetensors``, then ``config.json`` and
    ``tokenizer.json``."""
    arch = config["architectures"][0]
    moe = arch == "MixtralForCausalLM"
    D, H = config["hidden_size"], config["intermediate_size"]
    nh = config["num_attention_heads"]
    kvh = config.get("num_key_value_heads", nh)
    hd = config.get("head_dim") or D // nh
    V, L = config["vocab_size"], config["num_hidden_layers"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def rand(*shape):
        return (torch.randn(shape, generator=gen, device=device) * std).to(dtype).cpu()

    def ones(n):
        return torch.ones(n, dtype=dtype)

    t = {"model.embed_tokens.weight": rand(V, D)}
    for l in range(L):
        p = f"model.layers.{l}"
        t[f"{p}.input_layernorm.weight"] = ones(D)
        t[f"{p}.self_attn.q_proj.weight"] = rand(nh * hd, D)
        t[f"{p}.self_attn.k_proj.weight"] = rand(kvh * hd, D)
        t[f"{p}.self_attn.v_proj.weight"] = rand(kvh * hd, D)
        t[f"{p}.self_attn.o_proj.weight"] = rand(D, nh * hd)
        t[f"{p}.post_attention_layernorm.weight"] = ones(D)
        if moe:
            m = f"{p}.block_sparse_moe"
            t[f"{m}.gate.weight"] = rand(config["num_local_experts"], D)
            for e in range(config["num_local_experts"]):
                t[f"{m}.experts.{e}.w1.weight"] = rand(H, D)
                t[f"{m}.experts.{e}.w2.weight"] = rand(D, H)
                t[f"{m}.experts.{e}.w3.weight"] = rand(H, D)
        else:
            t[f"{p}.mlp.gate_proj.weight"] = rand(H, D)
            t[f"{p}.mlp.up_proj.weight"] = rand(H, D)
            t[f"{p}.mlp.down_proj.weight"] = rand(D, H)
    t["model.norm.weight"] = ones(D)
    if config.get("tie_word_embeddings") is not True:
        t["lm_head.weight"] = rand(V, D)
    os.makedirs(d, exist_ok=True)
    container.write_tensors(os.path.join(d, "model.safetensors"), t, {})
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(config, f)
    hf_tokenizer_json(d, V)
