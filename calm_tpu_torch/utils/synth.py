"""Synthetic model weights built directly on the device.

Decode speed does not depend on weight values, so full-size models for
measurement are filled with a cheap deterministic bit pattern instead of
downloaded checkpoints. The pattern and the fill order are those of
``calm_tpu.utils.synth`` (value i of a tensor has bits
``i * 2654435761 + seed`` mod 2^32, masked so fp8 stays finite and small
and fp16 stays below ~0.06), so the two packages build identical weights
from one seed. :func:`synth_container` writes such a model as a .calm
file with the port's own container writer.

The pattern repeats every 256 values in its low byte, so in an fp8 matrix
whose rows are a multiple of 256 wide every row holds the same bytes and
every logit comes out equal. Checks of correctness therefore ask for
``random=True``: the same masks over bits drawn from a seeded
``torch.Generator`` on the device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from calm_tpu_torch.config import ModelConfig
from calm_tpu_torch.container import write_tensors
from calm_tpu_torch.model import LayerWeights, Weights
from calm_tpu_torch.ops.qmm import QTensor

_SLAB = 1 << 26  # elements generated per pass (bounds the int64 temporaries)


def _signed(bits: torch.Tensor, width: int) -> torch.Tensor:
    half = 1 << (width - 1)
    return ((bits + half) & ((1 << width) - 1)) - half


def _fill(shape, fmt: str, seed: int, device,
          gen: torch.Generator | None = None) -> torch.Tensor:
    n = math.prod(shape)
    out_dtype = {"fp16": torch.float16, "fp8": torch.float8_e5m2,
                 "fp8e4": torch.float8_e4m3fn, "gf4": torch.int32,
                 "f32": torch.float32}[fmt]
    out = torch.empty(n, dtype=out_dtype, device=device)
    for s in range(0, n, _SLAB):
        m = min(_SLAB, n - s)
        if gen is None:
            i = (torch.arange(s, s + m, dtype=torch.int64, device=device)
                 * 2654435761 + seed) & 0xFFFFFFFF
        else:
            i = torch.randint(0, 1 << 32, (m,), generator=gen,
                              dtype=torch.int64, device=device)
        if fmt == "fp16":
            v = _signed((i & 0x83FF) | 0x2400, 16).to(torch.int16).view(torch.float16)
        elif fmt == "fp8":
            v = (i & 0x9F).to(torch.uint8).view(torch.float8_e5m2)
        elif fmt == "fp8e4":
            v = (i & 0xBF).to(torch.uint8).view(torch.float8_e4m3fn)
        elif fmt == "gf4":
            v = _signed((i & 0xFFFFFF00) | (i & 0x1F), 32).to(torch.int32)
        else:
            v = _signed((i & 0x807FFFFF) | 0x3E800000, 32).to(torch.int32).view(torch.float32)
        out[s:s + m] = v
    return out.reshape(shape)


def synth_weights(cfg: ModelConfig, seed: int = 0, device="cpu",
                  random: bool = False) -> Weights:
    """Device-resident pattern weights in the container layouts (untied
    output, no biases); random bits under the same masks with ``random``."""
    if cfg.n_experts:
        raise NotImplementedError("MoE models wait for the MoE slice")
    fmt = cfg.dtype
    gs = 8 if fmt == "gf4" else 1
    D, Hd, Q, KV, V, L = (cfg.dim, cfg.hidden_dim, cfg.q_dim, cfg.kv_dim,
                          cfg.vocab_size, cfg.n_layers)
    k = [seed]
    gen = None
    if random:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)

    def nxt():
        k[0] += 1
        return k[0]

    def qt(*shape):
        scale = (torch.ones(tuple(shape[:-2]) + (1,), device=device)
                 if fmt == "fp8e4" else None)
        return QTensor(_fill(shape, fmt, nxt(), device, gen), fmt, scale)

    def f32(*shape):
        return _fill(shape, "f32", nxt(), device, gen)

    # same fill order as calm_tpu.utils.synth.synth_weights
    w1 = qt(L, Hd, D // gs)
    w3 = qt(L, Hd, D // gs)
    w2 = qt(L, D, Hd // gs)
    attn_norm, ffn_norm = f32(L, D), f32(L, D)
    wq, wk, wv = qt(L, Q, D // gs), qt(L, KV, D // gs), qt(L, KV, D // gs)
    wo = qt(L, D, Q // gs)
    layers = LayerWeights(attn_norm=attn_norm, ffn_norm=ffn_norm, wq=wq,
                          wk=wk, wv=wv, wo=wo, w1=w1, w2=w2, w3=w3)
    embed = qt(V, D // gs)
    final_norm = f32(D)
    return Weights(embed=embed, layers=layers, final_norm=final_norm,
                   output=qt(V, D // gs))


def weight_bytes(cfg: ModelConfig) -> tuple[int, int]:
    """(total_bytes, decode_bandwidth_bytes) of a synthetic dense model, as
    the container accounting counts them (src/run.c:523-532): the
    embedding is one row per token, so it is left out of the bandwidth."""
    bits = {"fp16": 16, "fp8": 8, "fp8e4": 8, "gf4": 4}[cfg.dtype]
    D, Hd, Q, KV, V, L = (cfg.dim, cfg.hidden_dim, cfg.q_dim, cfg.kv_dim,
                          cfg.vocab_size, cfg.n_layers)
    per_layer = (Q * D + 2 * KV * D + D * Q + 3 * Hd * D) * bits // 8
    norms = 4 * (2 * L * D + D)
    head = V * D * bits // 8
    return 2 * head + L * per_layer + norms, head + L * per_layer + norms


def byte_vocab(vocab_size: int):
    """Minimal vocab: specials + 256 byte-fallback pieces + filler."""
    pieces = [b"<unk>", b"<s>", b"</s>"]
    pieces += [f"<0x{b:02X}>".encode() for b in range(256)]
    while len(pieces) < vocab_size:
        pieces.append(f"<fill{len(pieces)}>".encode())
    tokens = np.frombuffer(b"".join(p + b"\0" for p in pieces), dtype=np.uint8)
    return tokens, np.zeros(vocab_size, dtype=np.float32)


def synth_container(path: str, cfg: ModelConfig, seed: int = 0,
                    device="cpu", random: bool = False) -> ModelConfig:
    """Write pattern (or, with ``random``, seeded random) weights for
    ``cfg`` (with bos 1 / eos 2 and a byte vocab) as a .calm container."""
    w = synth_weights(cfg, seed, device, random)
    lw = w.layers
    t: dict = {"model.embed.weight": w.embed.data}
    per_layer = {"attn.norm": lw.attn_norm, "attn.wq": lw.wq.data,
                 "attn.wk": lw.wk.data, "attn.wv": lw.wv.data,
                 "attn.wo": lw.wo.data, "mlp.norm": lw.ffn_norm,
                 "mlp.w1": lw.w1.data, "mlp.w2": lw.w2.data,
                 "mlp.w3": lw.w3.data}
    for l in range(cfg.n_layers):
        for name, stack in per_layer.items():
            t[f"model.layers.{l}.{name}.weight"] = stack[l]
    t["model.norm.weight"] = w.final_norm
    t["model.output.weight"] = w.output.data
    tokens, scores = byte_vocab(cfg.vocab_size)
    t["tokenizer.tokens"] = tokens
    t["tokenizer.scores"] = scores
    write_tensors(path, t, cfg.to_metadata())
    return cfg
