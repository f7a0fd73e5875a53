"""The dense decoder-only transformer in PyTorch: greedy decode of fp8/fp16
Llama/Mistral-family models (the port of ``calm_tpu.model``'s decode path).

Tensor layouts match the JAX package at every public function: weights
are layer-stacked (L, d, n) in storage dtype, the KV cache is head-major
(L, B, KVH, S, hd). A decode step runs, for one token per sequence slot:

1. embed the token;
2. prime layer 0's q/k/v (attn-norm + three ``qmm_decode`` matvecs);
3. per layer: bias, qk-norm, clip, interleaved RoPE, sink re-rotation
   once the window has wrapped, ``decode_attention`` in fresh mode (the
   current K/V ride into the kernel; the cache write is deferred), then
   ``qx_offn_qkv`` for wo through w2 plus the next layer's q/k/v
   (``calm_tpu/model.py:1224-1285``);
4. one cache write for all layers (``model.py:1289-1306``);
5. final norm and the lm-head through ``qmm_decode``.

Models whose dims are not 128-aligned take the same step with per-op
matvecs in place of the fused epilogue. On the card every matvec and the
attention go through the Hopper kernels; on the CPU the wrappers run
their plain versions. MoE, parallel-norm archs and, on the card, gf4 and
fp8e4 weights belong to later slices and raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from calm_tpu_torch.config import ModelConfig
from calm_tpu_torch.container import TensorFile, to_torch
from calm_tpu_torch.ops.hopper_attn import decode_attention
from calm_tpu_torch.ops.hopper_qmm import (act, qmm_decode, qx_offn_qkv,
                                           qx_offn_supported)
from calm_tpu_torch.ops.norms import rmsnorm
from calm_tpu_torch.ops.qmm import STORAGE, QTensor, embed_lookup, qmatmul
from calm_tpu_torch.ops.rope import apply_rope, rope_tables

KV_SINKS = 2  # attention sinks kept live in the rolling window

_TAGS = {"fp16": "F16", "fp8": "F8_E5M2", "fp8e4": "F8_E4M3", "gf4": "I32"}
KV_DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16,
             "fp8": torch.float8_e5m2}


@dataclasses.dataclass
class LayerWeights:
    attn_norm: torch.Tensor   # (L, D) f32
    ffn_norm: torch.Tensor    # (L, D) f32
    wq: QTensor               # (L, q_dim, D)
    wk: QTensor               # (L, kv_dim, D)
    wv: QTensor               # (L, kv_dim, D)
    wo: QTensor               # (L, D, q_dim)
    w1: QTensor               # (L, H, D)
    w2: QTensor               # (L, D, H)
    w3: QTensor               # (L, H, D)
    bq: torch.Tensor | None = None  # (L, q_dim) f32, None when absent
    bk: torch.Tensor | None = None
    bv: torch.Tensor | None = None
    q_norm: torch.Tensor | None = None  # (L, q_dim) f32 when cfg.norm_qk
    k_norm: torch.Tensor | None = None


@dataclasses.dataclass
class Weights:
    embed: QTensor        # (V, D)
    layers: LayerWeights
    final_norm: torch.Tensor  # (D,) f32
    output: QTensor       # (V, D); the embed QTensor itself when tied


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor  # (L, B, KVH, S, hd)
    v: torch.Tensor

    @classmethod
    def create(cls, cfg: ModelConfig, batch: int = 1,
               dtype=torch.bfloat16, device="cpu") -> "KVCache":
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, cfg.seq_len, cfg.head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def check_supported(cfg: ModelConfig, device) -> None:
    """Raise NotImplementedError for configurations of later slices."""
    if cfg.n_experts:
        raise NotImplementedError("MoE models wait for the MoE slice")
    if cfg.norm_par:
        raise NotImplementedError(
            "parallel attn+ffn norm (norm_par) is not ported yet")
    if torch.device(device).type == "cuda" and cfg.dtype not in ("fp8", "fp16"):
        raise NotImplementedError(
            f"{cfg.dtype} weights on the GPU wait for the "
            f"{'gf4' if cfg.dtype == 'gf4' else 'fp8e4'} slice")


# ---------------------------------------------------------------------------
# weight loading
# ---------------------------------------------------------------------------


def load_weights(tf: TensorFile, cfg: ModelConfig, device="cpu") -> Weights:
    """Container tensors -> device weights, one layer plane at a time (the
    host never holds a whole stack)."""
    check_supported(cfg, device)
    fmt = cfg.dtype
    tag = _TAGS[fmt]
    gs = 8 if fmt == "gf4" else 1
    L = cfg.n_layers
    D, Hd, Q, KV, V = (cfg.dim, cfg.hidden_dim, cfg.q_dim, cfg.kv_dim,
                       cfg.vocab_size)

    def one(name, shape, t=tag):
        return to_torch(tf.get(name, None, t, shape), t, device)

    def stack(name, shape, t=tag):
        out = torch.empty((L,) + tuple(shape), dtype=STORAGE[fmt] if t == tag
                          else torch.float32, device=device)
        for l in range(L):
            out[l].copy_(to_torch(tf.get(name, l, t, shape), t))
        return out

    def qone(name, shape):
        scale = one(name + ".scale", (1,), "F32") if fmt == "fp8e4" else None
        return QTensor(one(name, shape), fmt, scale)

    def qstack(name, shape):
        scale = stack(name + ".scale", (1,), "F32") if fmt == "fp8e4" else None
        return QTensor(stack(name, shape), fmt, scale)

    bias = None
    if tf.find("model.layers.%d.attn.wqkv.bias", 0):
        bias = stack("model.layers.%d.attn.wqkv.bias", (Q + 2 * KV,), "F32")

    layers = LayerWeights(
        attn_norm=stack("model.layers.%d.attn.norm.weight", (D,), "F32"),
        ffn_norm=stack("model.layers.%d.mlp.norm.weight", (D,), "F32"),
        wq=qstack("model.layers.%d.attn.wq.weight", (Q, D // gs)),
        wk=qstack("model.layers.%d.attn.wk.weight", (KV, D // gs)),
        wv=qstack("model.layers.%d.attn.wv.weight", (KV, D // gs)),
        wo=qstack("model.layers.%d.attn.wo.weight", (D, Q // gs)),
        w1=qstack("model.layers.%d.mlp.w1.weight", (Hd, D // gs)),
        w2=qstack("model.layers.%d.mlp.w2.weight", (D, Hd // gs)),
        w3=qstack("model.layers.%d.mlp.w3.weight", (Hd, D // gs)),
        bq=None if bias is None else bias[:, :Q].contiguous(),
        bk=None if bias is None else bias[:, Q:Q + KV].contiguous(),
        bv=None if bias is None else bias[:, Q + KV:].contiguous(),
        q_norm=(stack("model.layers.%d.attn.q_norm.weight", (Q,), "F32")
                if cfg.norm_qk else None),
        k_norm=(stack("model.layers.%d.attn.k_norm.weight", (KV,), "F32")
                if cfg.norm_qk else None))
    embed = qone("model.embed.weight", (V, D // gs))
    output = (embed if tf.find("model.output.weight") is None
              else qone("model.output.weight", (V, D // gs)))
    return Weights(embed=embed, layers=layers,
                   final_norm=one("model.norm.weight", (D,), "F32"),
                   output=output)


def weights_from_numpy(arrays: dict[str, np.ndarray], cfg: ModelConfig,
                       device="cpu") -> Weights:
    """Weights from the JAX ``Weights`` pytree's leaves as numpy, keyed by
    field path: ``"embed"``, ``"output"``, ``"final_norm"``,
    ``"layers.wq"`` ... (a QTensor's data under its path, an fp8e4 scale
    under ``<path>.scale``; fp8 as uint8). A missing ``"output"`` ties it to
    the embedding; all-zero biases (the JAX default) are dropped."""
    check_supported(cfg, device)
    fmt = cfg.dtype

    def t(key, dtype=None):
        x = torch.from_numpy(np.array(arrays[key]))  # owned, writable copy
        if dtype is not None and x.dtype != dtype:
            x = x.view(dtype)
        return x.to(device)

    def q(key):
        scale = t(key + ".scale", torch.float32) if key + ".scale" in arrays else None
        return QTensor(t(key, STORAGE[fmt]), fmt, scale)

    def bias(key):
        if key not in arrays or not np.any(arrays[key]):
            return None
        return t(key, torch.float32)

    def opt(key):
        return t(key, torch.float32) if arrays.get(key) is not None else None

    layers = LayerWeights(
        attn_norm=t("layers.attn_norm", torch.float32),
        ffn_norm=t("layers.ffn_norm", torch.float32),
        wq=q("layers.wq"), wk=q("layers.wk"), wv=q("layers.wv"),
        wo=q("layers.wo"), w1=q("layers.w1"), w2=q("layers.w2"),
        w3=q("layers.w3"),
        bq=bias("layers.bq"), bk=bias("layers.bk"), bv=bias("layers.bv"),
        q_norm=opt("layers.q_norm"), k_norm=opt("layers.k_norm"))
    embed = q("embed")
    return Weights(embed=embed, layers=layers,
                   final_norm=t("final_norm", torch.float32),
                   output=q("output") if "output" in arrays else embed)


# ---------------------------------------------------------------------------
# forward pieces
# ---------------------------------------------------------------------------


def decode_indices(cfg: ModelConfig, pos: int) -> tuple[int, int]:
    """Attention-sink + rolling-window indices (``calm_tpu/model.py:1334``):
    kv_pos = sink + (pos - sink) % (S - sink) with sink = KV_SINKS once
    pos >= S; kv_len = min(pos + 1, S)."""
    S = cfg.seq_len
    sink = KV_SINKS if pos >= S else 0
    return sink + (pos - sink) % (S - sink), min(pos + 1, S)


def _norm(cfg: ModelConfig, x, weight):
    return rmsnorm(x, weight, cfg.norm_eps, subtract_mean=cfg.norm_ln)


def _mv(x: torch.Tensor, qt: QTensor, layer=None) -> torch.Tensor:
    """Decode matvec: the Hopper kernel's wrapper for fp8/fp16 (plain on
    the CPU); the plain f32 path for the other formats on the CPU only."""
    if qt.fmt in ("fp8", "fp16"):
        return qmm_decode(x, qt.data, qt.fmt, layer)
    if x.is_cuda:
        raise NotImplementedError(f"no CUDA matvec for {qt.fmt} yet")
    return qmatmul(x, qt, layer)


def _embed(embed: QTensor, tokens: torch.Tensor):
    return embed_lookup(tokens, embed)  # (B, D) f32


def _fused(cfg: ModelConfig, w: Weights, B: int) -> bool:
    lw = w.layers
    return qx_offn_supported(lw.wq.fmt, B, (cfg.dim, lw.w1.data.shape[1],
                                             cfg.q_dim, cfg.kv_dim))


@dataclasses.dataclass
class _Step:
    """Per-step state shared by every layer."""
    kv_pos: torch.Tensor    # (B,) int32
    kv_len: torch.Tensor    # (B,) int32
    kv_row: int
    cos: torch.Tensor       # (B, hd/2)
    sin: torch.Tensor
    sink_cos: torch.Tensor | None  # (B, KV_SINKS, hd/2) once wrapped
    sink_sin: torch.Tensor | None


def _rotate_sinks(cache: KVCache, layer: int, st: _Step):
    """Rotate the sink keys forward one position so their relative RoPE
    phase tracks the sliding window (``calm_tpu/model.py:1020-1033``)."""
    sink = cache.k[layer, :, :, :KV_SINKS, :]            # (B, KVH, 2, hd)
    rot = apply_rope(sink.float().transpose(1, 2), st.sink_cos, st.sink_sin)
    cache.k[layer, :, :, :KV_SINKS, :] = rot.transpose(1, 2).to(cache.k.dtype)


def _layer(cfg: ModelConfig, lw: LayerWeights, layer: int, x, qkv, cache,
           st: _Step, fused: bool):
    """One layer on x (B, D). ``qkv`` is this layer's (q, k, v) from the
    previous fused epilogue (or layer 0's priming); None on the per-op
    path. Returns (x, next qkv or None, fresh (k, v) rows)."""
    B, D = x.shape
    hd = cfg.head_dim
    H, KVH = cfg.n_heads, cfg.n_kv_heads
    if qkv is None:
        xb = _norm(cfg, x, lw.attn_norm[layer])
        qkv = (_mv(xb, lw.wq, layer), _mv(xb, lw.wk, layer),
               _mv(xb, lw.wv, layer))
    q, k, v = qkv
    if lw.bq is not None:  # added after the carried projections
        q, k, v = q + lw.bq[layer], k + lw.bk[layer], v + lw.bv[layer]
    if cfg.norm_qk:
        q = q * torch.rsqrt((q * q).sum(-1, keepdim=True) / cfg.q_dim
                            + cfg.norm_eps) * lw.q_norm[layer]
        k = k * torch.rsqrt((k * k).sum(-1, keepdim=True) / cfg.kv_dim
                            + cfg.norm_eps) * lw.k_norm[layer]
    if math.isfinite(cfg.qkv_clip):
        c = cfg.qkv_clip
        q, k, v = q.clamp(-c, c), k.clamp(-c, c), v.clamp(-c, c)

    q = apply_rope(q.reshape(B, H, hd), st.cos, st.sin)
    k = apply_rope(k.reshape(B, KVH, hd), st.cos, st.sin)
    kc = k.to(cache.k.dtype).contiguous()
    vc = v.reshape(B, KVH, hd).to(cache.k.dtype).contiguous()

    if st.sink_cos is not None:
        _rotate_sinks(cache, layer, st)
    att = decode_attention(q.float().contiguous(), cache.k, cache.v,
                           st.kv_len, layer, fresh=(kc, vc, st.kv_pos))
    att = att.reshape(B, H * hd)

    if fused:
        x, qn, kn, vn = qx_offn_qkv(
            att, x, lw.ffn_norm, lw.attn_norm, lw.wo.data, lw.w1.data,
            lw.w3.data, lw.w2.data, lw.wq.data, lw.wk.data, lw.wv.data,
            layer, lw.wq.fmt, cfg.act_gelu, cfg.norm_eps, cfg.norm_ln)
        return x, (qn, kn, vn), (kc, vc)

    x = x + _mv(att, lw.wo, layer)
    xb2 = _norm(cfg, x, lw.ffn_norm[layer])
    h = act(_mv(xb2, lw.w1, layer), cfg.act_gelu) * _mv(xb2, lw.w3, layer)
    x = x + _mv(h, lw.w2, layer)
    return x, None, (kc, vc)


def _head(cfg: ModelConfig, w: Weights, x):
    return _mv(_norm(cfg, x, w.final_norm), w.output)


def _step_state(cfg: ModelConfig, pos: int, B: int, device) -> _Step:
    kv_row, kv_len = decode_indices(cfg, pos)
    cos, sin = rope_tables(torch.full((B,), pos, device=device),
                           cfg.head_dim, cfg.rope_theta, cfg.rotary_dim)
    sink_cos = sink_sin = None
    if pos >= cfg.seq_len:
        sink_cos, sink_sin = rope_tables(
            torch.ones((B, KV_SINKS), dtype=torch.int64, device=device),
            cfg.head_dim, cfg.rope_theta, cfg.rotary_dim)
    return _Step(
        kv_pos=torch.full((B,), kv_row, dtype=torch.int32, device=device),
        kv_len=torch.full((B,), kv_len, dtype=torch.int32, device=device),
        kv_row=kv_row, cos=cos, sin=sin, sink_cos=sink_cos, sink_sin=sink_sin)


def _run_layers(cfg: ModelConfig, w: Weights, x, cache: KVCache, st: _Step):
    """Every layer on x (B, D), then the deferred cache write
    (``calm_tpu/model.py:1224-1306``). On the fused path q/k/v ride from one
    layer's epilogue into the next, primed with layer 0's projections."""
    lw = w.layers
    fused = _fused(cfg, w, x.shape[0])
    qkv = None
    if fused:
        xb0 = _norm(cfg, x, lw.attn_norm[0])
        qkv = (_mv(xb0, lw.wq, 0), _mv(xb0, lw.wk, 0), _mv(xb0, lw.wv, 0))
    fresh_k, fresh_v = [], []
    for layer in range(cfg.n_layers):
        x, qkv, (fk, fv) = _layer(cfg, lw, layer, x, qkv, cache, st, fused)
        fresh_k.append(fk)
        fresh_v.append(fv)
    # every layer's row in one copy per cache
    cache.k[:, :, :, st.kv_row, :] = torch.stack(fresh_k)
    cache.v[:, :, :, st.kv_row, :] = torch.stack(fresh_v)
    return x


@torch.no_grad()
def decode_step(cfg: ModelConfig, w: Weights, token: torch.Tensor, pos: int,
                cache: KVCache):
    """One token for each of the B sequence slots, all at position ``pos``:
    token (B,) int64 -> (logits (B, V) f32, cache). The cache is updated in
    place."""
    x = _embed(w.embed, token)
    st = _step_state(cfg, pos, token.shape[0], x.device)
    x = _run_layers(cfg, w, x, cache, st)
    return _head(cfg, w, x), cache


@torch.no_grad()
def decode_loop(cfg: ModelConfig, w: Weights, token: torch.Tensor, pos0: int,
                cache: KVCache, n_steps: int):
    """Greedy-decode ``n_steps`` tokens, argmax on the device (the
    counterpart of ``decode_scan_fn``): returns (tokens (B, N) int64,
    cache, per-step logits (N, B, V))."""
    toks, logits = [], []
    for i in range(n_steps):
        out, cache = decode_step(cfg, w, token, pos0 + i, cache)
        token = out.argmax(-1)  # first max wins, like jnp.argmax
        toks.append(token)
        logits.append(out)
    return torch.stack(toks, 1), cache, torch.stack(logits)


def logits_hash(logits: np.ndarray) -> int:
    """Fold f32 logits into the reference's 32-bit fingerprint
    (src/run.c:242-253): h = h*5 + bits(logit_k), printed as #%08x."""
    bits = np.asarray(logits, dtype=np.float32).reshape(-1).view(np.uint32)
    n = bits.size
    powers = np.empty(n, dtype=np.uint64)
    p = 1
    for i in range(n - 1, -1, -1):
        powers[i] = p
        p = (p * 5) & 0xFFFFFFFF
    return int((bits.astype(np.uint64) * powers).sum() & 0xFFFFFFFF)
