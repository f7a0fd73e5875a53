"""The decoder-only transformer in PyTorch: decode and batched prefill of
fp8/fp16/gf4 Llama/Mistral-family models, dense or Mixtral-style MoE (the
port of ``calm_tpu.model``'s decode and prefill paths, and of
``calm_tpu.paged``'s paged decode step).

Tensor layouts match the JAX package at every public function: weights
are layer-stacked (L, d, n) in storage dtype (gf4: (L, d, n/8) int32
words; MoE expert stacks (L, E, d, n)), the KV cache is head-major (L, B,
KVH, S, hd), or a page pool (L, P, KVH, PR, hd) with a page table (B,
S/PR). A decode step runs, for one token per sequence slot, each slot at
its own position:

1. embed the token;
2. prime layer 0's q/k/v (attn-norm + three ``qmm_decode`` matvecs);
3. per layer: bias, qk-norm, clip, interleaved RoPE, sink re-rotation of
   the slots whose window has wrapped, ``decode_attention`` in fresh mode
   (the current K/V ride into the kernel; the cache write is deferred),
   then ``qx_offn_qkv`` (fp8/fp16) or ``gf4_offn_qkv`` (gf4) for wo
   through w2 plus the next layer's q/k/v (``calm_tpu/model.py:1192-1285``);
4. one cache write for all layers, each slot at its own row
   (``model.py:1289-1306``);
5. final norm and the lm-head through ``qmm_decode``.

The step's host ints (tokens, positions, window rows) reach the card in
one non-blocking copy, so a step makes no host sync before its logits are
read.

Models whose dims are not 128-aligned, MoE and parallel-norm (Cohere)
models (as ``model.py:1228``), and fp8/fp16 models under ``CALM_ROT=0``
take the same step with per-op matvecs in place of the fused epilogue;
gf4 under ``CALM_ROT=0`` runs each layer's own q/k/v, then ``gf4_offn``
(wo + residual, ffn-norm and the FFN). A parallel-norm layer feeds its
FFN the attn-normed input (``gf4_ffn`` for gf4 at <= 16 rows) and adds wo
and the FFN to the residual, as ``model.py:1119-1149``. A MoE layer's
FFN is :func:`_moe_ffn`: the gate
matvec, top-k routing, then at <= 16 rows the expert sweep over the
layer's unique experts (``qmm_moe_dense`` three times, or ``gf4_moe_ffn``
once for gf4), above it the rows grouped by expert through the product
kernels. :func:`prefill` runs T
tokens per sequence at once (``model.py:1363-1374``): per layer the
projections, bias/qk-norm/clip, RoPE over T positions, the write of the T
rows into the cache, then ``prefill_attention`` reading them back, then wo
and the FFN per op. On the card every product and the attention go
through the Hopper kernels (products of more than 16 rows of fp8/fp16, or
17..31 of gf4, through ``dense_matmul``; gf4's w2 product through
``qmm_prefill_w2``); on the CPU the wrappers run their plain versions.
fp8e4 weights on the card belong to a later slice and raise
NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from calm_tpu_torch.config import ModelConfig
from calm_tpu_torch.container import TensorFile, to_torch
from calm_tpu_torch.ops.hopper_attn import decode_attention, prefill_attention
from calm_tpu_torch.ops.hopper_qmm import (MAX_ROWS, act, gf4_ffn,
                                           gf4_ffn_supported, gf4_moe_ffn,
                                           gf4_offn, gf4_offn_qkv,
                                           gf4_offn_supported, mm_supported,
                                           qmm_decode, qmm_moe_dense,
                                           qmm_prefill, qmm_prefill_w2,
                                           qx_offn_qkv, qx_offn_supported)
from calm_tpu_torch.ops.norms import rmsnorm
from calm_tpu_torch.ops.qmm import (STORAGE, QTensor, dense_matmul,
                                    embed_lookup, qmatmul)
from calm_tpu_torch.ops.rope import apply_rope, rope_tables

KV_SINKS = 2  # attention sinks kept live in the rolling window

# The rotated epilogue (each layer's fused call projects the next layer's
# q/k/v); CALM_ROT=0 turns it off, read once at import as
# calm_tpu/model.py:1164 reads it: gf4 decode then runs gf4_offn (K7) and
# the layer's own q/k/v, fp8/fp16 decode runs per op.
ROTATED_DECODE = os.environ.get("CALM_ROT", "1") == "1"

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
    w1: QTensor               # (L, [E,] H, D); fp8e4 scales (L, [E,] 1)
    w2: QTensor               # (L, [E,] D, H)
    w3: QTensor               # (L, [E,] H, D)
    bq: torch.Tensor | None = None  # (L, q_dim) f32, None when absent
    bk: torch.Tensor | None = None
    bv: torch.Tensor | None = None
    q_norm: torch.Tensor | None = None  # (L, q_dim) f32 when cfg.norm_qk
    k_norm: torch.Tensor | None = None
    moegate: QTensor | None = None  # (L, E, D) for MoE models


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
    if torch.device(device).type == "cuda" and cfg.dtype == "fp8e4":
        raise NotImplementedError("fp8e4 weights on the GPU wait for the fp8e4 slice")


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
    L, E = cfg.n_layers, cfg.n_experts
    D, Hd, Q, KV, V = (cfg.dim, cfg.hidden_dim, cfg.q_dim, cfg.kv_dim,
                       cfg.vocab_size)
    ex = (E,) if E else ()  # MoE expert stacks: (E, ...) per layer

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

    def qstack(name, shape, scale_shape=(1,)):
        scale = stack(name + ".scale", scale_shape, "F32") if fmt == "fp8e4" else None
        return QTensor(stack(name, shape), fmt, scale)

    def qmlp(name, shape):  # MoE stacks quantize per (layer, expert)
        return qstack(name, ex + shape, ex + (1,))

    bias = None
    if tf.find("model.layers.%d.attn.wqkv.bias", 0):
        bias = stack("model.layers.%d.attn.wqkv.bias", (Q + 2 * KV,), "F32")

    layers = LayerWeights(
        attn_norm=stack("model.layers.%d.attn.norm.weight", (D,), "F32"),
        # parallel-norm archs (Cohere) have no ffn-norm: zeros, as
        # calm_tpu/model.py:227-228
        ffn_norm=(torch.zeros((L, D), dtype=torch.float32, device=device)
                  if cfg.norm_par
                  else stack("model.layers.%d.mlp.norm.weight", (D,), "F32")),
        wq=qstack("model.layers.%d.attn.wq.weight", (Q, D // gs)),
        wk=qstack("model.layers.%d.attn.wk.weight", (KV, D // gs)),
        wv=qstack("model.layers.%d.attn.wv.weight", (KV, D // gs)),
        wo=qstack("model.layers.%d.attn.wo.weight", (D, Q // gs)),
        w1=qmlp("model.layers.%d.mlp.w1.weight", (Hd, D // gs)),
        w2=qmlp("model.layers.%d.mlp.w2.weight", (D, Hd // gs)),
        w3=qmlp("model.layers.%d.mlp.w3.weight", (Hd, D // gs)),
        bq=None if bias is None else bias[:, :Q].contiguous(),
        bk=None if bias is None else bias[:, Q:Q + KV].contiguous(),
        bv=None if bias is None else bias[:, Q + KV:].contiguous(),
        q_norm=(stack("model.layers.%d.attn.q_norm.weight", (Q,), "F32")
                if cfg.norm_qk else None),
        k_norm=(stack("model.layers.%d.attn.k_norm.weight", (KV,), "F32")
                if cfg.norm_qk else None),
        moegate=(qstack("model.layers.%d.moegate.weight", (E, D // gs))
                 if E else None))
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
    the embedding; all-zero biases (the JAX default) are dropped.

    The fused gf4 layouts that ``calm_tpu.engine.Engine`` holds
    (``fuse_gf4_weights``, ``calm_tpu/model.py:343-397``) are taken too
    and undone to natural words: the row-concat ``"layers.wqkv"`` (L, Q +
    2 KV, D/8) is split into wq/wk/wv; the plane-major
    ``"layers.w1p"``/``"layers.w3p"`` (L, 8, H/8, D/8), ``[l, k, c] =
    w1[l, 8c + k]``, the MoE ``"layers.w1pe"``/``"layers.w3pe"`` (L, E, 8,
    H/8, D/8) and the offn tier's ``"layers.wo_p"`` (L, 8, D/8, Q/8) go
    back to rows in natural order; the word-transposed ``"layers.w2t"``
    (L, H/8, D) and the offn tier's ``"layers.w2tp"`` (its columns
    plane-permuted, ``[l, j, k D/8 + c] = w2t[l, j, 8c + k]``) go back to
    (L, D, H/8). The offn tier's ``an_pl``/``fn_pl`` are permutations of
    ``attn_norm``/``ffn_norm``, which the tree keeps beside them."""
    check_supported(cfg, device)
    fmt = cfg.dtype

    def tensor(a, dtype=None):
        x = torch.from_numpy(np.array(a, order="C"))  # owned, writable copy
        if dtype is not None and x.dtype != dtype:
            x = x.view(dtype)
        return x.to(device)

    def t(key, dtype=None):
        return tensor(arrays[key], dtype)

    def rows(p):  # plane-major rows (..., 8, d/8, n) -> natural (..., d, n)
        p = np.asarray(p)
        return np.swapaxes(p, -3, -2).reshape(*p.shape[:-3], 8 * p.shape[-2], p.shape[-1])

    def natural(key):
        for suffix in ("p", "pe", "_p"):
            if key + suffix in arrays:
                return rows(arrays[key + suffix])
        if key + "tp" in arrays:  # w2tp: columns un-permuted give w2t
            tp = np.asarray(arrays[key + "tp"])
            L, gh, D = tp.shape
            w2t = np.swapaxes(tp.reshape(L, gh, 8, D // 8), -2, -1).reshape(L, gh, D)
            return np.swapaxes(w2t, 1, 2)
        if key + "t" in arrays:
            return np.swapaxes(np.asarray(arrays[key + "t"]), 1, 2)
        return arrays[key]

    def q(key):
        scale = t(key + ".scale", torch.float32) if key + ".scale" in arrays else None
        return QTensor(tensor(natural(key), STORAGE[fmt]), fmt, scale)

    if "layers.wq" not in arrays and "layers.wqkv" in arrays:  # row-concat
        wqkv = np.asarray(arrays["layers.wqkv"])
        Q, KV = cfg.q_dim, cfg.kv_dim
        arrays = dict(arrays, **{"layers.wq": wqkv[:, :Q],
                                 "layers.wk": wqkv[:, Q:Q + KV],
                                 "layers.wv": wqkv[:, Q + KV:]})

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
        q_norm=opt("layers.q_norm"), k_norm=opt("layers.k_norm"),
        moegate=q("layers.moegate") if cfg.n_experts else None)
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
    """Decode matvec: the Hopper kernels' wrapper for fp8/fp16/gf4 (plain
    on the CPU); the plain f32 path for fp8e4 on the CPU only."""
    if qt.fmt in ("fp8", "fp16", "gf4"):
        return qmm_decode(x, qt.data, qt.fmt, layer)
    if x.is_cuda:
        raise NotImplementedError(f"no CUDA matvec for {qt.fmt} yet")
    return qmatmul(x, qt, layer)


def _mm(x: torch.Tensor, qt: QTensor, layer=None, w2: bool = False) -> torch.Tensor:
    """x (R, n) @ W[layer]^T for any row count, routed as
    ``calm_tpu.ops.qmm.qmatmul``: <= 16 rows to the matvec kernels, gf4
    from 32 rows to the gf4 matmul kernel (``qmm_prefill_w2`` for the FFN's
    w2, as ``qmatmul_w2t``), the rest to ``dense_matmul``."""
    if x.shape[0] <= MAX_ROWS:
        return _mv(x, qt, layer)
    if mm_supported(x.shape[0], qt.data, qt.fmt):
        return (qmm_prefill_w2 if w2 else qmm_prefill)(x, qt.data, layer)
    return dense_matmul(x, qt, layer)


def _embed(embed: QTensor, tokens: torch.Tensor):
    return embed_lookup(tokens, embed)  # (B, D) f32


def _shapes(cfg: ModelConfig, w: Weights):
    return (cfg.dim, w.layers.w1.data.shape[1], cfg.q_dim, cfg.kv_dim)


def _fused(cfg: ModelConfig, w: Weights, B: int) -> bool:
    """The rotated epilogue: q/k/v ride from each layer's fused call into
    the next. MoE and parallel-norm layers run per op, and none runs it
    under CALM_ROT=0 (calm_tpu/model.py:1211, :1225-1228)."""
    if cfg.n_experts or cfg.norm_par or not ROTATED_DECODE:
        return False
    if w.layers.wq.fmt == "gf4":
        return gf4_offn_supported(B, _shapes(cfg, w))
    return qx_offn_supported(w.layers.wq.fmt, B, _shapes(cfg, w))


def _offn(cfg: ModelConfig, w: Weights, B: int) -> bool:
    """Dense gf4 decode under CALM_ROT=0: every layer's wo + FFN through
    gf4_offn (K7) after its own q/k/v (calm_tpu/model.py:1194-1201,
    :1106-1110); fp8/fp16 run per op."""
    return (not ROTATED_DECODE and w.layers.wq.fmt == "gf4" and not cfg.n_experts
            and not cfg.norm_par and gf4_offn_supported(B, _shapes(cfg, w)))


@dataclasses.dataclass
class _Step:
    """Per-step state shared by every layer."""
    kv_pos: torch.Tensor    # (B,) int32 logical row each slot writes
    kv_len: torch.Tensor    # (B,) int32
    cos: torch.Tensor       # (B, hd/2)
    sin: torch.Tensor
    sink_rows: torch.Tensor | None  # (W,) cache axis-1 index of the sinks of
                                    # the W slots past the window; None if none
    sink_cos: torch.Tensor | None   # (W, KV_SINKS, hd/2)
    sink_sin: torch.Tensor | None
    pt: torch.Tensor | None         # (B, n_blocks) int32 page table


def _rotate_sinks(cache: KVCache, layer: int, st: _Step):
    """Rotate the wrapped slots' sink keys forward one position so their
    relative RoPE phase tracks the sliding window
    (``calm_tpu/model.py:1007-1033``); a paged slot's sinks live in its
    own page 0."""
    idx = (layer, st.sink_rows, slice(None), slice(0, KV_SINKS))
    sink = cache.k[idx]                                   # (W, KVH, 2, hd)
    rot = apply_rope(sink.float().transpose(1, 2), st.sink_cos, st.sink_sin)
    cache.k[idx] = rot.transpose(1, 2).to(cache.k.dtype)


def _qkv_post(cfg: ModelConfig, lw: LayerWeights, layer: int, q, k, v):
    """Bias, qk-norm and clip on projected (rows, dim) q/k/v, in the JAX
    order (``calm_tpu/model.py:930-941``)."""
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
    return q, k, v


def route(cfg: ModelConfig, gate: torch.Tensor):
    """Expert weights and ids (R, k) of each row of the gate logits (R, E)
    (``calm_tpu/model.py:743-750``): a softmax over the top-k logits under
    ``moe_renorm`` (Mixtral, DBRX), else the top-k of the softmax over all
    E (OLMoE). Ties go to the lowest expert index, as ``lax.top_k`` breaks
    them: a stable descending sort, where ``torch.topk`` promises no order
    (fp8 pattern weights make every gate logit equal)."""
    k = cfg.n_experts_ac
    if cfg.moe_renorm:
        vals, idx = torch.sort(gate, dim=-1, descending=True, stable=True)
        return torch.softmax(vals[:, :k], dim=-1), idx[:, :k]
    vals, idx = torch.sort(torch.softmax(gate, dim=-1), dim=-1, descending=True,
                           stable=True)
    return vals[:, :k], idx[:, :k]


def expert_slots(idx: torch.Tensor, n_experts: int):
    """The sorted unique expert ids of ``idx`` (R, k), compacted to the
    front of A = min(E, R k) slots and padded with the last of them, as
    int32, and their count as a (1,) int32, all computed on the device with
    no host sync (``calm_tpu/model.py:774-796``)."""
    s = torch.sort(idx.reshape(-1)).values
    R = s.shape[0]
    firsts = torch.ones_like(s, dtype=torch.bool)
    firsts[1:] = s[1:] != s[:-1]
    su = s[torch.sort((~firsts).to(torch.int32), stable=True).indices]
    cnt = firsts.sum().reshape(1)
    A = min(n_experts, R)
    pad = su.index_select(0, (cnt - 1).clamp(0, R - 1))
    live = torch.arange(A, device=s.device) < cnt
    return torch.where(live, su[:A], pad).to(torch.int32), cnt.to(torch.int32)


def _moe_sweep(cfg: ModelConfig, lw: LayerWeights, layer: int, xb2, wts, idx):
    """<= 16 rows: every unique expert's weights read once for all rows
    (``calm_tpu/model.py:764-827``), then each row takes the slots it was
    routed to with its gate weights; dead slots come back as zeros."""
    uniq, cnt = expert_slots(idx, cfg.n_experts)
    if lw.w1.fmt == "gf4":
        z = gf4_moe_ffn(xb2, lw.w1.data, lw.w3.data, lw.w2.data, uniq, cnt, layer,
                        cfg.act_gelu)
    else:
        xf = xb2[None]
        h = (act(qmm_moe_dense(xf, lw.w1.data, uniq, cnt, lw.w1.fmt, layer),
                 cfg.act_gelu)
             * qmm_moe_dense(xf, lw.w3.data, uniq, cnt, lw.w3.fmt, layer))
        z = qmm_moe_dense(h, lw.w2.data, uniq, cnt, lw.w2.fmt, layer)  # (A, R, D)
    live = torch.arange(uniq.shape[0], device=z.device) < cnt
    wmat = ((wts[:, :, None] * (idx[:, :, None] == uniq)).sum(1)
            * live)                                                 # (R, A)
    return torch.einsum("ra,ard->rd", wmat, z)


def _moe_grouped(cfg: ModelConfig, lw: LayerWeights, layer: int, xb2, wts, idx):
    """Any row count: the rows grouped by expert, each group through the
    product kernels (``_mm``), weighted and summed back. The same function
    as the JAX per-token vmap (``calm_tpu/model.py:829-857``) without its
    per-row weight reads. The group sizes cost one host sync per layer,
    which a prefill's products dwarf; the decode sweep has none."""
    k = idx.shape[1]
    flat = idx.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    sizes = torch.bincount(flat, minlength=cfg.n_experts).tolist()
    w_flat = wts.reshape(-1)
    out = torch.zeros_like(xb2)
    start = 0
    for e, c in enumerate(sizes):
        if not c:
            continue
        sel = order[start:start + c]
        start += c
        rows = sel // k
        xe = xb2.index_select(0, rows)
        h = (act(_mm(xe, lw.w1[layer, e]), cfg.act_gelu)
             * _mm(xe, lw.w3[layer, e]))
        y = _mm(h, lw.w2[layer, e], w2=True)
        out.index_add_(0, rows, y * w_flat[sel, None])
    return out


def _moe_ffn(cfg: ModelConfig, lw: LayerWeights, layer: int, xb2):
    """Top-k routed MoE FFN on xb2 (R, D) (``calm_tpu/model.py:731-857``,
    without expert parallelism): the gate matvec, routing, then the expert
    sweep at <= 16 rows or the grouped products above. fp8e4 experts take
    the grouped path with their per-expert scales (CPU only)."""
    wts, idx = route(cfg, _mm(xb2, lw.moegate, layer))
    if xb2.shape[0] <= MAX_ROWS and lw.w1.fmt in ("fp8", "fp16", "gf4"):
        return _moe_sweep(cfg, lw, layer, xb2, wts, idx)
    return _moe_grouped(cfg, lw, layer, xb2, wts, idx)


def _ffn(cfg: ModelConfig, lw: LayerWeights, layer: int, x, att, xb):
    """wo + residual, then the FFN and its residual, per op, in the JAX
    order (``calm_tpu/model.py:1112-1149``): on ffn-norm(x + wo . att), or
    for parallel-norm archs (Cohere) on the attn-normed input ``xb``. A
    parallel-norm gf4 FFN of <= 16 rows is one gf4_ffn (K6), as the JAX
    package's fused layout runs it there (``:1130-1135``)."""
    x = x + _mm(att, lw.wo, layer)
    xb2 = xb if cfg.norm_par else _norm(cfg, x, lw.ffn_norm[layer])
    if cfg.n_experts:
        return x + _moe_ffn(cfg, lw, layer, xb2)
    if (cfg.norm_par and lw.w1.fmt == "gf4"
            and gf4_ffn_supported(xb2.shape, lw.w1.data, lw.w2.data)):
        return x + gf4_ffn(xb2, lw.w1.data, lw.w3.data, lw.w2.data, layer,
                           cfg.act_gelu)
    h = act(_mm(xb2, lw.w1, layer), cfg.act_gelu) * _mm(xb2, lw.w3, layer)
    return x + _mm(h, lw.w2, layer, w2=True)


def _layer(cfg: ModelConfig, lw: LayerWeights, layer: int, x, qkv, cache,
           st: _Step, mode: str | None):
    """One layer on x (B, D). ``qkv`` is this layer's (q, k, v) from the
    previous fused epilogue (or layer 0's priming); None otherwise.
    ``mode``: "qkv" for the rotated epilogue, "offn" for gf4_offn (K7),
    None per op. Returns (x, next qkv or None, fresh (k, v) rows)."""
    B, D = x.shape
    hd = cfg.head_dim
    H, KVH = cfg.n_heads, cfg.n_kv_heads
    xb = None
    if qkv is None:
        xb = _norm(cfg, x, lw.attn_norm[layer])
        qkv = (_mm(xb, lw.wq, layer), _mm(xb, lw.wk, layer),
               _mm(xb, lw.wv, layer))
    q, k, v = _qkv_post(cfg, lw, layer, *qkv)
    q = apply_rope(q.reshape(B, H, hd), st.cos, st.sin)
    k = apply_rope(k.reshape(B, KVH, hd), st.cos, st.sin)
    kc = k.to(cache.k.dtype).contiguous()
    vc = v.reshape(B, KVH, hd).to(cache.k.dtype).contiguous()

    if st.sink_rows is not None:
        _rotate_sinks(cache, layer, st)
    att = decode_attention(q.float().contiguous(), cache.k, cache.v,
                           st.kv_len, layer, fresh=(kc, vc, st.kv_pos), pt=st.pt)
    att = att.reshape(B, H * hd)

    if mode == "qkv":
        ws = (att, x, lw.ffn_norm, lw.attn_norm, lw.wo.data, lw.w1.data,
              lw.w3.data, lw.w2.data, lw.wq.data, lw.wk.data, lw.wv.data, layer)
        tail = (cfg.act_gelu, cfg.norm_eps, cfg.norm_ln)
        if lw.wq.fmt == "gf4":
            x, qn, kn, vn = gf4_offn_qkv(*ws, *tail)
        else:
            x, qn, kn, vn = qx_offn_qkv(*ws, lw.wq.fmt, *tail)
        return x, (qn, kn, vn), (kc, vc)
    if mode == "offn":
        ffn, r1 = gf4_offn(att, x, lw.ffn_norm, lw.wo.data, lw.w1.data, lw.w3.data,
                           lw.w2.data, layer, cfg.act_gelu, cfg.norm_eps, cfg.norm_ln)
        return r1 + ffn, None, (kc, vc)
    return _ffn(cfg, lw, layer, x, att, xb), None, (kc, vc)


def _head(cfg: ModelConfig, w: Weights, x):
    """Final norm and the lm-head on x (rows, D)."""
    return _mm(_norm(cfg, x, w.final_norm), w.output)


def upload(values, device, dtype=torch.int32) -> torch.Tensor:
    """Host numbers -> a tensor on ``device`` in one copy that makes no
    host sync (``non_blocking``; CUDA stages the pageable source
    before the call returns, so no pinned buffer has to outlive it)."""
    return torch.tensor(list(values), dtype=dtype).to(device, non_blocking=True)


def _step_state(cfg: ModelConfig, token, pos, device, pt=None):
    """The step's per-slot state from host ints, as ``decode_indices`` per
    element (``calm_tpu/model.py:1334-1345``), and the tokens on the
    device. ``token`` is a (B,) tensor, or host ints that then join the
    one upload; ``pos`` an int (every slot) or B host ints."""
    B = token.shape[0] if isinstance(token, torch.Tensor) else len(token)
    pos = [int(pos)] * B if isinstance(pos, (int, np.integer)) else [int(p) for p in pos]
    if len(pos) != B:
        raise ValueError(f"{len(pos)} positions for {B} slots")
    rows, lens = zip(*(decode_indices(cfg, p) for p in pos))
    wrapped = [b for b, p in enumerate(pos) if p >= cfg.seq_len]
    head = [] if isinstance(token, torch.Tensor) else [int(t) for t in token]
    vals = upload(head + pos + list(rows) + list(lens) + wrapped, device)
    n = len(head)
    if n:
        token = vals[:n].long()
    p_d, kv_pos, kv_len = (vals[n + i * B:n + (i + 1) * B] for i in range(3))
    cos, sin = rope_tables(p_d, cfg.head_dim, cfg.rope_theta, cfg.rotary_dim)
    sink_rows = sink_cos = sink_sin = None
    if wrapped:
        sink_rows = vals[n + 3 * B:].long()
        if pt is not None:  # each wrapped slot's own page 0
            sink_rows = pt[sink_rows, 0].long()
        sink_cos, sink_sin = rope_tables(
            torch.ones((len(wrapped), KV_SINKS), dtype=torch.int64, device=device),
            cfg.head_dim, cfg.rope_theta, cfg.rotary_dim)
    return _Step(kv_pos=kv_pos, kv_len=kv_len, cos=cos, sin=sin, sink_rows=sink_rows,
                 sink_cos=sink_cos, sink_sin=sink_sin, pt=pt), token


def _write_rows(cache: KVCache, st: _Step, fk: torch.Tensor, fv: torch.Tensor):
    """The deferred write: every layer's fresh row (L, B, KVH, hd) of each
    slot at its own row kv_pos[b], in one copy per cache; a paged slot's
    row lives at page pt[b, kv_pos // PR], row kv_pos % PR. Two advanced
    indices apart put the slot axis first: (B, L, KVH, hd)."""
    B = fk.shape[1]
    rows = st.kv_pos.long()
    if st.pt is None:
        slots = torch.arange(B, device=rows.device)
    else:
        PR = cache.k.shape[3]
        slots = st.pt[torch.arange(B, device=rows.device), rows // PR].long()
        rows = rows % PR
    cache.k[:, slots, :, rows, :] = fk.transpose(0, 1)
    cache.v[:, slots, :, rows, :] = fv.transpose(0, 1)


def _run_layers(cfg: ModelConfig, w: Weights, x, cache: KVCache, st: _Step):
    """Every layer on x (B, D), then the deferred cache write
    (``calm_tpu/model.py:1224-1306``). On the fused path q/k/v ride from one
    layer's epilogue into the next, primed with layer 0's projections."""
    lw = w.layers
    B = x.shape[0]
    mode = "qkv" if _fused(cfg, w, B) else "offn" if _offn(cfg, w, B) else None
    qkv = None
    if mode == "qkv":
        xb0 = _norm(cfg, x, lw.attn_norm[0])
        qkv = (_mv(xb0, lw.wq, 0), _mv(xb0, lw.wk, 0), _mv(xb0, lw.wv, 0))
    fresh_k, fresh_v = [], []
    for layer in range(cfg.n_layers):
        x, qkv, (fk, fv) = _layer(cfg, lw, layer, x, qkv, cache, st, mode)
        fresh_k.append(fk)
        fresh_v.append(fv)
    _write_rows(cache, st, torch.stack(fresh_k), torch.stack(fresh_v))
    return x


@torch.no_grad()
def decode_step(cfg: ModelConfig, w: Weights, token, pos, cache: KVCache):
    """One token for each of the B sequence slots: token (B,) int64 (or B
    host ints), pos an int for every slot or B host ints, one a slot ->
    (logits (B, V) f32, cache). Each slot attends its own window and
    writes its own row; only slots at pos >= seq_len rotate their sinks.
    The cache is updated in place."""
    st, token = _step_state(cfg, token, pos, cache.k.device)
    x = _run_layers(cfg, w, _embed(w.embed, token), cache, st)
    return _head(cfg, w, x), cache


@torch.no_grad()
def paged_decode_step(cfg: ModelConfig, w: Weights, token, pos,
                      pool: KVCache, pt: torch.Tensor):
    """:func:`decode_step` on a page pool (``calm_tpu/paged.py:36-48``):
    pool (L, P, KVH, PR, hd), pt (B, seq_len // PR) int32 on the pool's
    device. Attention reads each slot's pages through the table (K12 paged
    and fresh mode); the deferred write lands at page pt[b, kv_pos // PR],
    row kv_pos % PR; a wrapped slot rotates the sinks in its own page
    pt[b, 0]. The pool is updated in place."""
    st, token = _step_state(cfg, token, pos, pool.k.device, pt)
    x = _run_layers(cfg, w, _embed(w.embed, token), pool, st)
    return _head(cfg, w, x), pool


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


def _prefill_layer(cfg: ModelConfig, lw: LayerWeights, layer: int, x,
                   cache: KVCache, starts: list[int], cos, sin, pos0, kv_len,
                   batch_off: int):
    """One layer on x (B*T, D), in the JAX order (``calm_tpu/model.py``
    :915-1059, :1112-1149): the T fresh K/V rows are in the cache (slots
    from ``batch_off`` on) before the attention reads it."""
    B, T = len(starts), x.shape[0] // len(starts)
    hd, H, KVH = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    xb = _norm(cfg, x, lw.attn_norm[layer])
    q, k, v = _qkv_post(cfg, lw, layer, _mm(xb, lw.wq, layer),
                        _mm(xb, lw.wk, layer), _mm(xb, lw.wv, layer))
    q = apply_rope(q.reshape(B, T, H, hd), cos, sin)
    k = apply_rope(k.reshape(B, T, KVH, hd), cos, sin)
    kh = k.to(cache.k.dtype).transpose(1, 2)              # (B, KVH, T, hd)
    vh = v.reshape(B, T, KVH, hd).to(cache.k.dtype).transpose(1, 2)
    for b, p in enumerate(starts):
        cache.k[layer, batch_off + b, :, p:p + T] = kh[b]
        cache.v[layer, batch_off + b, :, p:p + T] = vh[b]
    att = prefill_attention(q.reshape(B, T, KVH, H // KVH, hd).contiguous(),
                            cache.k, cache.v, pos0, kv_len, layer, batch_off)
    return _ffn(cfg, lw, layer, x, att.reshape(B * T, H * hd), xb)


@torch.no_grad()
def prefill(cfg: ModelConfig, w: Weights, tokens: torch.Tensor, pos0,
            cache: KVCache, logits_mode: str = "last", batch_off: int = 0):
    """Batched prompt processing (``calm_tpu/model.py:1363-1374``): tokens
    (B, T) int64 at positions pos0[b] + t, pos0 (B,) ints, sequence b in
    cache slot batch_off + b. Requires pos0 + T <= seq_len (a prefill never
    rolls). Returns (logits, cache): logits (B, V) for ``"last"``, (B, T, V)
    for ``"all"``, None for ``"none"``; the cache is updated in place."""
    if logits_mode not in ("last", "all", "none"):
        raise ValueError(f"unknown logits_mode {logits_mode!r}")
    B, T = tokens.shape
    dev = tokens.device
    starts = [int(p) for p in torch.as_tensor(pos0).reshape(-1).tolist()]
    if len(starts) != B or min(starts) < 0 or max(starts) + T > cfg.seq_len:
        raise ValueError(f"prefill needs B={B} starts with start + {T} <= "
                         f"{cfg.seq_len}, got {starts}")
    if not 0 <= batch_off <= cache.k.shape[1] - B:
        raise ValueError(f"slots {batch_off}..{batch_off + B - 1} out of range "
                         f"for a cache of {cache.k.shape[1]}")
    p0 = torch.tensor(starts, dtype=torch.int32, device=dev)
    pos = p0[:, None].long() + torch.arange(T, device=dev)  # (B, T)
    cos, sin = rope_tables(pos, cfg.head_dim, cfg.rope_theta, cfg.rotary_dim)
    x = _embed(w.embed, tokens).reshape(B * T, cfg.dim)
    for layer in range(cfg.n_layers):
        x = _prefill_layer(cfg, w.layers, layer, x, cache, starts, cos, sin,
                           p0, p0 + T, batch_off)
    if logits_mode == "none":
        return None, cache
    if logits_mode == "last":
        return _head(cfg, w, x.reshape(B, T, -1)[:, -1]), cache
    return _head(cfg, w, x).reshape(B, T, -1), cache


def prefill_slot(cfg: ModelConfig, w: Weights, tokens: torch.Tensor,
                 slot: int, cache: KVCache, pos0: int = 0):
    """Prefill one slot of a shared multi-slot cache in place (continuous
    batching admission; ``calm_tpu/model.py:1525-1570`` without dp): tokens
    (1, T) at positions pos0 + t into slot ``slot``, whose rows [0, pos0)
    must already hold valid K/V (a prefix-cache hit copies them in). The
    other slots are untouched. Returns (logits after the last token (V,),
    cache).

    The JAX package right-pads T to a bucket so that XLA compiles once per
    bucket; eager PyTorch has no such compile, so exactly T rows run here.
    Under the causal mask padded rows could not change the last real
    token's logits, and the rows they wrote lie past kv_len, so the result
    is the same function."""
    logits, cache = prefill(cfg, w, tokens, [pos0], cache, "last", batch_off=slot)
    return logits[0], cache


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
