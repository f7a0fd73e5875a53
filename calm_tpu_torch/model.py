"""The decoder-only transformer in PyTorch: decode and batched prefill of
fp8/fp16/fp8e4/gf4 Llama/Mistral-family models, dense or Mixtral-style MoE (the
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

The step runs on device state (``_decode``): tokens (B,) int64 and
positions (B,) int32 on the card, the window rows computed from them as
JAX computes them (:func:`decode_indices`), and a static ``rolling`` flag
that the host picks, as ``decode_step_fn``'s (``calm_tpu/model.py
:1348-1360``). Nothing in it reads a device value on the host or sizes a
tensor by one, so it can be captured: on the card :func:`decode_loop` and
:func:`decode_once` replay it as a CUDA graph (``graphs.StepGraph``, kept
on the cache), which is the counterpart of ``decode_step``,
``decode_scan`` and ``decode_scan_sampled``. Host-int callers of
:func:`decode_step` upload their ints in one non-blocking copy and run
the same function eagerly. The CPU path and a sharded plan (whose
collectives go through ``torch.distributed``) run eagerly.

Models whose dims are not 128-aligned, MoE and parallel-norm (Cohere)
models (as ``model.py:1228``), fp8e4 models (``:1231``), and fp8/fp16
models under ``CALM_ROT=0`` or ``--precise`` (``:1237-1238``) take the
same step with per-op matvecs in place of the fused epilogue;
gf4 under ``CALM_ROT=0`` runs each layer's own q/k/v, then ``gf4_offn``
(wo + residual, ffn-norm and the FFN). A parallel-norm layer feeds its
FFN the attn-normed input (``gf4_ffn`` for gf4 at <= 16 rows) and adds wo
and the FFN to the residual, as ``model.py:1119-1149``. A MoE layer's
FFN is :func:`_moe_ffn`: the gate
matvec, top-k routing, then at <= 64 rows (:func:`moe_sweeps`) the expert
sweep over the layer's unique experts (``qmm_moe_ffn`` once, at one row
``qmm_moe_dense`` three times, or ``gf4_moe_ffn`` once for gf4), above it
the rows grouped by expert through the product kernels. :func:`prefill` runs T
tokens per sequence at once (``model.py:1363-1374``): per layer the
projections, bias/qk-norm/clip, RoPE over T positions, the write of the T
rows into the cache, then ``prefill_attention`` reading them back, then wo
and the FFN per op. On the card every product and the attention go
through the Hopper kernels (2-64 rows on the multi-row and wide
matvec paths; past 64 rows gf4 on its matmul kernel, gf4's w2 product
through ``qmm_prefill_w2``, fp8/fp16/fp8e4 on ``qmm_mm8``); on
the CPU the wrappers run their plain
versions. fp8e4 weights carry a power-of-two scale per tensor (per
(layer, expert) in MoE stacks) that the kernels read on the device.
Under ``ops.qmm._PRECISE`` (``Engine(precise=True)``) :func:`mm_route`
sends products past 64 rows to an f32 ``dense_matmul`` and :func:`_fused`
declines the fp8/fp16 epilogue; the matvecs of 2-64 rows take the
multi-row and wide paths as by default, x in two f16 terms
(``hopper_qmm.decode_path``).

Under a ``ShardingPlan`` the same functions are one rank's program on its
local weights and cache, with the collectives on a
``parallel.mesh.Mesh`` in place of JAX's axis names (``calm_tpu/model.py
:452-576``, ``:977-1050``): tp closes wo's and the FFN's partial sums
(``rs_ag``: a reduce-scatter and an all-gather), the vocab-sharded embed
with a masked lookup and a psum and the OLMoE qk-norm with a scalar psum;
ep sweeps the rank's resident experts; sp decode writes a row on the shard
that owns it, rotates the sinks on shard 0 and merges K12's partials (one
pmax, two psums); sp prefill attends over the all-gathered K/V, or under
``plan.ring`` folds the chunks in as they come round the ring. Decode
under tp, sp or ep runs per op (no fused epilogue). ``parallel.sharding``
cuts the local tensors and gathers the logits; ``parallel.pipeline`` runs
each pipeline stage's layers through the same step on its layer shard, a
microbatch's slots from a slot offset (``_Step.batch_off``).
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from calm_tpu_torch.config import ModelConfig
from calm_tpu_torch.container import TensorFile, to_torch
from calm_tpu_torch.graphs import StepGraph, VerifyGraph
from calm_tpu_torch.ops.hopper_attn import (HEAD_DIMS, decode_attention,
                                            prefill_attention, tree_attention)
from calm_tpu_torch.ops.hopper_qmm import (MAX_MV_ROWS, MAX_ROWS, act, gf4_ffn,
                                           gf4_ffn_supported, gf4_moe_ffn,
                                           gf4_offn, gf4_offn_qkv,
                                           gf4_offn_supported, mm_supported,
                                           moe_multirow_supported,
                                           prefill_operand, qmm_decode,
                                           qmm_mm8, qmm_moe_dense, qmm_moe_ffn,
                                           qmm_prefill, qmm_prefill_w2,
                                           qx_offn_qkv, qx_offn_supported)
from calm_tpu_torch.ops import qmm as _qmm
from calm_tpu_torch.ops.cost import count, span
from calm_tpu_torch.ops.norms import rmsnorm
from calm_tpu_torch.ops.qmm import STORAGE, QTensor, dense_matmul, embed_lookup
from calm_tpu_torch.ops.rope import apply_rope, rope_tables
from calm_tpu_torch.parallel.plan import NO_SHARDING, ShardingPlan
from calm_tpu_torch.sampler import device_sample

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
    # the captured decode steps on this cache (step_graph); they go with it
    graphs: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @classmethod
    def create(cls, cfg: ModelConfig, batch: int = 1,
               dtype=torch.bfloat16, device="cpu") -> "KVCache":
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, cfg.seq_len, cfg.head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def check_supported(cfg: ModelConfig, device) -> None:
    """Raise NotImplementedError at load for what the card's kernels do
    not take: head dims the attention kernels are not built for, and
    fp8/fp16/fp8e4 contraction dims the matvec kernels cannot split
    (``hopper_qmm._check_cuda``)."""
    if torch.device(device).type != "cuda":
        return
    if cfg.head_dim not in HEAD_DIMS:
        raise NotImplementedError(f"head_dim {cfg.head_dim}: the attention kernels "
                                  f"take {HEAD_DIMS}")
    odd = [n for n in (cfg.dim, cfg.q_dim, cfg.hidden_dim) if n % 16]
    if cfg.dtype in ("fp8", "fp16", "fp8e4") and odd:
        raise NotImplementedError(f"the {cfg.dtype} matvec kernel takes contraction "
                                  f"dims in multiples of 16, not {odd}")


# ---------------------------------------------------------------------------
# weight loading
# ---------------------------------------------------------------------------


def load_weights(tf: TensorFile, cfg: ModelConfig, device="cpu") -> Weights:
    """Container tensors -> device weights, one layer plane at a time (the
    host never holds a whole stack). Each tensor takes the shape that
    ``tf.get`` returns, after checking the file's against the config's:
    ``parallel.sharding.load_weights_sharded`` hands in a file whose
    matrices come back as one rank's slice."""
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

    def stack(name, shape, t=tag):  # sized by what tf gives (a shard's slice)
        out = None
        for l in range(L):
            a = to_torch(tf.get(name, l, t, shape), t)
            if out is None:
                out = torch.empty((L,) + tuple(a.shape), dtype=a.dtype, device=device)
            out[l].copy_(a)
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


def decode_indices(cfg: ModelConfig, pos):
    """Attention-sink + rolling-window indices (``calm_tpu/model.py:1334``):
    kv_pos = sink + (pos - sink) % (S - sink) with sink = KV_SINKS once
    pos >= S; kv_len = min(pos + 1, S). On a (B,) int32 tensor as JAX
    computes them on the device; on a host int as ints, for the host's
    page bookkeeping."""
    S = cfg.seq_len
    if isinstance(pos, torch.Tensor):
        sink = torch.where(pos >= S, KV_SINKS, 0).to(pos.dtype)
        return sink + (pos - sink) % (S - sink), (pos + 1).clamp(max=S)
    sink = KV_SINKS if pos >= S else 0
    return sink + (pos - sink) % (S - sink), min(pos + 1, S)


def _norm(cfg: ModelConfig, x, weight):
    return rmsnorm(x, weight, cfg.norm_eps, subtract_mean=cfg.norm_ln)


def _mv(x: torch.Tensor, qt: QTensor, layer=None) -> torch.Tensor:
    """Decode matvec of <= 64 rows: the Hopper kernels' wrapper for every
    format, fp8e4 with its scale (plain on the CPU), the same launches
    under ``--precise`` (x in two f16 terms)."""
    return qmm_decode(x, qt.data, qt.fmt, layer, qt.scale)


def mm_route(rows: int, qt: QTensor, precise: bool = False) -> str:
    """Where :func:`_mm` sends a product of ``rows`` rows: "mv" (<= 64
    rows, the matvec kernels: 2-16 rows the multi-row path, 17-64 the wide
    one), past 64 rows "mm" (gf4, the gf4 matmul kernel) or "mm8"
    (fp16/fp8/fp8e4, ``qmm_mm8``), and under ``precise``, whose JAX
    counterpart runs these in XLA at f32 (``calm_tpu/ops/qmm.py:158``,
    ``:190-197``), "dense" (``dense_matmul``'s f32 product). gf4 at
    32-64 rows, which K4 could take, keeps the wide path: on an H100 it
    timed faster than K4 on a Mistral-7B w2 (4x) and w1 and on the
    lm-head to 48 rows, slower only on the lm-head at 64 (PERF.md §6)."""
    if rows <= MAX_MV_ROWS:
        return "mv"
    if precise:
        return "dense"
    return "mm" if mm_supported(rows, qt.data, qt.fmt) else "mm8"


def _mm(x: torch.Tensor, qt: QTensor, layer=None, w2: bool = False) -> torch.Tensor:
    """x (R, n) @ W[layer]^T for any row count, routed by
    :func:`mm_route`: <= 64 rows to the matvec kernels (JAX runs 17-64 in
    XLA), past them gf4 to the gf4 matmul kernel (``qmm_prefill_w2`` for
    the FFN's w2, as ``qmatmul_w2t``) and the other formats to
    ``qmm_mm8``; under ``--precise`` to ``dense_matmul``."""
    route = mm_route(x.shape[0], qt, _qmm._PRECISE)
    if route == "mv":
        return _mv(x, qt, layer)
    if route == "mm":
        return (qmm_prefill_w2 if w2 else qmm_prefill)(x, qt.data, layer)
    if route == "mm8":
        return qmm_mm8(x, qt.data, qt.fmt, layer, qt.scale)
    return dense_matmul(x, qt, layer)


def _mm_operand(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """x rounded once to bf16 when :func:`_mm` will give it to a kernel
    that reads bf16 (the gf4 matmul kernel, ``qmm_mm8``), so products that
    share x (wq/wk/wv, w1/w3, an expert group's w1/w3) share one cast; else
    x as it is."""
    return prefill_operand(x, mm_route(x.shape[0], qt, _qmm._PRECISE) in ("mm", "mm8"))


def _embed(embed: QTensor, tokens: torch.Tensor, plan: ShardingPlan = NO_SHARDING,
           mesh=None):
    """Token embedding (B, D) f32; vocab-sharded under tp, a masked lookup
    of this rank's rows closed by a psum (``calm_tpu/model.py:511-520``)."""
    if plan.tp is None:
        return embed_lookup(tokens, embed)
    v_local = embed.data.shape[0]
    lid = tokens - mesh.axis_index(plan.tp) * v_local
    ok = (lid >= 0) & (lid < v_local)
    rows = embed_lookup(lid.clamp(0, v_local - 1), embed)
    return mesh.psum(rows * ok[..., None], plan.tp)


def _close_residual(y, plan: ShardingPlan, mesh, with_ep: bool = False):
    """Close a row-sharded product's partial sum over tp, after ep for the
    MoE FFN (``calm_tpu/model.py:455-476``); ``plan.rs_ag`` closes tp as a
    reduce-scatter and an all-gather along the features."""
    if with_ep and plan.ep is not None:
        y = mesh.psum(y, plan.ep)
    if plan.tp is None:
        return y
    if plan.rs_ag:
        return mesh.all_gather(mesh.psum_scatter(y, plan.tp, dim=-1), plan.tp, dim=-1)
    return mesh.psum(y, plan.tp)


def _split(plan: ShardingPlan) -> bool:
    """A plan that splits a layer's work over ranks (tp, sp or ep)."""
    return plan.tp is not None or plan.sp is not None or plan.ep is not None


def _shapes(cfg: ModelConfig, w: Weights):
    return (cfg.dim, w.layers.w1.data.shape[1], cfg.q_dim, cfg.kv_dim)


def _fused(cfg: ModelConfig, w: Weights, B: int, plan: ShardingPlan = NO_SHARDING,
           precise: bool = False) -> bool:
    """The rotated epilogue: q/k/v ride from each layer's fused call into
    the next. MoE and parallel-norm layers run per op, and none runs it
    under CALM_ROT=0 (calm_tpu/model.py:1211, :1225-1228) or under a plan
    that splits the layer: its residual closes across ranks between wo and
    the FFN (``:1226-1227``). fp8e4 has no fused epilogue (``:1231``), and
    fp8/fp16 decline it under ``precise``, as JAX's (``:1237-1238``; its
    products stage x in f16); gf4's runs as it does."""
    if cfg.n_experts or cfg.norm_par or not ROTATED_DECODE or _split(plan):
        return False
    if w.layers.wq.fmt == "gf4":
        return gf4_offn_supported(B, _shapes(cfg, w))
    return not precise and qx_offn_supported(w.layers.wq.fmt, B, _shapes(cfg, w))


def _offn(cfg: ModelConfig, w: Weights, B: int, plan: ShardingPlan = NO_SHARDING) -> bool:
    """Dense gf4 decode under CALM_ROT=0: every layer's wo + FFN through
    gf4_offn (K7) after its own q/k/v (calm_tpu/model.py:1194-1201,
    :1106-1110); fp8/fp16 run per op, and so does a plan that splits the
    layer (``:1194-1195``)."""
    return (not ROTATED_DECODE and w.layers.wq.fmt == "gf4" and not cfg.n_experts
            and not cfg.norm_par and not _split(plan)
            and gf4_offn_supported(B, _shapes(cfg, w)))


@dataclasses.dataclass
class _Step:
    """Per-step state shared by every layer, all on the device."""
    pos: torch.Tensor       # (B,) int32
    kv_pos: torch.Tensor    # (B,) int32 logical row each slot writes
    kv_len: torch.Tensor    # (B,) int32
    cos: torch.Tensor       # (B, hd/2)
    sin: torch.Tensor
    sink_cos: torch.Tensor | None   # (B, KV_SINKS, hd/2), one position
    sink_sin: torch.Tensor | None   # forward; None when not rolling
    pt: torch.Tensor | None         # (B, n_blocks) int32 page table
    plan: ShardingPlan = NO_SHARDING
    mesh: object = None             # parallel.mesh.Mesh under a plan
    batch_off: int = 0              # the cache slot of row 0 (a pipeline's microbatch)


def _sink_slots(cache: KVCache, B: int, pt, off: int = 0):
    """The cache axis-1 index of each slot's sinks: slot off + b, or a
    paged slot's own page pt[b, 0]."""
    return slice(off, off + B) if pt is None else pt[:, 0].long()


def _rotate_sinks(cache: KVCache, layer: int, st: _Step, S: int):
    """Under ``rolling``: every slot's sink keys rotated forward one
    position where its window has wrapped (pos >= seq_len) and written
    back unchanged elsewhere, so that their relative RoPE phase tracks the
    sliding window (``calm_tpu/model.py:1007-1033``); a paged slot's sinks
    live in its own page pt[b, 0]."""
    idx = (layer, _sink_slots(cache, st.pos.shape[0], st.pt, st.batch_off), slice(None),
           slice(0, KV_SINKS))
    sink = cache.k[idx]                                   # (B, KVH, 2, hd)
    rot = apply_rope(sink.float().transpose(1, 2), st.sink_cos, st.sink_sin)
    wrapped = (st.pos >= S)[:, None, None, None]
    cache.k[idx] = torch.where(wrapped, rot.transpose(1, 2).to(cache.k.dtype), sink)


def _qkv_post(cfg: ModelConfig, lw: LayerWeights, layer: int, q, k, v,
              plan: ShardingPlan = NO_SHARDING, mesh=None):
    """Bias, qk-norm and clip on projected (rows, dim) q/k/v, in the JAX
    order (``calm_tpu/model.py:930-941``). Under tp the q/k columns are
    sharded and the qk-norm's mean square closes with a psum (``:499``)."""
    if lw.bq is not None:  # added after the carried projections
        q, k, v = q + lw.bq[layer], k + lw.bk[layer], v + lw.bv[layer]
    if cfg.norm_qk:
        def ms(x, dim):
            ss = (x * x).sum(-1, keepdim=True)
            return (ss if plan.tp is None else mesh.psum(ss, plan.tp)) / dim
        q = q * torch.rsqrt(ms(q, cfg.q_dim) + cfg.norm_eps) * lw.q_norm[layer]
        k = k * torch.rsqrt(ms(k, cfg.kv_dim) + cfg.norm_eps) * lw.k_norm[layer]
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


def _local_experts(lw: LayerWeights, plan: ShardingPlan, mesh) -> tuple[int, int]:
    """(first expert id, count) of the experts this rank holds: all of them
    without ep."""
    e_local = lw.w1.data.shape[1]
    return (0 if plan.ep is None else mesh.axis_index(plan.ep) * e_local), e_local


def _moe_sweep(cfg: ModelConfig, lw: LayerWeights, layer: int, xb2, wts, idx,
               plan: ShardingPlan, mesh):
    """<= 64 rows: every unique expert's weights read once for all rows
    (``calm_tpu/model.py:764-827``, there to 16 rows), then each row takes
    the slots it was routed to with its gate weights; dead slots come back
    as zeros. Under ep a rank sweeps its resident experts only: a slot of
    another rank's expert re-reads a local one and weighs 0
    (``:800-808``). The FFN of the slots is one ``gf4_moe_ffn`` (gf4), one
    ``qmm_moe_ffn`` (fp16/fp8/fp8e4 at 2-64 rows of whole steps: the
    multi-row path, past 16 rows the wide one), or three
    ``qmm_moe_dense`` and the activation (one row, other shapes); fp8e4
    hands each product its (E, 1) scales of the layer, which the kernels
    index by the slot's expert id on the device."""
    uniq, cnt = expert_slots(idx, cfg.n_experts)
    off, e_local = _local_experts(lw, plan, mesh)
    live = torch.arange(uniq.shape[0], device=uniq.device) < cnt
    lid = uniq - off
    local = live & (lid >= 0) & (lid < e_local)
    if plan.ep is not None:  # a local id in every slot
        fill = lid[local.to(torch.int8).argmax()].clamp(0, e_local - 1)
        lid = torch.where(local, lid.clamp(0, e_local - 1),
                          torch.where(local.any(), fill, torch.zeros_like(fill)))
    lid = lid.to(torch.int32)
    fmt = lw.w1.fmt
    if fmt == "gf4":
        z = gf4_moe_ffn(xb2, lw.w1.data, lw.w3.data, lw.w2.data, lid, cnt, layer,
                        cfg.act_gelu)
    elif moe_multirow_supported(fmt, xb2.shape[0], lw.w1.data.shape[-1],
                                lw.w2.data.shape[-1]):
        z = qmm_moe_ffn(xb2, lw.w1.data, lw.w3.data, lw.w2.data, lid, cnt, fmt, layer,
                        cfg.act_gelu, (lw.w1.scale, lw.w3.scale, lw.w2.scale))
    else:
        xf = xb2[None]
        h = (act(qmm_moe_dense(xf, lw.w1.data, lid, cnt, fmt, layer, lw.w1.scale),
                 cfg.act_gelu)
             * qmm_moe_dense(xf, lw.w3.data, lid, cnt, fmt, layer, lw.w3.scale))
        z = qmm_moe_dense(h, lw.w2.data, lid, cnt, fmt, layer, lw.w2.scale)  # (A, R, D)
    wmat = ((wts[:, :, None] * (idx[:, :, None] == uniq)).sum(1)
            * local)                                                # (R, A)
    return torch.einsum("ra,ard->rd", wmat, z)


def _moe_grouped(cfg: ModelConfig, lw: LayerWeights, layer: int, xb2, wts, idx,
                 plan: ShardingPlan, mesh):
    """Any row count: the rows grouped by expert, each group through the
    product kernels (``_mm``), weighted and summed back. The same function
    as the JAX per-token vmap (``calm_tpu/model.py:829-857``) without its
    per-row weight reads. The group sizes cost one host sync per layer,
    which a prefill's products dwarf; the decode sweep has none. Under ep a
    rank runs the groups of its own experts."""
    k = idx.shape[1]
    flat = idx.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    with span("model.expert_sizes"):
        sizes = torch.bincount(flat, minlength=cfg.n_experts).tolist()
    count("model.host_syncs")
    off, e_local = _local_experts(lw, plan, mesh)
    w_flat = wts.reshape(-1)
    out = torch.zeros_like(xb2)
    start = 0
    for e, c in enumerate(sizes):
        if not c:
            continue
        sel = order[start:start + c]
        start += c
        if not off <= e < off + e_local:
            continue
        rows = sel // k
        xe = _mm_operand(xb2.index_select(0, rows), lw.w1[layer, e - off])
        h = (act(_mm(xe, lw.w1[layer, e - off]), cfg.act_gelu)
             * _mm(xe, lw.w3[layer, e - off]))
        y = _mm(h, lw.w2[layer, e - off], w2=True)
        out.index_add_(0, rows, y * w_flat[sel, None])
    return out


def moe_sweeps(lw: LayerWeights, R: int) -> bool:
    """Whether a MoE layer's FFN of R rows takes the expert sweep (no host
    sync: what a captured verify replays): up to 16 rows, and 17-64 rows
    whose products the multi-row path takes (whole steps); else the
    grouped products."""
    return R <= MAX_ROWS or moe_multirow_supported(lw.w1.fmt, R, lw.w1.shape[-1],
                                                   lw.w2.shape[-1])


def _moe_ffn(cfg: ModelConfig, lw: LayerWeights, layer: int, xb2,
             plan: ShardingPlan = NO_SHARDING, mesh=None):
    """Top-k routed MoE FFN on xb2 (R, D) (``calm_tpu/model.py:731-857``):
    the gate matvec (replicated), routing, then the expert sweep
    (:func:`moe_sweeps`: up to 64 rows, where JAX runs 17-64 as its
    per-token vmap in XLA) or the grouped products above, over this rank's
    experts, fp8e4 experts with their per-expert scales. Returns the rank's
    partial sum; the caller closes it over ep and tp."""
    wts, idx = route(cfg, _mm(xb2, lw.moegate, layer))
    if moe_sweeps(lw, xb2.shape[0]):
        return _moe_sweep(cfg, lw, layer, xb2, wts, idx, plan, mesh)
    return _moe_grouped(cfg, lw, layer, xb2, wts, idx, plan, mesh)


def _ffn(cfg: ModelConfig, lw: LayerWeights, layer: int, x, att, xb,
         plan: ShardingPlan = NO_SHARDING, mesh=None):
    """wo + residual, then the FFN and its residual, per op, in the JAX
    order (``calm_tpu/model.py:1112-1149``): on ffn-norm(x + wo . att), or
    for parallel-norm archs (Cohere) on the attn-normed input ``xb``. A
    parallel-norm gf4 FFN of <= 16 rows is one gf4_ffn (K6), as the JAX
    package's fused layout runs it there (``:1130-1135``). Under a plan
    wo's and the FFN's partial sums close across ranks first."""
    x = x + _close_residual(_mm(att, lw.wo, layer), plan, mesh)
    xb2 = xb if cfg.norm_par else _norm(cfg, x, lw.ffn_norm[layer])
    if cfg.n_experts:
        return x + _close_residual(_moe_ffn(cfg, lw, layer, xb2, plan, mesh),
                                   plan, mesh, with_ep=True)
    if (cfg.norm_par and lw.w1.fmt == "gf4"
            and gf4_ffn_supported(xb2.shape, lw.w1.data, lw.w2.data)):
        ffn = gf4_ffn(xb2, lw.w1.data, lw.w3.data, lw.w2.data, layer, cfg.act_gelu)
    else:
        xf = _mm_operand(xb2, lw.w1)
        h = act(_mm(xf, lw.w1, layer), cfg.act_gelu) * _mm(xf, lw.w3, layer)
        ffn = _mm(h, lw.w2, layer, w2=True)
    return x + _close_residual(ffn, plan, mesh)


def _sp_write(cache: KVCache, layer: int, st: _Step, kc, vc):
    """sp decode: the new rows (B, KVH, hd) land in the S-shard that owns
    global row kv_pos; the other shards rewrite their current row
    (``calm_tpu/model.py:977-995``)."""
    S_loc = cache.k.shape[3]
    wr = st.kv_pos.long() - st.mesh.axis_index(st.plan.sp) * S_loc
    own = ((wr >= 0) & (wr < S_loc))[:, None, None]
    wr = wr.clamp(0, S_loc - 1)
    slots = torch.arange(kc.shape[0], device=wr.device)
    for buf, new in ((cache.k, kc), (cache.v, vc)):
        buf[layer, slots, :, wr] = torch.where(own, new, buf[layer, slots, :, wr])


def _sp_attention(cache: KVCache, layer: int, st: _Step, q):
    """sp decode attention (``calm_tpu/model.py:557-576``): K12 in partials
    mode over this S-shard's rows below the global kv_len, then the exact
    softmax across shards from one pmax and two psums."""
    S_loc = cache.k.shape[3]
    off = st.mesh.axis_index(st.plan.sp) * S_loc
    kv_loc = (st.kv_len - off).clamp(0, S_loc).to(torch.int32)
    acc, m, l = decode_attention(q, cache.k, cache.v, kv_loc, layer, partials=True)
    mg = st.mesh.pmax(m, st.plan.sp)
    scale = torch.exp(m - mg)  # an empty shard's -inf gives 0
    num = st.mesh.psum(acc * scale, st.plan.sp)
    return num / st.mesh.psum(l * scale, st.plan.sp)


def _layer(cfg: ModelConfig, lw: LayerWeights, layer: int, x, qkv, cache,
           st: _Step, mode: str | None):
    """One layer on x (B, D). ``qkv`` is this layer's (q, k, v) from the
    previous fused epilogue (or layer 0's priming); None otherwise.
    ``mode``: "qkv" for the rotated epilogue, "offn" for gf4_offn (K7),
    None per op. Returns (x, next qkv or None, fresh (k, v) rows for the
    deferred write, or None under sp, whose rows are written here). Head
    counts are this rank's: tp shards the heads."""
    B, D = x.shape
    hd = cfg.head_dim
    plan, mesh = st.plan, st.mesh
    xb = None
    if qkv is None:
        xb = _norm(cfg, x, lw.attn_norm[layer])
        xq = _mm_operand(xb, lw.wq)
        qkv = (_mm(xq, lw.wq, layer), _mm(xq, lw.wk, layer),
               _mm(xq, lw.wv, layer))
    q, k, v = _qkv_post(cfg, lw, layer, *qkv, plan, mesh)
    H, KVH = q.shape[-1] // hd, k.shape[-1] // hd
    q = apply_rope(q.reshape(B, H, hd), st.cos, st.sin)
    k = apply_rope(k.reshape(B, KVH, hd), st.cos, st.sin)
    kc = k.to(cache.k.dtype).contiguous()
    vc = v.reshape(B, KVH, hd).to(cache.k.dtype).contiguous()

    if plan.sp is not None:  # write, rotate, then read, as JAX under sp
        _sp_write(cache, layer, st, kc, vc)
    if st.sink_cos is not None:
        _rotate_sinks(cache, layer, st, cfg.seq_len)
    if plan.sp is not None:
        att, fresh = _sp_attention(cache, layer, st, q.float().contiguous()), None
    else:
        att = decode_attention(q.float().contiguous(), cache.k, cache.v,
                               st.kv_len, layer, fresh=(kc, vc, st.kv_pos), pt=st.pt,
                               batch_off=st.batch_off)
        fresh = (kc, vc)
    att = att.reshape(B, H * hd)

    if mode == "qkv":
        ws = (att, x, lw.ffn_norm, lw.attn_norm, lw.wo.data, lw.w1.data,
              lw.w3.data, lw.w2.data, lw.wq.data, lw.wk.data, lw.wv.data, layer)
        tail = (cfg.act_gelu, cfg.norm_eps, cfg.norm_ln)
        if lw.wq.fmt == "gf4":
            x, qn, kn, vn = gf4_offn_qkv(*ws, *tail)
        else:
            x, qn, kn, vn = qx_offn_qkv(*ws, lw.wq.fmt, *tail)
        return x, (qn, kn, vn), fresh
    if mode == "offn":
        ffn, r1 = gf4_offn(att, x, lw.ffn_norm, lw.wo.data, lw.w1.data, lw.w3.data,
                           lw.w2.data, layer, cfg.act_gelu, cfg.norm_eps, cfg.norm_ln)
        return r1 + ffn, None, fresh
    return _ffn(cfg, lw, layer, x, att, xb, plan, mesh), None, fresh


def _head(cfg: ModelConfig, w: Weights, x):
    """Final norm and the lm-head on x (rows, D)."""
    return _mm(_norm(cfg, x, w.final_norm), w.output)


def upload(values, device, dtype=torch.int32) -> torch.Tensor:
    """Host numbers -> a tensor on ``device`` in one copy that makes no
    host sync (``non_blocking``; CUDA stages the pageable source
    before the call returns, so no pinned buffer has to outlive it)."""
    return torch.tensor(list(values), dtype=dtype).to(device, non_blocking=True)


def _on_device(token, pos, device):
    """token (B,) int64 and pos (B,) int32 on ``device``: tensors as they
    are, host ints (pos an int for every slot, or B of them) in one
    upload."""
    if isinstance(token, torch.Tensor) and isinstance(pos, torch.Tensor):
        return token.to(device), pos.to(device, torch.int32)
    head = [] if isinstance(token, torch.Tensor) else [int(t) for t in token]
    B = token.shape[0] if isinstance(token, torch.Tensor) else len(head)
    if isinstance(pos, torch.Tensor):
        pos = pos.tolist()
    pos = [int(pos)] * B if isinstance(pos, (int, np.integer)) else [int(p) for p in pos]
    if len(pos) != B:
        raise ValueError(f"{len(pos)} positions for {B} slots")
    vals = upload(head + pos, device)
    return (token if not head else vals[:B].long()), vals[len(head):]


def _step_state(cfg: ModelConfig, pos: torch.Tensor, rolling: bool, pt=None,
                plan: ShardingPlan = NO_SHARDING, mesh=None, batch_off: int = 0) -> _Step:
    """The step's per-slot state from pos (B,) int32 on the device
    (``calm_tpu/model.py:1334-1345``), and the one-position tables of the
    sink rotation under ``rolling``. Under sp the sinks (global rows 0 and
    1) live in shard 0, which alone rotates them (``:1028-1030``). Row b
    is cache slot batch_off + b (a pipeline's microbatch, ``:1282``)."""
    kv_pos, kv_len = decode_indices(cfg, pos)
    cos, sin = rope_tables(pos, cfg.head_dim, cfg.rope_theta, cfg.rotary_dim)
    sink_cos = sink_sin = None
    if rolling and (plan.sp is None or mesh.axis_index(plan.sp) == 0):
        sink_cos, sink_sin = rope_tables(
            torch.ones((pos.shape[0], KV_SINKS), dtype=torch.int32, device=pos.device),
            cfg.head_dim, cfg.rope_theta, cfg.rotary_dim)
    return _Step(pos=pos, kv_pos=kv_pos, kv_len=kv_len, cos=cos, sin=sin,
                 sink_cos=sink_cos, sink_sin=sink_sin, pt=pt, plan=plan, mesh=mesh,
                 batch_off=batch_off)


def _row_index(cache: KVCache, kv_pos: torch.Tensor, pt, off: int = 0):
    """(cache axis-1 index, row) of each slot's row kv_pos[b]: slot off +
    b, or a paged slot's page pt[b, kv_pos // PR] at row kv_pos % PR."""
    rows = kv_pos.long()
    slots = torch.arange(rows.shape[0], device=rows.device) + off
    if pt is None:
        return slots, rows
    PR = cache.k.shape[3]
    return pt[slots, rows // PR].long(), rows % PR


def _write_rows(cache: KVCache, st: _Step, fk: torch.Tensor, fv: torch.Tensor):
    """The deferred write: every layer's fresh row (L, B, KVH, hd) of each
    slot at its own row kv_pos[b], in one copy per cache; a paged slot's
    row lives at page pt[b, kv_pos // PR], row kv_pos % PR. Two advanced
    indices apart put the slot axis first: (B, L, KVH, hd)."""
    slots, rows = _row_index(cache, st.kv_pos, st.pt, st.batch_off)
    cache.k[:, slots, :, rows, :] = fk.transpose(0, 1)
    cache.v[:, slots, :, rows, :] = fv.transpose(0, 1)


def _run_layers(cfg: ModelConfig, w: Weights, x, cache: KVCache, st: _Step):
    """Every layer on x (B, D), then the deferred cache write
    (``calm_tpu/model.py:1224-1306``). On the fused path q/k/v ride from one
    layer's epilogue into the next, primed with layer 0's projections."""
    lw = w.layers
    B = x.shape[0]
    mode = ("qkv" if _fused(cfg, w, B, st.plan, _qmm._PRECISE)
            else "offn" if _offn(cfg, w, B, st.plan) else None)
    qkv = None
    if mode == "qkv":
        xb0 = _norm(cfg, x, lw.attn_norm[0])
        qkv = (_mv(xb0, lw.wq, 0), _mv(xb0, lw.wk, 0), _mv(xb0, lw.wv, 0))
    fresh_k, fresh_v = [], []
    for layer in range(cfg.n_layers):
        x, qkv, fresh = _layer(cfg, lw, layer, x, qkv, cache, st, mode)
        if fresh is not None:
            fresh_k.append(fresh[0])
            fresh_v.append(fresh[1])
    if fresh_k:
        _write_rows(cache, st, torch.stack(fresh_k), torch.stack(fresh_v))
    return x


def _decode(cfg: ModelConfig, w: Weights, token: torch.Tensor, pos: torch.Tensor,
            cache: KVCache, rolling: bool, pt=None, plan: ShardingPlan = NO_SHARDING,
            mesh=None) -> torch.Tensor:
    """The step on device state (``decode_step_fn``, ``calm_tpu/model.py
    :1348-1360``): token (B,) int64, pos (B,) int32 -> logits (B, V); the
    cache is updated in place. It reads no device value on the host, makes
    no upload and sizes no tensor by a value: what a graph captures."""
    st = _step_state(cfg, pos, rolling, pt, plan, mesh)
    x = _run_layers(cfg, w, _embed(w.embed, token, plan, mesh), cache, st)
    return _head(cfg, w, x)


@torch.no_grad()
def decode_step(cfg: ModelConfig, w: Weights, token, pos, cache: KVCache,
                plan: ShardingPlan = NO_SHARDING, mesh=None, rolling: bool = True):
    """One token for each of the B sequence slots, eagerly: token (B,)
    int64 (or B host ints), pos (B,) int32 on the device, an int for
    every slot or B host ints -> (logits (B, V) f32, cache). Each slot
    attends its own window and writes its own row. ``rolling`` (static,
    as JAX's) keeps the sink rotation: under it a slot at pos >= seq_len
    rotates its sinks; ``rolling=False`` leaves it out, which a caller may
    pick when no slot is past the window (the results are then equal).
    The cache is updated in place.

    Under a ``plan`` on ``mesh`` (``parallel.mesh.Mesh``) this is one
    rank's program on its local weights and cache: tp shards heads, FFN
    columns and the vocab (the logits come back as this rank's vocab
    slice), ep the experts, sp the cache rows, dp the slots; the
    wrappers of ``parallel.sharding`` build the local tensors. A sharded
    step always runs eagerly: its collectives go through
    ``torch.distributed``."""
    token, pos = _on_device(token, pos, cache.k.device)
    return _decode(cfg, w, token, pos, cache, rolling, None, plan, mesh), cache


def _snapshot(cfg: ModelConfig, cache: KVCache, rolling: bool):
    """``snapshot(pos, pt)`` for a StepGraph on ``cache``: saves the rows a
    step at pos writes (each slot's row kv_pos in every layer, and its
    sinks under ``rolling``) and returns the function that writes them
    back."""
    def snapshot(pos, pt):
        slots, rows = _row_index(cache, decode_indices(cfg, pos)[0], pt)
        sinks = _sink_slots(cache, pos.shape[0], pt)
        saved = [(buf, buf[:, slots, :, rows].clone(),
                  buf[:, sinks, :, :KV_SINKS].clone() if rolling else None)
                 for buf in (cache.k, cache.v)]

        def restore():
            for buf, row, sink in saved:
                buf[:, slots, :, rows] = row
                if sink is not None:
                    buf[:, sinks, :, :KV_SINKS] = sink
        return restore
    return snapshot


def step_graph(cfg: ModelConfig, w: Weights, cache: KVCache, B: int, rolling: bool,
               sampled: bool = False, pt: torch.Tensor | None = None) -> StepGraph:
    """The captured step of B slots on ``cache`` (a dense cache, or a page
    pool with the table ``pt``, a buffer the caller updates in place),
    captured at first use and kept on the cache, keyed by the weights
    (held by the graph), B, ``rolling``, ROTATED_DECODE, the precise mode,
    sampled or greedy and dense or paged. Call :meth:`StepGraph.load`
    before the first replay: the capture starts from the static inputs."""
    key = (id(w), B, rolling, ROTATED_DECODE, _qmm._PRECISE, sampled, pt is not None)
    g = cache.graphs.get(key)
    if g is not None:
        if any(a is not b for a, b in zip(g.keep, (w, cache.k, cache.v))) or g.pt is not pt:
            raise RuntimeError("a captured decode step met other cache buffers or "
                               "another page table than it was captured on")
        return g
    kv = KVCache(cache.k, cache.v)  # the buffers only: no cycle through the cache

    def step(token, pos, pt_):
        return _decode(cfg, w, token, pos, kv, rolling, pt_)
    g = StepGraph(step, _snapshot(cfg, kv, rolling), B, w.output.data.shape[0],
                  cache.k.device, sampled, pt, keep=(w, cache.k, cache.v))
    cache.graphs[key] = g
    return g


def _replayed(cfg, w, cache, token, pos, rolling, pt=None, sampling=None) -> StepGraph:
    """The cache's graph for this step, loaded with token and pos (and
    the sampling's temperature and min-p), captured if new."""
    B = token.shape[0] if isinstance(token, torch.Tensor) else len(token)
    g = step_graph(cfg, w, cache, B, rolling, sampling is not None, pt)
    g.load(token, pos, sampling)
    if g.graph is None:
        g.capture()
    return g


@torch.no_grad()
def decode_once(cfg: ModelConfig, w: Weights, token, pos, cache: KVCache,
                rolling: bool, pt: torch.Tensor | None = None, sampling=None):
    """One step for every slot, the next token chosen on the device: the
    argmax, or with ``sampling`` = (generator, temperature (B,), minp (B,))
    a min-p draw (``sampler.device_sample``). token and pos as
    :func:`decode_step` takes them; ``pt`` pages the cache as
    :func:`paged_decode_step`. Returns (logits (B, V), next ids (B,)) on
    the device. On the card the cache's captured step is replayed (its
    outputs are the graph's own buffers, overwritten by its next replay);
    on the CPU the step runs eagerly."""
    if cache.k.is_cuda:
        g = _replayed(cfg, w, cache, token, pos, rolling, pt, sampling)
        g.replay(None if sampling is None else sampling[0])
        return g.logits, g.token
    token, pos = _on_device(token, pos, cache.k.device)
    out = _decode(cfg, w, token, pos, cache, rolling, pt)
    return out, out.argmax(-1) if sampling is None else device_sample(out, *sampling)


def greedy_next(logits: torch.Tensor, plan: ShardingPlan = NO_SHARDING,
                mesh=None) -> torch.Tensor:
    """The global argmax (B,) int64 of (possibly vocab-sharded) logits (B,
    V_local): under tp the pmax of the value, then the pmin of the global
    index among the ranks that hold it, so ties go to the first
    occurrence, as ``jnp.argmax`` (``calm_tpu/model.py:1483-1497``)."""
    if plan.tp is None:
        return logits.argmax(-1)
    v_local = logits.shape[-1]
    val, idx = logits.max(-1)  # the first max of the slice
    g_val = mesh.pmax(val, plan.tp)
    cand = torch.where(val == g_val, idx + mesh.axis_index(plan.tp) * v_local,
                       torch.full_like(idx, 2 ** 30))
    return mesh.pmin(cand, plan.tp)


@torch.no_grad()
def paged_decode_step(cfg: ModelConfig, w: Weights, token, pos,
                      pool: KVCache, pt: torch.Tensor, rolling: bool = True,
                      plan: ShardingPlan = NO_SHARDING, mesh=None):
    """:func:`decode_step` on a page pool (``calm_tpu/paged.py:36-48``):
    pool (L, P, KVH, PR, hd), pt (B, seq_len // PR) int32 on the pool's
    device. Attention reads each slot's pages through the table (K12 paged
    and fresh mode); the deferred write lands at page pt[b, kv_pos // PR],
    row kv_pos % PR; under ``rolling`` a wrapped slot rotates the sinks in
    its own page pt[b, 0]. The pool is updated in place.

    Under a tp/ep ``plan`` on ``mesh`` this is one rank's program on its
    local weights and its pool's local kv heads, with the table the same
    on every rank: every write lands on the page and row axes, so each
    rank updates its own heads with no collective beyond the step's own.
    The logits come back as this rank's vocab slice."""
    token, pos = _on_device(token, pos, pool.k.device)
    return _decode(cfg, w, token, pos, pool, rolling, pt, plan, mesh), pool


def weights_to(w: Weights, device) -> Weights:
    """``w`` on ``device``: ``w`` itself when it lies there already (so
    decoders that share a device share one copy), else a copy of every
    tensor (a tied lm-head stays the embedding)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if w.embed.data.device == device:
        return w

    def move(x):
        if isinstance(x, QTensor):
            return QTensor(x.data.to(device), x.fmt,
                           None if x.scale is None else x.scale.to(device))
        return None if x is None else x.to(device)
    lw = w.layers
    layers = LayerWeights(**{f: move(getattr(lw, f)) for f in lw.__dataclass_fields__})
    embed = move(w.embed)
    return Weights(embed=embed, layers=layers, final_norm=move(w.final_norm),
                   output=embed if w.output is w.embed else move(w.output))


@torch.no_grad()
def decode_loop(cfg: ModelConfig, w: Weights, token: torch.Tensor, pos0,
                cache: KVCache, n_steps: int, sampling=None, rolling: bool | None = None):
    """Decode ``n_steps`` tokens with each token chosen on the device: the
    argmax (the counterpart of ``decode_scan_fn``), or with ``sampling``,
    a (generator, temperature (B,), minp (B,)) triple, min-p drawn by
    ``sampler.device_sample`` from each step's logits (``decode_scan_
    sampled_fn``, ``calm_tpu/model.py:1428-1455``). ``pos0`` is an int for
    every slot or B host ints, each slot's first position. The chunk keeps
    the sink rotation only when it can reach the window's edge, as
    ``calm_tpu/engine.py:251-252`` picks ``rolling``, unless the caller
    gives ``rolling`` (static, as JAX's). On the card each step is a replay
    of the cache's captured step, its token and logits copied out after it;
    on the CPU the step runs eagerly. Returns (tokens (B, N) int64, cache,
    per-step logits (N, B, V)), all on the device."""
    B = token.shape[0]
    starts = [int(pos0)] * B if isinstance(pos0, (int, np.integer)) else [int(p) for p in pos0]
    if rolling is None:
        rolling = max(starts) + n_steps >= cfg.seq_len
    if cache.k.is_cuda:
        g = _replayed(cfg, w, cache, token, pos0 if isinstance(pos0, int) else starts,
                      rolling, sampling=sampling)
        toks = torch.empty((B, n_steps), dtype=torch.int64, device=token.device)
        logits = torch.empty((n_steps,) + tuple(g.logits.shape), dtype=g.logits.dtype,
                             device=token.device)
        for i in range(n_steps):
            g.replay(None if sampling is None else sampling[0])
            toks[:, i].copy_(g.token)
            logits[i].copy_(g.logits)
        return toks, cache, logits
    pos = upload(starts, token.device)
    toks, logits = [], []
    for _ in range(n_steps):
        out = _decode(cfg, w, token, pos, cache, rolling)
        # first max wins, like jnp.argmax
        token = out.argmax(-1) if sampling is None else device_sample(out, *sampling)
        pos = pos + 1
        toks.append(token)
        logits.append(out)
    return torch.stack(toks, 1), cache, torch.stack(logits)


def _prefill_layer(cfg: ModelConfig, lw: LayerWeights, layer: int, x,
                   cache: KVCache, rows: torch.Tensor, cos, sin, pos0, kv_len,
                   batch_off: int, plan: ShardingPlan = NO_SHARDING, mesh=None,
                   tree: torch.Tensor | None = None):
    """One layer on x (B*T, D), in the JAX order (``calm_tpu/model.py``
    :915-1059, :1112-1149): the T fresh K/V rows are in the cache (slots
    from ``batch_off`` on, row rows[b, t] of slot b, one indexed write on
    the device) before the attention reads it. Under sp (the all-gather
    path, ``:1044-1050``) the rows are this rank's chunk of the prompt:
    they land in its S-shard at rows 0..T, and the attention reads every
    shard's chunk, gathered at cache precision, or under ``plan.ring``
    folds them in as they come round the ring (:func:`_attention_ring`).
    With ``tree`` the queries are a speculation tree's nodes:
    :func:`hopper_attn.tree_attention`, the split-S route of the prefill
    kernel with the tree's mask on the card (its plan a function of the
    shapes, so eager and replayed runs sum alike), its plain version over
    every row of the window on the CPU."""
    B, T = rows.shape
    hd = cfg.head_dim
    xb = _norm(cfg, x, lw.attn_norm[layer])
    xq = _mm_operand(xb, lw.wq)
    q, k, v = _qkv_post(cfg, lw, layer, _mm(xq, lw.wq, layer),
                        _mm(xq, lw.wk, layer), _mm(xq, lw.wv, layer), plan, mesh)
    H, KVH = q.shape[-1] // hd, k.shape[-1] // hd
    q = apply_rope(q.reshape(B, T, H, hd), cos, sin)
    k = apply_rope(k.reshape(B, T, KVH, hd), cos, sin)
    kt = k.to(cache.k.dtype)                               # (B, T, KVH, hd)
    vt = v.reshape(B, T, KVH, hd).to(cache.k.dtype)
    slots = torch.arange(batch_off, batch_off + B, device=rows.device)[:, None]
    cache.k[layer][slots, :, rows] = kt
    cache.v[layer][slots, :, rows] = vt
    qg = q.reshape(B, T, KVH, H // KVH, hd).contiguous()
    if plan.sp is not None and plan.ring:
        att = _attention_ring(qg, kt, vt, pos0, plan, mesh)
    elif plan.sp is not None:  # the whole prompt's K/V as a one-layer cache
        ka = mesh.all_gather(kt.transpose(1, 2), plan.sp, dim=2)[None].contiguous()
        va = mesh.all_gather(vt.transpose(1, 2), plan.sp, dim=2)[None].contiguous()
        att = prefill_attention(qg, ka, va, pos0, kv_len, 0)
    elif tree is not None:
        att = tree_attention(qg, cache.k, cache.v, pos0, kv_len, layer, tree, batch_off)
    else:
        att = prefill_attention(qg, cache.k, cache.v, pos0, kv_len, layer, batch_off)
    return _ffn(cfg, lw, layer, x, att.reshape(B * T, H * hd), xb, plan, mesh)


def _attention_ring(q, k, v, pos0, plan: ShardingPlan, mesh):
    """Blockwise ring attention of sp prefill under ``plan.ring``
    (``_attention_ring``, ``calm_tpu/model.py:678-728``): q (B, T, KVH, M,
    hd) f32 this rank's chunk of queries at positions pos0 + t, k/v (B, T,
    KVH, hd) its chunk's fresh rows at cache precision. n hops: hop r holds
    shard (i - r) mod n's chunk, the local one first (its causal diagonal
    keeps the running max finite from the start), folded into a running
    (m, l, acc) online softmax; between hops the chunks move one rank on
    the sp ring (``Mesh.ppermute``). So a rank holds two chunks at a time,
    never the whole prompt's K/V. The same softmax as the all-gather path
    with another association. JAX computes it in jnp (no Pallas kernel),
    and so does the port, on both devices: operands rounded to bf16 on the
    card and kept f32 on the CPU, as JAX's ``cdt``, products summed in f32.
    Returns (B, T, KVH, M, hd) f32."""
    B, T, KVH, M, hd = q.shape
    n, i = mesh.axis_size(plan.sp), mesh.axis_index(plan.sp)
    cdt = torch.bfloat16 if q.is_cuda else torch.float32
    qf = q.to(cdt).float()
    q_pos = pos0.long()[:, None] + torch.arange(T, device=q.device)   # (B, T)
    m = torch.full((B, KVH, M, T), -math.inf, device=q.device)
    l = torch.zeros((B, KVH, M, T), device=q.device)
    acc = torch.zeros((B, T, KVH, M, hd), device=q.device)
    perm = [(j, (j + 1) % n) for j in range(n)]
    kc, vc = k, v
    for r in range(n):
        base = ((i - r) % n) * T
        kf = kc.transpose(1, 2).to(cdt).float()                       # (B, KVH, T, hd)
        vf = vc.transpose(1, 2).to(cdt).float()
        s = torch.einsum("btkmh,bksh->bkmts", qf, kf) / math.sqrt(hd)
        causal = (base + torch.arange(T, device=q.device))[None, None, :] <= q_pos[:, :, None]
        s = s.masked_fill(~causal[:, None, None], -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(torch.isfinite(s), torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_new), 0.0)
        l = l * alpha + p.sum(-1)
        hop = torch.einsum("bkmts,bksh->btkmh", p.to(cdt).float(), vf)
        acc = acc * alpha.permute(0, 3, 1, 2)[..., None] + hop
        m = m_new
        if r != n - 1:
            kc = mesh.ppermute(kc, plan.sp, perm)
            vc = mesh.ppermute(vc, plan.sp, perm)
    return acc / l.permute(0, 3, 1, 2)[..., None].clamp_min(1e-37)


def check_rows(cfg: ModelConfig, cache: KVCache, B: int, T: int, starts,
               batch_off: int = 0) -> list[int]:
    """The host's bounds check of a forward of T rows a sequence from
    ``starts`` (B host ints, or a tensor the caller holds on the host):
    start + T <= seq_len and the slots inside the cache. Returns the
    starts as ints."""
    starts = [int(p) for p in (starts.reshape(-1).tolist() if isinstance(starts, torch.Tensor)
                               else starts)]
    if len(starts) != B or min(starts) < 0 or max(starts) + T > cfg.seq_len:
        raise ValueError(f"prefill needs B={B} starts with start + {T} <= "
                         f"{cfg.seq_len}, got {starts}")
    if not 0 <= batch_off <= cache.k.shape[1] - B:
        raise ValueError(f"slots {batch_off}..{batch_off + B - 1} out of range "
                         f"for a cache of {cache.k.shape[1]}")
    return starts


def _forward(cfg, w, tokens, p0, cache, logits_mode, batch_off=0,
             plan: ShardingPlan = NO_SHARDING, mesh=None, kv_len=None, depth=None,
             tree=None):
    """The prefill forward on device state (``_forward``, ``calm_tpu/model.py
    :1323-1331``): tokens (B, T) int64 and p0 (B,) int32 on the device,
    rows bounds-checked by the caller (:func:`check_rows`). RoPE positions
    are p0 + t, or p0 + depth[t] for a tree (``depth`` (T,) int32; sibling
    lanes share positions); KV rows land at p0 + t either way (under sp at
    t, in the rank's S-shard); kv_len defaults to p0 + T. It reads no device
    value on the host and sizes no tensor by one: what a graph captures
    (``graphs.VerifyGraph``). Returns logits per ``logits_mode``."""
    if logits_mode not in ("last", "all", "none"):
        raise ValueError(f"unknown logits_mode {logits_mode!r}")
    B, T = tokens.shape
    dev = tokens.device
    t_idx = torch.arange(T, device=dev)
    rows = (torch.zeros_like(p0) if plan.sp is not None else p0)[:, None].long() + t_idx
    pos = p0[:, None].long() + (t_idx if depth is None else depth.long())[None, :]
    cos, sin = rope_tables(pos, cfg.head_dim, cfg.rope_theta, cfg.rotary_dim)
    x = _embed(w.embed, tokens, plan, mesh).reshape(B * T, cfg.dim)
    kv_len = p0 + T if kv_len is None else kv_len
    for layer in range(cfg.n_layers):
        x = _prefill_layer(cfg, w.layers, layer, x, cache, rows, cos, sin, p0, kv_len,
                           batch_off, plan, mesh, tree)
    if logits_mode == "none":
        return None
    if logits_mode == "last":
        return _head(cfg, w, x.reshape(B, T, -1)[:, -1])
    return _head(cfg, w, x).reshape(B, T, -1)


@torch.no_grad()
def prefill(cfg: ModelConfig, w: Weights, tokens: torch.Tensor, pos0,
            cache: KVCache, logits_mode: str = "last", batch_off: int = 0,
            plan: ShardingPlan = NO_SHARDING, mesh=None):
    """Batched prompt processing (``calm_tpu/model.py:1363-1374``): tokens
    (B, T) int64 at positions pos0[b] + t, pos0 (B,) ints, sequence b in
    cache slot batch_off + b. Requires pos0 + T <= seq_len (a prefill never
    rolls). Returns (logits, cache): logits (B, V) for ``"last"``, (B, T, V)
    for ``"all"``, None for ``"none"``; the cache is updated in place.
    Under a ``plan`` (without sp: see :func:`prefill_sp`) one rank's
    program on its local weights and cache, as :func:`decode_step`."""
    if plan.sp is not None:
        raise ValueError("an sp plan prefills through prefill_sp")
    with span("model.prefill"):
        return _prefill(cfg, w, tokens, pos0, cache, logits_mode, batch_off, plan, mesh)


def _prefill(cfg, w, tokens, pos0, cache, logits_mode, batch_off, plan, mesh,
             kv_len=None):
    B, T = tokens.shape
    starts = check_rows(cfg, cache, B, T, pos0, batch_off)
    p0 = upload(starts, tokens.device)
    return _forward(cfg, w, tokens, p0, cache, logits_mode, batch_off, plan, mesh,
                    kv_len), cache


@torch.no_grad()
def tree_verify(cfg: ModelConfig, w: Weights, tokens: torch.Tensor, pos0,
                depth: torch.Tensor, tree: torch.Tensor, cache: KVCache,
                plan: ShardingPlan = NO_SHARDING, mesh=None):
    """Verify a static-shape speculation tree in one forward, eagerly
    (``tree_verify_fn``, ``calm_tpu/model.py:1377-1400``): tokens (1, N)
    the tree's nodes in flat order (node 0 the root), pos0 (1,) host
    ints, depth (N,) int32 each node's depth below the root, tree (N, N)
    bool ancestor-or-self reachability. RoPE positions are pos0 + depth
    (sibling lanes share positions); KV rows land flat at pos0 + [0, N);
    kv_len = pos0 + N. A node attends the context below the tree and its
    ancestors-or-self inside it (:func:`hopper_attn.tree_attention`: a
    kernel on the card, its plain version on the CPU; the tree has no TPU
    kernel, JAX runs it in jnp, ``:1051-1064``). Requires pos0 + N <=
    seq_len. Returns (logits
    (1, N, V), cache); ``verify_once`` replays it on the card. Under a
    ``plan`` one rank's program, as :func:`prefill`."""
    B, N = tokens.shape
    starts = check_rows(cfg, cache, B, N, pos0)
    p0 = upload(starts, tokens.device)
    dev = tokens.device
    return _forward(cfg, w, tokens, p0, cache, "all", 0, plan, mesh,
                    depth=depth.to(dev), tree=tree.to(dev)), cache


def _clamp_rows(r0: int, n: int, S: int) -> int:
    """A row offset clamped as ``lax.dynamic_slice`` clamps it: the n rows
    stay inside [0, S)."""
    return min(max(int(r0), 0), S - n)


@torch.no_grad()
def cache_move_rows(cache: KVCache, src0: int, dst0: int, n: int) -> KVCache:
    """Relocate ``n`` rows [src0, src0 + n) to [dst0, dst0 + n) in every
    layer and slot, in place (``cache_move_rows_fn``, ``calm_tpu/model.py
    :1403-1411``): the tree verify's accepted path lands on contiguous
    rows. The rows are read into a temporary first, so overlapping ranges
    are safe, as JAX's slice-then-update; offsets clamp as its dynamic
    slices do. A graph captured on the cache's buffers sees the moved rows:
    no buffer is replaced."""
    S = cache.k.shape[3]
    src0, dst0 = _clamp_rows(src0, n, S), _clamp_rows(dst0, n, S)
    for buf in (cache.k, cache.v):
        buf[:, :, :, dst0:dst0 + n] = buf[:, :, :, src0:src0 + n].clone()
    return cache


@torch.no_grad()
def cache_bcast_rows(cache: KVCache, lane: int, row0: int, n: int) -> KVCache:
    """Broadcast one slot's rows [row0, row0 + n) to every slot, in place
    (``cache_bcast_rows_fn``, ``calm_tpu/model.py:1414-1425``): after a tree
    round the winning draft lane's chain becomes every lane's history.
    Read into a temporary first, offsets clamped, as
    :func:`cache_move_rows`."""
    B, S = cache.k.shape[1], cache.k.shape[3]
    lane, row0 = min(max(int(lane), 0), B - 1), _clamp_rows(row0, n, S)
    for buf in (cache.k, cache.v):
        buf[:, :, :, row0:row0 + n] = buf[:, lane:lane + 1, :, row0:row0 + n].clone()
    return cache


@torch.no_grad()
def prefill_sp(cfg: ModelConfig, w: Weights, tokens: torch.Tensor, cache: KVCache,
               plan: ShardingPlan, mesh):
    """Sequence-parallel full-window prefill, one rank's program
    (``calm_tpu/model.py:1458``): tokens (B, T_local) are this rank's chunk
    of a prompt of seq_len tokens split over ``plan.sp`` in rank order, the
    cache its S-shard of T_local rows. Each layer projects the chunk at its
    absolute positions, writes it into the shard and attends causally over
    the K/V of every chunk: all-gathered (K13 over the gathered rows), or
    under ``plan.ring`` brought round the sp ring a chunk a hop
    (:func:`_attention_ring`). Returns (logits (B, T_local, V_local),
    cache)."""
    B, T = tokens.shape
    if T * mesh.axis_size(plan.sp) != cfg.seq_len or cache.k.shape[3] != T:
        raise ValueError(f"sp prefill takes the whole window: {T} tokens a shard of "
                         f"{cache.k.shape[3]} rows, {cfg.seq_len} in all")
    start = mesh.axis_index(plan.sp) * T
    kv_len = torch.full((B,), cfg.seq_len, dtype=torch.int32, device=tokens.device)
    with span("model.prefill"):
        return _prefill(cfg, w, tokens, [start] * B, cache, "all", 0, plan, mesh, kv_len)


def _verify_snapshot(cache: KVCache, T: int):
    """``snapshot(pos0)`` for a VerifyGraph on ``cache``: saves the rows
    pos0[b] + [0, T) of every slot and layer, which a (B, T) forward writes,
    and returns the function that writes them back."""
    def snapshot(pos0):
        rows = pos0[:, None].long() + torch.arange(T, device=pos0.device)
        slots = torch.arange(pos0.shape[0], device=pos0.device)[:, None]
        saved = [(buf, buf[:, slots, :, rows].clone()) for buf in (cache.k, cache.v)]

        def restore():
            for buf, old in saved:
                buf[:, slots, :, rows] = old
        return restore
    return snapshot


def verify_graph(cfg: ModelConfig, w: Weights, cache: KVCache, B: int, T: int,
                 tree: bool = False) -> VerifyGraph:
    """The captured (B, T) verify forward on ``cache`` (every row's logits;
    with ``tree`` the tree-masked forward of :func:`tree_verify`), captured
    at first use and kept on the cache, keyed as :func:`step_graph` keys the
    step: by the weights (held by the graph), B, T, the tree's shape or
    none, ROTATED_DECODE, the precise mode and the KV dtype."""
    key = ("verify", id(w), B, T, (T, T) if tree else None, ROTATED_DECODE,
           _qmm._PRECISE, cache.k.dtype)
    g = cache.graphs.get(key)
    if g is not None:
        if any(a is not b for a, b in zip(g.keep, (w, cache.k, cache.v))):
            raise RuntimeError("a captured verify met other cache buffers than it was "
                               "captured on")
        return g
    kv = KVCache(cache.k, cache.v)  # the buffers only: no cycle through the cache

    def forward(tokens, p0, depth, tr):
        return _forward(cfg, w, tokens, p0, kv, "all", depth=depth, tree=tr)
    g = VerifyGraph(forward, _verify_snapshot(kv, T), B, T, cache.k.device, tree,
                    keep=(w, cache.k, cache.v))
    cache.graphs[key] = g
    return g


@torch.no_grad()
def verify_once(cfg: ModelConfig, w: Weights, tokens, pos0, cache: KVCache,
                depth=None, tree=None) -> torch.Tensor:
    """Score (B, T) tokens from pos0 (B host ints) in one forward that
    returns every row's logits (B, T, V): the speculative verify, JAX's
    ``prefill(..., logits_mode="all")`` over every slot, or with ``depth``
    and ``tree`` its ``tree_verify``. On the card the forward is the
    cache's captured :class:`graphs.VerifyGraph`, replayed (its output is
    the graph's own buffer, overwritten by its next replay; the same bits
    as the eager forward on the same inputs): a dense model's at any B x T,
    a MoE model's where its FFN sweeps the experts (:func:`moe_sweeps`: B x
    T <= 64 rows of whole steps). Past that a MoE forward stays eager: its
    grouped products read the group sizes on the host (``_moe_grouped``).
    On the CPU every forward runs eagerly. The cache is updated in place."""
    tokens = torch.as_tensor(tokens, dtype=torch.int64)
    B, T = tokens.shape
    starts = check_rows(cfg, cache, B, T, pos0)
    if cache.k.is_cuda and (not cfg.n_experts or moe_sweeps(w.layers, B * T)):
        g = verify_graph(cfg, w, cache, B, T, tree is not None)
        g.load(tokens, starts, depth, tree)
        if g.graph is None:
            g.capture()
        g.replay()
        return g.logits
    tokens = tokens.to(cache.k.device)
    if tree is not None:
        return tree_verify(cfg, w, tokens, starts, torch.as_tensor(depth),
                           torch.as_tensor(tree), cache)[0]
    return _prefill(cfg, w, tokens, starts, cache, "all", 0, NO_SHARDING, None)[0]


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
