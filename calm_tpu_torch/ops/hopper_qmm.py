"""Quantized products on Hopper: the ports of pallas_qmm's kernels.

- :func:`qmm_decode` replaces ``_layered_qmm_kernel``
  (``calm_tpu/ops/pallas_qmm.py:92``): y = x . dequant(W[layer])^T for
  fp8/fp16 (``csrc/qmm.cu``); gf4 goes to :func:`qmm_decode_gf4`.
- :func:`qmm_decode_gf4` replaces ``_layered_gf4_kernel`` (``:100``): the
  same matvec on natural gf4 words, B <= 16 (``csrc/gf4.cu``).
- :func:`qmm_prefill` replaces ``_gf4_mm_kernel`` (``:238``): the gf4
  product for R >= 32 rows (``csrc/gf4.cu``), eligibility as
  ``mm_supported`` (``:275-283``).
- :func:`qmm_prefill_w2` replaces ``_gf4_mmt_kernel`` (``:346``): the
  FFN's w2 product at prefill. The TPU kernel reads word-transposed w2 for
  Mosaic; on natural words it is K4's product and launches K4's kernel.
- :func:`qx_offn_qkv` replaces ``_qx_offn_qkv_kernel`` (``:942``): one
  layer's wo + residual, ffn-norm, w1/w3 + activation, w2 + residual and
  the next layer's attn-norm + q/k/v (``csrc/qmm.cu``).
- :func:`gf4_offn_qkv` replaces ``_gf4_offn_qkv_kernel`` (``:737``): the
  same epilogue on natural gf4 words (``csrc/qmm.cu``, fmt 2), where the
  TPU kernel reads plane-permuted layouts.
- :func:`gf4_ffn` replaces ``_gf4_ffn_kernel`` (``:464``): the gf4 FFN
  alone, w2 . (act(w1 . x) * (w3 . x)), which parallel-norm (Cohere)
  decode runs on the attn-normed input (``csrc/qmm.cu``), where the TPU
  kernel reads plane-major w1/w3 and word-transposed w2.
- :func:`gf4_offn` replaces ``_gf4_offn_kernel`` (``:601``): wo +
  residual, ffn-norm and the FFN, returning the FFN and r1 apart (the
  ``CALM_ROT=0`` decode; ``csrc/qmm.cu``), in natural order where the TPU
  kernel runs on a plane-permuted residual stream.
- :func:`qmm_moe_dense` replaces ``_moe_dense_kernel`` and
  ``_moe_dense_gf4_kernel`` (``:1248``, ``:1256``): the MoE expert sweep,
  one matvec per expert slot with the ids on the device (``csrc/moe.cu``).
- :func:`gf4_moe_ffn` replaces ``_gf4_moe_ffn_kernel`` (``:1361``): each
  slot's whole expert FFN on natural gf4 words (``csrc/moe.cu``), where
  the TPU kernel reads plane-major w1/w3.

Each wrapper takes its plain PyTorch version (``*_plain``, f32) for tensors
on the CPU, and launches the kernel for CUDA tensors or raises; it counts
its launches in ``.launches``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from calm_tpu_torch.ops import build
from calm_tpu_torch.ops.norms import rmsnorm
from calm_tpu_torch.ops.qmm import STORAGE, QTensor, dequant

_FMT_CODE = {"fp16": 0, "fp8": 1}  # qmm_decode, qx_offn_qkv
_OFFN_CODE = dict(_FMT_CODE, gf4=2)  # csrc/qmm.cu's epilogue, csrc/moe.cu
MAX_ROWS = 16
MIN_MM_ROWS = 32  # qmm_prefill's least row count (pallas_qmm.mm_supported)
MAX_NORM_DIM = 16384  # norm_kernel: 1024 threads x 4 float4 in registers


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_cuda(fmt: str, x: torch.Tensor, weights) -> None:
    _check(fmt in _OFFN_CODE, f"no CUDA kernel for weight format {fmt!r}")
    _check(x.dtype == torch.float32 and x.is_contiguous(),
           "activations must be contiguous float32")
    _check(x.data_ptr() % 16 == 0, "activations must be 16-byte aligned")
    for w in weights:
        _check(w.device == x.device, "weights and activations on different devices")
        _check(w.dtype == STORAGE[fmt], f"{fmt} weights must be {STORAGE[fmt]}")
        _check(w.is_contiguous(), "weights must be contiguous")
        _check(w.shape[-1] % 16 == 0, "contraction dim must be a multiple of 16")


def _plane_ptr(w: torch.Tensor, layer: int) -> int:
    """Address of the contiguous plane w[layer], without building a view
    (the fused epilogue takes nine of them per layer and token)."""
    return w.data_ptr() + layer * w.stride(0) * w.element_size()


def _plane(w: torch.Tensor, layer) -> torch.Tensor:
    if w.ndim == 2:
        return w
    _check(layer is not None and 0 <= int(layer) < w.shape[0],
           f"layer {layer} out of range for a stack of {w.shape[0]}")
    return w[int(layer)]


# ---------------------------------------------------------------------------
# K2: qmm_decode
# ---------------------------------------------------------------------------


def qmm_decode_plain(x: torch.Tensor, w: torch.Tensor, fmt: str,
                     layer=None) -> torch.Tensor:
    wf = dequant(QTensor(_plane(w, layer), fmt), torch.float32)
    return x.float() @ wf.T


def qmm_decode(x: torch.Tensor, w: torch.Tensor, fmt: str,
               layer=None) -> torch.Tensor:
    """x (B, n) f32 @ W[layer]^T for W (L, d, n) (or (d, n)) in storage
    dtype, (L, d, n/8) int32 words for gf4 -> (B, d) f32."""
    if fmt == "gf4":
        return qmm_decode_gf4(x, w, layer)
    if x.device.type == "cpu":
        return qmm_decode_plain(x, w, fmt, layer)
    wl = _plane(w, layer)
    _check_cuda(fmt, x, [wl])
    B, n = x.shape
    d = wl.shape[0]
    _check(wl.shape[1] == n, f"x has {n} columns, W has {wl.shape[1]}")
    _check(1 <= B <= MAX_ROWS, f"the decode kernel takes 1..{MAX_ROWS} rows")
    y = torch.empty((B, d), dtype=torch.float32, device=x.device)
    rc = build.lib("qmm").calm_qmm_decode(
        x.data_ptr(), wl.data_ptr(), y.data_ptr(), B, d, n, _FMT_CODE[fmt],
        _stream(x))
    build.check("qmm", rc)
    qmm_decode.launches += 1
    return y


qmm_decode.launches = 0


# ---------------------------------------------------------------------------
# K3 and K4: gf4 matvec and matmul
# ---------------------------------------------------------------------------


def _check_gf4(x: torch.Tensor, wl: torch.Tensor) -> tuple[int, int, int]:
    _check(x.dtype == torch.float32 and x.is_contiguous() and x.ndim == 2,
           "activations must be contiguous 2-D float32")
    _check(x.data_ptr() % 16 == 0, "activations must be 16-byte aligned")
    _check(wl.device == x.device, "weights and activations on different devices")
    _check(wl.dtype == torch.int32 and wl.is_contiguous(),
           "gf4 weights must be contiguous int32 words")
    R, n = x.shape
    d, n8 = wl.shape
    _check(n == 8 * n8, f"x has {n} columns, W has {n8} words (x8) per row")
    return R, d, n8


def qmm_decode_gf4_plain(x: torch.Tensor, w: torch.Tensor,
                         layer=None) -> torch.Tensor:
    return qmm_decode_plain(x, w, "gf4", layer)


def qmm_decode_gf4(x: torch.Tensor, w: torch.Tensor, layer=None) -> torch.Tensor:
    """x (B <= 16, n) f32 @ W[layer]^T for gf4 words W (L, d, n/8) (or
    (d, n/8)) -> (B, d) f32."""
    if x.device.type == "cpu":
        return qmm_decode_gf4_plain(x, w, layer)
    wl = _plane(w, layer)
    B, d, n8 = _check_gf4(x, wl)
    _check(1 <= B <= MAX_ROWS, f"the decode kernel takes 1..{MAX_ROWS} rows")
    y = torch.empty((B, d), dtype=torch.float32, device=x.device)
    rc = build.lib("gf4").calm_gf4_matvec(x.data_ptr(), wl.data_ptr(),
                                          y.data_ptr(), B, d, n8, _stream(x))
    build.check("gf4", rc)
    qmm_decode_gf4.launches += 1
    return y


qmm_decode_gf4.launches = 0


def mm_supported(rows: int, wdata: torch.Tensor, fmt: str) -> bool:
    """qmm_prefill's eligibility, as pallas_qmm.mm_supported: gf4 words and
    prefill-sized row counts (<= 16 rows keep the matvec; 17..31 take the
    dequantized matmul)."""
    return fmt == "gf4" and wdata.ndim in (2, 3) and rows >= MIN_MM_ROWS


qmm_prefill_plain = qmm_decode_gf4_plain  # the same function, any row count
qmm_prefill_w2_plain = qmm_decode_gf4_plain


def _gf4_matmul(x: torch.Tensor, w: torch.Tensor, layer) -> torch.Tensor:
    wl = _plane(w, layer)
    R, d, n8 = _check_gf4(x, wl)
    _check(R >= MIN_MM_ROWS, f"the matmul kernel takes >= {MIN_MM_ROWS} rows")
    y = torch.empty((R, d), dtype=torch.float32, device=x.device)
    rc = build.lib("gf4").calm_gf4_matmul(x.data_ptr(), wl.data_ptr(),
                                          y.data_ptr(), R, d, n8, _stream(x))
    build.check("gf4", rc)
    return y


def qmm_prefill(x: torch.Tensor, w: torch.Tensor, layer=None) -> torch.Tensor:
    """x (R >= 32, n) f32 @ W[layer]^T for gf4 words W (L, d, n/8) (or
    (d, n/8)) -> (R, d) f32. On the card the weights decode exactly to
    bf16 and x is rounded once to bf16, as the TPU kernel rounds it."""
    if x.device.type == "cpu":
        return qmm_prefill_plain(x, w, layer)
    y = _gf4_matmul(x, w, layer)
    qmm_prefill.launches += 1
    return y


qmm_prefill.launches = 0


def qmm_prefill_w2(h: torch.Tensor, w2: torch.Tensor, layer=None) -> torch.Tensor:
    """The FFN's down product at prefill: h (R >= 32, H) f32 @ w2[layer]^T
    for gf4 words w2 (L, D, H/8) -> (R, D) f32, as :func:`qmm_prefill`."""
    if h.device.type == "cpu":
        return qmm_prefill_w2_plain(h, w2, layer)
    y = _gf4_matmul(h, w2, layer)
    qmm_prefill_w2.launches += 1
    return y


qmm_prefill_w2.launches = 0


# ---------------------------------------------------------------------------
# K9: qx_offn_qkv
# ---------------------------------------------------------------------------


def act(h: torch.Tensor, act_gelu: bool) -> torch.Tensor:
    """The FFN activation: tanh-GELU or SiLU (pallas_qmm.py:1010-1014)."""
    return F.gelu(h, approximate="tanh") if act_gelu else F.silu(h)


def _ffn_plain(x, w1, w3, w2, layer, fmt: str, act_gelu: bool):
    h = (act(qmm_decode_plain(x, w1, fmt, layer), act_gelu)
         * qmm_decode_plain(x, w3, fmt, layer))
    return qmm_decode_plain(h, w2, fmt, layer)


def _offn_plain(a, r, g, wo, w1, w3, w2, layer, fmt: str, act_gelu: bool,
                eps: float, sub_mean: bool):
    """(ffn, r1): r1 = r + a . wo^T, ffn = the FFN of ffn-norm(r1)."""
    r1 = r.float() + qmm_decode_plain(a, wo, fmt, layer)
    xn = rmsnorm(r1, g[layer], eps, sub_mean)
    return _ffn_plain(xn, w1, w3, w2, layer, fmt, act_gelu), r1


def qx_offn_qkv_plain(a, r, g, anx, wo, w1, w3, w2, wq, wk, wv, layer,
                      fmt: str, act_gelu: bool, eps: float, sub_mean: bool):
    L = wo.shape[0]
    l, ln = int(layer), min(int(layer) + 1, L - 1)
    ffn, r1 = _offn_plain(a, r, g, wo, w1, w3, w2, l, fmt, act_gelu, eps, sub_mean)
    x = r1 + ffn
    xq = rmsnorm(x, anx[ln], eps, sub_mean)
    return (x, *(qmm_decode_plain(xq, w, fmt, ln) for w in (wq, wk, wv)))


def _offn_qkv(a, r, g, anx, wo, w1, w3, w2, wq, wk, wv, layer, fmt: str,
              act_gelu: bool, eps: float, sub_mean: bool):
    gs = 8 if fmt == "gf4" else 1  # values per stored element
    L, D = wo.shape[:2]
    Qd = wo.shape[2] * gs
    H = w1.shape[1]
    KVd = wk.shape[1]
    B = a.shape[0]
    l, ln = int(layer), min(int(layer) + 1, L - 1)
    _check(0 <= l < L, f"layer {l} out of range for a stack of {L}")
    _check(1 <= B <= MAX_ROWS, f"the decode kernel takes 1..{MAX_ROWS} rows")
    _check(tuple(a.shape) == (B, Qd) and tuple(r.shape) == (B, D),
           "attention output / residual shape mismatch")
    _check(tuple(w1.shape) == (L, H, D // gs) and tuple(w3.shape) == (L, H, D // gs)
           and tuple(w2.shape) == (L, D, H // gs)
           and tuple(wq.shape) == (L, Qd, D // gs)
           and tuple(wk.shape) == (L, KVd, D // gs)
           and tuple(wv.shape) == (L, KVd, D // gs), "weight stack shape mismatch")
    _check_cuda(fmt, a, [wo, w1, w3, w2, wq, wk, wv])
    for t in (r, g, anx):
        _check(t.dtype == torch.float32 and t.is_contiguous()
               and t.device == a.device and t.data_ptr() % 16 == 0,
               "residual and norm weights must be contiguous float32 on the card")
    _check(tuple(g.shape) == (L, D) and tuple(anx.shape) == (L, D),
           "norm weights must be (L, D)")
    _check(D <= MAX_NORM_DIM, f"the norm launch takes rows of <= {MAX_NORM_DIM}")
    dev = a.device
    r1 = torch.empty((B, D), dtype=torch.float32, device=dev)
    xn = torch.empty((B, D), dtype=torch.float32, device=dev)
    h = torch.empty((B, H), dtype=torch.float32, device=dev)
    x = torch.empty((B, D), dtype=torch.float32, device=dev)
    qkv = torch.empty((B, Qd + 2 * KVd), dtype=torch.float32, device=dev)
    rc = build.lib("qmm").calm_qx_offn_qkv(
        a.data_ptr(), r.data_ptr(), _plane_ptr(g, l), _plane_ptr(anx, ln),
        _plane_ptr(wo, l), _plane_ptr(w1, l), _plane_ptr(w3, l),
        _plane_ptr(w2, l), _plane_ptr(wq, ln), _plane_ptr(wk, ln),
        _plane_ptr(wv, ln), r1.data_ptr(), xn.data_ptr(), h.data_ptr(),
        x.data_ptr(), qkv.data_ptr(), B, D, H, Qd, KVd, _OFFN_CODE[fmt],
        int(act_gelu), float(eps), int(sub_mean), _stream(a))
    build.check("qmm", rc)
    return (x, qkv[:, :Qd], qkv[:, Qd:Qd + KVd], qkv[:, Qd + KVd:])


def qx_offn_qkv(a, r, g, anx, wo, w1, w3, w2, wq, wk, wv, layer, fmt: str,
                act_gelu: bool, eps: float, sub_mean: bool):
    """a (B, Qd) f32 attention output; r (B, D) f32 residual; g/anx (L, D)
    f32 ffn/attn norm weights; wo (L, D, Qd), w1/w3 (L, H, D), w2 (L, D, H),
    wq (L, Qd, D), wk/wv (L, KVd, D) in storage dtype ->
    (x_new (B, D), q (B, Qd), k (B, KVd), v (B, KVd)) with q/k/v projected
    from layer + 1, clamped to L - 1, without bias, clip or qk-norm.
    On CUDA, q, k and v are views of one (B, Qd + 2 KVd) buffer."""
    if a.device.type == "cpu":
        return qx_offn_qkv_plain(a, r, g, anx, wo, w1, w3, w2, wq, wk, wv,
                                 layer, fmt, act_gelu, eps, sub_mean)
    _check(fmt in _FMT_CODE, f"qx_offn_qkv takes fp8/fp16 weights, not {fmt!r}")
    out = _offn_qkv(a, r, g, anx, wo, w1, w3, w2, wq, wk, wv, layer, fmt,
                    act_gelu, eps, sub_mean)
    qx_offn_qkv.launches += 1
    return out


qx_offn_qkv.launches = 0


def gf4_offn_qkv_plain(a, r, g, anx, wo, w1, w3, w2, wq, wk, wv, layer,
                       act_gelu: bool, eps: float, sub_mean: bool):
    return qx_offn_qkv_plain(a, r, g, anx, wo, w1, w3, w2, wq, wk, wv, layer,
                             "gf4", act_gelu, eps, sub_mean)


def gf4_offn_qkv(a, r, g, anx, wo, w1, w3, w2, wq, wk, wv, layer,
                 act_gelu: bool, eps: float, sub_mean: bool):
    """:func:`qx_offn_qkv` on natural gf4 words: wo (L, D, Qd/8), w1/w3
    (L, H, D/8), w2 (L, D, H/8), wq (L, Qd, D/8), wk/wv (L, KVd, D/8)
    int32."""
    if a.device.type == "cpu":
        return gf4_offn_qkv_plain(a, r, g, anx, wo, w1, w3, w2, wq, wk, wv,
                                  layer, act_gelu, eps, sub_mean)
    out = _offn_qkv(a, r, g, anx, wo, w1, w3, w2, wq, wk, wv, layer, "gf4",
                    act_gelu, eps, sub_mean)
    gf4_offn_qkv.launches += 1
    return out


gf4_offn_qkv.launches = 0


# ---------------------------------------------------------------------------
# K6 and K7: the gf4 FFN, and wo + residual + ffn-norm + FFN
# ---------------------------------------------------------------------------


def _check_ffn_words(w1, w3, w2, D: int, x: torch.Tensor) -> int:
    """Checks of one layer's natural gf4 FFN words against a model width D;
    returns the hidden width H."""
    H = w1.shape[0]
    for w in (w1, w3, w2):
        _check(w.device == x.device and w.dtype == torch.int32 and w.is_contiguous(),
               "gf4 weights must be contiguous int32 words on the activations' device")
    _check(tuple(w1.shape) == (H, D // 8) and tuple(w3.shape) == (H, D // 8)
           and tuple(w2.shape) == (D, H // 8) and H % 8 == 0,
           f"FFN words must be w1/w3 (H, D/8), w2 (D, H/8) for D={D}, got "
           f"{tuple(w1.shape)}, {tuple(w3.shape)}, {tuple(w2.shape)}")
    return H


def gf4_ffn_plain(x, w1, w3, w2, layer, act_gelu: bool):
    return _ffn_plain(x, w1, w3, w2, layer, "gf4", act_gelu)


def gf4_ffn(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor,
            layer, act_gelu: bool) -> torch.Tensor:
    """x (B <= 16, D) f32; w1/w3 (L, H, D/8), w2 (L, D, H/8) natural gf4
    words (or one layer's planes) -> (B, D) f32 = w2 . (act(w1 . x) * (w3
    . x)). Two launches of ``csrc/qmm.cu``, h between them in a buffer
    allocated here."""
    if x.device.type == "cpu":
        return gf4_ffn_plain(x, w1, w3, w2, layer, act_gelu)
    w1l, w3l, w2l = (_plane(w, layer) for w in (w1, w3, w2))
    B, _, _ = _check_gf4(x, w1l)
    D = x.shape[1]
    H = _check_ffn_words(w1l, w3l, w2l, D, x)
    _check(1 <= B <= MAX_ROWS, f"the decode kernel takes 1..{MAX_ROWS} rows")
    h = torch.empty((B, H), dtype=torch.float32, device=x.device)
    y = torch.empty((B, D), dtype=torch.float32, device=x.device)
    rc = build.lib("qmm").calm_gf4_ffn(
        x.data_ptr(), w1l.data_ptr(), w3l.data_ptr(), w2l.data_ptr(), h.data_ptr(),
        y.data_ptr(), B, D, H, int(act_gelu), _stream(x))
    build.check("qmm", rc)
    gf4_ffn.launches += 1
    return y


gf4_ffn.launches = 0


def gf4_ffn_supported(x_shape, w1: torch.Tensor, w2: torch.Tensor) -> bool:
    """:func:`gf4_ffn`'s eligibility, as pallas_qmm.gf4_ffn_supported: a
    decode-sized batch and FFN words that match x."""
    return (1 <= x_shape[0] <= MAX_ROWS and x_shape[-1] == 8 * w1.shape[-1]
            and w1.shape[-2] == 8 * w2.shape[-1])


def gf4_offn_plain(a, r, g, wo, w1, w3, w2, layer, act_gelu: bool, eps: float,
                   sub_mean: bool):
    return _offn_plain(a, r, g, wo, w1, w3, w2, int(layer), "gf4", act_gelu, eps,
                       sub_mean)


def gf4_offn(a: torch.Tensor, r: torch.Tensor, g: torch.Tensor, wo: torch.Tensor,
             w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor, layer,
             act_gelu: bool, eps: float, sub_mean: bool):
    """a (B <= 16, Qd) f32 attention output; r (B, D) f32 residual; g (L,
    D) f32 ffn-norm weights; wo (L, D, Qd/8), w1/w3 (L, H, D/8), w2 (L, D,
    H/8) natural gf4 words -> (ffn (B, D), r1 (B, D)) f32 with r1 = r + a
    . wo^T and ffn the FFN of ffn-norm(r1); the caller's new residual is
    r1 + ffn. Four launches of ``csrc/qmm.cu``."""
    if a.device.type == "cpu":
        return gf4_offn_plain(a, r, g, wo, w1, w3, w2, layer, act_gelu, eps, sub_mean)
    wol, w1l, w3l, w2l = (_plane(w, layer) for w in (wo, w1, w3, w2))
    B, D, q8 = _check_gf4(a, wol)
    H = _check_ffn_words(w1l, w3l, w2l, D, a)
    _check(1 <= B <= MAX_ROWS, f"the decode kernel takes 1..{MAX_ROWS} rows")
    _check(D % 4 == 0 and D <= MAX_NORM_DIM,
           f"the norm launch takes rows of a multiple of 4, <= {MAX_NORM_DIM}")
    for t in (r, g):
        _check(t.dtype == torch.float32 and t.is_contiguous() and t.device == a.device
               and t.data_ptr() % 16 == 0,
               "residual and norm weights must be contiguous float32 on the card")
    _check(tuple(r.shape) == (B, D) and g.ndim == 2 and g.shape[1] == D,
           f"r must be (B, D) and g (L, D) for D={D}")
    l = int(layer)
    _check(0 <= l < g.shape[0], f"layer {l} out of range for norm weights of {g.shape[0]}")
    dev = a.device
    r1, xn, ffn = (torch.empty((B, D), dtype=torch.float32, device=dev) for _ in range(3))
    h = torch.empty((B, H), dtype=torch.float32, device=dev)
    rc = build.lib("qmm").calm_gf4_offn(
        a.data_ptr(), r.data_ptr(), _plane_ptr(g, l), wol.data_ptr(), w1l.data_ptr(),
        w3l.data_ptr(), w2l.data_ptr(), r1.data_ptr(), xn.data_ptr(), h.data_ptr(),
        ffn.data_ptr(), B, D, H, 8 * q8, int(act_gelu), float(eps), int(sub_mean),
        _stream(a))
    build.check("qmm", rc)
    gf4_offn.launches += 1
    return ffn, r1


gf4_offn.launches = 0


# ---------------------------------------------------------------------------
# K10 and K11: expert-indexed matvecs for MoE decode
# ---------------------------------------------------------------------------


def qmm_moe_dense_plain(x: torch.Tensor, wstack: torch.Tensor, eidx: torch.Tensor,
                        cnt: torch.Tensor, fmt: str, layer=None) -> torch.Tensor:
    A = eidx.shape[0]
    planes = _plane(wstack, layer).index_select(0, eidx.to(wstack.device).long())
    wf = dequant(QTensor(planes, fmt), torch.float32)  # (A, d, n)
    y = torch.einsum("abn,adn->abd", x.float().expand(A, -1, -1), wf)
    live = torch.arange(A, device=y.device) < cnt.to(y.device).reshape(())
    return torch.where(live[:, None, None], y, 0.0)


def _check_slots(x: torch.Tensor, eidx: torch.Tensor, cnt: torch.Tensor) -> None:
    _check(eidx.dtype == torch.int32 and eidx.ndim == 1 and eidx.is_contiguous()
           and eidx.device == x.device, "eidx must be (A,) int32 on the card")
    _check(cnt.dtype == torch.int32 and cnt.numel() == 1 and cnt.device == x.device,
           "cnt must be one int32 on the card")


def _check_stack(x: torch.Tensor, w: torch.Tensor, fmt: str, layer) -> int:
    """Checks of one (L, E, d, n_packed) expert stack against x (.., n);
    returns its layer index."""
    _check(x.dtype == torch.float32 and x.is_contiguous() and x.data_ptr() % 16 == 0,
           "activations must be contiguous 16-byte aligned float32")
    _check(w.device == x.device and w.dtype == STORAGE[fmt] and w.is_contiguous()
           and w.ndim == 4, f"{fmt} expert stacks must be contiguous (L, E, d, n) "
           f"{STORAGE[fmt]} on the activations' device")
    gs = 8 if fmt == "gf4" else 1
    _check(x.shape[-1] == w.shape[-1] * gs and x.shape[-1] % 4 == 0,
           f"x has {x.shape[-1]} columns, W rows hold {w.shape[-1] * gs} "
           "(a multiple of 4)")
    _check(layer is not None and 0 <= int(layer) < w.shape[0],
           f"layer {layer} out of range for a stack of {w.shape[0]}")
    return int(layer)


def qmm_moe_dense(x: torch.Tensor, wstack: torch.Tensor, eidx: torch.Tensor,
                  cnt: torch.Tensor, fmt: str, layer=None) -> torch.Tensor:
    """The expert sweep: Y[a] = x[min(a, Ax - 1)] @ W[layer, eidx[a]]^T for
    x (Ax, B <= 16, n) f32 with Ax in {1, A}, W (L, E, d, n) fp16/fp8 or
    (L, E, d, n/8) gf4 words, eidx (A,) int32 and cnt (1,) int32 on the
    device -> (A, B, d) f32; slots a >= cnt give zeros."""
    if x.device.type == "cpu":
        return qmm_moe_dense_plain(x, wstack, eidx, cnt, fmt, layer)
    _check(fmt in _OFFN_CODE, f"no CUDA kernel for weight format {fmt!r}")
    l = _check_stack(x, wstack, fmt, layer)
    _check_slots(x, eidx, cnt)
    Ax, B, n = x.shape
    A = eidx.shape[0]
    _check(Ax in (1, A) and 1 <= B <= MAX_ROWS,
           f"x must be (1 or {A}, 1..{MAX_ROWS}, n), got {tuple(x.shape)}")
    d = wstack.shape[2]
    y = torch.empty((A, B, d), dtype=torch.float32, device=x.device)
    rc = build.lib("moe").calm_moe_dense(
        x.data_ptr(), _plane_ptr(wstack, l), y.data_ptr(), eidx.data_ptr(),
        cnt.data_ptr(), Ax, A, B, d, n, wstack.shape[1], _OFFN_CODE[fmt], _stream(x))
    build.check("moe", rc)
    qmm_moe_dense.launches += 1
    return y


qmm_moe_dense.launches = 0


def gf4_moe_ffn_plain(x, w1, w3, w2, eidx, cnt, layer, act_gelu: bool):
    x1 = x.float()[None]
    h = (act(qmm_moe_dense_plain(x1, w1, eidx, cnt, "gf4", layer), act_gelu)
         * qmm_moe_dense_plain(x1, w3, eidx, cnt, "gf4", layer))
    return qmm_moe_dense_plain(h, w2, eidx, cnt, "gf4", layer)


def gf4_moe_ffn(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                w2: torch.Tensor, eidx: torch.Tensor, cnt: torch.Tensor, layer,
                act_gelu: bool) -> torch.Tensor:
    """The whole expert FFN of each slot on natural gf4 words: x (B <= 16,
    D) f32, w1/w3 (L, E, H, D/8), w2 (L, E, D, H/8) int32 -> z (A, B, D)
    f32 with z[a] = (act(x W1[l,e]^T) * (x W3[l,e]^T)) W2[l,e]^T, e =
    eidx[a]; slots a >= cnt give zeros. Two launches of ``csrc/moe.cu``,
    the h between them in a buffer allocated here."""
    if x.device.type == "cpu":
        return gf4_moe_ffn_plain(x, w1, w3, w2, eidx, cnt, layer, act_gelu)
    l = _check_stack(x, w1, "gf4", layer)
    _check_slots(x, eidx, cnt)
    B, D = x.shape
    L, E, H, _ = w1.shape
    _check(1 <= B <= MAX_ROWS, f"the decode kernel takes 1..{MAX_ROWS} rows")
    _check(w3.shape == w1.shape and w3.dtype == w1.dtype and w3.is_contiguous()
           and w3.device == x.device, "w3 must match w1")
    _check(tuple(w2.shape) == (L, E, D, H // 8) and H % 8 == 0 and w2.dtype == w1.dtype
           and w2.is_contiguous() and w2.device == x.device,
           f"w2 must be (L, E, D, H/8) = {(L, E, D, H // 8)} int32, got {tuple(w2.shape)}")
    A = eidx.shape[0]
    h = torch.empty((A, B, H), dtype=torch.float32, device=x.device)
    z = torch.empty((A, B, D), dtype=torch.float32, device=x.device)
    rc = build.lib("moe").calm_gf4_moe_ffn(
        x.data_ptr(), _plane_ptr(w1, l), _plane_ptr(w3, l), _plane_ptr(w2, l),
        eidx.data_ptr(), cnt.data_ptr(), h.data_ptr(), z.data_ptr(), A, B, D, H, E,
        int(act_gelu), _stream(x))
    build.check("moe", rc)
    gf4_moe_ffn.launches += 1
    return z


gf4_moe_ffn.launches = 0


def _offn_shapes_ok(B: int, shapes) -> bool:
    return (B <= MAX_ROWS and shapes[0] <= MAX_NORM_DIM
            and all(s % 128 == 0 for s in shapes))


def qx_offn_supported(fmt: str, B: int, shapes) -> bool:
    """The fused epilogue's eligibility, as pallas_qmm.qx_offn_supported:
    fp8/fp16, decode-sized batch, 128-aligned (D, H, Qd, KVd), and D
    within the norm launch's row limit."""
    return fmt in _FMT_CODE and _offn_shapes_ok(B, shapes)


def gf4_offn_supported(B: int, shapes) -> bool:
    """:func:`gf4_offn_qkv`'s and :func:`gf4_offn`'s eligibility on gf4
    weights: the same shapes as :func:`qx_offn_supported` (128-aligned
    dims are whole words)."""
    return _offn_shapes_ok(B, shapes)
