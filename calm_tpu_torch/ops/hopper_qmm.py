"""Decode matvecs on Hopper: the ports of pallas_qmm's fp8/fp16 kernels.

- :func:`qmm_decode` replaces ``_layered_qmm_kernel``
  (``calm_tpu/ops/pallas_qmm.py:92``): y = x . dequant(W[layer])^T.
- :func:`qx_offn_qkv` replaces ``_qx_offn_qkv_kernel`` (``:942``): one
  layer's wo + residual, ffn-norm, w1/w3 + activation, w2 + residual and
  the next layer's attn-norm + q/k/v.

Both kernels live in ``csrc/qmm.cu``. Each wrapper takes its plain PyTorch
version (``*_plain``, f32) for tensors on the CPU, and launches the kernel
for CUDA tensors or raises; it counts its launches in ``.launches``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from calm_tpu_torch.ops import build
from calm_tpu_torch.ops.norms import rmsnorm
from calm_tpu_torch.ops.qmm import STORAGE, QTensor, dequant

_FMT_CODE = {"fp16": 0, "fp8": 1}
MAX_ROWS = 16
MAX_NORM_DIM = 16384  # norm_kernel: 1024 threads x 4 float4 in registers


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_cuda(fmt: str, x: torch.Tensor, weights) -> None:
    _check(fmt in _FMT_CODE, f"no CUDA kernel for weight format {fmt!r}")
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
    dtype -> (B, d) f32."""
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
# K9: qx_offn_qkv
# ---------------------------------------------------------------------------


def act(h: torch.Tensor, act_gelu: bool) -> torch.Tensor:
    """The FFN activation: tanh-GELU or SiLU (pallas_qmm.py:1010-1014)."""
    return F.gelu(h, approximate="tanh") if act_gelu else F.silu(h)


def qx_offn_qkv_plain(a, r, g, anx, wo, w1, w3, w2, wq, wk, wv, layer,
                      fmt: str, act_gelu: bool, eps: float, sub_mean: bool):
    L = wo.shape[0]
    l, ln = int(layer), min(int(layer) + 1, L - 1)

    def mv(x, w, li):
        return qmm_decode_plain(x, w, fmt, li)

    r1 = r.float() + mv(a, wo, l)
    xn = rmsnorm(r1, g[l], eps, sub_mean)
    h = act(mv(xn, w1, l), act_gelu) * mv(xn, w3, l)
    x = r1 + mv(h, w2, l)
    xq = rmsnorm(x, anx[ln], eps, sub_mean)
    return x, mv(xq, wq, ln), mv(xq, wk, ln), mv(xq, wv, ln)


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
    L, D, Qd = wo.shape
    H = w1.shape[1]
    KVd = wk.shape[1]
    B = a.shape[0]
    l, ln = int(layer), min(int(layer) + 1, L - 1)
    _check(0 <= l < L, f"layer {l} out of range for a stack of {L}")
    _check(1 <= B <= MAX_ROWS, f"the decode kernel takes 1..{MAX_ROWS} rows")
    _check(tuple(a.shape) == (B, Qd) and tuple(r.shape) == (B, D),
           "attention output / residual shape mismatch")
    _check(tuple(w1.shape) == (L, H, D) and tuple(w3.shape) == (L, H, D)
           and tuple(w2.shape) == (L, D, H) and tuple(wq.shape) == (L, Qd, D)
           and tuple(wk.shape) == (L, KVd, D)
           and tuple(wv.shape) == (L, KVd, D), "weight stack shape mismatch")
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
        x.data_ptr(), qkv.data_ptr(), B, D, H, Qd, KVd, _FMT_CODE[fmt],
        int(act_gelu), float(eps), int(sub_mean), _stream(a))
    build.check("qmm", rc)
    qx_offn_qkv.launches += 1
    return (x, qkv[:, :Qd], qkv[:, Qd:Qd + KVd], qkv[:, Qd + KVd:])


qx_offn_qkv.launches = 0


def qx_offn_supported(fmt: str, B: int, shapes) -> bool:
    """The fused epilogue's eligibility, as pallas_qmm.qx_offn_supported:
    fp8/fp16, decode-sized batch, 128-aligned (D, H, Qd, KVd), and D
    within the norm launch's row limit."""
    if fmt not in _FMT_CODE or B > MAX_ROWS or shapes[0] > MAX_NORM_DIM:
        return False
    return all(s % 128 == 0 for s in shapes)
