"""Weight quantization formats: fp16, fp8 (e5m2), fp8e4 (e4m3 + scale), gf4.

The container-level quantization math of ``calm_tpu.quant`` without
``ml_dtypes``: fp8 rounding goes through torch's own ``float8_e5m2`` /
``float8_e4m3fn`` casts (round-to-nearest-even from float32, like
ml_dtypes), and fp8 codes travel as ``uint8`` numpy arrays. Where the two
casts part (NaN for e5m2, overflow for e4m3fn) the bytes are pinned to
ml_dtypes'.

fp8e4 is e4m3fn with a power-of-two per-tensor scale (one per (layer,
expert) for MoE stacks in the container): :func:`fp8e4_quantize`.

gf4 ("group float 4"): 8 consecutive values share one u32 word:

    bits [0:8)   fp8-e5m2 group scale byte ``m`` (the group's abs-max,
                 rounded to fp8, sign included)
    bits [8+3k : 8+3k+3)  3-bit code ``q_k`` for value k in [0, 8)

    value_k = (q_k - 4) * (fp8_decode(m) / -4)
"""

from __future__ import annotations

import numpy as np
import torch

GF4_SHIFTS = np.array([8 + 3 * k for k in range(8)], dtype=np.uint32)


def _to_fp8_bytes(t: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    f = np.ascontiguousarray(t, dtype=np.float32)
    b = torch.from_numpy(f).to(dtype).view(torch.uint8).numpy()
    if dtype == torch.float8_e5m2:
        # ml_dtypes (and so calm_tpu) writes NaN as 0x7e, sign kept; torch's
        # cast writes 0x7f. Both decode to NaN.
        b = np.where(np.isnan(f), np.where(np.signbit(f), 0xFE, 0x7E), b).astype(np.uint8)
    return b


def _from_fp8_bytes(t: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    b = torch.from_numpy(np.ascontiguousarray(t).view(np.uint8))
    return b.view(dtype).to(torch.float32).numpy()


def fp8_quantize(t: np.ndarray) -> np.ndarray:
    """Round to fp8 e5m2; returns the code bytes (uint8)."""
    return _to_fp8_bytes(t, torch.float8_e5m2)


def fp8_dequantize(t: np.ndarray) -> np.ndarray:
    return _from_fp8_bytes(t, torch.float8_e5m2)


def fp8e4_quantize_tensor(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`fp8e4_quantize` on a tensor where it lies (the card, for
    weights made there): codes as ``float8_e4m3fn`` and the scale as a
    (1,) float32 tensor on t's device. The scale is 2^ceil(log2(amax /
    448)), or 1 when amax is 0 (or NaN), computed on the host from amax as
    ``calm_tpu/quant.py:51-54`` computes it, so max |t / s| <= 448 for
    finite t. torch's cast saturates to +-448 where ml_dtypes writes NaN
    (|t / s| > 464, inf): those bytes are pinned to NaN, sign kept."""
    t = t.float()
    amax = t.abs().max().item() if t.numel() else 0.0
    s = float(2.0 ** np.ceil(np.log2(amax / 448.0))) if amax > 0 else 1.0
    v = t / s
    codes = v.to(torch.float8_e4m3fn).view(torch.uint8)
    nan = torch.where(torch.signbit(v), 0xFF, 0x7F).to(torch.uint8)
    codes = torch.where(v.abs() > 464.0, nan, codes)
    return (codes.view(torch.float8_e4m3fn),
            torch.full((1,), s, dtype=torch.float32, device=t.device))


def fp8e4_quantize(t: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Round to fp8 e4m3fn with a power-of-two per-tensor scale: returns
    (code bytes (uint8), scale (1,) float32), bit for bit as
    ``calm_tpu.quant.fp8e4_quantize`` (the scale makes the dequantization
    codes x scale exact)."""
    codes, scale = fp8e4_quantize_tensor(
        torch.from_numpy(np.ascontiguousarray(t, dtype=np.float32)))
    return codes.view(torch.uint8).numpy(), scale.numpy()


def fp8e4_dequantize(t: np.ndarray, scale: np.ndarray) -> np.ndarray:
    return _from_fp8_bytes(t, torch.float8_e4m3fn) * np.float32(scale.reshape(()))


def gf4_quantize(t: np.ndarray) -> np.ndarray:
    """Quantize the last axis (a multiple of 8) to gf4 words (int32), bit
    for bit as ``calm_tpu.quant.gf4_quantize``, in torch on the host's
    threads (a 7B plane in about a second). numpy's float16 products round
    each operation through float32, which ``.half()`` after each f32
    operation reproduces: f16(f16(g) * -4 + 4), then round half to even,
    clipped to [0, 7]."""
    t = torch.from_numpy(np.ascontiguousarray(t, dtype=np.float32))
    assert t.shape[-1] % 8 == 0, "gf4 requires last dim % 8 == 0"
    gt = t.reshape(*t.shape[:-1], -1, 8)

    gmaxi = gt.abs().argmax(dim=-1, keepdim=True)
    gmax_b = torch.from_numpy(fp8_quantize(torch.gather(gt, -1, gmaxi).numpy()))
    gmax = gmax_b.view(torch.float8_e5m2).float()

    gn = torch.nan_to_num(gt / gmax, nan=0.0, posinf=0.0, neginf=0.0)
    q = (gn.half().float() * -4 + 4).half().float().round().clamp(0, 7).to(torch.int64)

    words = (q << torch.from_numpy(GF4_SHIFTS.astype(np.int64))).sum(dim=-1)
    words += gmax_b.reshape(words.shape).to(torch.int64)
    return words.numpy().astype(np.uint32).view(np.int32)


def gf4_dequantize(words: np.ndarray) -> np.ndarray:
    """Decode gf4 words back to float32, expanding the last axis by 8."""
    w = np.asarray(words).view(np.uint32)
    scale = fp8_dequantize((w & 0xFF).astype(np.uint8)) / -4.0
    codes = ((w[..., None] >> GF4_SHIFTS) & 7).astype(np.int32) - 4
    vals = codes.astype(np.float32) * scale[..., None]
    return vals.reshape(*w.shape[:-1], w.shape[-1] * 8)


def quantize(t: np.ndarray, dtype: str) -> np.ndarray:
    """Quantize a float tensor for the container; dtype in {fp16, fp8, gf4}
    (fp8e4 carries a side scale: :func:`quantize_scaled`)."""
    if dtype == "fp16":
        return np.asarray(t, dtype=np.float32).astype(np.float16)
    if dtype == "fp8":
        return fp8_quantize(t)
    if dtype == "gf4":
        return gf4_quantize(t)
    raise ValueError(f"unknown weight dtype {dtype!r}")


def quantize_scaled(t: np.ndarray, dtype: str):
    """(codes, scale or None) in any of the four container formats; the
    scale is (1,) float32 for fp8e4."""
    if dtype == "fp8e4":
        return fp8e4_quantize(t)
    return quantize(t, dtype), None


def container_codes(q: np.ndarray, dtype: str):
    """Codes as the container writer tags them: fp8 and fp8e4 bytes as
    ``torch.float8_e5m2`` / ``float8_e4m3fn`` views (``F8_E5M2`` /
    ``F8_E4M3``, as ml_dtypes' arrays are tagged), the others unchanged."""
    fp8 = {"fp8": torch.float8_e5m2, "fp8e4": torch.float8_e4m3fn}.get(dtype)
    if fp8 is None:
        return q
    return torch.from_numpy(np.ascontiguousarray(q, dtype=np.uint8)).view(fp8)


def dequantize(t: np.ndarray, dtype: str, scale=None) -> np.ndarray:
    if dtype == "fp16":
        return np.asarray(t, dtype=np.float32)
    if dtype == "fp8":
        return fp8_dequantize(t)
    if dtype == "fp8e4":
        return fp8e4_dequantize(t, np.ones(1, np.float32) if scale is None else scale)
    if dtype == "gf4":
        return gf4_dequantize(t)
    raise ValueError(f"unknown weight dtype {dtype!r}")


def dtype_bits(dtype: str) -> int:
    return {"fp16": 16, "fp8": 8, "fp8e4": 8, "gf4": 4}[dtype]
