"""Weight quantization formats: fp16, fp8 (e5m2), fp8e4 (e4m3 + scale), gf4.

The container-level quantization math of ``calm_tpu.quant`` without
``ml_dtypes``: fp8 rounding goes through torch's own ``float8_e5m2`` /
``float8_e4m3fn`` casts (round-to-nearest-even from float32, like
ml_dtypes), and fp8 codes travel as ``uint8`` numpy arrays.

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
    f = torch.from_numpy(np.ascontiguousarray(t, dtype=np.float32))
    return f.to(dtype).view(torch.uint8).numpy()


def _from_fp8_bytes(t: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    b = torch.from_numpy(np.ascontiguousarray(t).view(np.uint8))
    return b.view(dtype).to(torch.float32).numpy()


def fp8_quantize(t: np.ndarray) -> np.ndarray:
    """Round to fp8 e5m2; returns the code bytes (uint8)."""
    return _to_fp8_bytes(t, torch.float8_e5m2)


def fp8_dequantize(t: np.ndarray) -> np.ndarray:
    return _from_fp8_bytes(t, torch.float8_e5m2)


def fp8e4_dequantize(t: np.ndarray, scale: np.ndarray) -> np.ndarray:
    return _from_fp8_bytes(t, torch.float8_e4m3fn) * np.float32(scale.reshape(()))


def gf4_quantize(t: np.ndarray) -> np.ndarray:
    """Quantize the last axis (a multiple of 8) to gf4 words (int32)."""
    t = np.asarray(t, dtype=np.float32)
    assert t.shape[-1] % 8 == 0, "gf4 requires last dim % 8 == 0"
    gt = t.reshape(*t.shape[:-1], -1, 8)

    gmaxi = np.abs(gt).argmax(axis=-1)
    gmax = np.take_along_axis(gt, gmaxi[..., None], axis=-1)
    gmax_b = fp8_quantize(gmax)
    gmax = fp8_dequantize(gmax_b)

    with np.errstate(divide="ignore", invalid="ignore"):
        gn = gt / gmax
    gn = np.nan_to_num(gn, nan=0.0, posinf=0.0, neginf=0.0)

    q = np.clip(np.round(gn.astype(np.float16) * np.float16(-4) + np.float16(4)), 0, 7)
    q = q.astype(np.uint32)

    words = (q << GF4_SHIFTS).sum(axis=-1, dtype=np.uint32)
    words += gmax_b.reshape(words.shape).astype(np.uint32)
    return words.view(np.int32)


def gf4_dequantize(words: np.ndarray) -> np.ndarray:
    """Decode gf4 words back to float32, expanding the last axis by 8."""
    w = np.asarray(words).view(np.uint32)
    scale = fp8_dequantize((w & 0xFF).astype(np.uint8)) / -4.0
    codes = ((w[..., None] >> GF4_SHIFTS) & 7).astype(np.int32) - 4
    vals = codes.astype(np.float32) * scale[..., None]
    return vals.reshape(*w.shape[:-1], w.shape[-1] * 8)


def quantize(t: np.ndarray, dtype: str) -> np.ndarray:
    """Quantize a float tensor for the container; dtype in {fp16, fp8, gf4}."""
    if dtype == "fp16":
        return np.asarray(t, dtype=np.float32).astype(np.float16)
    if dtype == "fp8":
        return fp8_quantize(t)
    if dtype == "gf4":
        return gf4_quantize(t)
    raise ValueError(f"unknown weight dtype {dtype!r}")


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
