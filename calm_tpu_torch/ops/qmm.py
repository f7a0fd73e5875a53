"""Quantized weight tensors and their plain dequantizing matmuls.

``QTensor`` holds a container weight in its storage dtype:

- fp16:  ``torch.float16``
- fp8:   ``torch.float8_e5m2``
- fp8e4: ``torch.float8_e4m3fn`` plus a power-of-two per-tensor ``scale``
  (a trailing (1,) vector stacked like the data)
- gf4:   ``torch.int32`` words packing 8 values on the last axis

Layer-stacked weights are (L, d, n_packed), as in ``calm_tpu.ops.qmm``.
The functions here are the plain f32 reference path: the CPU runs them,
and the Hopper kernels in ``hopper_qmm`` are held against them.
"""

from __future__ import annotations

import dataclasses

import torch

GF4_SHIFTS = tuple(8 + 3 * k for k in range(8))

STORAGE = {"fp16": torch.float16, "fp8": torch.float8_e5m2,
           "fp8e4": torch.float8_e4m3fn, "gf4": torch.int32}


@dataclasses.dataclass
class QTensor:
    data: torch.Tensor
    fmt: str  # "fp16" | "fp8" | "fp8e4" | "gf4"
    scale: torch.Tensor | None = None

    def __post_init__(self):
        if self.fmt not in STORAGE:
            raise ValueError(f"unknown format {self.fmt!r}")
        if self.data.dtype != STORAGE[self.fmt]:
            raise TypeError(f"{self.fmt} QTensor needs {STORAGE[self.fmt]}, "
                            f"got {self.data.dtype}")

    @property
    def shape(self):
        """Logical (unpacked) shape."""
        s = tuple(self.data.shape)
        return s[:-1] + (s[-1] * 8,) if self.fmt == "gf4" else s

    def __getitem__(self, idx) -> "QTensor":
        return QTensor(self.data[idx], self.fmt,
                       None if self.scale is None else self.scale[idx])


def gf4_decode_words(words: torch.Tensor,
                     out_dtype=torch.float32) -> torch.Tensor:
    """Decode gf4 int32 words (..., g) -> (..., g*8):
    value_k = (((w >> (8+3k)) & 7) - 4) * (fp8_e5m2(w & 0xff) / -4)."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    scale_bits = (w & 0xFF).to(torch.uint8)
    scale = scale_bits.view(torch.float8_e5m2).to(out_dtype) * (-0.25)
    codes = torch.stack([(w >> s) & 7 for s in GF4_SHIFTS], dim=-1)
    vals = (codes.to(out_dtype) - 4.0) * scale[..., None]
    return vals.reshape(*w.shape[:-1], w.shape[-1] * 8)


def dequant(qt: QTensor, dtype=torch.float32) -> torch.Tensor:
    if qt.fmt == "gf4":
        return gf4_decode_words(qt.data, dtype)
    w = qt.data.to(dtype)
    if qt.scale is not None:
        s = qt.scale.reshape(tuple(qt.scale.shape[:-1])
                             + (1,) * (w.ndim - qt.scale.ndim + 1))
        w = w * s.to(dtype)
    return w


def qmatmul(x: torch.Tensor, qt: QTensor, layer: int | None = None) -> torch.Tensor:
    """x (..., n) @ W^T for W (d, n) logical -> (..., d) in float32.

    With ``layer``, qt is the layer-stacked (L, d, n_packed) weight and the
    product runs against plane ``layer``; the fp8e4 per-tensor scale
    multiplies the output, not the weight (``calm_tpu/ops/qmm.py:185-187``).
    """
    data, scale = qt.data, qt.scale
    if layer is not None:
        data = data[layer]
        scale = None if scale is None else scale[layer]
    w = dequant(QTensor(data, qt.fmt), torch.float32)
    out = x.float() @ w.transpose(-1, -2)
    return out if scale is None else out * scale.float()


def embed_lookup(tokens: torch.Tensor, qt: QTensor,
                 dtype=torch.float32) -> torch.Tensor:
    """Gather + dequantize embedding rows (reads only the needed rows)."""
    rows = qt.data[tokens]
    if qt.fmt == "gf4":
        return gf4_decode_words(rows, dtype)
    rows = rows.to(dtype)
    if qt.scale is not None:
        rows = rows * qt.scale.to(dtype)
    return rows
