"""Quantized weight tensors and their plain dequantizing matmuls.

``QTensor`` holds a container weight in its storage dtype:

- fp16:  ``torch.float16``
- fp8:   ``torch.float8_e5m2``
- fp8e4: ``torch.float8_e4m3fn`` plus a power-of-two per-tensor ``scale``
  (a trailing (1,) vector stacked like the data)
- gf4:   ``torch.int32`` words packing 8 values on the last axis

Layer-stacked weights are (L, d, n_packed), as in ``calm_tpu.ops.qmm``.
The functions here are the plain f32 reference path: the CPU runs them,
and the Hopper kernels in ``hopper_qmm`` are held against them. One more,
:func:`dense_matmul`, is the product of many rows outside any kernel: the
quality mode's f32 product on the card.

``_PRECISE`` is the process-wide quality mode of ``calm_tpu.ops.qmm``
(``:110-129``): ``Engine(precise=)`` sets it, the CLI's ``--precise`` or
``CALM_PRECISE=1`` asks for it. Under it every product that
``model._mm`` routes past 64 rows takes f32 operands and f32 sums on the
card too (:func:`dense_matmul`); 2-64 rows take the default's multi-row and
wide paths with x in two f16 terms and f32 sums.
"""

from __future__ import annotations

import dataclasses

import torch

from calm_tpu_torch.ops.cost import count

STORAGE = {"fp16": torch.float16, "fp8": torch.float8_e5m2,
           "fp8e4": torch.float8_e4m3fn, "gf4": torch.int32}

_PRECISE = False


def enable_precise(on: bool = True) -> None:
    """f32 operands and sums for routed products of more than 64 rows on
    the card: they dequantize to f32 for a TF32-free ``torch.mm``, where
    the default rounds x to bf16; fp8/fp16 decode runs per op. One row
    keeps the f32 loops; 2-64 rows take the default's multi-row and wide
    paths, x in two f16 terms (the wide path's default takes one) with f32
    sums: from the float64 product about half an f32 matmul's distance,
    twice the f32 loops'. Sticky for the process, as
    JAX's flag; ``Engine`` sets it every time, so a later
    ``Engine(precise=False)`` turns it off."""
    global _PRECISE
    _PRECISE = bool(on)


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
    value_k = (((w >> (8+3k)) & 7) - 4) * (fp8_e5m2(w & 0xff) / -4).
    (An arithmetic shift of the int32 word leaves the 3 masked bits exact.)"""
    w = words.to(torch.int32)
    scale = (w & 0xFF).to(torch.uint8).view(torch.float8_e5m2).to(out_dtype) * (-0.25)
    shifts = torch.arange(8, dtype=torch.int32, device=w.device) * 3 + 8  # 8 + 3k
    vals = ((w[..., None] >> shifts) & 7).to(out_dtype)  # all 8 codes in one pass
    vals.sub_(4.0).mul_(scale[..., None])
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


def dense_matmul(x: torch.Tensor, qt: QTensor, layer: int | None = None) -> torch.Tensor:
    """x (R, n) f32 @ W[layer]^T -> (R, d) f32 in f32 through the library:
    on the card the products ``model.mm_route`` sends here under
    ``_PRECISE`` (every product past 64 rows), the JAX quality mode's
    (``calm_tpu/ops/qmm.py:190-197``): the plane dequantized to f32 and an
    f32 product with TF32 off, the fp8e4 scale on the device after. On the
    CPU: :func:`qmatmul`'s f32 product, which ``hopper_qmm.qmm_mm8`` takes
    there too. Counts its rows in ``qmm.dense_rows``."""
    count("qmm.dense_rows", x.shape[0])
    if x.device.type == "cpu":
        return qmatmul(x, qt, layer)
    data, scale = qt.data, qt.scale
    if layer is not None:
        data = data[layer]
        scale = None if scale is None else scale[layer]
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = torch.mm(x.float(), dequant(QTensor(data, qt.fmt), torch.float32).T)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was
    return out if scale is None else out * scale


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
