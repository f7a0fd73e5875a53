"""The .calm model container: one safetensors file holding quantized
weights, tokenizer tensors and hyperparameter metadata.

Same file contract as ``calm_tpu.container`` (256-byte aligned data,
tokenizer tensors last, strict dtype/shape validation on every fetch), with
no dependency on ``ml_dtypes``: numpy has no 8-bit float or bfloat16, so
``F8_E5M2``/``F8_E4M3`` tensors are handed out as ``uint8`` and ``BF16`` as
``uint16``. :func:`to_torch` reinterprets such an array as the torch dtype
named by its tag (``torch.float8_e5m2``, ``torch.float8_e4m3fn``,
``torch.bfloat16``).
"""

from __future__ import annotations

import json
import math
import os
import warnings
from typing import Mapping, Sequence

import numpy as np
import torch

ALIGN = 256
MAX_HEADER = 64 * 1024 * 1024

# safetensors dtype tag -> numpy storage dtype (8-bit floats as raw bytes)
DTYPES = {
    "F32": np.dtype(np.float32),
    "F16": np.dtype(np.float16),
    "BF16": np.dtype(np.uint16),
    "F8_E5M2": np.dtype(np.uint8),
    "F8_E4M3": np.dtype(np.uint8),
    "I32": np.dtype(np.int32),
    "I16": np.dtype(np.int16),
    "I8": np.dtype(np.int8),
    "U8": np.dtype(np.uint8),
}

# tag -> torch dtype the raw bytes are reinterpreted as
TORCH_DTYPES = {
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "F8_E5M2": torch.float8_e5m2,
    "F8_E4M3": torch.float8_e4m3fn,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
}
_TORCH_TAGS = {v: k for k, v in TORCH_DTYPES.items()}
_NUMPY_TAGS = {np.dtype(np.float32): "F32", np.dtype(np.float16): "F16",
               np.dtype(np.int32): "I32", np.dtype(np.int16): "I16",
               np.dtype(np.int8): "I8", np.dtype(np.uint8): "U8"}


class ContainerError(Exception):
    pass


class TensorFile:
    """Read-only mmap view of a .calm safetensors container."""

    def __init__(self, path: str):
        self.path = path
        size = os.path.getsize(path)
        if size < 8:
            raise ContainerError("file too small for safetensors header")

        self._mm = np.memmap(path, dtype=np.uint8, mode="r")
        hsize = int.from_bytes(bytes(self._mm[:8]), "little")
        if hsize > MAX_HEADER or 8 + hsize > size:
            raise ContainerError(f"invalid header size {hsize}")

        try:
            header = json.loads(bytes(self._mm[8 : 8 + hsize]).decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ContainerError(f"invalid header JSON: {e}") from e
        if not isinstance(header, dict):
            raise ContainerError("header is not a JSON object")

        self.metadata: dict[str, str] = {}
        # name -> (tag, shape, begin, end)
        self._tensors: dict[str, tuple[str, tuple[int, ...], int, int]] = {}

        data_size = size - 8 - hsize
        for name, desc in header.items():
            if name == "__metadata__":
                if not isinstance(desc, dict) or not all(
                    isinstance(k, str) and isinstance(v, str) for k, v in desc.items()
                ):
                    raise ContainerError("metadata must map strings to strings")
                self.metadata = desc
                continue
            if not isinstance(desc, dict):
                raise ContainerError(f"tensor {name!r}: not an object")
            try:
                tag = desc["dtype"]
                shape = tuple(int(d) for d in desc["shape"])
                begin, end = (int(x) for x in desc["data_offsets"])
            except (KeyError, TypeError, ValueError) as e:
                raise ContainerError(f"tensor {name!r}: malformed descriptor") from e
            if tag not in DTYPES:
                raise ContainerError(f"tensor {name!r}: unsupported dtype {tag!r}")
            n = 1
            for d in shape:
                if d < 0 or (d and n > 2**63 // max(d, 1)):
                    raise ContainerError(f"tensor {name!r}: shape overflow")
                n *= d
            if not (0 <= begin <= end <= data_size):
                raise ContainerError(f"tensor {name!r}: offsets out of range")
            if end - begin != n * DTYPES[tag].itemsize:
                raise ContainerError(f"tensor {name!r}: size mismatch")
            self._tensors[name] = (tag, shape, 8 + hsize + begin, 8 + hsize + end)

    # -- lookups ----------------------------------------------------------

    def _key(self, name: str, layer: int | None) -> str:
        return name % layer if layer is not None and "%d" in name else name

    def names(self) -> list[str]:
        return list(self._tensors)

    def find(self, name: str, layer: int | None = None):
        """(tag, shape) of a tensor, or None."""
        t = self._tensors.get(self._key(name, layer))
        return (t[0], t[1]) if t else None

    def nbytes(self, name: str) -> int:
        _, _, begin, end = self._tensors[name]
        return end - begin

    def get(self, name: str, layer: int | None = None,
            tag: str | None = None,
            shape: Sequence[int] | None = None) -> np.ndarray:
        """Zero-copy fetch with hard dtype-tag/shape validation."""
        key = self._key(name, layer)
        if key not in self._tensors:
            raise ContainerError(f"tensor {key!r} not found in {self.path}")
        ttag, tshape, begin, end = self._tensors[key]
        if tag is not None and tag != ttag:
            raise ContainerError(
                f"tensor {key!r}: dtype mismatch (file {ttag}, want {tag})")
        if shape is not None and tuple(shape) != tshape:
            raise ContainerError(
                f"tensor {key!r}: shape mismatch (file {tshape}, want {tuple(shape)})")
        return self._mm[begin:end].view(DTYPES[ttag]).reshape(tshape)

    def count_bytes(self, prefix: str, contains: str | None = None):
        """(bytes, params) over tensors whose name starts with ``prefix``
        (and holds ``contains``, when given); gf4 words (I32) count as 8
        parameters each."""
        total_bytes = 0
        params = 0
        for name, (tag, shape, begin, end) in self._tensors.items():
            if not name.startswith(prefix) or (contains and contains not in name):
                continue
            n = math.prod(shape) if shape else 1
            if tag == "I32":
                n *= 8
            params += n
            total_bytes += end - begin
        return total_bytes, params

    def close(self):
        self._mm = None


def to_torch(arr: np.ndarray, tag: str, device=None) -> torch.Tensor:
    """Copy a container array to ``device`` as the torch dtype of ``tag``
    (8-bit floats and bf16 are reinterpreted from their raw bytes)."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:  # memmap views: torch wants owned memory
        arr = arr.copy()
    t = torch.from_numpy(arr)
    want = TORCH_DTYPES[tag]
    if t.dtype != want:
        t = t.view(want)
    return t.to(device) if device is not None else t


def to_torch_view(arr: np.ndarray, tag: str) -> torch.Tensor:
    """A container array as the torch dtype of ``tag`` without a copy: a
    view of the same memory (a read-only memmap's pages included, which
    the caller must not write)."""
    with warnings.catch_warnings():  # torch warns of read-only memory
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(arr)
    want = TORCH_DTYPES[tag]
    return t if t.dtype == want else t.view(want)


def write_tensors(path: str, tensors: Mapping[str, "np.ndarray | torch.Tensor"],
                  metadata: Mapping[str, str] | None = None) -> None:
    """Write a .calm safetensors file with 256-byte-aligned tensor data.

    Values are numpy arrays (f32/f16/int dtypes) or torch tensors of any
    dtype in ``TORCH_DTYPES`` (8-bit floats and bf16 included), on any
    device; tensor order is preserved.
    """
    header: dict = {}
    if metadata:
        if not all(isinstance(v, str) for v in metadata.values()):
            raise ContainerError("metadata values must be strings")
        header["__metadata__"] = dict(metadata)

    offset = 0
    blobs = []
    for name, arr in tensors.items():
        if isinstance(arr, torch.Tensor):
            if arr.dtype not in _TORCH_TAGS:
                raise ContainerError(f"tensor {name!r}: unsupported dtype {arr.dtype}")
            tag = _TORCH_TAGS[arr.dtype]
            shape = list(arr.shape)
            raw = arr.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy()
        else:
            arr = np.ascontiguousarray(arr)
            if arr.dtype not in _NUMPY_TAGS:
                raise ContainerError(f"tensor {name!r}: unsupported dtype {arr.dtype}")
            tag = _NUMPY_TAGS[arr.dtype]
            shape = list(arr.shape)
            raw = arr.reshape(-1).view(np.uint8)
        header[name] = {"dtype": tag, "shape": shape,
                        "data_offsets": [offset, offset + raw.nbytes]}
        blobs.append(raw)
        offset += raw.nbytes

    hjson = json.dumps(header).encode("utf-8")
    hjson += b" " * (-(len(hjson) + 8) % ALIGN)

    with open(path, "wb") as f:
        f.write(len(hjson).to_bytes(8, "little"))
        f.write(hjson)
        for raw in blobs:
            f.write(memoryview(raw))
