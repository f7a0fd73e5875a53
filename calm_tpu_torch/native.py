"""ctypes bridge to the native host library (the port of
``calm_tpu.native``): the reference's C core rebuilt for the host side
(src/tensors.c, src/tokenizer.c, src/sampler.c) — a validating container
reader, the heap-merge BPE encoder the tokenizer uses, argmax and min-p
sampling with the xorshift64* stream.

The library is the repo's ``native/{tensors,tokenizer,sampler}.cc``,
built with ``g++`` at first use into ``calm_tpu_torch/_build/``
(``ops.build.build_host``: the sources' hash names it, the build lock
serialises processes); the JAX package's own build in ``calm_tpu/_native/``
is never loaded. Every entry point's argtypes and restype are declared.

Everything here is optional, as in the JAX package: ``available()`` is
False when the library cannot be built (``last_error()`` says why), and
every caller keeps its pure-Python path. ``CALM_TPU_NO_NATIVE=1`` keeps
the tokenizer on the Python encoder.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np

_error = "the host library was not loaded"


@lru_cache(maxsize=1)
def _load():
    global _error
    from calm_tpu_torch.ops import build

    try:
        lib = ctypes.CDLL(build.build_host())
    except (OSError, build.KernelError) as e:
        _error = str(e)
        return None
    _declare(lib)
    return lib


def _declare(lib):
    c = ctypes
    lib.cn_last_error.argtypes = []
    lib.cn_last_error.restype = c.c_char_p

    lib.cn_tensors_open.argtypes = [c.c_char_p]
    lib.cn_tensors_open.restype = c.c_void_p
    lib.cn_tensors_parse.argtypes = [c.c_void_p, c.c_size_t]
    lib.cn_tensors_parse.restype = c.c_void_p
    lib.cn_tensors_close.argtypes = [c.c_void_p]
    lib.cn_tensors_close.restype = None
    lib.cn_tensor_count.argtypes = [c.c_void_p]
    lib.cn_tensor_count.restype = c.c_int
    lib.cn_tensor_name.argtypes = [c.c_void_p, c.c_int]
    lib.cn_tensor_name.restype = c.c_char_p
    lib.cn_tensor_info.argtypes = [
        c.c_void_p, c.c_char_p, c.POINTER(c.c_char_p), c.POINTER(c.c_int),
        c.POINTER(c.c_int64), c.POINTER(c.c_void_p), c.POINTER(c.c_int64)]
    lib.cn_tensor_info.restype = c.c_int
    lib.cn_metadata_count.argtypes = [c.c_void_p]
    lib.cn_metadata_count.restype = c.c_int
    lib.cn_metadata_key.argtypes = [c.c_void_p, c.c_int]
    lib.cn_metadata_key.restype = c.c_char_p
    lib.cn_metadata_find.argtypes = [c.c_void_p, c.c_char_p]
    lib.cn_metadata_find.restype = c.c_char_p

    lib.cn_tokenizer_create.argtypes = [
        c.c_void_p, c.c_size_t, c.POINTER(c.c_float), c.c_int, c.c_int]
    lib.cn_tokenizer_create.restype = c.c_void_p
    lib.cn_tokenizer_free.argtypes = [c.c_void_p]
    lib.cn_tokenizer_free.restype = None
    lib.cn_tokenizer_encode.argtypes = [
        c.c_void_p, c.c_void_p, c.c_size_t, c.c_int, c.POINTER(c.c_int), c.c_size_t]
    lib.cn_tokenizer_encode.restype = c.c_int
    lib.cn_tokenizer_find.argtypes = [c.c_void_p, c.c_void_p, c.c_size_t]
    lib.cn_tokenizer_find.restype = c.c_int

    lib.cn_rand64.argtypes = [c.POINTER(c.c_uint64)]
    lib.cn_rand64.restype = c.c_uint64
    lib.cn_sample_argmax.argtypes = [c.POINTER(c.c_float), c.c_int]
    lib.cn_sample_argmax.restype = c.c_int
    lib.cn_sample_minp.argtypes = [
        c.POINTER(c.c_float), c.c_int, c.c_float, c.c_float, c.POINTER(c.c_uint64)]
    lib.cn_sample_minp.restype = c.c_int


def available() -> bool:
    """The library is built (now, if it was not) and loaded."""
    return _load() is not None


def library_path() -> str | None:
    lib = _load()
    return None if lib is None else lib._name


def last_error() -> str:
    lib = _load()
    return lib.cn_last_error().decode() if lib else _error


def _lib():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library not available: {_error}")
    return lib


class NativeContainer:
    """A validating parse of a container by the C++ reader: a second
    opinion beside the numpy reader in ``container.py``, which stays the
    data path."""

    def __init__(self, path: str):
        self._lib = _lib()
        self._h = self._lib.cn_tensors_open(path.encode())
        if not self._h:
            raise ValueError(f"native parse failed: {last_error()}")

    def names(self) -> list[str]:
        n = self._lib.cn_tensor_count(self._h)
        return [self._lib.cn_tensor_name(self._h, i).decode() for i in range(n)]

    def info(self, name: str):
        """(dtype tag, shape, bytes) of a tensor; KeyError when absent."""
        c = ctypes
        tag, ndim, data, nbytes = c.c_char_p(), c.c_int(), c.c_void_p(), c.c_int64()
        shape = (c.c_int64 * 8)()
        rc = self._lib.cn_tensor_info(self._h, name.encode(), c.byref(tag), c.byref(ndim),
                                      shape, c.byref(data), c.byref(nbytes))
        if rc != 0:
            raise KeyError(name)
        return tag.value.decode(), tuple(shape[:ndim.value]), int(nbytes.value)

    def metadata(self) -> dict[str, str]:
        out = {}
        for i in range(self._lib.cn_metadata_count(self._h)):
            k = self._lib.cn_metadata_key(self._h, i).decode()
            out[k] = self._lib.cn_metadata_find(self._h, k.encode()).decode()
        return out

    def close(self):
        if self._h:
            self._lib.cn_tensors_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def parse_bytes(data) -> bool:
    """Whether the native parser accepts an in-memory container: bytes, or
    a writable buffer (a bytearray), read in place."""
    lib = _lib()
    buf = (ctypes.c_char * len(data)).from_buffer(
        bytearray(data) if isinstance(data, bytes) else data)
    h = lib.cn_tensors_parse(ctypes.cast(buf, ctypes.c_void_p), len(data))
    if h:
        lib.cn_tensors_close(h)
        return True
    return False


class NativeTokenizer:
    """BPE encode by the C++ heap-merge implementation, ids equal to the
    Python encoder's."""

    def __init__(self, pieces: list[bytes], scores: np.ndarray, bos_id: int):
        self._lib = _lib()
        blob = b"".join(p + b"\0" for p in pieces)
        self._blob = ctypes.create_string_buffer(blob, len(blob))  # kept alive
        self._scores = np.ascontiguousarray(scores, dtype=np.float32)
        self._h = self._lib.cn_tokenizer_create(
            ctypes.cast(self._blob, ctypes.c_void_p), len(blob),
            self._scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(pieces), bos_id)
        if not self._h:
            raise ValueError("native tokenizer rejected the vocab")

    def encode(self, data: bytes, bos: bool = False) -> list[int]:
        cap = len(data) + 3  # tokenizer_bound
        out = (ctypes.c_int * cap)()
        buf = ctypes.create_string_buffer(data, len(data))
        n = self._lib.cn_tokenizer_encode(self._h, ctypes.cast(buf, ctypes.c_void_p),
                                          len(data), int(bos), out, cap)
        if n < 0:
            raise RuntimeError("native encode overflow")
        return list(out[:n])

    def __del__(self):
        try:
            if self._h:
                self._lib.cn_tokenizer_free(self._h)
        except Exception:
            pass


def rand64(state: int) -> tuple[int, int]:
    """One xorshift64* step: (output, new state)."""
    st = ctypes.c_uint64(state)
    v = _lib().cn_rand64(ctypes.byref(st))
    return int(v), int(st.value)


def sample_argmax(logits: np.ndarray) -> int:
    logits = np.ascontiguousarray(logits, dtype=np.float32)
    return int(_lib().cn_sample_argmax(
        logits.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(logits)))


def sample_minp(logits: np.ndarray, temperature: float, minp: float,
                state: int) -> tuple[int, int]:
    """One min-p draw; returns (token, new rng state)."""
    logits = np.ascontiguousarray(logits, dtype=np.float32)
    st = ctypes.c_uint64(state)
    idx = _lib().cn_sample_minp(logits.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                len(logits), temperature, minp, ctypes.byref(st))
    return int(idx), int(st.value)
