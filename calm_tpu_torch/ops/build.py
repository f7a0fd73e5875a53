"""Build the hand-written CUDA kernels at first use and load them.

Each ``csrc/<name>.cu`` compiles with ``nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC`` into
``calm_tpu_torch/_build/<name>-<hash>.so`` (git-ignored; the hash covers
the source and the shared headers ``csrc/*.cuh``, so an edit to either
rebuilds) and loads with ``ctypes``. The C
functions take ``c_void_p`` for every pointer and the stream and return
``cudaGetLastError()``; :func:`check` raises when that is not 0. A build
holds ``_build/.lock`` (``flock``), so processes that start together (the
ranks of a sharded run) build each library once.

The host library (``native/*.cc``: the container reader, the BPE encoder,
the sampler) builds the same way with ``g++`` (:func:`build_host`) into
``_build/libcalm_native-<hash>.so``, never into the JAX package's
``calm_tpu/_native/``.

Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time

from calm_tpu_torch.device import nvcc_path

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NATIVE = os.path.join(os.path.dirname(_PKG), "native")  # the host library's sources
NATIVE_SOURCES = ("tensors.cc", "tokenizer.cc", "sampler.cc")
NATIVE_HEADERS = ("calm_native.h",)
# the flags of native/Makefile
CXXFLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-fno-exceptions"]
SOURCES = ("mm", "qmm", "attn", "gf4", "moe", "stream", "ring")
ARCH = "arch=compute_90a,code=sm_90a"

P, I, F, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong

# C signatures: function name -> argtypes (all return int)
SIGNATURES = {
    "mm": {
        "calm_mm8": [P] * 4 + [I] * 8 + [P],
        "calm_mm8_smem": [I, I],
    },
    "qmm": {
        "calm_qmm_decode": [P, P, P, I, I, I, I, P, P, P, P, I, P],
        "calm_qx_offn_qkv": [P] * 16 + [I] * 7 + [F, I, P, P, P, P],
        "calm_gf4_ffn": [P] * 6 + [I] * 4 + [P] * 4,
        "calm_gf4_offn": [P] * 11 + [I] * 5 + [F, I, P, P, P, P],
        "calm_moe_mmv": [P] * 5 + [I] * 7 + [P] * 4 + [I, P],
        "calm_moe_ffn": [P] * 8 + [I] * 7 + [P] * 6 + [I, P],
        "calm_wide_smem": [I, I],
    },
    "attn": {
        "calm_decode_attention": [P] * 15 + [I] * 12 + [P],
        "calm_prefill_attention": [P] * 6 + [I] * 12 + [P],
        "calm_verify_attention": [P] * 11 + [I] * 14 + [P],
        "calm_decode_smem": [I] * 3,
        "calm_prefill_smem": [I] * 2,
        "calm_verify_smem": [I] * 2,
    },
    "gf4": {
        "calm_gf4_matvec": [P, P, P, I, I, I, P],
        "calm_gf4_matmul": [P, P, P, I, I, I, P],
        "calm_gf4_mm_smem": [],
    },
    "moe": {
        "calm_moe_dense": [P] * 5 + [I] * 7 + [P, P],
        "calm_gf4_moe_ffn": [P] * 8 + [I] * 6 + [P],
    },
    "stream": {
        "calm_stream_sum": [P, I64, I64, I, P, P, P, I, P],
    },
    "ring": {
        "calm_ring_all_reduce": [P, P, P, I, I64, I, I64, P],
        "calm_ring_gmax": [],
    },
}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


class KernelError(RuntimeError):
    pass


def _target(name: str) -> str:
    """The library's path, named by the hash of ``csrc/<name>.cu`` and
    every shared header beside it."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [name + ".cu"] + headers:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _nvcc_cmd(name: str, out: str) -> list[str]:
    nvcc = nvcc_path()
    if nvcc is None:
        raise KernelError("nvcc not found (CUDA_HOME/bin or PATH): the "
                          "CUDA kernels cannot be built")
    return [nvcc, "-gencode", ARCH, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", out, os.path.join(CSRC, name + ".cu")]


def build_all(names=SOURCES) -> float:
    """Compile every missing library, one ``nvcc`` per source, all started
    together, under the build lock. Returns the wall seconds spent; ptxas
    reports go to ``_build/<name>.log``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        _build_missing(names)
    return time.perf_counter() - t0


def _build_missing(names) -> None:
    procs = []
    for name in names:
        out = _target(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        log = open(os.path.join(BUILD_DIR, name + ".log"), "w")
        procs.append((name, out, tmp, log, subprocess.Popen(
            _nvcc_cmd(name, tmp), stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for name, out, tmp, log, p in procs:
        rc = p.wait()
        log.close()
        if rc != 0:
            failed.append(name)
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    if failed:
        logs = "\n".join(
            open(os.path.join(BUILD_DIR, n + ".log")).read()[-4000:]
            for n in failed)
        raise KernelError(f"nvcc failed for {failed}:\n{logs}")


def host_target() -> str:
    """The host library's path, named by the hash of its sources, headers
    and flags."""
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    for fname in NATIVE_SOURCES + NATIVE_HEADERS:
        with open(os.path.join(NATIVE, fname), "rb") as f:
            h.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libcalm_native-{h.hexdigest()[:16]}.so")


def build_host() -> str:
    """The host library (``native/*.cc``), compiled with ``g++`` under the
    build lock if missing; returns its path. Raises KernelError when the
    sources or ``g++`` are missing or the compile fails (its output goes
    to ``_build/native.log``)."""
    out = host_target()
    if os.path.exists(out):
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise KernelError("g++ not found: the host library cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if not os.path.exists(out):
            tmp = f"{out}.{os.getpid()}.tmp"
            logf = os.path.join(BUILD_DIR, "native.log")
            with open(logf, "w") as log:
                rc = subprocess.run([cxx, *CXXFLAGS, "-shared", "-o", tmp] +
                                    [os.path.join(NATIVE, f) for f in NATIVE_SOURCES],
                                    stdout=log, stderr=subprocess.STDOUT).returncode
            if rc != 0:
                raise KernelError(f"g++ failed for the host library:\n"
                                  f"{open(logf).read()[-4000:]}")
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    return out


def lib(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if missing."""
    with _lock:
        if name not in _libs:
            out = _target(name)
            if not os.path.exists(out):
                build_all((name,))
            dll = ctypes.CDLL(out)
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(dll, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            err = getattr(dll, f"calm_{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _libs[name] = dll
        return _libs[name]


def check(name: str, rc: int) -> None:
    if rc != 0:
        msg = getattr(lib(name), f"calm_{name}_error_string")(rc).decode()
        raise KernelError(f"{name} kernel launch failed: {msg} ({rc})")
