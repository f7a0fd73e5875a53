"""Build the hand-written CUDA kernels at first use and load them.

Each ``csrc/<name>.cu`` compiles with ``nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC`` into
``calm_tpu_torch/_build/<name>-<hash>.so`` (git-ignored; the hash is the
source's, so an edited source rebuilds) and loads with ``ctypes``. The C
functions take ``c_void_p`` for every pointer and the stream and return
``cudaGetLastError()``; :func:`check` raises when that is not 0.

Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time

from calm_tpu_torch.device import nvcc_path

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("qmm", "attn")
ARCH = "arch=compute_90a,code=sm_90a"

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# C signatures: function name -> argtypes (all return int)
SIGNATURES = {
    "qmm": {
        "calm_qmm_decode": [P, P, P, I, I, I, I, P],
        "calm_qx_offn_qkv": [P] * 16 + [I] * 7 + [F, I, P],
    },
    "attn": {
        "calm_decode_attention": [P] * 11 + [I] * 8 + [P],
    },
}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


class KernelError(RuntimeError):
    pass


def _target(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"{name}-{digest}.so")


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
    together. Returns the wall seconds spent; ptxas reports go to
    ``_build/<name>.log``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
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
    seconds = time.perf_counter() - t0
    if failed:
        logs = "\n".join(
            open(os.path.join(BUILD_DIR, n + ".log")).read()[-4000:]
            for n in failed)
        raise KernelError(f"nvcc failed for {failed}:\n{logs}")
    return seconds


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
