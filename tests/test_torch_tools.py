"""The HBM-ceiling tools on the port against calm_tpu on the CPU:
``stream_sum`` (K1, K15's dma) and ``gf4_decode_sum`` (K15's decode),
plain, against numpy sums and ``calm_tpu.ops.qmm.gf4_decode_words``, and
against the tools' own Pallas kernels run in interpret mode.

The Pallas calls are built here over the flattened buffer with a 1-D
grid, as ``tools/gf4_bound.py:79-96`` builds its own: the kernels keep
their sum in an SMEM scalar and start it at step 0 of grid axis 0.
``tools/dma_ceiling.py:39-56`` runs a 2-D (layer, tile) grid, where axis
0 is the layer, so its scalar keeps only layer 0's last tile plus the
other layers' tiles (every byte is still read, which is what it times);
the port's kernel computes the whole sum. Both tools exit 1 on a machine
without a GPU."""

import functools
import importlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from calm_tpu.ops.qmm import gf4_decode_words
from calm_tpu_torch.ops import hopper_stream as hs

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(name, monkeypatch):
    """tools/<name>.py, imported with the persistent XLA cache left off."""
    monkeypatch.setenv("CALM_NO_COMPILE_CACHE", "1")
    return importlib.import_module(f"tools.{name}")


def _pallas_sum(kernel, seed: float, w: np.ndarray, td: int) -> float:
    """The tools' SMEM-carried sum over (1, d, g) words in interpret mode."""
    _, d, g = w.shape
    out = pl.pallas_call(
        kernel, grid=(d // td,),
        in_specs=[pl.BlockSpec((1, 1), lambda i: (0, 0), memory_space=pltpu.SMEM),
                  pl.BlockSpec((1, td, g), lambda i: (0, i, 0))],
        out_specs=pl.BlockSpec((1, 1), lambda i: (0, 0), memory_space=pltpu.SMEM),
        out_shape=jax.ShapeDtypeStruct((1, 1), jnp.float32), interpret=True,
    )(jnp.full((1, 1), seed, jnp.float32), jnp.asarray(w))
    return float(out[0, 0])


def _gf4_words(rng, shape) -> np.ndarray:
    """Random codes under finite e5m2 scale bytes (no inf/nan encodings)."""
    w = rng.integers(0, 2**32, shape, dtype=np.int64).astype(np.uint32)
    w = (w & ~np.uint32(0xFF)) | rng.integers(0, 0x7C, shape).astype(np.uint32)
    return w.view(np.int32)


@pytest.mark.parametrize("shape", [(2, 16, 512), (7,), (1003, 5)])
def test_stream_sum_plain(rng, shape):
    w = rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)
    got = hs.stream_sum(torch.from_numpy(w), 2.5)
    assert got.shape == (1,) and got.dtype == torch.float32
    want = np.float32(w.astype(np.float64).sum() + 2.5)
    assert got.item() == want
    assert hs.stream_sum_plain(torch.from_numpy(w), torch.tensor([2.5])).item() == want


@pytest.mark.parametrize("full", [False, True])
def test_gf4_decode_sum_plain(rng, full):
    w = _gf4_words(rng, (3, 40, 17))
    got = hs.gf4_decode_sum(torch.from_numpy(w), torch.tensor([-1.0]), full)
    vals = np.asarray(gf4_decode_words(jnp.asarray(w)), np.float64)
    want = vals.sum() - 1.0
    assert abs(got.item() - want) <= 1e-6 * np.abs(vals).sum()
    assert hs.abs_sum(torch.from_numpy(w), gf4=True) == pytest.approx(np.abs(vals).sum())


def test_dma_kernel_interpret_matches_plain(rng, monkeypatch):
    """tools/dma_ceiling.py:26 and tools/gf4_bound.py:42, the same
    function, over 8 tiles of 16 rows; f32 sums there."""
    w = np.broadcast_to(np.arange(512, dtype=np.int32), (1, 128, 512)).copy()
    w[0, ::3] *= -7
    want = hs.stream_sum_plain(torch.from_numpy(w), 3.0).item()
    for name in ("dma_ceiling", "gf4_bound"):
        got = _pallas_sum(_tool(name, monkeypatch)._dma_kernel, 3.0, w, 16)
        assert abs(got - want) <= 1e-6 * hs.abs_sum(torch.from_numpy(w)), name


@pytest.mark.parametrize("full", [False, True])
def test_decode_kernel_interpret_matches_plain(rng, monkeypatch, full):
    """tools/gf4_bound.py:55 over the tool's own random words (scale byte
    0x30), 4 tiles of 8 rows."""
    gb = _tool("gf4_bound", monkeypatch)
    w = np.array(gb.rnd_gf4(rng, (1, 32, 64)))  # a writable copy
    got = _pallas_sum(functools.partial(gb._decode_kernel, full=full), 0.5, w, 8)
    tw = torch.from_numpy(w)
    want = hs.gf4_decode_sum_plain(tw, 0.5, full).item()
    assert abs(got - want) <= 1e-6 * hs.abs_sum(tw, gf4=True)


def test_wrappers_on_cpu_take_the_plain_path(rng):
    w = torch.from_numpy(_gf4_words(rng, (64,)))
    hs.stream_sum(w, 0.0)
    hs.gf4_decode_sum(w, 0.0, True)
    assert hs.stream_sum.launches == hs.gf4_decode_sum.launches == 0


def test_error_bound_covers_an_f32_sum(rng):
    """The stated worst-case bound is above what one f32 running sum of a
    thread's share of words actually loses."""
    span = 1 << 20
    v = rng.integers(-2**31, 2**31, span // (4 * hs.THREADS), dtype=np.int64)
    acc = np.float32(0)
    for x in v.astype(np.float32):
        acc = np.float32(acc + x)
    err = abs(float(acc) - float(v.sum()))
    assert err <= hs.error_bound(float(np.abs(v).sum()), span)


@pytest.mark.parametrize("tool", ["dma_ceiling", "gf4_bound"])
def test_tool_without_gpu_exits_1(tool):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the tool would run")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-m", f"calm_tpu_torch.tools.{tool}"], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 1 and "no CUDA GPU" in r.stderr, r.stderr
    assert not r.stdout
