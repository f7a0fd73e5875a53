"""Streaming reductions on Hopper: the ports of the HBM-ceiling tools'
kernels (``csrc/stream.cu``).

- :func:`stream_sum` replaces ``_dma_kernel`` of ``tools/dma_ceiling.py:26``
  (K1) and of ``tools/gf4_bound.py:42`` (K15's dma), which compute the
  same function: the f32 sum of every int32 word converted to float, plus
  a seed.
- :func:`gf4_decode_sum` replaces ``_decode_kernel``
  (``tools/gf4_bound.py:55``, K15): the sum of the eight decoded planes of
  every gf4 word, each plane rounded through bf16 with ``full``, plus a
  seed.

The seed and the result are (1,) f32 tensors on the words' device, so a
timed chain feeds each call's result to the next with no host sync. The
plain versions (``*_plain``) sum in float64 and return f32; each wrapper
takes its plain version for tensors on the CPU, launches the kernel for
CUDA tensors or raises, and counts its launches in ``.launches``.
"""

from __future__ import annotations

import math

import torch

from calm_tpu_torch.ops import build

THREADS = 256   # csrc/stream.cu's block
CHUNK = 4 * 4 * THREADS  # words one block takes in one loop step (4 int4 a thread)
BLOCKS_PER_SM = 4
U = 2.0 ** -24  # f32 unit roundoff


def _as_seed(seed, device) -> torch.Tensor:
    if isinstance(seed, torch.Tensor):
        return seed.reshape(1).to(device=device, dtype=torch.float32)
    return torch.tensor([float(seed)], dtype=torch.float32, device=device)


def span_for(n: int, device) -> int:
    """Words a block reduces: about BLOCKS_PER_SM blocks on each SM, the
    span a whole number of loop steps."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per = -(-n // (BLOCKS_PER_SM * sms))
    return max(CHUNK, -(-per // CHUNK) * CHUNK)


def error_bound(abs_sum: float, span: int, per_word_terms: int = 1) -> float:
    """A worst-case bound on |kernel - exact| for a sum of words whose
    values' magnitudes total ``abs_sum``: each thread's four f32 sums take
    span / (4 THREADS) words each, of ``per_word_terms`` f32 terms (8 for a
    gf4 word), then 2 + 5 + 3 tree levels; the float64 fold of the block
    sums and the final rounding to f32 add one unit roundoff of the
    result, which ``abs_sum`` bounds. (The standard bound of recursive
    summation: an f32 sum of k terms is off by at most k u sum |terms|.)"""
    k = -(-span // (4 * THREADS)) + per_word_terms + 10
    return (k + 1) * U * abs_sum


def _launch(w: torch.Tensor, seed, mode: int) -> torch.Tensor:
    if w.dtype != torch.int32 or not w.is_contiguous() or w.data_ptr() % 16:
        raise ValueError("the words must be contiguous, 16-byte aligned int32")
    n = w.numel()
    if n < 1:
        raise ValueError("no words to sum")
    span = span_for(n, w.device)
    nblocks = -(-n // span)
    partials = torch.empty(nblocks, dtype=torch.float32, device=w.device)
    out = torch.empty(1, dtype=torch.float32, device=w.device)
    s = _as_seed(seed, w.device)
    rc = build.lib("stream").calm_stream_sum(
        w.data_ptr(), n, span, nblocks, s.data_ptr(), partials.data_ptr(), out.data_ptr(),
        mode, torch.cuda.current_stream(w.device).cuda_stream)
    build.check("stream", rc)
    return out


# ---------------------------------------------------------------------------
# K1 and K15's dma
# ---------------------------------------------------------------------------


def stream_sum_plain(w: torch.Tensor, seed) -> torch.Tensor:
    s = torch.sum(w, dtype=torch.float64) + _as_seed(seed, w.device).double()
    return s.float()


def stream_sum(w: torch.Tensor, seed) -> torch.Tensor:
    """(1,) f32: ``seed`` plus the sum of every int32 word of ``w`` (any
    shape) as a float value; each block reduces ``span_for`` words."""
    if w.device.type == "cpu":
        return stream_sum_plain(w, seed)
    out = _launch(w, seed, 0)
    stream_sum.launches += 1
    return out


stream_sum.launches = 0


# ---------------------------------------------------------------------------
# K15's decode
# ---------------------------------------------------------------------------


def _gf4_planes64(w: torch.Tensor):
    """The eight decoded planes of the gf4 words w, float64, one at a time:
    (code_k - 4) * e5m2(w & 0xff) / -4 (``calm_tpu/ops/qmm.py:82-94``)."""
    u = w.reshape(-1).to(torch.int64) & 0xFFFFFFFF
    scale = (u & 0xFF).to(torch.uint8).view(torch.float8_e5m2).double() * -0.25
    for k in range(8):
        yield (((u >> (8 + 3 * k)) & 7) - 4).double() * scale


def gf4_decode_sum_plain(w: torch.Tensor, seed, full: bool) -> torch.Tensor:
    total = _as_seed(seed, w.device).double()
    for plane in _gf4_planes64(w):
        if full:
            plane = plane.float().bfloat16().double()
        total = total + plane.sum()
    return total.float()


def gf4_decode_sum(w: torch.Tensor, seed, full: bool) -> torch.Tensor:
    """(1,) f32: ``seed`` plus the sum of all eight decoded values of every
    gf4 word of ``w`` (int32, any shape), each value rounded through bf16
    when ``full``."""
    if w.device.type == "cpu":
        return gf4_decode_sum_plain(w, seed, full)
    out = _launch(w, seed, 2 if full else 1)
    gf4_decode_sum.launches += 1
    return out


gf4_decode_sum.launches = 0


def abs_sum(w: torch.Tensor, gf4: bool = False) -> float:
    """The sum of the magnitudes of the values a sum over ``w`` adds (the
    words' values, or their decoded gf4 values), in float64: the scale of
    :func:`error_bound`."""
    if not gf4:
        return float(w.to(torch.float64).abs_().sum())
    return math.fsum(float(p.abs().sum()) for p in _gf4_planes64(w))
