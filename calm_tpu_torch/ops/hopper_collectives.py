"""The ring all-reduce on Hopper: the port of ``pallas_collectives``.

:func:`ring_all_reduce` replaces ``_ring_kernel``
(``calm_tpu/ops/pallas_collectives.py:42``, through ``ring_all_reduce
:111``): an in-place sum all-reduce over a 1-D ring of n ranks, 2(n-1)
steps of reduce-scatter then all-gather with double-buffered receive
slots, an entry barrier and consumption acks (``csrc/ring.cu``). This
launcher runs n logical ranks on one device in one launch, each rank's
data a tensor of its own; the device code reaches them through arrays of
pointers, so a launcher over several GPUs adds host code only.

As in the JAX package, the model's tp close stays the framework's
collective (``parallel.mesh.Mesh.psum``); the ring stands alone.

:func:`ring_all_reduce_plain` sums each chunk in the ring's own order, so
kernel and plain version agree bit for bit in f32 and bf16. The wrapper
takes the plain version for tensors on the CPU, launches the kernel for
CUDA tensors or raises, and counts its launches in ``.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from calm_tpu_torch.ops import build

LANES = 128  # chunks pad to a multiple of this, as pallas_collectives.py:134
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_state: dict = {}  # (device, n) -> [flags (n, 4 gmax) uint64, last epoch]


def _layout(xs) -> tuple[int, int]:
    """(elements per rank, chunk): n lane-aligned chunks cover the data."""
    total = xs[0].numel()
    chunk = -(-total // len(xs))
    return total, -(-chunk // LANES) * LANES


def _padded(xs, chunk: int) -> torch.Tensor:
    """(n, n * chunk): rank r's data, zero-padded."""
    n, total = len(xs), xs[0].numel()
    v = torch.zeros((n, n * chunk), dtype=xs[0].dtype, device=xs[0].device)
    for r, x in enumerate(xs):
        v[r, :total] = x.reshape(-1)
    return v


def ring_all_reduce_plain(xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """The elementwise sum of ``xs``, one copy a rank, each chunk summed as
    the ring sums it: chunk c starts from rank c's value and adds rank
    c+1's, c+2's, ... round to c-1's, in the tensors' dtype."""
    n = len(xs)
    total, chunk = _layout(xs)
    v = _padded(xs, chunk).reshape(n, n, chunk)  # (rank, chunk, element)
    out = torch.empty((n, chunk), dtype=v.dtype, device=v.device)
    for c in range(n):
        acc = v[c, c].clone()
        for j in range(1, n):
            acc = acc + v[(c + j) % n, c]
        out[c] = acc
    s = out.reshape(-1)[:total].reshape(xs[0].shape)
    return [s.clone() for _ in range(n)]


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def ring_all_reduce(xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """The sum of ``xs`` (n tensors of one shape and dtype, f32 or bf16),
    as n new tensors, rank r's result at index r. The data pads to n
    chunks of a multiple of 128 elements, as the TPU kernel's host code
    does (``pallas_collectives.py:130-137``)."""
    n = len(xs)
    _check(n >= 1, "no ranks")
    x0 = xs[0]
    for x in xs:
        _check(x.shape == x0.shape and x.dtype == x0.dtype and x.device == x0.device,
               "every rank's tensor must have one shape, dtype and device")
    if x0.device.type == "cpu":
        return ring_all_reduce_plain(xs)
    if n == 1:
        return [x0.clone()]
    _check(x0.dtype in _DTYPE_CODE, f"no CUDA ring for {x0.dtype}")
    lib = build.lib("ring")
    gmax = lib.calm_ring_gmax()
    _check(n <= 16, "the ring kernel takes at most 16 ranks")
    total, chunk = _layout(xs)
    dev = x0.device
    key = (str(dev), n)
    if key not in _state:  # zeroed once: every later call raises the epoch
        _state[key] = [torch.zeros((n, 4 * gmax), dtype=torch.int64, device=dev), 0]
    flags, epoch = _state[key]
    epoch += 1
    _state[key][1] = epoch
    bufs = _padded(xs, chunk)
    slots = torch.empty((n, 2 * (chunk + gmax)), dtype=x0.dtype, device=dev)
    arr = ctypes.c_void_p * n
    pb = arr(*[bufs[r].data_ptr() for r in range(n)])
    ps = arr(*[slots[r].data_ptr() for r in range(n)])
    pf = arr(*[flags[r].data_ptr() for r in range(n)])
    rc = lib.calm_ring_all_reduce(
        ctypes.addressof(pb), ctypes.addressof(ps), ctypes.addressof(pf), n, chunk,
        _DTYPE_CODE[x0.dtype], epoch, torch.cuda.current_stream(dev).cuda_stream)
    build.check("ring", rc)
    ring_all_reduce.launches += 1
    return [bufs[r, :total].reshape(x0.shape) for r in range(n)]


ring_all_reduce.launches = 0


def ring_flags(device, n: int) -> tuple[torch.Tensor, int, int]:
    """The flags of the CUDA ring at n ranks on ``device`` after its last
    call, for checks of the protocol: (flags (n, 4 gmax) int64, that call's
    epoch, gmax). Rank r's flags are arrive (gmax, 2), then ack (gmax),
    then entry (gmax); after a call of G blocks a rank, segment j < G holds
    entry ``epoch << 32``, ack ``epoch << 32 | 2 (n - 1)`` and arrivals of
    the last two steps, and every other flag an earlier epoch's value."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    flags, epoch = _state[(str(d), n)]
    return flags, epoch, flags.shape[1] // 4
