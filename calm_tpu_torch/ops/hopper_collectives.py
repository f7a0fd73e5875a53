"""The sum all-reduce on Hopper: the port of ``pallas_collectives``.

:func:`ring_all_reduce` replaces ``_ring_kernel``
(``calm_tpu/ops/pallas_collectives.py:42``, through ``ring_all_reduce
:111``) and keeps its name and its sum order: n chunks, chunk c summed
from rank c's value round the ring to rank c-1's. The kernel
(``csrc/ring.cu``) is a two-shot, not a ring: rank r owns chunk r, reads it
from all n inputs in 16-byte vectors, sums it in the ring's order and
writes the sum into all n outputs. On one card, and across cards that
NVLink joins all to all, that moves exactly the bound's bytes (n inputs
read, n outputs written) where the ring moved ~9 (n-1) chunks a rank
through receive slots. Epoch-tagged flags give an entry barrier (inputs
ready) and an exit barrier (every owner has written to rank r). This
launcher runs n logical ranks on one device in one launch, each rank's
data a tensor of its own; the device code reaches them through arrays of
pointers, so a launcher over several GPUs adds host code only.

The callers' tensors go to the kernel as they are when their size is a
multiple of n * 128 elements (:func:`kernel_layout`); only a ragged size
is padded, with one copy. The inputs stay untouched and the outputs are
new tensors, as the JAX function is functional.

As in the JAX package, the model's tp close stays the framework's
collective (``parallel.mesh.Mesh.psum``); this all-reduce stands alone.

:func:`ring_all_reduce_plain` sums each chunk in the ring's own order, so
kernel and plain version agree bit for bit in f32 and bf16. The wrapper
takes the plain version for tensors on the CPU, launches the kernel for
CUDA tensors or raises, and counts its launches in ``.launches`` (and,
while a profiler trace is open, records their bytes, ``ops/cost.py``).
"""

from __future__ import annotations

import ctypes

import torch

from calm_tpu_torch.ops import build, cost

LANES = 128  # chunks pad to a multiple of this, as pallas_collectives.py:134
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_state: dict = {}  # (device, n) -> [flags (n, 2 gmax) uint64, last epoch]


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


def kernel_layout(xs) -> tuple[list[torch.Tensor], int, bool]:
    """What the kernel reads: (n flat inputs of n * chunk elements each,
    chunk, padded). Contiguous, 16-byte aligned tensors whose size is a
    multiple of n * 128 elements are passed as they are (views, no copy);
    any other size is padded with zeros to n chunks of a multiple of 128
    elements, one copy a rank, as the TPU kernel's host code pads
    (``pallas_collectives.py:130-137``)."""
    n = len(xs)
    total, chunk = _layout(xs)
    if total == n * chunk and all(x.is_contiguous() and x.data_ptr() % 16 == 0 for x in xs):
        return [x.reshape(-1) for x in xs], chunk, False
    return list(_padded(xs, chunk)), chunk, True


@cost.ranged
def ring_all_reduce(xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """The sum of ``xs`` (n tensors of one shape and dtype, f32 or bf16),
    as n new tensors, rank r's result at index r; the inputs stay as they
    were. Chunk c of the n chunks (:func:`kernel_layout`) sums rank c's
    value first, round the ring, bit for bit as the TPU kernel."""
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
    _check(x0.dtype in _DTYPE_CODE, f"no CUDA all-reduce for {x0.dtype}")
    lib = build.lib("ring")
    gmax = lib.calm_ring_gmax()
    _check(n <= 16, "the all-reduce kernel takes at most 16 ranks")
    ins, chunk, padded = kernel_layout(xs)
    dev = x0.device
    key = (str(dev), n)
    if key not in _state:  # zeroed once: every later call raises the epoch
        _state[key] = [torch.zeros((n, 2 * gmax), dtype=torch.int64, device=dev), 0]
    flags, epoch = _state[key]
    epoch += 1
    _state[key][1] = epoch
    if padded:
        outv = torch.empty((n, n * chunk), dtype=x0.dtype, device=dev)
        outs = list(outv)
    else:
        outs = [torch.empty_like(x) for x in xs]
    arr = ctypes.c_void_p * n
    pi = arr(*[t.data_ptr() for t in ins])
    po = arr(*[t.data_ptr() for t in outs])
    pf = arr(*[flags[r].data_ptr() for r in range(n)])
    rc = lib.calm_ring_all_reduce(
        ctypes.addressof(pi), ctypes.addressof(po), ctypes.addressof(pf), n, chunk,
        _DTYPE_CODE[x0.dtype], epoch, torch.cuda.current_stream(dev).cuda_stream)
    build.check("ring", rc)
    if cost.active():  # each rank's input read, its output written, once
        cost.record("allreduce_kernel", 2 * n * x0.numel() * x0.element_size(),
                    n * x0.numel())
    ring_all_reduce.launches += 1
    if padded:
        total = x0.numel()
        return [o[:total].reshape(x0.shape) for o in outs]
    return outs


ring_all_reduce.launches = 0


def ring_flags(device, n: int) -> tuple[torch.Tensor, int, int]:
    """The flags of the CUDA all-reduce at n ranks on ``device`` after its
    last call, for checks of the protocol: (flags (n, 2 gmax) int64, that
    call's epoch, gmax). Rank r's flags are entry (gmax), then done
    (gmax); after a call of G blocks a rank, segment j < G holds entry
    ``epoch << 32`` and done ``epoch << 32 | 1``, and every other flag an
    earlier epoch's value."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    flags, epoch = _state[(str(d), n)]
    return flags, epoch, flags.shape[1] // 2
