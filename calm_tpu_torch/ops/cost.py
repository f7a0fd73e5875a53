"""The port's tracing: the bytes and operations of each kernel launch
while a profiler trace is open, spans at the layer boundaries, and
counters.

torch.profiler's kernel events carry neither the bytes a kernel moves nor
the operations it does; XLA's carry both (``bytes_accessed``, ``flops``),
and ``calm_tpu/profiler.py``'s table reads them. Here the kernel wrappers
of ``ops/hopper_*`` say it themselves: while :func:`calm_tpu_torch.profiler.
trace` is open, each launch is recorded with the kernel's name as the CUDA
profiler shows it (without its template arguments), its stage (the
innermost wrapper running, whose ``record_function`` range
``calm__<stage>`` the trace shows around its kernels), the bytes it must
move (each input read once, each output written once) and its operations
(2 a multiply-add). One stream runs its kernels in launch order, so the
n-th recorded launch of a kernel is the n-th event of that name in the
trace (``profiler.parse_trace`` joins them so).

A value that lives on the device (a sequence's kv_len, the live experts of
a sweep) is recorded as a function of tensors the step made anyway, and
read once the trace has closed: recording makes no host sync and launches
nothing. Outside a trace a wrapper pays one check. Inside a captured graph's
replay no wrapper runs, so a trace of a replayed step records nothing.

:func:`span` marks a layer boundary (the server's tick and its phases, the
engine's generate, the model's prefill, a graph capture) with a
``record_function`` range ``calm.<name>`` while a torch profiler records
(or this module's recording is open): the profiler stamps both ends on
the timeline of its device events, and a span's parent is the span it
nests in. Otherwise a span costs one check. The Chrome export drops a
range's argument string, so per-request spans carry no request id: the
n-th of a name inside one ``calm.serve.admit`` is its n-th admission's.

:func:`count` adds to one process-wide dict of counters, always on (the
server's admissions, queue wait and prefix hits, graph captures and
replays, the model's host syncs); :func:`counters` returns a copy.
"""

from __future__ import annotations

import contextlib
import functools

from torch.profiler import record_function

from torch._C._autograd import _profiler_enabled

_LOG: list | None = None  # [kernel, stage, bytes, ops] a launch, in launch order
_STAGES: list[str] = []   # the wrappers running, innermost last
_COUNTS: dict[str, float] = {}
_OFF = contextlib.nullcontext()


def active() -> bool:
    return _LOG is not None


def start() -> None:
    global _LOG
    _LOG = []


def stop() -> list[tuple[str, str, int, int]]:
    """End the recording: every launch as (kernel, stage, bytes, ops), the
    device values read now (the caller has synchronised the card)."""
    global _LOG
    log, _LOG = _LOG or [], None

    def val(v):
        return int(v() if callable(v) else v)
    return [(k, s, val(b), val(o)) for k, s, b, o in log]


def record(kernel: str, nbytes, ops) -> None:
    """One launch of ``kernel``; ``nbytes`` and ``ops`` are ints or
    functions of no argument, called at :func:`stop`."""
    if _LOG is not None:
        _LOG.append((kernel, _STAGES[-1] if _STAGES else "", nbytes, ops))


def ranged(f):
    """A wrapper whose calls, while a trace is open, run inside a
    ``record_function`` range ``calm__<name>`` and record their launches
    under that stage."""
    name = f.__name__

    @functools.wraps(f)
    def g(*a, **k):
        if _LOG is None:
            return f(*a, **k)
        _STAGES.append(name)
        try:
            with record_function(f"calm__{name}"):
                return f(*a, **k)
        finally:
            _STAGES.pop()
    return g


@contextlib.contextmanager
def recording():
    """Record the launches of a block (``profiler.trace`` runs its profile
    inside one); yields the list that :func:`stop`'s entries fill when the
    block ends."""
    out: list = []
    start()
    try:
        yield out
    finally:
        out.extend(stop())


def span(name: str):
    """A ``with`` block that a recording profiler shows as ``calm.<name>``;
    when none records, nothing."""
    if _LOG is None and not _profiler_enabled():
        return _OFF
    return record_function("calm." + name)


def count(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name``."""
    _COUNTS[name] = _COUNTS.get(name, 0) + n


def counters() -> dict[str, float]:
    """A copy of every counter."""
    return dict(_COUNTS)
