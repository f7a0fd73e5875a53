"""The shares the per-layer readers report, from a run's ``Readings``.

Over the traced slice: the summed roofline bound of the work inside it
(``roofline.Work``) over the slice's wall time is the step's share of
the chip's peak (``mfu``); over the union of the device's operation
intervals, the kernels' share of their roofline; and the time with no
operation on the device is the idle share. So mfu = kernel share x (1 -
idle) over the same slice. Each is None where no slice was traced.
"""

from __future__ import annotations

import statistics


def mfu(r) -> float | None:
    if r.summary is None or not r.work.bound_s:
        return None
    return 100.0 * r.work.bound_s / r.summary.window_s


def kernel_roofline(r) -> float | None:
    if r.summary is None or not r.work.bound_s or not r.summary.busy_s:
        return None
    return 100.0 * r.work.bound_s / r.summary.busy_s


def idle(r) -> float | None:
    if r.summary is None or not r.summary.window_s:
        return None
    return 100.0 * (1.0 - r.summary.busy_s / r.summary.window_s)


def tick_p50(r, kind: str) -> float | None:
    ms = [m for k, m in r.ticks if k == kind]
    return statistics.median(ms) if ms else None
