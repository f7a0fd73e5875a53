"""The traced slice of a ``--trace 1`` run: ``torch.profiler`` (CUPTI)
over a few steady seconds of the window, read back from its Chrome trace.

The driver opens the slice where the device is idle (after a
synchronising host copy) and closes it after synchronising, and records
the work done inside it. A span ``bench.slice`` marks the slice on the
host; the device's operations (kernels, copies, fills) inside it make
the busy time, the union of their intervals, so that operations that
overlap count once. The breakdown names the operations that took most
time and the longest idle stretches, each by what the host was doing at
its middle: the innermost host event there (the benchmark's own spans
``bench.generate``, ``bench.submit`` and ``bench.tick``, or an operator
or runtime call inside them).
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
SLICE = "bench.slice"
SHORT_GAP_US = 10.0  # gaps shorter than this are the device's own launch gaps


@dataclasses.dataclass
class Summary:
    busy_s: float
    window_s: float
    device_ops: list
    idle_gaps: list


class Slice:
    """One traced slice: :meth:`begin`, the work, :meth:`end`."""

    def __init__(self):
        self._prof = None
        self._span = None
        self.summary: Summary | None = None
        self.read_s = 0.0  # seconds to export and read the trace

    def warm(self) -> None:
        """Start and stop the profiler once, in set-up: its first start
        (CUPTI's) takes seconds that would otherwise fall in the window."""
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def begin(self) -> None:
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._span = torch.profiler.record_function(SLICE)
        self._span.__enter__()

    def end(self) -> None:
        torch.cuda.synchronize()
        self._span.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        t = time.perf_counter()
        fd, path = tempfile.mkstemp(suffix=".trace.json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self._prof = None
        self.summary = summarize(events)
        self.read_s = time.perf_counter() - t


def _union(iv: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _innermost(host: list, t: float, back: int) -> str | None:
    """The shortest of the last ``back`` host events started by ``t`` that
    still run at ``t``."""
    i = bisect.bisect_right(host, (t, float("inf"), ""))
    best = None
    for s, e, name in host[max(0, i - back):i]:
        if e >= t and (best is None or e - s < best[0]):
            best = (e - s, name)
    return best[1] if best else None


def summarize(events: list[dict]) -> Summary:
    """Busy and window seconds and the breakdown of one slice's events."""
    span = [e for e in events if e.get("ph") == "X" and e.get("name") == SLICE
            and e.get("cat") == "user_annotation"]
    if not span:
        raise RuntimeError("the trace holds no bench.slice span")
    t0 = float(span[0]["ts"])
    t1 = t0 + float(span[0]["dur"])
    dev, by_name = [], collections.Counter()
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a, b = max(float(e["ts"]), t0), min(float(e["ts"]) + float(e["dur"]), t1)
        if b > a:
            dev.append((a, b))
            by_name[e["name"]] += (b - a) * 1e-6
    busy = _union(dev)
    busy_s = sum(b - a for a, b in busy) * 1e-6

    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                  for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS
                  and e.get("name") != SLICE)
    ours = [h for h in host if h[2].startswith("bench.")]
    gaps = collections.Counter()
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        if b - a < SHORT_GAP_US:
            gaps["device: gaps under 10 us between operations"] += (b - a) * 1e-6
            continue
        best = _innermost(host, (a + b) / 2, 300) or _innermost(ours, (a + b) / 2, 50)
        gaps[f"host: {best}" if best else "host: no traced event"] += (b - a) * 1e-6
    return Summary(busy_s=busy_s, window_s=(t1 - t0) * 1e-6,
                   device_ops=[[n, s] for n, s in by_name.most_common(10)],
                   idle_gaps=[[n, s] for n, s in gaps.most_common(10)])
