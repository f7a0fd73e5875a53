"""The program's own spans in a traced slice: the ``calm.*`` ranges that
``calm_tpu_torch.ops.cost.span`` opens at the port's layer boundaries
(the server's tick and its phases, the engine's generate, the model's
prefill, a graph capture), read from the slice's Chrome events.

For every span name :func:`read` gives the count; the host seconds and
the self seconds (a span's duration less the part its child spans cover,
a child being the next ``calm.*`` span nested in it); the device-busy
seconds of the operations launched inside it (an operation is joined to
the runtime call that launched it by ``args.correlation``, and counts for
the innermost ``calm.*`` span running at that call and for each span
around it); and the idle seconds whose gap's midpoint lies inside it as
the innermost ``calm.*`` span, gaps under ``trace.SHORT_GAP_US`` left out
(the device's own launch gaps). Each instance keeps its own numbers, which
medians over instances read: its start, host, self and device seconds,
and the host seconds of the spans nested in it, by name. The spans are
those of the one thread that drives the program.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

from benchmark.trace import DEVICE_CATS, SHORT_GAP_US, SLICE, _union

PREFIX = "calm."
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class Instance:
    start: float  # us, on the trace's clock
    host_s: float
    self_s: float
    device_s: float = 0.0
    inner: dict = dataclasses.field(default_factory=dict)  # nested span name -> host s


@dataclasses.dataclass
class Span:
    count: int = 0
    host_s: float = 0.0
    self_s: float = 0.0
    device_s: float = 0.0
    idle_s: float = 0.0
    each: list = dataclasses.field(default_factory=list)  # Instance, in start order


@dataclasses.dataclass
class Reading:
    spans: dict            # name -> Span
    busy_s: float          # the union of the slice's device operations
    idle_s: float          # the slice's idle, gaps under SHORT_GAP_US left out
    idle_outside_s: float  # of which no calm.* span ran at the gap's midpoint


def _dur(iv) -> float:
    return sum(b - a for a, b in iv)


def read(events: list[dict]) -> Reading:
    """The ``calm.*`` spans of the slice that ``bench.slice`` marks."""
    mark = [e for e in events if e.get("ph") == "X" and e.get("name") == SLICE
            and e.get("cat") == "user_annotation"]
    if not mark:
        raise RuntimeError("the trace holds no bench.slice span")
    t0 = float(mark[0]["ts"])
    t1 = t0 + float(mark[0]["dur"])
    xs = [e for e in events if e.get("ph") == "X"]

    # each span's parent (the innermost span around it), and the stretches
    # of the timeline over which one span is the innermost
    found = sorted((float(e["ts"]), -float(e["dur"]), e["name"]) for e in xs
                   if e.get("cat") == "user_annotation" and e["name"].startswith(PREFIX)
                   and float(e["ts"]) < t1 and float(e["ts"]) + float(e["dur"]) > t0)
    nodes = []   # (start, end, name, parent)
    kids = []    # each node's children's intervals
    cuts = []    # (time, innermost node from then, or None)
    stack: list[int] = []

    def pop_until(t: float) -> None:
        while stack and nodes[stack[-1]][1] <= t:
            end = nodes[stack.pop()][1]
            cuts.append((end, stack[-1] if stack else None))
    for s, neg, name in found:
        pop_until(s)
        parent = stack[-1] if stack else None
        nodes.append((s, s - neg, name, parent))
        kids.append([])
        if parent is not None:
            kids[parent].append((s, s - neg))
        cuts.append((s, len(nodes) - 1))
        stack.append(len(nodes) - 1)
    pop_until(float("inf"))
    times = [t for t, _ in cuts]

    def innermost(t: float) -> int | None:
        i = bisect.bisect_right(times, t)
        return cuts[i - 1][1] if i else None

    inst = [Instance(start=s, host_s=(e - s) * 1e-6,
                     self_s=(e - s - _dur(_union(kids[j]))) * 1e-6)
            for j, (s, e, _, _) in enumerate(nodes)]
    for s, e, name, parent in nodes:
        while parent is not None:
            inner = inst[parent].inner
            inner[name] = inner.get(name, 0.0) + (e - s) * 1e-6
            parent = nodes[parent][3]

    # device operations, clipped to the slice, each under its launching call's spans
    launched = {e["args"]["correlation"]: float(e["ts"]) for e in xs
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    dev, under = [], collections.defaultdict(list)
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = max(float(e["ts"]), t0), min(float(e["ts"]) + float(e["dur"]), t1)
        if b <= a:
            continue
        dev.append((a, b))
        at = launched.get(e.get("args", {}).get("correlation"))
        j = innermost(at) if at is not None else None
        while j is not None:
            under[j].append((a, b))
            j = nodes[j][3]
    for j, iv in under.items():
        inst[j].device_s = _dur(_union(iv)) * 1e-6

    spans: dict = collections.defaultdict(Span)
    for (_, _, name, _), x in zip(nodes, inst):
        sp = spans[name]
        sp.count += 1
        sp.host_s += x.host_s
        sp.self_s += x.self_s
        sp.device_s += x.device_s
        sp.each.append(x)

    busy = _union(dev)
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    idle = outside = 0.0
    for a, b in zip(edges[0::2], edges[1::2]):
        if b - a < SHORT_GAP_US:
            continue
        idle += (b - a) * 1e-6
        j = innermost((a + b) / 2)
        if j is None:
            outside += (b - a) * 1e-6
        else:
            spans[nodes[j][2]].idle_s += (b - a) * 1e-6
    return Reading(spans=dict(spans), busy_s=_dur(busy) * 1e-6, idle_s=idle,
                   idle_outside_s=outside)
