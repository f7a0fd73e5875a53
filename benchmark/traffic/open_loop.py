"""Independent chat users: an open loop of Poisson arrivals at a fixed
``rate`` (requests a second) into ``serve.Server``.

Each request is one of ``system_prompts`` system prompts drawn from the
seed (``system_bytes`` bytes each), followed by a user turn of lognormal
length (``user_bytes``), and asks for a lognormal number of greedy tokens
(``output_tokens``). There are round(rate * seconds) requests, all due
inside the window; their lengths, gaps and system prompts are stratified
(``benchmark.mix``) and shuffled by ``schedule_seed``, so that every seed
sends the same schedule, its texts and weights its own: the tail of a
few hundred requests then moves with the program, not with the order the
seed would deal. The server has ``slots``
slots, a dense cache, a prefix cache of ``prefix_cache_tokens`` and host
sampling. Set-up admits each system prompt once, as a running deployment
holds them, then requests whose user turns cover ``warm_user_bytes``.

A request is timed from when it was due: ``ttft_p50_ms`` is the median
over every request due in the window (one still waiting when it closes
counts with its wait so far), ``itl_p95_ms`` the 95th percentile over
every gap between consecutive tokens of a request inside the window. The
95th percentile of the time to first token goes on a line of its own: on
one schedule it moved by a quarter between runs (PERF.md). A traced run traces the ticks of
the window's last ``slice_seconds``.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import mix, program
from benchmark.served import Driver


def setup(ctx) -> None:
    p = ctx.params
    eng = ctx.engine(p["slots"])
    srv = ctx.program = program.server(eng, p["slots"], p["prefix_cache_tokens"])
    ctx.state = [mix.text(ctx.rng, p["system_bytes"]) for _ in range(p["system_prompts"])]
    for s in ctx.state:
        srv.submit(s, max_tokens=2, temperature=0.0)
    srv.run_until_drained()
    for i, n in enumerate(p["warm_user_bytes"]):
        srv.submit(ctx.state[i % len(ctx.state)] + mix.text(ctx.rng, n), max_tokens=2,
                   temperature=0.0)
    srv.run_until_drained()


def schedule(ctx, rate: float):
    """(due seconds from the window's start, text, max tokens) of every
    request of a window at ``rate``."""
    p = ctx.params
    order = np.random.default_rng(p["schedule_seed"])
    rng = np.random.default_rng([ctx.seed, 1])
    systems = ctx.state
    n = max(1, round(rate * ctx.seconds))
    due = np.cumsum(mix.shuffled(order, mix.exponential(n, rate)))
    users = mix.shuffled(order, mix.lognormal(n, **p["user_bytes"]))
    outs = mix.shuffled(order, mix.lognormal(n, **p["output_tokens"]))
    which = mix.shuffled(order, np.arange(n) % len(systems))
    return [(float(due[i]), systems[which[i]] + mix.text(rng, users[i]), int(outs[i]))
            for i in range(n)]


def p95(xs) -> float:
    return float(np.percentile(np.asarray(xs, dtype=np.float64), 95)) if len(xs) else float("nan")


def window(ctx, rate: float | None = None) -> dict:
    """Run the window at ``rate`` (the cell's by default); returns what a
    rate sweep reads."""
    p = ctx.params
    rate = p["rate"] if rate is None else rate
    sched = schedule(ctx, rate)
    drv = Driver(ctx, ctx.program)
    t0 = time.perf_counter()
    end = t0 + ctx.seconds
    lat = 0.0
    i = 0
    waits = []  # pending queue length after each tick: (t, n)
    while True:
        now = time.perf_counter()
        if now >= end:
            break
        while i < len(sched) and t0 + sched[i][0] <= now:
            lat = max(lat, now - (t0 + sched[i][0]))
            drv.submit(sched[i][1], sched[i][2], t0 + sched[i][0])
            i += 1
        if drv.busy():
            drv.slice_from(end - p["slice_seconds"], now)
            drv.tick()
            waits.append((time.perf_counter() - t0, len(ctx.program.pending)))
        elif i < len(sched):
            time.sleep(max(0.0, min(t0 + sched[i][0], end) - time.perf_counter()))
        else:
            time.sleep(max(0.0, min(end - time.perf_counter(), 0.001)))
    drv.close_slice()

    lives = drv.done + drv.live
    ttft = []
    for lv in lives:
        first = [s for s in lv.stamps if s <= end]
        ttft.append(((first[0] if first else end) - lv.due) * 1e3)
    due_unsent = [t0 + d for d, _, _ in sched[i:] if t0 + d <= end]
    ttft += [(end - d) * 1e3 for d in due_unsent]
    waiting = sum(1 for lv in lives if not [s for s in lv.stamps if s <= end]) + len(due_unsent)
    ctx.attempted += len(due_unsent)
    itl = [(b - a) * 1e3 for st in drv.stamps_until(end) for a, b in zip(st, st[1:])]
    ctx.info(f"open loop at {rate} req/s: {len(ttft)} due, {len(drv.done)} finished, "
             f"{waiting} without a token at the close, generator late by at most "
             f"{lat * 1e3:.3f} ms, {drv.ticks} ticks; time to first token p95 "
             f"{p95(ttft)} ms")
    ctx.metrics["ttft_p50_ms"] = (float(np.median(ttft)), "ms")
    ctx.metrics["itl_p95_ms"] = (p95(itl), "ms")
    q = [n for t, n in waits]
    third = max(1, len(q) // 3)
    return {"rate": rate, "due": len(ttft), "finished": len(drv.done), "waiting": waiting,
            "ttft_p50_ms": float(np.median(ttft)) if ttft else float("nan"),
            "ttft_p95_ms": p95(ttft), "itl_p95_ms": p95(itl),
            "queue_first_third": float(np.mean(q[:third])) if q else 0.0,
            "queue_last_third": float(np.mean(q[-third:])) if q else 0.0,
            "tokens": sum(len(s) for s in drv.stamps_until(end)), "drv": drv}
