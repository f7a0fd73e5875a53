"""An offline batch job: a closed loop of ``clients`` clients on
``serve.Server``, each sending its next request as soon as its last one
finishes.

Requests are a prompt of lognormal length (``prompt_bytes``) drawn from
the seed and a lognormal number of greedy tokens (``output_tokens``),
taken in turn from a pool of ``pool`` stratified sizes in an order that
``schedule_seed`` shuffles (again each time it runs out): every seed runs
the same job, its texts and weights its own. The server has ``slots`` slots, a
dense cache and host sampling. Set-up runs requests of
``warm_prompt_bytes`` so that the captured step and each prefill route
are built, then starts the clients: their first requests are admitted
(one tick prefills them all) before the window opens, so that the window
sees the job running and not its start.

``batch_tok_s`` is every output token generated in the window over its
seconds; the window closes with the first tick that ends once
``seconds`` have passed. A traced run traces the ticks of the window's
last ``slice_seconds``.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import mix, program
from benchmark.served import Driver


def setup(ctx) -> None:
    p = ctx.params
    eng = ctx.engine(p["slots"])
    srv = ctx.program = program.server(eng, p["slots"])
    for n in p["warm_prompt_bytes"]:
        srv.submit(mix.text(ctx.rng, n), max_tokens=2, temperature=0.0)
    srv.run_until_drained()
    pool, drv = Pool(ctx), Driver(ctx, srv)
    ctx.state = (pool, drv)
    for _ in range(p["clients"]):
        drv.submit(*pool.next(), 0.0)
    drv.tick()


class Pool:
    def __init__(self, ctx):
        p = ctx.params
        self.order_rng = np.random.default_rng(p["schedule_seed"])
        self.rng = np.random.default_rng([ctx.seed, 2])
        self.prompts = mix.lognormal(p["pool"], **p["prompt_bytes"])
        self.outs = mix.lognormal(p["pool"], **p["output_tokens"])
        self.order: list = []

    def next(self) -> tuple[str, int]:
        if not self.order:
            self.order = list(zip(mix.shuffled(self.order_rng, self.prompts),
                                  mix.shuffled(self.order_rng, self.outs)))[::-1]
        n, out = self.order.pop()
        return mix.text(self.rng, n), int(out)


def window(ctx) -> None:
    p = ctx.params
    pool, drv = ctx.state
    t0 = time.perf_counter()
    end = t0 + ctx.seconds
    while True:
        now = time.perf_counter()
        if now >= end:
            break
        drv.slice_from(end - p["slice_seconds"], now)
        for _ in drv.tick():
            drv.submit(*pool.next(), time.perf_counter())
    stop = time.perf_counter()
    drv.close_slice()
    n = sum(1 for st in drv.stamps_until(stop) for s in st if s > t0)
    ctx.info(f"closed loop: {p['clients']} clients, {len(drv.done)} finished, {n} tokens, "
             f"{drv.ticks} ticks in {stop - t0:.6f} s")
    ctx.metrics["batch_tok_s"] = (n / (stop - t0), "tokens/s")
