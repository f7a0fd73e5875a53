"""Driving ``serve.Server`` from one thread, as the traffic drivers of
served cells do: submit, tick, and after each tick read what each request
got.

A token is stamped when the tick that produced it returns (the tick ends
with the logits' copy to the host, which synchronises). A request whose
first token came in a tick was admitted in that tick: the tick ran its
prefill of the prompt less the rows its prefix-cache hit copied in. Each
tick is timed on the host and kept as "admit" (it admitted a request,
so it ran ``prefill_slot``) or "decode"; the traced slice's ticks are
kept apart, and their work (each prefill, and the decode step of every
slot that got a token, at its KV length) is counted for the roofline.
"""

from __future__ import annotations

import dataclasses
import time

from torch.profiler import record_function


@dataclasses.dataclass
class Live:
    req: object
    text: str
    ids: list  # the prompt as the program's tokenizer gave it
    due: float
    stamps: list = dataclasses.field(default_factory=list)


class Driver:
    def __init__(self, ctx, srv):
        self.ctx, self.srv = ctx, srv
        self.live: list[Live] = []
        self.done: list[Live] = []
        self.in_slice = False
        self.ticks = 0

    def submit(self, text: str, max_tokens: int, due: float) -> Live:
        with record_function("bench.submit"):
            req = self.srv.submit(text, max_tokens=max_tokens, temperature=0.0)
        lv = Live(req, text, self.srv.engine.tokenizer.encode(text, bos=True), due)
        self.live.append(lv)
        self.ctx.attempted += 1
        return lv

    def busy(self) -> bool:
        return bool(self.srv.pending) or any(s.active for s in self.srv.slots)

    def tick(self) -> list[Live]:
        """One tick; returns the requests it finished."""
        ctx = self.ctx
        t_a = time.perf_counter()
        with record_function("bench.tick"):
            self.srv.tick()
        t_b = time.perf_counter()
        self.ticks += 1
        admitted, rows, ended = False, [], []
        for lv in self.live:
            k = len(lv.req.ids)
            new = k - len(lv.stamps)
            if new <= 0:
                continue
            if not lv.stamps:
                admitted = True
                if self.in_slice:
                    hit = lv.req.cached_prefix
                    ctx.work.prefill(ctx.d, len(lv.ids) - 1 - hit, hit)
            lv.stamps += [t_b] * new
            rows.append(len(lv.ids) + k - 1)
        if self.in_slice:
            ctx.work.decode(ctx.d, rows)
        else:
            ctx.ticks.append(("admit" if admitted else "decode", (t_b - t_a) * 1e3))
        for lv in self.live:
            if lv.req.done:
                ended.append(lv)
        if ended:
            self.live = [lv for lv in self.live if not lv.req.done]
            for lv in ended:
                if lv.req.timed_out or lv.req.out_of_pages or lv.req.cancelled:
                    ctx.failed += 1
                else:
                    ctx.finished.append({"text": lv.text, "ids": lv.ids,
                                         "served": list(lv.req.ids)})
            self.done += ended
        return ended

    def slice_from(self, begin: float, now: float) -> None:
        """Open the traced slice at the first tick from ``begin``; it runs
        to the window's close (:meth:`close_slice`), so that reading the
        trace, which takes seconds, stalls nothing inside the window."""
        if self.ctx.slice is not None and not self.in_slice and now >= begin:
            self.ctx.slice.begin()
            self.in_slice = True

    def close_slice(self) -> None:
        if self.in_slice:
            self.ctx.slice.end()
            self.in_slice = False

    def stamps_until(self, end: float) -> list[list[float]]:
        """Each request's token stamps up to ``end``."""
        return [[s for s in lv.stamps if s <= end] for lv in self.done + self.live]

    def drain(self) -> None:
        """Cancel what waits, finish what runs (between a sweep's rates)."""
        for r in list(self.srv.pending):
            self.srv.cancel(r)
        self.srv.run_until_drained()
        self.live = []
