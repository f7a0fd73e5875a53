"""One user, requests back to back: each a prompt of ``prompt_bytes``
bytes drawn from the seed, prefilled, then ``new_tokens`` greedy tokens
through ``Engine.generate(temperature=0)``, as the CLI runs it.

``decode_tok_s`` counts every token that ``generate`` produced in the
window, stamped on the host as its chunk of 16 arrives (the stop token,
where one ends a request, when ``generate`` returns), over the window's
seconds. The window closes with the first chunk that arrives once
``seconds`` have passed, so that it holds whole chunks. Prefills and the
host's syncs are inside. The request running then finishes for the
check. A traced run traces the window's second request whole.
"""

from __future__ import annotations

import time

from torch.profiler import record_function

from benchmark import mix


def setup(ctx) -> None:
    p = ctx.params
    eng = ctx.program = ctx.engine(1)
    ctx.state = [mix.text(ctx.rng, p["prompt_bytes"]) for _ in range(p["prompts"])]
    # the captured one-row step and a prefill of the prompts' length
    warm = mix.text(ctx.rng, p["prompt_bytes"])
    n = len(eng.tokenizer.encode(warm, bos=True))
    eng.generate(warm, steps=n - 1 + p["warm_tokens"], temperature=0.0)


def window(ctx) -> None:
    p = ctx.params
    eng = ctx.program
    stamps: list[float] = []
    t0 = time.perf_counter()
    end = t0 + ctx.seconds
    i = 0
    while time.perf_counter() < end:
        text = ctx.state[i % len(ctx.state)]
        i += 1
        ids = eng.tokenizer.encode(text, bos=True)
        got: list[float] = []
        traced = ctx.slice is not None and i == 2
        if traced:
            ctx.slice.begin()
        with record_function("bench.generate"):
            st = eng.generate(text, steps=len(ids) - 1 + p["new_tokens"], temperature=0.0,
                              on_piece=lambda _s: got.append(time.perf_counter()))
        t_ret = time.perf_counter()
        if len(st.ids) > len(got):  # the stop token is not emitted as a piece
            got.append(t_ret)
        if traced:
            ctx.slice.end()
            ctx.work.prefill(ctx.d, len(ids) - 1)
            for j in range(len(st.ids)):
                ctx.work.decode(ctx.d, [len(ids) + j])
        stamps += got
        ctx.attempted += 1
        ctx.finished.append({"text": text, "ids": ids, "served": list(st.ids)})
    stop = min((s for s in stamps if s >= end), default=end)
    n = sum(1 for s in stamps if s <= stop)
    ctx.info(f"stream: {i} requests, {n} tokens in {stop - t0:.6f} s")
    ctx.metrics["decode_tok_s"] = (n / (stop - t0), "tokens/s")
