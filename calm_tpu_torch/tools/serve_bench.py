"""Serving-level benchmark: continuous-batching throughput and latency
(the port of ``tools/serve_bench.py``).

``tools.bench`` measures the single-stream decode rate (the reference's
perf line, src/run.c:249-253); this measures what a deployment sees:
aggregate tokens/s across slots, time-to-first-token percentiles, and the
effect of the serving features (paged pool, prefix sharing, speculation)
on a synthetic request load, through the port's ``serve.Server``.

    python -m calm_tpu_torch.tools.serve_bench --synthetic mistral7b --dtype fp8 \\
        --batch 8 --requests 32 --prompt-len 128 --max-tokens 64
    python -m calm_tpu_torch.tools.serve_bench m.calm --page-rows 512 --prefix-share 0.5
    CALM_CPU=1 python -m calm_tpu_torch.tools.serve_bench --synthetic tiny ...  # the CPU

``--synthetic`` writes its container (into the temporary directory, kept
for later runs) with ``utils.synth.synth_container(random=True)`` on the
device: seeded random bits under the format's masks, a byte vocab.
``tools/serve_bench.py`` writes numpy random weights with
``tests/modelgen``, which would take minutes at 7B; the weights' values
do not change what is timed here.

A warm-up load (the first batch + 1 prompts, 4 tokens each) runs first,
so that every step is captured and every kernel built before timing. It
also admits the shared prefix, so with a prefix cache the timed load
starts warm: a ``#`` line on stderr says whether the cache held entries
when timing began. Emits one JSON line with ``tools/serve_bench.py``'s
keys: ``{"metric": "serve_agg_tok_s_<tag>_<dtype>", "value", "unit",
"ttft_p50_ms", "ttft_p95_ms", "requests", "slots"}``. Without a GPU (and
without ``CALM_CPU=1``) it exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m calm_tpu_torch.tools.serve_bench")
    ap.add_argument("checkpoint", nargs="?", default=None)
    ap.add_argument("--synthetic", default=None,
                    help="tools.bench shape name (synthetic weights)")
    ap.add_argument("--dtype", default="fp8",
                    choices=["fp16", "fp8", "fp8e4", "gf4"])
    ap.add_argument("--ctx", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--prompt-len", type=int, default=128,
                    help="tokens per prompt (synthetic token ids)")
    ap.add_argument("--max-tokens", type=int, default=64)
    ap.add_argument("--prefix-share", type=float, default=0.0,
                    help="fraction of the prompt shared across requests "
                         "(exercises the prefix cache when enabled)")
    ap.add_argument("--prefix-cache-tokens", type=int, default=0)
    ap.add_argument("--page-rows", type=int, default=0)
    ap.add_argument("--pool-pages", type=int, default=0)
    ap.add_argument("--draft", default=None)
    ap.add_argument("--gamma", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    args = ap.parse_args(argv)

    cpu = os.environ.get("CALM_CPU", "0") == "1"
    if not cpu and not torch.cuda.is_available():
        print("serve_bench: no CUDA GPU available (CALM_CPU=1 runs on the CPU)",
              file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cpu" if cpu else "cuda")
    from calm_tpu_torch.serve import Server

    if args.synthetic:
        # the Server needs a container: the tokenizer rides inside
        from calm_tpu_torch.config import ModelConfig
        from calm_tpu_torch.tools.bench import SHAPES
        from calm_tpu_torch.utils.synth import synth_container
        shape = dict(SHAPES[args.synthetic])
        cfg = ModelConfig(**shape, seq_len=args.ctx, rope_theta=10000.0,
                          norm_ln=False, dtype=args.dtype,
                          rotary_dim=shape["head_dim"])
        path = os.path.join(tempfile.gettempdir(), f"serve_bench_{args.synthetic}_"
                            f"{args.dtype}_{args.ctx}.calm")
        if not os.path.exists(path):
            print(f"# synthesizing {path} ...", file=sys.stderr)
            synth_container(path, cfg, seed=3, device=dev, random=True)
    else:
        path = args.checkpoint
        if path is None:
            ap.error("need a checkpoint or --synthetic <shape>")

    srv = Server(path, batch=args.batch,
                 context=args.ctx if args.synthetic is None else 0,
                 prefix_cache_tokens=args.prefix_cache_tokens,
                 page_rows=args.page_rows, pool_pages=args.pool_pages,
                 draft_path=args.draft, gamma=args.gamma, device=dev)
    print(srv.engine.banner(), file=sys.stderr)

    # synthetic prompts of numbers: the server takes text, so build texts
    # the tokenizer round-trips reasonably
    rng = np.random.default_rng(11)
    shared_n = int(args.prompt_len * args.prefix_share)
    shared = " ".join(str(int(x)) for x in rng.integers(0, 999, shared_n))
    prompts = []
    for i in range(args.requests):
        tail_n = max(1, args.prompt_len - shared_n)
        tail = " ".join(str(int(x))
                        for x in rng.integers(0, 999, tail_n))
        prompts.append((shared + " " + tail).strip())

    # warm-up: a small load first, so that every step is captured and
    # every kernel built before the measured pass (else inside TTFT)
    warm = [srv.submit(p, max_tokens=4, temperature=args.temperature)
            for p in prompts[: min(len(prompts), args.batch + 1)]]
    srv.run_until_drained(max_ticks=100000)
    assert all(r.done for r in warm)

    pc = srv.prefix_cache
    if pc is None:
        print("# prefix cache: off", file=sys.stderr)
    else:
        print(f"# prefix cache: {'warm' if pc.tokens else 'cold'} when timing began "
              f"({len(pc._entries)} entries, {pc.tokens} tokens; the warm-up admitted "
              f"{len(warm)} prompts)", file=sys.stderr)
        hits0 = pc.hits

    t0 = time.perf_counter()
    reqs = [srv.submit(p, max_tokens=args.max_tokens,
                       temperature=args.temperature) for p in prompts]
    srv.run_until_drained(max_ticks=100000)
    wall = time.perf_counter() - t0
    assert all(r.done for r in reqs)

    gen = sum(r.n_generated for r in reqs)
    ttft = np.asarray(sorted(
        (r.first_token_at - r.submitted_at) * 1e3
        for r in reqs if r.first_token_at))
    agg = gen / wall
    line = (f"# {args.requests} reqs x <= {args.max_tokens} tok on "
            f"{args.batch} slots: {gen} tokens in {wall:.2f}s = "
            f"{agg:.1f} tok/s aggregate; TTFT ms "
            f"p50 {np.percentile(ttft, 50):.0f} "
            f"p95 {np.percentile(ttft, 95):.0f}")
    if pc is not None:
        line += f"; prefix hits {pc.hits} ({pc.hits - hits0} timed)"
    if srv._draft is not None:
        line += (f"; spec acceptance "
                 f"{srv.spec_accepted / max(srv.spec_emitted, 1):.2f}")
    print(line, file=sys.stderr)

    tag = args.synthetic or os.path.basename(path)
    out = {
        "metric": f"serve_agg_tok_s_{tag}_{args.dtype}",
        "value": round(agg, 2), "unit": "tok/s aggregate",
        "ttft_p50_ms": round(float(np.percentile(ttft, 50)), 1),
        "ttft_p95_ms": round(float(np.percentile(ttft, 95)), 1),
        "requests": args.requests, "slots": args.batch,
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
