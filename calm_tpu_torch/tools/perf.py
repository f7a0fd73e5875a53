"""Profile a decode (or a prefill) on the GPU: the achieved-against-SoL
roofline and, with ``--trace``, the measured per-op table (the port of
``tools/perf.py``).

    python -m calm_tpu_torch.tools.perf model.calm [-n 32] [--trace DIR]
    python -m calm_tpu_torch.tools.perf --synthetic mistral7b --dtype fp8 \\
        --pos 0 --attainable 3200 --trace DIR
    python -m calm_tpu_torch.tools.perf --synthetic mistral7b --prefill 2048

Times ``n`` greedy decode steps as ``model.decode_loop`` runs them (on the
card a replayed CUDA graph), least of 3 after a warm-up, and prints
``profiler.roofline_report`` (with ``--attainable``, the achieved GB/s as a
share of that measured read rate too; ``tools.dma_ceiling`` measures it).
With ``--prefill T`` it times a T-token prefill instead. With ``--trace``
it runs once more eagerly under ``profiler.trace`` (a replayed graph runs
no wrapper, so only the eager step's kernels carry their bytes) and prints
``profiler.trace_table``. ``--synthetic`` takes a shape of
``tools.bench.SHAPES`` on ``utils.synth`` pattern weights. Runs on the
card; ``CALM_CPU=1`` runs the plain path on the CPU. Without a GPU (and
without ``CALM_CPU=1``) it exits 1.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from calm_tpu_torch import model as M
from calm_tpu_torch import profiler
from calm_tpu_torch.config import ModelConfig
from calm_tpu_torch.tools.bench import SHAPES

def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def load(args, dev):
    """(cfg, weights) of the checkpoint or the synthetic shape, on dev."""
    if args.synthetic:
        from calm_tpu_torch.utils.synth import synth_weights
        shape = dict(SHAPES[args.synthetic])
        cfg = ModelConfig(**shape, seq_len=args.ctx, rope_theta=10000.0,
                          norm_ln=False, dtype=args.dtype, rotary_dim=shape["head_dim"])
        return cfg, synth_weights(cfg, device=dev)
    from calm_tpu_torch.container import TensorFile
    tf = TensorFile(args.checkpoint)
    cfg = ModelConfig.from_metadata(tf.metadata, args.ctx)
    M.check_supported(cfg, dev)
    return cfg, M.load_weights(tf, cfg, dev)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m calm_tpu_torch.tools.perf")
    ap.add_argument("checkpoint", nargs="?")
    ap.add_argument("--synthetic", default=None, choices=sorted(SHAPES),
                    help="a bench.py shape instead of a checkpoint")
    ap.add_argument("--dtype", default="fp8", choices=["fp16", "fp8", "fp8e4", "gf4"])
    ap.add_argument("-n", dest="steps", type=int, default=32)
    ap.add_argument("--ctx", type=int, default=4096)
    ap.add_argument("--pos", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=1, help="decode slots")
    ap.add_argument("--trace", default=None,
                    help="trace one eager run into this directory and print its table")
    ap.add_argument("--prefill", type=int, default=0, metavar="T",
                    help="time a T-token prefill chunk instead of decode")
    ap.add_argument("--attainable", type=float, default=None, metavar="GBPS",
                    help="the card's measured HBM read rate, for the report")
    args = ap.parse_args(argv)
    if not (args.checkpoint or args.synthetic):
        ap.error("need a checkpoint or --synthetic <shape>")

    cpu = os.environ.get("CALM_CPU", "0") == "1"
    if not cpu and not torch.cuda.is_available():
        print("perf: no CUDA GPU available (CALM_CPU=1 runs on the CPU)", file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cpu" if cpu else "cuda")
    cfg, w = load(args, dev)
    kv_dtype = torch.float8_e5m2 if cfg.seq_len > 4096 else torch.bfloat16
    kv_bits = 8 if kv_dtype == torch.float8_e5m2 else 16
    B = args.batch
    # one cache for every run: a replayed step is captured on the cache it
    # runs on, so a new cache a run would time a capture each run
    cache = M.KVCache.create(cfg, B, kv_dtype, dev)
    tok = torch.zeros(B, dtype=torch.int64, device=dev)
    rolling = args.pos + args.steps >= cfg.seq_len

    if args.prefill:
        T = args.prefill
        tokens = torch.zeros((B, T), dtype=torch.int64, device=dev)

        def run():
            _sync(dev)
            t0 = time.perf_counter()
            M.prefill(cfg, w, tokens, [0] * B, cache, "last")
            _sync(dev)
            return time.perf_counter() - t0
        eager = run
    else:
        def run():
            _sync(dev)
            t0 = time.perf_counter()
            M.decode_loop(cfg, w, tok, args.pos, cache, args.steps, rolling=rolling)
            _sync(dev)
            return time.perf_counter() - t0

        def eager():
            t, pos = tok, args.pos
            for _ in range(args.steps):
                logits, _ = M.decode_step(cfg, w, t, pos, cache, rolling=rolling)
                t, pos = logits.argmax(-1), pos + 1
            _sync(dev)

    run()  # warm: builds the kernels, captures the step
    best = min(run() for _ in range(3))
    if args.prefill:
        print(f"# prefill T={args.prefill}: {best * 1e3:.1f} ms/chunk, "
              f"{args.prefill / best:.0f} tok/s")
    else:
        print(profiler.roofline_report(cfg, best * 1000 / args.steps, kv_bits, args.pos,
                                       attainable_gbps=args.attainable))
    if args.trace:
        eager()  # warm outside the trace
        with profiler.trace(args.trace, cuda=dev.type == "cuda"):
            eager()
        what = (f"one eager prefill of {args.prefill} tokens" if args.prefill else
                f"one eager run of {args.steps} steps from position {args.pos}")
        print(profiler.trace_table(args.trace, cfg, steps=1 if args.prefill else args.steps,
                                   kv_bits=kv_bits, pos=args.pos, label=what))
        print(f"# trace written to {args.trace} (load the .trace.json in Perfetto)")


if __name__ == "__main__":
    main()
