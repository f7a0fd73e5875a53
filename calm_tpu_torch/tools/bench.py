"""Decode-throughput benchmark on the GPU (the port of ``bench.py``).

Measures single-stream greedy decode tokens/s and achieved HBM bandwidth
on a synthetic Mistral-7B (``utils.synth`` weights on the card: weight
values do not change a bandwidth-bound decode), following the reference
measurement protocol (README.md:86,111): 32-token windows early in the
context and near its end, bandwidth from weight bytes a token + KV bytes
at the position (src/run.c:211-212,249-253).

    python -m calm_tpu_torch.tools.bench [--model mistral7b] [--dtype fp8] \\
        [--kv bf16] [--ctx 4096] [--steps 32] [--batch 1] [--prefill T]
    CALM_CPU=1 python -m calm_tpu_torch.tools.bench --model tiny   # the CPU

Prints ONE JSON line with ``bench.py``'s keys: ``{"metric", "value",
"unit", "vs_baseline", "spread_pct", "gb_s"}``, value = % of the card's
nominal HBM rate (``device.HBM_GBPS``: 3350 GB/s on an H100 SXM), and on
the card ``attainable_ceiling_gbps`` (the 3 GB streaming read of
``tools.dma_ceiling``, K1, measured in this process) with
``pct_of_attainable_ceiling``. ``--prefill T`` times a T-token chunk
instead: ``{"metric", "value", "unit"}`` and on the card
``pct_mxu_peak``, the share of the dense bf16 tensor-core peak
(``profiler.PEAKS``), under ``bench.py``'s key.

The windows are ``bench.py``'s (:func:`windows`): the slope of runs of
``steps`` and ``2*steps`` tokens from ``pos0`` times positions [pos0 +
steps, pos0 + 2*steps), and first32's pos0 is ``min(2000, ctx // 2) -
steps``, so at ctx 4096 "first32" times positions 2000-2031 and "last32"
4063-4094, not position 0.

On the card each run is ``model.decode_loop``, which replays the cache's
captured step. Each length keeps one cache, made in its dropped first
run, where the step is captured; a repeat zeroes it in place (a fresh
cache's contents with the captured step's buffers kept), so no timed run
captures. A ``#`` line on stderr counts the captures of each kind. The
CPU (``CALM_CPU=1``) runs the same protocol eagerly; without a GPU and
without ``CALM_CPU=1`` it exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

from calm_tpu_torch import model as M
from calm_tpu_torch.config import ModelConfig
from calm_tpu_torch.engine import kv_cache_bytes
from calm_tpu_torch.utils.synth import synth_weights, weight_bytes

SHAPES = {
    # dim, hidden, head_dim, layers, heads, kv_heads, vocab, experts/active
    "mistral7b": dict(dim=4096, hidden_dim=14336, head_dim=128, n_layers=32,
                      n_heads=32, n_kv_heads=8, vocab_size=32000),
    "llama3-8b": dict(dim=4096, hidden_dim=14336, head_dim=128, n_layers=32,
                      n_heads=32, n_kv_heads=8, vocab_size=128256),
    "llama2-7b": dict(dim=4096, hidden_dim=11008, head_dim=128, n_layers=32,
                      n_heads=32, n_kv_heads=32, vocab_size=32000),
    "llama2-13b": dict(dim=5120, hidden_dim=13824, head_dim=128, n_layers=40,
                       n_heads=40, n_kv_heads=40, vocab_size=32000),
    "mixtral8x7b": dict(dim=4096, hidden_dim=14336, head_dim=128, n_layers=32,
                        n_heads=32, n_kv_heads=8, vocab_size=32000,
                        n_experts=8, n_experts_ac=2),
    "mixtral4x7b": dict(dim=4096, hidden_dim=14336, head_dim=128, n_layers=32,
                        n_heads=32, n_kv_heads=8, vocab_size=32000,
                        n_experts=4, n_experts_ac=2),
    "tiny": dict(dim=256, hidden_dim=512, head_dim=64, n_layers=2,
                 n_heads=4, n_kv_heads=2, vocab_size=2048),
}
BITS = {"fp16": 16, "fp8": 8, "fp8e4": 8, "gf4": 4}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def windows(ctx: int, steps: int) -> list[tuple[str, int]]:
    """(name, pos0) of the two windows (``bench.py:254-256``): the slope
    covers positions [pos0 + steps, pos0 + 2*steps), clamped so that tiny
    contexts never start below 0."""
    return [("first32", max(0, min(2000, ctx // 2) - steps)),
            ("last32", ctx - 2 * steps - 1)]


def window_bytes(cfg: ModelConfig, kv_bits: int, pos0: int, steps: int,
                 batch: int = 1) -> int:
    """Bytes the window's ``steps`` tokens read: the weights' decode bytes
    a token and each slot's KV at its position (``bench.py:259-260``)."""
    _, bw = weight_bytes(cfg)
    return sum(bw + batch * kv_cache_bytes(cfg, kv_bits, pos0 + steps + i)
               for i in range(steps))


def _spread_pct(slopes):
    if len(slopes) < 2:
        return float("inf")
    med = statistics.median(slopes)
    return 100.0 * (max(slopes) - min(slopes)) / med


def bench_decode(cfg: ModelConfig, kv_dtype, steps: int, pos0: int,
                 repeats: int = 5, batch: int = 1, passes: int = 3,
                 max_passes: int = 6, spread_gate: float = 2.0, device="cuda"):
    """Marginal decode time a window via the slope method
    (``bench.py:68-143``): runs of ``steps`` and ``2*steps`` tokens from
    ``pos0`` differenced, so a run's fixed cost cancels. A pass takes the
    least of ``repeats`` timed runs of each length (each length's first
    run, where its step is captured, dropped); the result is the median
    of ``passes`` passes, with more passes (up to ``max_passes``) while
    their spread ((max - min) / median) exceeds ``spread_gate`` percent,
    and a warning when it still does.

    Returns (median seconds for ``steps`` tokens, spread_pct, tokens)."""
    dev = torch.device(device)
    w = synth_weights(cfg, device=dev)
    _sync(dev)
    caches: dict[int, M.KVCache] = {}
    captured = {"dropped": 0, "timed": 0}

    def run(n):
        first = n not in caches
        if first:
            caches[n] = M.KVCache.create(cfg, batch, kv_dtype, dev)
        cache = caches[n]
        best = None
        toks = None
        for r in range(repeats + (1 if first else 0)):
            cache.k.zero_()
            cache.v.zero_()
            token = torch.zeros(batch, dtype=torch.int64, device=dev)
            before = len(cache.graphs)
            _sync(dev)
            t0 = time.perf_counter()
            toks, _, _ = M.decode_loop(cfg, w, token, pos0, cache, n,
                                       rolling=pos0 + n >= cfg.seq_len)
            toks = toks.cpu()  # the result on the host: the run has ended
            dt = time.perf_counter() - t0
            new = len(cache.graphs) - before
            if first and r == 0:  # drop the capture run
                captured["dropped"] += new
            else:
                captured["timed"] += new
                best = dt if best is None else min(best, dt)
        return best, toks

    slopes = []
    toks = None
    while len(slopes) < passes or (len(slopes) < max_passes
                                   and _spread_pct(slopes) > spread_gate):
        t1, toks = run(steps)
        t2, _ = run(2 * steps)
        slopes.append(max(t2 - t1, 1e-9))

    spread = _spread_pct(slopes)
    print(f"# captured steps at pos0 {pos0}: {captured['dropped']} in the dropped first "
          f"runs of {len(caches)} lengths, {captured['timed']} in timed runs"
          + ("" if dev.type == "cuda" else " (the CPU runs eagerly)"), file=sys.stderr)
    if spread > spread_gate:
        print(f"# WARNING: slope spread {spread:.1f}% > {spread_gate:.0f}% "
              f"after {len(slopes)} passes: a noisy run, treat the number "
              f"with suspicion (passes: {[round(s * 1000, 2) for s in slopes]} ms)",
              file=sys.stderr)
    return statistics.median(slopes), spread, toks


def bench_prefill(cfg: ModelConfig, kv_dtype, T: int, repeats: int = 3, device="cuda"):
    """Marginal prefill chunk time via the same slope method
    (``bench.py:153-183``): 1-chunk and 2-chunk prompt ingestion of (1, T)
    tokens differenced, so the timed chunk is the second, attending over T
    prior rows. Returns seconds for one T-token chunk."""
    dev = torch.device(device)
    w = synth_weights(cfg, device=dev)
    tokens = torch.zeros((1, T), dtype=torch.int64, device=dev)

    def run(n_chunks):
        best = None
        for r in range(repeats + 1):
            cache = M.KVCache.create(cfg, 1, kv_dtype, dev)
            _sync(dev)
            t0 = time.perf_counter()
            logits = None
            for c in range(n_chunks):
                logits, _ = M.prefill(cfg, w, tokens, [c * T], cache, "last")
            logits.cpu()
            dt = time.perf_counter() - t0
            if r > 0:
                best = dt if best is None else min(best, dt)
            del cache
        return best

    t1 = run(1)
    t2 = run(2)
    return max(t2 - t1, 1e-9)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m calm_tpu_torch.tools.bench")
    ap.add_argument("--model", default="mistral7b", choices=sorted(SHAPES))
    ap.add_argument("--dtype", default="fp8", choices=["fp16", "fp8", "fp8e4", "gf4"])
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--ctx", type=int, default=4096)
    ap.add_argument("--kv", default="bf16", choices=["bf16", "fp16", "fp8"])
    ap.add_argument("--batch", type=int, default=1,
                    help="decode slots (batched serving throughput; the "
                         "weight stream amortizes across slots)")
    ap.add_argument("--prefill", type=int, default=0, metavar="T",
                    help="measure prompt-ingestion tok/s for a T-token "
                         "chunk instead of decode (prefill is bound by the "
                         "tensor cores, reported against their bf16 peak)")
    args = ap.parse_args(argv)

    cpu = os.environ.get("CALM_CPU", "0") == "1"
    if not cpu and not torch.cuda.is_available():
        print("bench: no CUDA GPU available (CALM_CPU=1 runs on the CPU)", file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cpu" if cpu else "cuda")
    from calm_tpu_torch import profiler
    from calm_tpu_torch.ops import qmm
    from calm_tpu_torch.parallel.mesh import detect_topology

    if os.environ.get("CALM_PRECISE", "0") == "1":
        qmm.enable_precise(True)
    topo = detect_topology() if dev.type == "cuda" else None
    kind = topo.device_kind if topo else "cpu"
    nominal = (topo.hbm_gbps_per_chip if topo else None) or profiler.CPU_HBM_GBPS
    shape = dict(SHAPES[args.model])
    cfg = ModelConfig(**shape, seq_len=args.ctx, rope_theta=10000.0,
                      norm_ln=False, dtype=args.dtype,
                      rotary_dim=shape["head_dim"])

    kv_dtype = M.KV_DTYPES[args.kv]
    kv_bits = 8 if args.kv == "fp8" else 16
    total_bytes, bw_bytes = weight_bytes(cfg)

    if args.prefill:
        if args.ctx < 2 * args.prefill:
            ap.error("--ctx must be >= 2*T so the two-chunk slope fits")
        T = args.prefill
        secs = bench_prefill(cfg, kv_dtype, T, device=dev)
        tok_s = T / secs
        # flops/token ~= 2 * active weight params, head excluded (logits
        # once a chunk); attention flops are <1% at these contexts
        bits = BITS[cfg.dtype]
        head_bytes = cfg.vocab_size * cfg.dim * bits // 8
        params_act = (bw_bytes - head_bytes) * 8 // bits
        achieved_tf = 2 * params_act * tok_s / 1e12
        peak_tf = profiler.peaks(kind)[0] / 1e12 if dev.type == "cuda" else None
        print(f"# prefill T={T}: {tok_s:.0f} tok/s, "
              f"{secs * 1000:.1f} ms/chunk, {achieved_tf:.1f} TFLOP/s"
              + (f" = {100 * achieved_tf / peak_tf:.1f}% of the bf16 tensor-core peak "
                 f"({peak_tf:.1f} TFLOP/s)" if peak_tf else ""), file=sys.stderr)
        out = {"metric": f"prefill_tok_s_{args.model}_{args.dtype}",
               "value": round(tok_s, 1), "unit": "tok/s"}
        if peak_tf:
            out["pct_mxu_peak"] = round(100 * achieved_tf / peak_tf, 2)
        print(json.dumps(out))
        return out

    if args.ctx < 2 * args.steps + 1:
        ap.error(f"--ctx must be >= 2*steps+1 ({2 * args.steps + 1}) so the "
                 "last32 slope window fits inside the context")

    results = {}
    for name, pos0 in windows(args.ctx, args.steps):
        secs, spread, _ = bench_decode(cfg, kv_dtype, args.steps, pos0,
                                       batch=args.batch, device=dev)
        read = window_bytes(cfg, kv_bits, pos0, args.steps, args.batch)
        results[name] = dict(
            tok_s=args.batch * args.steps / secs,
            gb_s=read / 1e9 / secs,
            ms_tok=secs * 1000 / args.steps,
            spread_pct=spread,
        )
        print(f"# {name}: {results[name]['tok_s']:.1f} tok/s"
              f"{f' (batch {args.batch})' if args.batch > 1 else ''}, "
              f"{results[name]['gb_s']:.1f} GB/s, "
              f"{results[name]['ms_tok']:.2f} ms/step "
              f"(median of passes, spread {spread:.1f}%)", file=sys.stderr)

    gb_s = results["first32"]["gb_s"]
    pct_sol = 100.0 * gb_s / nominal
    print(f"# chip: {kind} (SoL {nominal} GB/s); "
          f"model {args.model} {args.dtype} ({total_bytes / 2**30:.1f} GiB)",
          file=sys.stderr)
    # the attainable ceiling on this card, measured here: K1 streaming a
    # model-sized (3 GB) buffer (tools.dma_ceiling)
    attainable = None
    if dev.type == "cuda":
        from calm_tpu_torch.tools import dma_ceiling
        attainable = dma_ceiling.attainable()
        print(f"# vs measured-attainable ceiling ({attainable:.1f} GB/s, K1 3 GB read "
              f"in this process): {100.0 * gb_s / attainable:.1f}%", file=sys.stderr)

    # the reference sustains ~92% of peak HBM bandwidth on this metric (BASELINE.md)
    out = {
        "metric": f"pct_hbm_sol_{args.model}_{args.dtype}_decode",
        "value": round(pct_sol, 2),
        "unit": "% of HBM speed-of-light",
        "vs_baseline": round(pct_sol / 92.0, 4),
        "spread_pct": round(results["first32"]["spread_pct"], 2),
        "gb_s": round(gb_s, 1),
    }
    if attainable:
        out["pct_of_attainable_ceiling"] = round(100.0 * gb_s / attainable, 2)
        out["attainable_ceiling_gbps"] = round(attainable, 1)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
