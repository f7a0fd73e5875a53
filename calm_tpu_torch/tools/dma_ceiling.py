"""The card's attainable HBM read rate, from a streaming read (the port of
``tools/dma_ceiling.py``).

    python -m calm_tpu_torch.tools.dma_ceiling

For each (L, 16384, 512) int32 buffer -- 32 MB, 512 MB and 3 GB, the
size a 7B fp8 decode step streams -- it times chains of n1 and n2 calls of
``stream_sum`` (K1, ``csrc/stream.cu``), each call's seed the previous
call's result, and prints the slope (t2 - t1) / (n2 - n1) as ms a pass
and GB/s. A chain is captured once as a CUDA graph and timed with CUDA
events around its replay, least of 5, so that the host's pace between
calls does not enter (the TPU tool runs its chain inside one jitted
scan). ``td`` is the TPU tool's row tile, printed so that the lines pair
with its output; the port's kernel takes its own blocks, about four on
each SM, so a buffer is timed once and its rate printed on each of its td
lines.

On an H100 the 32 MB buffer fits in the 50 MB L2 cache, so that line
measures L2, not HBM; the 3 GB lines give the attainable HBM read rate.
Needs a CUDA GPU: without one it exits 1 ("no CUDA GPU").
"""

from __future__ import annotations

import sys

import torch

from calm_tpu_torch.ops.hopper_stream import stream_sum

D, G = 16384, 512  # rows of a layer, words a row
ROWS = (  # (GiB, tds, (n1, n2)) as tools/dma_ceiling.py:73-78
    (0.03125, (2048,), (16, 144)),  # 32 MB: in L2 on an H100
    (0.5, (2048,), (2, 18)),        # 512 MB
    (3.0, (2048, 8192), (1, 4)),    # 3 GB: one 7B fp8 model
)


def require_gpu(tool: str) -> None:
    if not torch.cuda.is_available():
        print(f"{tool}: no CUDA GPU available", file=sys.stderr)
        sys.exit(1)


def time_chain(call, n: int, reps: int = 5) -> float:
    """Least ms over ``reps`` replays of a CUDA graph of ``n`` chained
    calls; ``call(s)`` returns a (1,) result from the previous one."""
    seed = torch.zeros(1, device="cuda")
    call(seed)  # builds and loads the kernels outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        s = seed
        for _ in range(n):
            s = call(s)
    graph.replay()  # warm
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    best = float("inf")
    for _ in range(reps):
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def stream_rate(gib: float, n1: int, n2: int) -> tuple[float, float]:
    """(MB, ms a pass) of one (L, D, G) buffer of ``gib`` GiB: the slope
    of chains of ``n1`` and ``n2`` calls."""
    L = max(1, int(gib * (1 << 30)) // (G * 4 * D))
    w = torch.arange(G, dtype=torch.int32, device="cuda").expand(L, D, G).contiguous()
    mb = w.numel() * 4 / 1e6

    def call(s):
        return stream_sum(w, s)
    per = (time_chain(call, n2) - time_chain(call, n1)) / (n2 - n1)
    del w
    torch.cuda.empty_cache()
    return mb, per


def attainable() -> float:
    """The attainable HBM read rate in GB/s: the 3 GB buffer's line (the
    size a 7B fp8 decode step streams), for a tool that reads its own
    rate against it in the same process."""
    gib, _, (n1, n2) = ROWS[-1]
    mb, per = stream_rate(gib, n1, n2)
    return mb / per


def main() -> list[dict]:
    """Print one line a buffer; returns the rows (mb, td, ms, gb_s)."""
    require_gpu("dma_ceiling")
    out = []
    for gib, tds, (n1, n2) in ROWS:
        mb, ms = stream_rate(gib, n1, n2)
        gb_s = mb / ms
        for td in tds:
            print(f"buf {mb:7.0f} MB td={td}: {ms:8.2f} ms/pass "
                  f"{gb_s:5.0f} GB/s", flush=True)
            out.append(dict(mb=mb, td=td, ms=ms, gb_s=gb_s))
    return out


if __name__ == "__main__":
    main()
