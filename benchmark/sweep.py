"""Find an open-loop cell's knee: the highest rate it sustains with no
growing backlog, by one sweep on the card.

    python3 -m benchmark.sweep --workload mistral7b.chat --seed 7 --seconds 30 --rates 4,6,8

One set-up, then the cell's window at each rate in turn (``window(ctx,
rate)`` of its driver), the server drained between them. A rate passes
when fewer than a quarter of the slots' worth of requests still wait
without a token when the window closes and the queue's mean over the
window's last third is at most one more than over its first third. Prints
a line a rate and the knee; the cell's file then takes 0.8 x the knee as
its ``rate``.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark import weights as W
from benchmark.run import ROOT, Context, load_json, load_module


def passes(row: dict, slots: int) -> bool:
    return (row["waiting"] < max(1, slots // 4)
            and row["queue_last_third"] <= row["queue_first_third"] + 1.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True, help="comma-separated requests a second")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 2
    cell = load_json(ROOT, "workloads", args.workload)
    dims = W.Dims.from_json(load_json(ROOT, "configs", cell["config"]))
    driver = load_module(ROOT, "traffic", cell["driver"])
    ctx = Context(cell, dims, args.seed, args.seconds, False, "cuda")
    driver.setup(ctx)
    knee = None
    for rate in (float(r) for r in args.rates.split(",")):
        row = driver.window(ctx, rate)
        row.pop("drv").drain()
        row["passes"] = passes(row, ctx.params["slots"])
        print(json.dumps(row), flush=True)
        if row["passes"]:
            knee = rate
    print(json.dumps({"workload": args.workload, "knee": knee,
                      "rate_at_0.8": None if knee is None else 0.8 * knee}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
