"""Readings that set a cell's limit: the sound program's widest logit gap
and the control's, on many seeds in one process (set-up is long, so one
process reads them all).

    python3 -m benchmark.control --workload <cell> --seeds 11,12,13 --seconds 8

For each seed the cell runs as ``benchmark.run`` runs it (its weights,
traffic, window and check at the cell's own size) and then the control:
each of the reference's lower precisions (its KV cache at fp8 e5m2, its
weights at 4 bits), at the same prompts and served tokens
(``reference.compare.control_stats``). Prints one JSON line a seed, then
the largest sound gap and each control's smallest. The
benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark.run import run_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    sound, low = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        r = run_cell(args.workload, seed, args.seconds, False, control=True,
                     t_start=time.perf_counter())
        row = {"seed": seed, "correct": r["correct"], "readings": r["readings"],
               "controls": r["controls"],
               "requests": r["compared"]["requests_checked"]["value"],
               "metrics": {k: v["value"] for k, v in r["metrics"].items()}}
        print(json.dumps(row), flush=True)
        for k in ("max_logit_gap", "mean_logit_gap"):
            sound.setdefault(k, []).append(r["readings"][k])
            for c, v in r["controls"].items():
                low.setdefault(c, {}).setdefault(k, []).append(v[k])
    print(json.dumps({"workload": args.workload, "seeds": len(sound["max_logit_gap"]),
                      "sound_largest": {k: max(v) for k, v in sound.items()},
                      "control_smallest": {c: {k: min(v) for k, v in x.items()}
                                           for c, x in low.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
