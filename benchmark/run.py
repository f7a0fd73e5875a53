"""Run one cell of the benchmark and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's file ``workloads/<cell>.json`` names its configuration
(``configs/<config>.json``), its traffic driver (``traffic/<driver>.py``:
``setup(ctx)`` builds the program and warms up the shapes the traffic
uses, ``window(ctx)`` drives it for ``ctx.seconds`` and fills the
context's metrics, finished requests and traced work), the driver's
parameters, its end-to-end metrics, its per-layer metrics (each read by
``metrics/<name>.py``: ``read(readings)`` returns the number, or None
where the run holds nothing to read, and ``UNIT`` is its unit), the
requests its check samples and the limits of the check. Adding a cell,
a configuration, a driver or a metric adds files and edits none.

A run: the weights are made on the card from the seed, the driver builds
the program and warms up the shapes this cell's traffic uses (set-up,
timed as ``setup_s`` from the start of the process), then the driver's
window runs for ``--seconds``. With ``--trace 1`` the driver traces a
slice of the window and the per-layer metrics are read from it; with
``--trace 0`` the end-to-end metrics are reported. Once the window has
closed, the run checks that no JAX module was loaded, reads the memory
peak, frees the program, and runs the reference over a sample of the
requests the window finished (``benchmark.reference``). Once the metric
readers and the reference have run too, it checks again: a run that
loaded a JAX module anywhere gives no result. The numbers compared go,
each beside its limit, on the last lines of standard error and under
``compared``, the last key of the result line; the result line is the
last line of standard output.

Without a CUDA card, or with fewer than the cell asks for, it exits 2
and prints no result; it never falls back to the CPU.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse
import dataclasses
import gc
import importlib.util
import json
import os
import random
import subprocess
import sys

import numpy as np
import torch

from benchmark import program
from benchmark import trace as T
from benchmark import weights as W
from benchmark.reference.compare import Served, control_stats, served
from benchmark.reference.model import CONTROLS
from benchmark.roofline import Work

ROOT = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "calm_tpu")


def load_json(root: str, kind: str, name: str) -> dict:
    with open(os.path.join(root, kind, f"{name}.json")) as f:
        return json.load(f)


def load_module(root: str, kind: str, name: str):
    """``<root>/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(root, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name}".replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Readings:
    """What the per-layer metric readers read: the traced slice's summary
    and work, and the host's tick spans outside the slice."""

    summary: T.Summary | None
    work: Work
    ticks: list  # (kind, ms): kind "admit" for a tick that admitted a request


class Context:
    """One run's state, shared by the harness and its traffic driver."""

    def __init__(self, cell: dict, dims: W.Dims, seed: int, seconds: float,
                 trace: bool, device):
        self.cell, self.d, self.seed, self.seconds = cell, dims, seed, seconds
        self.params = cell["params"]
        self.device = torch.device(device)
        self.rng = np.random.default_rng(seed)
        self.slice = T.Slice() if trace and self.device.type == "cuda" else None
        self.work = Work()          # the traced slice's work
        self.ticks: list = []       # (kind, ms) outside the traced slice
        self.finished: list = []    # dicts: text, ids (the program's prompt ids), served
        self.metrics: dict = {}     # end-to-end name -> (value, unit)
        self.attempted = 0
        self.failed = 0
        self.program = None         # what the driver built; freed before the check
        self.state = None           # the driver's own state; freed with it
        self.phases: list = []      # set-up's parts: (name, seconds)
        self._t = time.perf_counter()

    def phase(self, name: str) -> None:
        """End a part of set-up (after a sync) and keep its seconds."""
        self.sync()
        now = time.perf_counter()
        self.phases.append((name, now - self._t))
        self._t = now

    def engine(self, batch: int):
        """The program's Engine on the weights for this seed, timed as
        set-up's "weights" and "engine" parts."""
        w = W.stacks(self.d, self.seed, self.device)
        self.phase("weights")
        eng = program.engine(self.d, w, self.device, batch)
        self.phase("engine")
        return eng

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def info(self, msg: str) -> None:
        print(f"# {msg}", file=sys.stderr, flush=True)


def _card_line(query: str = "name,power.limit,clocks.sm,clocks.max.sm") -> str:
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi not found"


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def no_forbidden_modules() -> None:
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"modules of JAX or the JAX package were loaded: {bad}")


def _host_line(cpu0: float, wall0: float) -> str:
    """The host beside the card: this process's CPU seconds over the
    window's wall seconds, and the milliseconds a fixed pure-Python loop
    takes now (a slower or busier host reads higher)."""
    cpu, wall = time.process_time() - cpu0, time.perf_counter() - wall0
    t = time.perf_counter()
    sum(i * i for i in range(1_000_000))
    probe = (time.perf_counter() - t) * 1e3
    return (f"host over the window: CPU {cpu:.3f} s of {wall:.3f} s ({100 * cpu / wall:.1f}%), "
            f"probe loop {probe:.3f} ms")


def sample(ctx: Context, n: int) -> list[dict]:
    """The requests the check runs: the longest served, then others drawn
    from the seed."""
    done = sorted(ctx.finished, key=lambda r: -len(r["served"]))
    if not done:
        return []
    rest = done[1:]
    random.Random(ctx.seed ^ 0x5EED).shuffle(rest)
    return [done[0]] + rest[:max(0, n - 1)]


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device="cuda",
             root: str = ROOT, t_start: float | None = None,
             control: bool = False) -> dict:
    """Run one cell and return its result (the result line's object, with
    ``compared`` last; with ``control`` also every number the check reads
    under ``readings`` and each control's under ``controls``, which the
    result line never carries)."""
    t_start = T_START if t_start is None else t_start
    cell = load_json(root, "workloads", name)
    dims = W.Dims.from_json(load_json(root, "configs", cell["config"]))
    driver = load_module(root, "traffic", cell["driver"])
    ctx = Context(cell, dims, seed, seconds, trace, device)
    ctx.phases.append(("start and imports", ctx._t - t_start))
    if ctx.device.type == "cuda":
        ctx.info(f"card: {_card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
        ctx.phase("card query")
    driver.setup(ctx)
    ctx.phase("warm-up")
    if ctx.slice:
        ctx.slice.warm()
        ctx.phase("profiler")
    setup_s = time.perf_counter() - t_start
    ctx.info(f"set-up {setup_s:.3f} s: " + ", ".join(f"{n} {s:.3f} s" for n, s in ctx.phases))
    ctx.ticks.clear()  # the readers read the window's ticks, not set-up's
    cpu0, wall0 = time.process_time(), time.perf_counter()
    driver.window(ctx)
    ctx.sync()
    ctx.info(_host_line(cpu0, wall0))
    if ctx.device.type == "cuda":
        ctx.info("card at the close (SM, memory MHz, W, C): "
                 + _card_line("clocks.sm,clocks.mem,power.draw,temperature.gpu"))
    for kind in ("admit", "decode"):
        ms = sorted(m for k, m in ctx.ticks if k == kind)
        if ms:
            ctx.info(f"{kind} ticks outside the traced slice: {len(ms)}, median "
                     f"{ms[len(ms) // 2]:.3f} ms, max {ms[-1]:.3f} ms, sum {sum(ms) / 1e3:.3f} s")

    no_forbidden_modules()
    cuda = ctx.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
    ctx.program = ctx.state = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the check: the benchmark's own tokenization of each prompt, then the
    # reference over a sample of the finished requests
    check = cell["check"]
    chosen = sample(ctx, check["requests"])
    mismatched = sum(r["ids"] != W.encode(r["text"]) for r in chosen)
    picked = [Served(W.encode(r["text"]), r["served"]) for r in chosen if r["served"]]
    t_ref = time.perf_counter()
    if picked:
        read, ref = served(dims, seed, picked, ctx.device)
    else:
        read, ref = {"max_logit_gap": float("inf"), "mean_logit_gap": float("inf"),
                     "tokens": 0}, None
    ctx.info(f"reference: {len(picked)} requests, {read['tokens']} served tokens, "
             f"{time.perf_counter() - t_ref:.3f} s; widest gap {read['max_logit_gap']}, "
             f"mean {read['mean_logit_gap']}")
    limits = check["limits"]
    compared = {k: {"value": read[k], "limit": v} for k, v in limits.items()}
    compared["prompt_ids_differing"] = {"value": mismatched, "limit": 0}
    compared["requests_checked"] = {"value": len(picked), "limit": 1, "at_least": True}
    correct = (all(read[k] <= v for k, v in limits.items()) and mismatched == 0
               and len(picked) >= 1)

    if trace:
        r = Readings(ctx.slice.summary if ctx.slice else None, ctx.work, ctx.ticks)
        metrics = {}
        for m in cell["per_layer"]:
            mod = load_module(root, "metrics", m)
            v = mod.read(r)
            if v is not None:
                metrics[m] = {"value": v, "unit": mod.UNIT}
        if ctx.slice and ctx.slice.summary:
            ctx.info(f"traced slice: {ctx.slice.summary.window_s:.3f} s, busy "
                     f"{ctx.slice.summary.busy_s:.3f} s, bound {ctx.work.bound_s:.3f} s "
                     f"({ctx.work.governs()}), {ctx.work.prefills} prefills and "
                     f"{ctx.work.decode_steps} decode steps; read in {ctx.slice.read_s:.3f} s")
    else:
        metrics = {k: {"value": v, "unit": u} for k, (v, u) in ctx.metrics.items()}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(ctx.device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    if trace and ctx.slice and ctx.slice.summary:
        dev["busy_s"] = ctx.slice.summary.busy_s
        dev["window_s"] = ctx.slice.summary.window_s
    result = {"correct": bool(correct), "attempted": ctx.attempted, "failed": ctx.failed,
              "metrics": metrics, "device": dev}
    if trace and ctx.slice and ctx.slice.summary:
        result["breakdown"] = {"device_ops": ctx.slice.summary.device_ops,
                               "idle_gaps": ctx.slice.summary.idle_gaps}
    if control:
        result["readings"] = read
        result["controls"] = {c: control_stats(dims, seed, picked, ctx.device, ref, c)
                              for c in CONTROLS if c}
    result["compared"] = compared
    no_forbidden_modules()
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_json(ROOT, "workloads", args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: the cell needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    for k, c in result["compared"].items():
        op = ">=" if c.get("at_least") else "<="
        print(f"# compared {k}: {c['value']} (limit {op} {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
