"""Bandwidth accounting, the roofline and trace capture on the GPU: the
port of ``calm_tpu.profiler``.

- :func:`stage_bytes`, :func:`step_bytes` and :func:`step_flops`: the
  analytic bytes and operations of one decode token, per stage, from the
  config (``calm_tpu/profiler.py:30-74``, copied as they are).
- :func:`roofline` and :func:`roofline_report`: latency >= max(bytes /
  HBM rate, operations / peak) a token against the card's data-sheet
  rates (``device.HBM_GBPS``, :data:`PEAKS`), the report with the
  attainable read rate beside the nominal one when it is given.
- :func:`trace`: ``torch.profiler`` (CPU, and CUDA where the run is on the
  card) around a block, written as a Chrome trace (``*.trace.json``,
  loadable in Perfetto) with the bytes and operations of every kernel
  launch that the wrappers recorded meanwhile (``ops/cost.py``) beside it;
  :func:`parse_trace` and :func:`trace_table` read them back as the
  per-op table: calls, mean ± std, total, share, and for the port's kernels
  GB/s, the share of the HBM rate, of the tensor cores' peak (JAX's MXU%)
  and of the f32 peak outside them (JAX's VPU%), and the unit that bounds
  the row. Inside a replayed CUDA graph no wrapper runs, so a trace that
  should carry bytes is taken over the eager step.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import glob
import json
import os
import time

import torch

from calm_tpu_torch.config import ModelConfig
from calm_tpu_torch.ops import cost
from calm_tpu_torch.parallel.mesh import Topology, detect_topology
from calm_tpu_torch.quant import dtype_bits


def stage_bytes(cfg: ModelConfig, kv_bits: int = 16, pos: int = 0,
                tied_output: bool = False) -> dict:
    """Expected HBM bytes read by one single-token decode step, per stage:
    weights at packed width, KV reads at the current length, activations
    ignored (``calm_tpu/profiler.py:30-57``)."""
    wb = dtype_bits(cfg.dtype) / 8
    D, Hd, Q, KV = cfg.dim, cfg.hidden_dim, cfg.q_dim, cfg.kv_dim
    L = cfg.n_layers
    kv_len = min(pos + 1, cfg.seq_len)
    kv_row = KV * kv_bits // 8

    s = {}
    s["embed"] = D * wb  # one row
    s["attn_norms"] = L * 2 * D * 4
    s["wqkv"] = L * (Q + 2 * KV) * D * wb
    s["kv_store"] = L * 2 * kv_row
    s["attn_read_kv"] = L * 2 * kv_row * kv_len
    s["wo"] = L * D * Q * wb
    if cfg.n_experts:
        s["moegate"] = L * cfg.n_experts * D * wb
        s["ffn"] = L * cfg.n_experts_ac * 3 * Hd * D * wb
    else:
        s["ffn"] = L * 3 * Hd * D * wb
    s["final_norm"] = D * 4
    s["lm_head"] = cfg.vocab_size * D * wb
    return s


def step_bytes(cfg: ModelConfig, kv_bits: int = 16, pos: int = 0) -> int:
    return int(sum(stage_bytes(cfg, kv_bits, pos).values()))


def step_flops(cfg: ModelConfig, pos: int = 0) -> int:
    """MAC-dominated flop count of one decode token (2 flops per MAC)."""
    D, Hd, Q, KV = cfg.dim, cfg.hidden_dim, cfg.q_dim, cfg.kv_dim
    L = cfg.n_layers
    kv_len = min(pos + 1, cfg.seq_len)
    per_layer = (Q + 2 * KV) * D + D * Q  # qkv + wo
    per_layer += 2 * Q * kv_len           # scores + mix (per q elem over kv)
    ffn = 3 * Hd * D * (cfg.n_experts_ac if cfg.n_experts else 1)
    return 2 * (L * (per_layer + ffn) + cfg.vocab_size * D)


# Peak rates of a card, dense, keyed as device.HBM_GBPS is (the longest
# substring of the device name wins): (tensor cores' bf16/f16 flops, f32
# flops outside them). NVIDIA H100 Tensor Core GPU data sheet: SXM 1979 and
# 67 TFLOPS, PCIe 1513 and 51, NVL 1671 and 60; NVIDIA H200 data sheet: SXM
# 1979 and 67. The data sheets' tensor-core figures are with sparsity,
# twice the dense rate, so they are halved here. "cpu": the JAX table's
# stand-in for a host (``calm_tpu/profiler.py:104``, its VPU table's
# ``:264``), with its 50 GB/s (``calm_tpu/chip.py``) where the topology
# names no rate.
PEAKS = {
    "H100 NVL": (835.5e12, 60e12),
    "H100 PCIe": (756.5e12, 51e12),
    "H100": (989.5e12, 67e12),
    "H200": (989.5e12, 67e12),
    "cpu": (1e12, 1e11),
}
CPU_HBM_GBPS = 50.0


def peaks(kind: str) -> tuple[float, float]:
    """(tensor-core, f32) peak flops of a device kind: the longest key of
    :data:`PEAKS` in its name, else the "cpu" entry."""
    best = max((k for k in PEAKS if k in kind), key=len, default="cpu")
    return PEAKS[best]


def hbm_rate(topo: Topology) -> float:
    """The topology's nominal HBM rate in GB/s (a host's stand-in when it
    names none)."""
    return topo.hbm_gbps_per_chip or CPU_HBM_GBPS


@dataclasses.dataclass
class Roofline:
    sol_ms_per_token: float
    bound: str               # "bandwidth" | "compute"
    bytes_per_token: int
    flops_per_token: int
    topo: Topology

    def achieved(self, ms_per_token: float, attainable_gbps: float | None = None) -> dict:
        gbs = self.bytes_per_token / 1e9 / (ms_per_token / 1000)
        out = {
            "ms_per_token": ms_per_token,
            "tok_s": 1000.0 / ms_per_token,
            "achieved_gb_s": gbs,
            "pct_sol_bandwidth": 100.0 * gbs / hbm_rate(self.topo),
            "pct_sol_latency": 100.0 * self.sol_ms_per_token / ms_per_token,
        }
        if attainable_gbps:
            out["pct_attainable"] = 100.0 * gbs / attainable_gbps
        return out


def roofline(cfg: ModelConfig, kv_bits: int = 16, pos: int = 0,
             topo: Topology | None = None) -> Roofline:
    topo = topo or detect_topology()
    b = step_bytes(cfg, kv_bits, pos)
    f = step_flops(cfg, pos)
    t_bw = b / (hbm_rate(topo) * 1e9)
    t_fl = f / peaks(topo.device_kind)[0]
    return Roofline(sol_ms_per_token=max(t_bw, t_fl) * 1000,
                    bound="bandwidth" if t_bw >= t_fl else "compute",
                    bytes_per_token=b, flops_per_token=f, topo=topo)


def roofline_report(cfg: ModelConfig, ms_per_token: float, kv_bits: int = 16,
                    pos: int = 0, topo: Topology | None = None,
                    attainable_gbps: float | None = None) -> str:
    """The achieved-against-SoL report (``calm_tpu/profiler.py:125-143``);
    with ``attainable_gbps`` (the card's measured read rate, K1's) the
    achieved GB/s is also given as its share of that rate."""
    r = roofline(cfg, kv_bits, pos, topo)
    a = r.achieved(ms_per_token, attainable_gbps)
    stages = stage_bytes(cfg, kv_bits, pos)
    total = sum(stages.values())
    rate = hbm_rate(r.topo)
    att = (f", {a['pct_attainable']:.1f}% of attainable {attainable_gbps:.1f} GB/s"
           if attainable_gbps else "")
    lines = [
        f"# roofline: {r.topo.device_kind}, {r.bound}-bound, "
        f"SoL {r.sol_ms_per_token:.2f} ms/tok "
        f"({r.bytes_per_token / 1e9:.2f} GB/tok, {r.flops_per_token / 1e9:.1f} GFLOP/tok)",
        f"# achieved: {a['ms_per_token']:.2f} ms/tok ({a['tok_s']:.1f} tok/s), "
        f"{a['achieved_gb_s']:.0f} GB/s = {a['pct_sol_bandwidth']:.1f}% of HBM SoL" + att,
    ]
    for name, b in sorted(stages.items(), key=lambda kv: -kv[1]):
        sol_us = b / (rate * 1e9) * 1e6
        lines.append(f"#   {name:<14} {b / 1e6:8.2f} MB/tok  "
                     f"SoL {sol_us:7.1f} us  ({100 * b / total:4.1f}%)")
    return "\n".join(lines)


@contextlib.contextmanager
def trace(path: str = "calm_trace", cuda: bool | None = None):
    """torch.profiler around a block: CPU activity, and CUDA (CUPTI) when
    ``cuda`` (default: a GPU is present). Writes ``<run>.trace.json`` under
    ``path`` and beside it ``<run>.launches.json``, every kernel launch the
    wrappers recorded in the block (kernel, stage, bytes, operations) in
    launch order."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available() if cuda is None else cuda
    os.makedirs(path, exist_ok=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    # the recording ends after the profile: it reads the device values
    # outside the trace
    with cost.recording() as launches, profile(activities=acts) as prof:
        try:
            yield path
        finally:
            if cuda:
                torch.cuda.synchronize()
    run = os.path.join(path, f"calm_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}")
    while os.path.exists(run + ".trace.json"):
        run += "_"
    prof.export_chrome_trace(run + ".trace.json")
    with open(run + ".launches.json", "w") as f:
        json.dump({"launches": launches}, f)


@dataclasses.dataclass
class OpStat:
    """Aggregated per-op timing from a captured trace (one row of the
    cudaprof-style table: count / mean / stddev / total / share)."""

    name: str
    count: int = 0
    total_us: float = 0.0
    bytes: int = 0    # summed bytes of the launches the wrappers recorded
    flops: int = 0    # summed operations of those launches (2 a multiply-add)
    transc: int = 0   # transcendentals (kept for the JAX table's shape; none
                      # are recorded)
    _m2: float = 0.0  # sum of squared durations (for the ±std column)

    @property
    def mean_us(self) -> float:
        return self.total_us / max(self.count, 1)

    @property
    def std_us(self) -> float:
        if self.count < 2:
            return 0.0
        var = self._m2 / self.count - self.mean_us ** 2
        return max(var, 0.0) ** 0.5


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def short_name(kernel: str) -> str:
    """'void (anonymous namespace)::qmv_kernel<1, 0>(Args)' ->
    'qmv_kernel<1, 0>'."""
    k = kernel.replace("(anonymous namespace)::", "").removeprefix("void ")
    return k.split("(")[0][:60]


def base_name(name: str) -> str:
    """A kernel's name without its template arguments and stage tag."""
    return name.split("__")[0].split("<")[0]


def _read(trace_dir: str) -> tuple[list[OpStat], dict]:
    """Per-op aggregates of every trace under ``trace_dir``, and the
    recorded launches that met no kernel of their name ({kernel: count},
    empty when the join is whole)."""
    files = sorted(glob.glob(os.path.join(trace_dir, "**", "*.trace.json"),
                             recursive=True))
    stats: dict[str, OpStat] = {}
    left: dict[str, int] = {}
    for fn in files:
        with open(fn) as f:
            events = json.load(f).get("traceEvents", [])
        side = fn[:-len(".trace.json")] + ".launches.json"
        queues = collections.defaultdict(collections.deque)
        if os.path.exists(side):
            with open(side) as f:
                for kernel, stage, nbytes, ops in json.load(f)["launches"]:
                    queues[kernel].append((stage, nbytes, ops))
        done = [ev for ev in events if ev.get("ph") == "X" and "dur" in ev]
        dev = [ev for ev in done if ev.get("cat") in _DEVICE_CATS]
        # a trace from the CPU alone: every complete event, as the JAX
        # parser falls back to every pid
        for ev in sorted(dev, key=lambda e: float(e.get("ts", 0))) if dev else done:
            name = short_name(str(ev.get("name", "?"))) if dev else str(ev.get("name", "?"))
            q = queues.get(base_name(name)) if ev.get("cat") == "kernel" else None
            rec = q.popleft() if q else None
            if rec and rec[0]:
                name = f"{name}__{rec[0]}"
            st = stats.get(name)
            if st is None:
                st = stats[name] = OpStat(name)
            dur = float(ev["dur"])  # us
            st.count += 1
            st.total_us += dur
            st._m2 += dur * dur
            if rec:
                st.bytes += int(rec[1])
                st.flops += int(rec[2])
        for kernel, q in queues.items():
            if q:
                left[kernel] = left.get(kernel, 0) + len(q)
    return sorted(stats.values(), key=lambda s: -s.total_us), left


def parse_trace(trace_dir: str) -> list[OpStat]:
    """Per-op aggregates of the traces :func:`trace` wrote under
    ``trace_dir``, largest total first. On a trace from the card the ops
    are its device events (``cat`` kernel, gpu_memcpy or gpu_memset, each
    kernel under its short name); with none (a CPU trace) every complete
    event. The n-th traced launch of one of the port's kernels takes the
    n-th recorded launch of that kernel (one stream runs them in launch
    order): its bytes and operations, and its stage as a ``__<stage>``
    tag of the row's name, as JAX's kernels carry theirs
    (``_qmm__wqkv``)."""
    return _read(trace_dir)[0]


# ALU operations a byte of gf4 words costs to decode (about 3.5
# instructions a weight in the one-row gf4 kernel, csrc/qmm.cu), charged
# to the f32/ALU column beside the products' own (the counterpart of JAX's
# VPU decode charge, ``calm_tpu/profiler.py:276-281``).
_ALU_DECODE_OPS_PER_BYTE = {"gf4": 7.0}

# kernel -> (stage label, decode class, unit of its multiply-adds: "tc" the
# tensor cores, "alu" f32 outside them). A ``__<stage>`` tag (the wrapper
# that launched it) wins over the label.
_KERNEL_STAGES = {
    "qmv_kernel": ("matvec", None, "alu"),
    "mmv_kernel": ("multi-row matvec", None, "tc"),
    "gf4_mv_kernel": ("gf4 matvec", "gf4", "alu"),
    "gf4_row_kernel": ("gf4 one-row epilogue", "gf4", "alu"),
    "moe_qmv_kernel": ("moe expert matvec", None, "alu"),
    "moe_gf4_kernel": ("gf4 moe ffn", "gf4", "alu"),
    "gf4_mm_kernel": ("gf4 matmul", "gf4", "tc"),
    "mm8_kernel": ("matmul", None, "tc"),
    "attn_decode_kernel": ("decode attention", None, "alu"),
    "prefill_kernel": ("prefill attention", None, "tc"),
    "verify_kernel": ("verify attention", None, "tc"),
    "split_kernel": ("x staged", None, "alu"),
    "norm_kernel": ("norm", None, "alu"),
    "sum_kernel": ("stream sum", None, "alu"),
    "fold_kernel": ("stream fold", None, "alu"),
    "allreduce_kernel": ("all-reduce", None, "alu"),
}


def _op_stage(name: str):
    """(stage label, decode class) of a traced op's name: the ``__<stage>``
    tag where the row has one (``qmv_kernel<1, 0>__qx_offn_qkv`` ->
    ``qx_offn_qkv``), else the kernel's own label; (None, None) for the
    kernels that are not the port's. The multi-row kernel decodes gf4
    words in its gf4 instantiations (format 2, its first template
    argument)."""
    base = base_name(name)
    if base not in _KERNEL_STAGES:
        return None, None
    label, decode, _ = _KERNEL_STAGES[base]
    if base == "mmv_kernel" and name.startswith("mmv_kernel<2,"):
        decode = "gf4"
    if "__" in name:
        label = name.rsplit("__", 1)[1]
    return label, decode


def trace_table(trace_dir: str, cfg: ModelConfig | None = None,
                steps: int = 1, kv_bits: int = 16, pos: int = 0,
                top: int = 16, topo: Topology | None = None, label: str = "") -> str:
    """The measured per-op table (``calm_tpu/profiler.py:284-350``): calls,
    mean ± std, total ms, share, and for a row with recorded bytes its
    GB/s, HBM%, TC% (operations on the tensor cores against their peak,
    JAX's MXU%), ALU% (f32 operations outside them and the gf4 decode
    against the f32 peak, JAX's VPU%) and the unit that bounds it, with the
    stage. ``label`` says what was traced (the eager step, where the bytes
    come from). Below the rows: the share of the device time in rows with
    recorded bytes, and any recorded launch that met no traced kernel."""
    stats, left = _read(trace_dir)
    if not stats:
        return "# trace: no device events found"
    total = sum(s.total_us for s in stats)
    del cfg, kv_bits, pos  # kept for the JAX signature; bytes come from the launches
    topo = topo or detect_topology()
    hbm_peak = hbm_rate(topo) * 1e9
    tc_peak, alu_peak = peaks(topo.device_kind)
    lines = [f"# measured per-op table ({trace_dir}{'; ' + label if label else ''}; "
             f"device total {total / 1000:.2f} ms over {steps} step(s))"]
    lines.append(f"# {'op':<40} {'calls':>6} {'mean us':>8} {'±std':>6} "
                 f"{'total ms':>8} {'share':>6} {'GB/s':>5} {'HBM%':>5} "
                 f"{'TC%':>5} {'ALU%':>5}  bound")
    covered = 0.0
    for s in stats:
        covered += s.total_us if s.bytes else 0.0
    for s in stats[:top]:
        sec = s.total_us / 1e6
        big = s.bytes > 0 and s.total_us > 0
        tail = ""
        if big:
            stage, decode = _op_stage(s.name)
            unit = _KERNEL_STAGES.get(base_name(s.name), (None, None, "alu"))[2]
            gbs = s.bytes / 1e9 / sec
            hbm = 100.0 * s.bytes / sec / hbm_peak
            tc = 100.0 * s.flops / sec / tc_peak if unit == "tc" else 0.0
            alu_ops = s.flops if unit == "alu" else 0.0
            if decode:
                alu_ops += _ALU_DECODE_OPS_PER_BYTE[decode] * s.bytes
            alu = 100.0 * alu_ops / sec / alu_peak
            units = {"hbm": hbm, "tc": tc, "alu": alu}
            bound = max(units, key=units.get)
            tail = (f"{gbs:5.0f} {hbm:5.1f} {tc:5.1f} {alu:5.1f}  {bound}"
                    + (f" ({stage})" if stage else ""))
        nm = s.name if len(s.name) <= 40 else s.name[:37] + "..."
        lines.append(f"# {nm:<40} {s.count:>6} {s.mean_us:>8.1f} "
                     f"{s.std_us:>6.1f} {s.total_us / 1000:>8.2f} "
                     f"{100 * s.total_us / total:>5.1f}% {tail}")
    lines.append(f"# rows with recorded bytes: {100 * covered / total:.1f}% of the "
                 f"device time")
    if left:
        lines.append("# recorded launches with no traced kernel: "
                     + ", ".join(f"{k} {n}" for k, n in sorted(left.items())))
    return "\n".join(lines)
