"""The port's profiler and its tools against the JAX package's
(``calm_tpu/profiler.py``, ``tools/sol.py``): the analytic bytes and flops
equal JAX's exactly, the roofline and its report match given the same
rate and peak, the trace tables read a real ``profiler.trace`` and a
synthetic one's columns, ``_op_stage`` knows the port's kernels, and
``sol`` and ``perf`` run as ``python -m calm_tpu_torch.tools.<name>``
(``perf`` on the CPU under CALM_CPU=1, exit 1 without a GPU otherwise).
The wrappers' launch records (``ops/cost.py``) are checked where the CPU
can reach them: the order of the epilogue chains and the attention's
byte count."""

import contextlib
import dataclasses
import importlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from calm_tpu import config as jconfig
from calm_tpu import profiler as jprof
from calm_tpu.parallel.mesh import Topology as JTopology
from calm_tpu_torch import profiler as prof
from calm_tpu_torch.config import ModelConfig
from calm_tpu_torch.container import TensorFile
from calm_tpu_torch.ops import cost
from calm_tpu_torch.ops import hopper_attn as ha
from calm_tpu_torch.ops import hopper_qmm as hq
from calm_tpu_torch.parallel.mesh import Topology
from tests.modelgen import tiny_config, write_tiny_model

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {
    "tiny": dataclasses.asdict(tiny_config()),
    "mistral7b": dict(dim=4096, hidden_dim=14336, head_dim=128, n_layers=32, n_heads=32,
                      n_kv_heads=8, vocab_size=32000, seq_len=4096, rotary_dim=128),
    "mixtral8x7b": dict(dim=4096, hidden_dim=14336, head_dim=128, n_layers=32, n_heads=32,
                        n_kv_heads=8, vocab_size=32000, seq_len=4096, rotary_dim=128,
                        n_experts=8, n_experts_ac=2),
}
H100 = Topology(1, "NVIDIA H100 80GB HBM3", 80.0, 3350.0)


def configs(shape, dtype):
    kw = dict(SHAPES[shape], dtype=dtype)
    return ModelConfig(**kw), jconfig.ModelConfig(**kw)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("dtype", ["fp16", "fp8", "fp8e4", "gf4"])
@pytest.mark.parametrize("kv_bits", [8, 16])
@pytest.mark.parametrize("pos", [0, 100, 10 ** 6])
def test_bytes_and_flops_equal_jax(shape, dtype, kv_bits, pos):
    """stage_bytes, step_bytes and step_flops: JAX's numbers exactly, for
    dense and MoE, every weight format, both KV widths, and a position past
    seq_len (the kv_len clamp)."""
    c, jc = configs(shape, dtype)
    assert prof.stage_bytes(c, kv_bits, pos) == jprof.stage_bytes(jc, kv_bits, pos)
    assert prof.step_bytes(c, kv_bits, pos) == jprof.step_bytes(jc, kv_bits, pos)
    assert prof.step_flops(c, pos) == jprof.step_flops(jc, pos)


@pytest.mark.parametrize("rate", [100.0, 1e7])  # bandwidth-bound, compute-bound
def test_roofline_equals_jax_at_one_rate_and_peak(rate):
    """The bound and SoL of JAX's roofline on a topology of the same rate
    and peak (the "cpu" entry of both tables: 1e12 flops)."""
    c, jc = configs("mistral7b", "fp8")
    r = prof.roofline(c, 16, 100, Topology(1, "cpu", 16, rate))
    j = jprof.roofline(jc, 16, 100, JTopology(1, "cpu", 16, rate))
    assert (r.bound, r.bytes_per_token, r.flops_per_token) == (
        j.bound, j.bytes_per_token, j.flops_per_token)
    assert r.sol_ms_per_token == pytest.approx(j.sol_ms_per_token, rel=1e-12)
    assert r.bound == ("bandwidth" if rate == 100.0 else "compute")


def test_roofline_report_format():
    """The report is JAX's line for line at the same rate and peak; with
    the attainable rate it gives the achieved GB/s as its share too."""
    c, jc = configs("mixtral8x7b", "gf4")
    want = jprof.roofline_report(jc, 5.0, 16, 7, JTopology(1, "cpu", 16, 819.0))
    assert prof.roofline_report(c, 5.0, 16, 7, Topology(1, "cpu", 16, 819.0)) == want
    rep = prof.roofline_report(c, 5.0, 16, 7, H100, attainable_gbps=3200.0)
    a = prof.roofline(c, 16, 7, H100).achieved(5.0, 3200.0)
    assert rep.splitlines()[0].startswith("# roofline: NVIDIA H100 80GB HBM3, bandwidth-bound")
    assert f"= {a['pct_sol_bandwidth']:.1f}% of HBM SoL, " \
           f"{a['pct_attainable']:.1f}% of attainable 3200.0 GB/s" in rep
    assert a["pct_attainable"] == pytest.approx(a["pct_sol_bandwidth"] * 3350 / 3200)
    assert len(rep.splitlines()) == len(want.splitlines())


def test_peaks_take_the_longest_name():
    assert prof.peaks("NVIDIA H100 PCIe") == prof.PEAKS["H100 PCIe"]
    assert prof.peaks("NVIDIA H100 80GB HBM3") == prof.PEAKS["H100"]
    assert prof.peaks("NVIDIA H100 NVL") == prof.PEAKS["H100 NVL"]
    assert prof.peaks("cpu") == prof.peaks("a card of no entry") == prof.PEAKS["cpu"]


def test_parse_trace_and_table(tmp_path):
    """A real profiler.trace of a CPU matmul: parse_trace aggregates its
    events (no device events: every complete one, as JAX's parser on the
    CPU), sorted by total; trace_table formats the per-op table with the
    port's columns, and nothing of the matmul carries bytes."""
    x = torch.ones((256, 256))
    with prof.trace(str(tmp_path / "tr"), cuda=False):
        for _ in range(3):
            (x @ x + 1.0).sum()
    files = sorted(os.listdir(tmp_path / "tr"))
    assert len(files) == 2 and files[0].endswith(".launches.json")
    assert files[1].endswith(".trace.json")
    stats = prof.parse_trace(str(tmp_path / "tr"))
    assert stats and all(s.count >= 1 and s.total_us >= 0 for s in stats)
    totals = [s.total_us for s in stats]
    assert totals == sorted(totals, reverse=True)
    mm = [s for s in stats if s.name == "aten::mm"]
    assert mm and mm[0].count == 3 and mm[0].bytes == 0
    table = prof.trace_table(str(tmp_path / "tr"), tiny_config(), steps=3, topo=H100,
                             label="three CPU matmuls")
    assert "per-op table" in table and "three CPU matmuls" in table
    assert "calls" in table and "share" in table
    assert "HBM%" in table and "TC%" in table and "ALU%" in table
    assert table.splitlines()[-1] == "# rows with recorded bytes: 0.0% of the device time"


def _kernel(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": f"void (anonymous namespace)::{name}(Args)",
            "pid": 0, "tid": 7, "ts": ts, "dur": dur}


def test_trace_table_utilization_math(tmp_path):
    """A synthetic trace of the card with its launch records: each traced
    launch takes its kernel's next record (stage tag in the row's name);
    GB/s, HBM%, TC% and ALU% against the H100's rates and the bound named
    (the counterpart of tests/test_profiler.py:109)."""
    events = [
        # 2 GB in 1 ms: 2000 GB/s, 59.7% of 3350; 1e11 flops on the
        # tensor cores, 10.1% of 989.5e12 -> hbm
        _kernel("mmv_kernel<1, 0, 2, 1, false, false, false>", 0, 1000),
        # one row: 0.1 GB (3.0%), 3e10 f32 flops in 1 ms, 44.8% of 67e12 -> alu
        _kernel("qmv_kernel<1, 0>", 2000, 1000),
        # the same kernel again: its second record
        _kernel("qmv_kernel<1, 0>", 4000, 500),
        # 1e7 B, 5e11 flops on the tensor cores in 1 ms: 50.5% -> tc
        _kernel("prefill_kernel<128, 1>", 6000, 1000),
        # gf4 one row: 0.3 GB (9.0%); 1.2e9 flops + 7 ops a byte = 3.3e12/s,
        # 4.9% of 67e12 -> hbm
        _kernel("gf4_row_kernel<1>", 8000, 1000),
        # not the port's: no record, no columns
        _kernel("at::native::vectorized_elementwise_kernel<4>", 9000, 500),
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "pid": 0, "ts": 9600,
         "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1, "ts": 0, "dur": 90000},
    ]
    launches = [["mmv_kernel", "qmm_decode", 2_000_000_000, 100_000_000_000],
                ["qmv_kernel", "qx_offn_qkv", 100_000_000, 30_000_000_000],
                ["qmv_kernel", "qx_offn_qkv", 50_000_000, 15_000_000_000],
                ["prefill_kernel", "prefill_attention", 10_000_000, 500_000_000_000],
                ["gf4_row_kernel", "", 300_000_000, 1_200_000_000],
                ["norm_kernel", "qx_offn_qkv", 16, 4]]  # traced nowhere
    d = tmp_path / "tr"
    d.mkdir()
    (d / "run.trace.json").write_text(json.dumps({"traceEvents": events}))
    (d / "run.launches.json").write_text(json.dumps({"launches": launches}))
    stats = {s.name: s for s in prof.parse_trace(str(d))}
    assert "aten::mm" not in stats  # device events only
    q = stats["qmv_kernel<1, 0>__qx_offn_qkv"]
    assert (q.count, q.bytes, q.flops, q.total_us) == (2, 150_000_000, 45_000_000_000, 1500)
    table = prof.trace_table(str(d), steps=1, topo=H100)
    rows = {l.split()[1]: l for l in table.splitlines()[2:] if not l.startswith("# rows")}
    mmv = rows["mmv_kernel<1,"]
    assert " 2000  59.7  10.1   0.0  hbm (qmm_decode)" in mmv
    assert " 44.8  alu (qx_offn_qkv)" in rows["qmv_kernel<1,"]
    assert rows["prefill_kernel<128,"].rstrip().endswith("50.5   0.0  tc (prefill_attention)")
    assert "   9.0   0.0   4.9  hbm (gf4 one-row epilogue)" in rows["gf4_row_kernel<1>"]
    other = next(v for k, v in rows.items() if k.startswith("at::native::"))
    assert other.rstrip().endswith("%")  # no columns past the share
    tail = table.splitlines()
    covered = 100 * 4500 / 5100
    assert tail[-2] == f"# rows with recorded bytes: {covered:.1f}% of the device time"
    assert tail[-1] == "# recorded launches with no traced kernel: norm_kernel 1"


def test_op_stage_tags():
    """The port's kernel names resolve to stage labels (a wrapper's stage
    tag wins) and decode classes; the multi-row kernel decodes gf4 in its
    format-2 instantiations; other kernels resolve to none."""
    assert prof._op_stage("qmv_kernel<1, 0>__qx_offn_qkv") == ("qx_offn_qkv", None)
    assert prof._op_stage("qmv_kernel<1, 0>") == ("matvec", None)
    assert prof._op_stage("gf4_row_kernel<1>__gf4_offn_qkv") == ("gf4_offn_qkv", "gf4")
    assert prof._op_stage("mmv_kernel<2, 0, 1, 1, false, false, false>") == (
        "multi-row matvec", "gf4")
    assert prof._op_stage("mmv_kernel<1, 0, 1, 1, false, false, false>")[1] is None
    for name in ("gf4_mv_kernel", "moe_qmv_kernel<1, 1>", "moe_gf4_kernel<0>",
                 "gf4_mm_kernel", "attn_decode_kernel<128, 1, 4, false>", "split_kernel",
                 "fold_kernel", "prefill_kernel<128, 1>", "verify_kernel<128, 1>",
                 "norm_kernel", "allreduce_kernel", "sum_kernel<0>"):
        assert prof._op_stage(name)[0], name
    assert prof._op_stage("at::native::reduce_kernel<512, 1>") == (None, None)


def test_cost_off_by_default_and_ranges_keep_counters():
    """Outside a trace the wrappers record nothing; the ranged wrappers keep
    their launch counters and take the plain path on the CPU."""
    assert not cost.active()
    x, w = torch.ones(1, 16), torch.ones(1, 4, 16, dtype=torch.float16)
    with cost.recording() as got:
        assert cost.active()
        hq.qmm_decode(x, w, "fp16", 0)
    assert got == [] and not cost.active()
    assert hq.qmm_decode.launches == 0 and hq.qmm_decode.__wrapped__.__name__ == "qmm_decode"


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("fmt", ["fp8", "gf4"])
def test_epilogue_records_follow_the_launch_order(B, fmt):
    """The records of one epilogue call (K9/K8) in the order csrc/qmm.cu
    launches: one row wo, norm, w1/w3, w2, norm, q/k/v on the one-row
    kernel; from 2 rows each product's x staged first."""
    D, H, Qd, KVd = 64, 128, 64, 32
    with cost.recording() as got:
        cost._STAGES.append("qx_offn_qkv")
        hq._cost_epilogue(fmt, B, D, H, Qd, Qd + 2 * KVd, resid2=True)
        cost._STAGES.pop()
    k = "mmv_kernel" if B > 1 else "gf4_row_kernel" if fmt == "gf4" else "qmv_kernel"
    want = ([k, "norm_kernel", k, k, "norm_kernel", k] if B == 1 else
            ["split_kernel", k, "norm_kernel", k, "split_kernel", k, "norm_kernel", k])
    assert [g[0] for g in got] == want and {g[1] for g in got} == {"qx_offn_qkv"}
    wb = {"fp8": 1.0, "gf4": 0.5}[fmt]
    w1 = next(g for g in got if g[0] == k and g[3] == 2 * B * H * D * 2)  # the dual launch
    assert w1[2] == 2 * H * D * wb + 4 * B * (D + H)


def test_attention_record_reads_kv_len_at_the_end():
    """K12's record: q and the output in f32, each slot's K and V rows
    below kv_len, read from the tensor when the recording ends."""
    B, H, KVH, S, hd = 2, 8, 2, 64, 16
    q = torch.zeros(B, H, hd)
    k = torch.zeros(1, B, KVH, S, hd, dtype=torch.bfloat16)
    kv_len = torch.tensor([5, 9], dtype=torch.int32)
    with cost.recording() as got:
        ha._cost_attention("attn_decode_kernel", q, k, kv_len)
        kv_len += 1  # read when the recording ends: the step's own tensor
    (name, stage, nbytes, ops), = got
    assert name == "attn_decode_kernel" and stage == ""
    assert nbytes == 8 * B * H * hd + 2 * KVH * hd * 2 * (6 + 10)
    assert ops == 4 * hd * H * (6 + 10)


def _report(fn, *a):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*a)
    return out.getvalue()


@pytest.mark.parametrize("model", ["mistral7b", "mixtral8x7b", "tinyllama"])
def test_sol_lines_equal_jax(monkeypatch, model):
    """The port's sol prints JAX's lines (and -v breakdown) for a card of
    the TPU's rate and peak; its own table covers the H100s."""
    monkeypatch.setenv("CALM_NO_COMPILE_CACHE", "1")
    jsol = importlib.import_module("tools.sol")
    from calm_tpu_torch.tools import sol

    monkeypatch.setitem(sol.CARDS, "TPU v5e", (16, 819.0))
    monkeypatch.setitem(prof.PEAKS, "TPU v5e", (197e12, 6.1e12))
    for args in (("fp8", 4096, 4095, 16), ("gf4", 8192, 100, 8)):
        want = _report(jsol.report_one, model, *args, "TPU v5e", True)
        assert _report(sol.report_one, model, *args, "TPU v5e", True) == want
    assert set(sol.CARDS) >= {"H100", "H100 PCIe", "H100 NVL", "H200"}


def _run(mod, *args, cpu=None):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    if cpu is not None:
        env["CALM_CPU"] = cpu
    return subprocess.run([sys.executable, "-m", f"calm_tpu_torch.tools.{mod}", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


def test_sol_runs_anywhere():
    """sol is arithmetic only: the preset sweep, the context sweep and the
    scaling model run without a GPU."""
    r = _run("sol")
    assert r.returncode == 0, r.stderr
    assert len(r.stdout.splitlines()) == 7 * 4  # presets x cards
    r = _run("sol", "--sweep-ctx", "--model", "mistral7b", "-v")
    assert r.returncode == 0 and r.stdout.count("ctx=") == 7, r.stderr
    r = _run("sol", "--scaling")
    assert r.returncode == 0 and "NVLink" in r.stdout and "(analytic)" in r.stdout


def test_perf_on_the_cpu(tmp_path):
    """perf under CALM_CPU=1 on a tiny container: the roofline report of
    the decode (its bytes a token profiler.step_bytes'), with --attainable
    its share, and the per-op table of one eager run with --trace; and the
    prefill line."""
    path = str(tmp_path / "m.calm")
    write_tiny_model(path, tiny_config(dtype="fp8"), seed=1)
    r = _run("perf", path, "-n", "3", "--pos", "5", "--ctx", "32", "--attainable", "40",
             "--trace", str(tmp_path / "tr"), cpu="1")
    assert r.returncode == 0, r.stderr
    want = prof.step_bytes(ModelConfig.from_metadata(TensorFile(path).metadata, 32), 16, 5)
    assert f"({want / 1e9:.2f} GB/tok" in r.stdout
    assert "# achieved:" in r.stdout and "of attainable 40.0 GB/s" in r.stdout
    assert "# measured per-op table" in r.stdout and "one eager run of 3 steps" in r.stdout
    assert os.listdir(tmp_path / "tr")
    r = _run("perf", path, "--prefill", "8", "--ctx", "32", cpu="1")
    assert r.returncode == 0 and r.stdout.startswith("# prefill T=8:"), r.stderr


def test_perf_without_gpu_exits_1(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the tool would run")
    r = _run("perf", "--synthetic", "tiny", cpu="0")
    assert r.returncode == 1 and "no CUDA GPU" in r.stderr, r.stderr
    assert not r.stdout
