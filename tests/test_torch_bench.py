"""The bench tool on the port (``calm_tpu_torch.tools.bench``) against
``bench.py``: the same shapes (the one table ``tools.perf`` reads too),
the same windows and GB/s arithmetic on the same inputs (each module's
``bench_decode`` replaced by one recorder that returns fixed times, so
both ``main``s print what their arithmetic makes of them), and JAX's JSON
keys on the decode and ``--prefill`` lines of a real run on the CPU's
plain path (``CALM_CPU=1 --model tiny``)."""

import contextlib
import importlib
import io
import json
import re

import pytest
import torch

from calm_tpu_torch.tools import bench as TB
from calm_tpu_torch.tools import perf

torch.set_num_threads(1)


@pytest.fixture
def jbench(monkeypatch):
    monkeypatch.setenv("CALM_NO_COMPILE_CACHE", "1")
    return importlib.import_module("bench")


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        main(argv)
    return json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue()


def test_shapes_are_bench_py_s(jbench):
    assert TB.SHAPES == jbench.SHAPES
    assert perf.SHAPES is TB.SHAPES


@pytest.mark.parametrize("argv", [
    ["--model", "mistral7b"],
    ["--model", "mistral7b", "--dtype", "gf4", "--kv", "fp8"],
    ["--model", "mixtral8x7b", "--dtype", "fp16", "--batch", "4"],
    ["--model", "llama2-13b", "--kv", "fp16", "--ctx", "8192", "--steps", "16"],
    ["--model", "tiny", "--ctx", "100", "--steps", "32"],
    ["--model", "tiny", "--ctx", "65", "--steps", "32"],
], ids=lambda a: "_".join(a).replace("--", ""))
def test_windows_and_rates_are_bench_py_s(jbench, monkeypatch, argv):
    """Both mains on one recorder's times: the same windows (each call's
    steps, pos0 and batch) and the same tok/s, GB/s and ms/step lines,
    spread and GB/s in the JSON."""
    calls = {"jax": [], "port": []}

    def recorder(side):
        def bench_decode(cfg, kv_dtype, steps, pos0, repeats=5, batch=1, **kw):
            calls[side].append((cfg.n_layers, cfg.dim, steps, pos0, batch))
            return 0.05 + 1e-5 * pos0, 1.25 + pos0 % 7, None
        return bench_decode
    monkeypatch.setattr(jbench, "bench_decode", recorder("jax"))
    monkeypatch.setattr(TB, "bench_decode", recorder("port"))
    monkeypatch.setenv("CALM_CPU", "1")
    jj, je = _run(jbench.main, argv)
    tj, te = _run(TB.main, argv)
    assert calls["jax"] == calls["port"] and len(calls["port"]) == 2
    opt = dict(zip(argv[::2], argv[1::2]))
    want = TB.windows(int(opt.get("--ctx", 4096)), int(opt.get("--steps", 32)))
    assert [c[3] for c in calls["port"]] == [p for _, p in want]
    pat = r"^# (first32|last32): .*$"
    assert re.findall(pat, je, re.M) == re.findall(pat, te, re.M)
    assert [l for l in je.splitlines() if l.startswith("# first32")] == \
        [l for l in te.splitlines() if l.startswith("# first32")]
    for k in ("spread_pct", "gb_s", "metric", "unit"):
        assert jj[k] == tj[k], k
    assert set(jj) == set(tj)


def test_prefill_arithmetic_is_bench_py_s(jbench, monkeypatch):
    monkeypatch.setattr(jbench, "bench_prefill", lambda cfg, kv, T, repeats=3: 0.125)
    monkeypatch.setattr(TB, "bench_prefill", lambda cfg, kv, T, repeats=3, device="cuda": 0.125)
    monkeypatch.setenv("CALM_CPU", "1")
    argv = ["--model", "mistral7b", "--prefill", "2048"]
    jj, je = _run(jbench.main, argv)
    tj, te = _run(TB.main, argv)
    assert jj == tj  # no tensor peak on the CPU: no pct_mxu_peak on either side
    line = r"# prefill T=2048: \d+ tok/s, [\d.]+ ms/chunk, [\d.]+ TFLOP/s"
    assert re.search(line, je).group(0) == re.search(line, te).group(0)


def test_decode_and_prefill_runs_on_cpu(jbench, monkeypatch):
    """A real run of each mode on the CPU's plain path: JAX's keys (those
    ``bench.py`` prints off its TPU table), a capture line a window that
    says the CPU runs eagerly, positive rates."""
    monkeypatch.setenv("CALM_CPU", "1")
    j, err = _run(TB.main, ["--model", "tiny", "--ctx", "96", "--steps", "4"])
    assert set(j) == {"metric", "value", "unit", "vs_baseline", "spread_pct", "gb_s"}
    assert j["metric"] == "pct_hbm_sol_tiny_fp8_decode" and j["value"] > 0 and j["gb_s"] > 0
    caps = re.findall(r"# captured steps at pos0 (\d+): 0 in the dropped first runs of 2 "
                      r"lengths, 0 in timed runs \(the CPU runs eagerly\)", err)
    assert caps == [str(p) for _, p in TB.windows(96, 4)]
    j, err = _run(TB.main, ["--model", "tiny", "--ctx", "64", "--prefill", "16"])
    assert set(j) == {"metric", "value", "unit"} and j["value"] > 0
    assert j["metric"] == "prefill_tok_s_tiny_fp8"


def test_window_bytes_is_engine_accounting():
    from calm_tpu_torch.config import ModelConfig
    from calm_tpu_torch.engine import kv_cache_bytes
    from calm_tpu_torch.utils.synth import weight_bytes

    cfg = ModelConfig(**TB.SHAPES["mixtral8x7b"], seq_len=4096, dtype="gf4", norm_ln=False)
    _, bw = weight_bytes(cfg)
    got = TB.window_bytes(cfg, 8, 1968, 32, batch=3)
    assert got == 32 * bw + 3 * sum(kv_cache_bytes(cfg, 8, 2000 + i) for i in range(32))
    assert TB.windows(4096, 32) == [("first32", 1968), ("last32", 4031)]


def test_chart_reads_the_port_s_lines(tmp_path, monkeypatch, capsys):
    """``tools/chart.py`` tabulates the port's JSON lines as they are."""
    monkeypatch.setenv("CALM_CPU", "1")
    j, _ = _run(TB.main, ["--model", "tiny", "--ctx", "80", "--steps", "4"])
    p = tmp_path / "results.jsonl"
    p.write_text("# a comment line\n" + json.dumps(j) + "\n")
    chart = importlib.import_module("tools.chart")
    assert chart.main([str(p), "-o", str(tmp_path / "bench.png")]) == 0
    assert re.search(rf"^{j['metric']} +{j['value']:.2f} +{j['vs_baseline']:.4f}$",
                     capsys.readouterr().out, re.M)
