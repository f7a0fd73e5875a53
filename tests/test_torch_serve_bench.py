"""The serving benchmark on the port (``calm_tpu_torch.tools.serve_bench``)
under ``CALM_CPU=1``: a tiny synthetic load, dense with a prefix cache and
paged, gives every request its ``--max-tokens`` (the synthetic container
has no stop token, as ``tools/serve_bench.py``'s), says whether the
prefix cache was warm when timing began, and prints one JSON line with
``tools/serve_bench.py``'s keys."""

import json
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"metric", "value", "unit", "ttft_p50_ms", "ttft_p95_ms", "requests", "slots"}
LOAD = ["--synthetic", "tiny", "--ctx", "256", "--batch", "4", "--requests", "6",
        "--prompt-len", "24", "--max-tokens", "5"]


@pytest.mark.parametrize("extra,prefix", [
    (["--prefix-share", "0.5", "--prefix-cache-tokens", "2048"], "warm"),
    (["--page-rows", "16", "--dtype", "gf4"], "off"),
])
def test_tiny_load_on_cpu(tmp_path, extra, prefix):
    env = dict(os.environ, CALM_CPU="1", TMPDIR=str(tmp_path), OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-m", "calm_tpu_torch.tools.serve_bench"] + LOAD
                       + extra, cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert set(out) == KEYS
    dtype = "gf4" if "gf4" in extra else "fp8"
    assert out["metric"] == f"serve_agg_tok_s_tiny_{dtype}" and out["value"] > 0
    assert (out["requests"], out["slots"]) == (6, 4)
    assert 0 < out["ttft_p50_ms"] <= out["ttft_p95_ms"]
    m = re.search(r"# 6 reqs x <= 5 tok on 4 slots: (\d+) tokens in ", r.stderr)
    assert m and int(m.group(1)) == 6 * 5, r.stderr
    assert re.search(rf"^# prefix cache: {prefix}\b", r.stderr, re.M), r.stderr
    assert os.path.exists(tmp_path / f"serve_bench_tiny_{dtype}_256.calm")
