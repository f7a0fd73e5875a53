"""The port's Engine and CLI against calm_tpu.engine on the CPU: greedy
and host-sampled generations give the same token ids, stepped prompt
ingestion gives the logits of JAX's batched prefill, and the perf line
keeps its format."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from calm_tpu import engine as JE
from calm_tpu import model as JM
from calm_tpu import sampler as jsampler
from calm_tpu_torch import engine as TE
from calm_tpu_torch import sampler as tsampler
from tests.modelgen import tiny_config, write_tiny_model

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PERF = re.compile(r"^# \d+ tokens: throughput: [\d.]+ tok/s; latency: [\d.]+ "
                  r"ms/tok; bandwidth: [\d.]+ GB/s; total [\d.]+ sec; "
                  r"#[0-9a-f]{8}$")


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("eng") / "m.calm")
    write_tiny_model(path, tiny_config(dtype="fp8", seq_len=32), seed=5)
    return path


def _record_jax_ids(monkeypatch):
    """Token ids the JAX engine draws: greedy chunks from decode_scan,
    sampled ones from the host Sampler."""
    ids = []
    real_scan, real_sample = JM.decode_scan, jsampler.Sampler.sample

    def scan(*a, **k):
        out = real_scan(*a, **k)
        ids.append(np.asarray(out[0])[0].tolist())
        return out

    def sample(self, logits):
        t = real_sample(self, logits)
        ids.append([t])
        return t

    monkeypatch.setattr(JM, "decode_scan", scan)
    monkeypatch.setattr(jsampler.Sampler, "sample", sample)
    return ids


@pytest.mark.parametrize("prompt,steps", [("hello", 40), ("", 20)])
def test_greedy_generate_matches_jax(model_path, monkeypatch, prompt, steps):
    ids = _record_jax_ids(monkeypatch)
    js = JE.Engine(model_path).generate(prompt, steps, temperature=0)
    ts = TE.Engine(model_path, device="cpu").generate(prompt, steps, temperature=0)
    jids = [t for chunk in ids for t in chunk][:len(ts.ids)]
    assert ts.ids == jids
    assert ts.text == js.text and ts.tokens == js.tokens


def test_sampled_generate_matches_jax_reference_sampling(model_path, monkeypatch):
    ids = _record_jax_ids(monkeypatch)
    js = JE.Engine(model_path).generate("hi", 40, temperature=0.9, minp=0.05,
                                        seed=4, reference_sampling=True)
    ts = TE.Engine(model_path, device="cpu").generate(
        "hi", 40, temperature=0.9, minp=0.05, seed=4)
    assert ts.ids == [t for chunk in ids for t in chunk]
    assert ts.text == js.text and len(set(ts.ids)) > 3


def test_stepped_prefill_matches_batched_prefill(model_path):
    toks = [1, 50, 60, 70, 80, 90, 100, 110, 120, 5]
    je = JE.Engine(model_path)
    want = je.prefill_tokens(toks)
    te = TE.Engine(model_path, device="cpu")
    got = te.prefill_tokens(toks)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-4
    # both caches now continue identically
    np.testing.assert_allclose(te.step(7, len(toks)), je.step(7, len(toks)),
                               rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_perf_line_and_accounting(model_path):
    te = TE.Engine(model_path, device="cpu")
    je = JE.Engine(model_path)
    assert (te.n_bandwidth, te.n_bytes, te.n_params) == (
        je.n_bandwidth, je.n_bytes, je.n_params)
    assert te.banner() == je.banner()
    st = te.generate("hi", 6, temperature=0)
    assert PERF.match(st.perf_line()), st.perf_line()
    assert PERF.match(JE.GenStats(6, 0.5, 10**6, 7, "").perf_line())
    c = te.cfg
    assert TE.kv_cache_bytes(c, 8, 40) == JE.kv_cache_bytes(c, 8, 40)


def test_long_context_picks_fp8_kv(tmp_path):
    path = str(tmp_path / "long.calm")
    write_tiny_model(path, tiny_config(dtype="fp16", seq_len=16), seed=2)
    te = TE.Engine(path, context=4097, device="cpu")
    assert te.kv_dtype == "fp8" and te.cache.k.dtype == torch.float8_e5m2
    assert TE.Engine(path, context=4096, device="cpu").kv_dtype == "bf16"


def test_sampler_copy_is_bit_compatible():
    a, b = jsampler.XorshiftRng(123), tsampler.XorshiftRng(123)
    assert [a.next_u32() for _ in range(50)] == [b.next_u32() for _ in range(50)]
    logits = np.linspace(-3, 3, 40).astype(np.float32)
    sa = jsampler.Sampler(40, 9, 0.8, 0.05)
    sb = tsampler.Sampler(40, 9, 0.8, 0.05)
    assert [sa.sample(logits) for _ in range(20)] == [sb.sample(logits) for _ in range(20)]


def test_cli_runs_on_cpu(model_path):
    env = dict(os.environ, CALM_CPU="1", CALM_TOKENS="1")
    r = subprocess.run([sys.executable, "-m", "calm_tpu_torch.cli", model_path,
                        "-t", "0", "-n", "8", "-i", "hello"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("# ") and "# device: cpu" in r.stdout
    assert PERF.match(r.stderr.strip().splitlines()[-1]), r.stderr
    r = subprocess.run([sys.executable, "-m", "calm_tpu_torch.cli", model_path,
                        "-x", "f.txt"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 2 and "not yet ported" in r.stderr
