"""The port's dp-paged serving against the JAX package: ``Server(page_rows,
dp_devices)`` runs one independent paged decoder a listed device
(``paged.PagedGroup``), here two CPU decoders as JAX's test runs two CPU
devices. The cases of tests/test_serve.py at :499 (parity with the single
pool), :520 (device sampling), :538 (a prefix cache a decoder) and :607
(``/v1/stats`` over HTTP), and ``python -m calm_tpu_torch.httpd --dp 2
--page-rows 16`` under ``CALM_CPU=1`` in a subprocess; also the group's
shared weights and split generators."""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from calm_tpu import serve as JS
from calm_tpu_torch import httpd as TH
from calm_tpu_torch import serve as TS
from calm_tpu_torch.paged import PagedDecoder, PagedGroup
from tests.modelgen import tiny_config, write_tiny_model

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPTS = ["AB", "zq", "hello world", "the quick"]
SYS = "abcd efgh " * 4  # two full 16-row pages
TWO = ["cpu", "cpu"]


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("group") / "m.calm")
    write_tiny_model(path, tiny_config(dtype="fp16", seq_len=64), seed=1)
    return path


def _texts(srv, prompts, n=6):
    reqs = [srv.submit(p, max_tokens=n, temperature=0.0) for p in prompts]
    srv.run_until_drained(max_ticks=40)
    assert all(r.done for r in reqs)
    return [r.text for r in reqs]


@pytest.fixture(scope="module")
def jax_group(model_path):
    """JAX's single-pool paged texts and its two-device group's."""
    single = _texts(JS.Server(model_path, batch=4, kv_dtype="fp16", page_rows=16,
                              pool_pages=16), PROMPTS)
    group = _texts(JS.Server(model_path, batch=4, kv_dtype="fp16", page_rows=16,
                             dp_devices=jax.devices("cpu")[:2]), PROMPTS)
    return single, group


def test_paged_dp_group_parity(model_path, jax_group):
    """One decoder a device, slots split over them: JAX's texts, and the
    single pool's; every pool drained at the end."""
    srv = TS.Server(model_path, batch=4, kv_dtype="fp16", page_rows=16, dp_devices=TWO)
    got = _texts(srv, PROMPTS)
    assert srv._paged_group and len(srv._paged.decs) == 2
    assert got == jax_group[0] == jax_group[1]
    assert srv._paged.pages_in_use() == 0
    # each decoder holds its own pool of 2 slots x 4 pages and the parking page
    assert [d.pool.k.shape[1] for d in srv._paged.decs] == [9, 9]
    assert [srv._paged.shard_of(b) for b in range(4)] == [0, 0, 1, 1]


def test_paged_dp_group_device_sampling(model_path, jax_group):
    """Greedy parity with sampling on each decoder's device, each with its
    own generator drawn from the server's."""
    dev = TS.Server(model_path, batch=4, kv_dtype="fp16", page_rows=16, dp_devices=TWO,
                    device_sampling=True)
    assert _texts(dev, PROMPTS) == jax_group[1]
    assert dev._paged.pages_in_use() == 0


def test_paged_dp_group_prefix_caches(model_path):
    """A prefix cache a decoder: each decoder's second request with the
    same system prompt hits its own cache; texts stay JAX's."""
    def run(S, **kw):
        srv = S.Server(model_path, batch=2, kv_dtype="fp16", page_rows=16,
                       prefix_cache_tokens=4096, **kw)
        waves = []
        for _ in range(2):  # one request a decoder (slots 0 and 1), twice
            reqs = [srv.submit(SYS + s, max_tokens=4, temperature=0.0)
                    for s in ("one", "two")]
            srv.run_until_drained(max_ticks=40)
            waves.append([(r.text, r.cached_prefix) for r in reqs])
        return srv, waves
    jsrv, want = run(JS, dp_devices=jax.devices("cpu")[:2])
    srv, got = run(TS, dp_devices=TWO)
    assert srv._prefix_caches is not None and len(srv._prefix_caches) == 2
    assert got == want
    assert [c for _, c in got[0]] == [0, 0] and all(c >= 16 for _, c in got[1])
    assert [c.hits for c in srv._prefix_caches] == [1, 1] == [
        c.hits for c in jsrv._prefix_caches]


def test_group_decoders_share_weights_one_device(model_path):
    """Decoders on one device share the weight tensors (no second copy)
    and keep their own pools; a group's step returns its own slots' rows,
    each decoder's as it would step alone."""
    srv = TS.Server(model_path, batch=4, kv_dtype="fp16", page_rows=16, dp_devices=TWO)
    a, b = srv._paged.decs
    assert a.weights is b.weights is srv.engine.weights
    assert a.pool.k.data_ptr() != b.pool.k.data_ptr()
    g = srv._paged
    for i, p in enumerate(PROMPTS):
        assert g.admit(i, srv.engine.tokenizer.encode(p, bos=True))
    lone = [PagedDecoder(srv.engine.cfg, srv.engine.weights, 8, 16, torch.float16, 2)
            for _ in range(2)]
    for i, p in enumerate(PROMPTS):
        lone[i // 2].admit(i % 2, srv.engine.tokenizer.encode(p, bos=True))
    got = g.step()
    want = np.concatenate([d.step() for d in lone])
    np.testing.assert_array_equal(got, want)
    assert isinstance(g, PagedGroup) and got.shape == (4, srv.engine.cfg.vocab_size)


def test_group_step_sampled_splits_the_generator(model_path):
    """step_sampled seeds each decoder's generator from the server's, as
    JAX splits its key: the same seed gives the same draws, and the two
    decoders draw from different streams."""
    srv = TS.Server(model_path, batch=2, kv_dtype="fp16", page_rows=16, dp_devices=TWO)
    g = srv._paged
    toks = srv.engine.tokenizer.encode("hello world", bos=True)
    draws = []
    for _ in range(2):
        for b in range(2):
            g.admit(b, toks)
        gen = torch.Generator().manual_seed(5)
        t, m = np.full(2, 1.5, np.float32), np.full(2, 0.0, np.float32)
        draws.append([tuple(g.step_sampled(gen, t, m)) for _ in range(6)])
        for b in range(2):
            g.release(b)
    assert draws[0] == draws[1]
    assert any(a != b for a, b in draws[0])  # same slot state, different streams


def test_http_dp_paged_stats(model_path):
    """``/v1/stats`` adds up the decoders' prefix caches and reports the
    pages in use, as JAX's front end."""
    srv = TS.Server(model_path, batch=2, kv_dtype="fp16", page_rows=16, dp_devices=TWO,
                    prefix_cache_tokens=1024)
    httpd = TH.serve_http(srv, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    want = _texts(JS.Server(model_path, batch=1, kv_dtype="fp16"), [SYS], 4)[0]
    try:
        body = json.dumps({"prompt": SYS, "max_tokens": 4, "temperature": 0.0}).encode()
        req = urllib.request.Request(f"{base}/v1/generate", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.load(r)
        assert out["tokens"] == 4 and out["text"] == want
        with urllib.request.urlopen(f"{base}/v1/stats", timeout=30) as r:
            stats = json.load(r)
        assert stats["slots"] == 2
        assert stats["prefix_cache"]["entries"] == 1  # the pinned prompt pages
        assert stats["prefix_cache"]["tokens"] == 32
        assert stats["pages_in_use"] == 0
    finally:
        httpd.shutdown()
        httpd.scheduler.stop()
        httpd.server_close()


def test_httpd_dp_subprocess(model_path):
    """``python -m calm_tpu_torch.httpd --dp 2 --page-rows 16`` under
    CALM_CPU=1: two CPU decoders behind the front end, JAX's greedy text,
    per-decoder stats, SIGTERM drains."""
    want = _texts(JS.Server(model_path, batch=1, kv_dtype="fp16"), ["hello world"], 6)[0]
    env = dict(os.environ, CALM_CPU="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "calm_tpu_torch.httpd", model_path, "--port", "0",
         "--batch", "2", "--kv", "fp16", "--dp", "2", "--page-rows", "16",
         "--prefix-cache-tokens", "256"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        proc.stdout.readline()  # the banner
        m = re.search(r"http://[\d.]+:(\d+)", proc.stdout.readline())
        assert m, proc.stderr.read()
        base = f"http://127.0.0.1:{m.group(1)}"
        body = json.dumps({"prompt": "hello world", "max_tokens": 6,
                           "temperature": 0.0}).encode()
        req = urllib.request.Request(f"{base}/v1/generate", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.load(r)
        with urllib.request.urlopen(f"{base}/v1/stats", timeout=30) as r:
            stats = json.load(r)
        proc.send_signal(signal.SIGTERM)
        _, errs = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert out["text"] == want and out["tokens"] == 6
    assert stats["slots"] == 2 and stats["pages_in_use"] == 0
    assert stats["prefix_cache"] == {"entries": 0, "tokens": 0, "hits": 0, "hit_tokens": 0}
    assert proc.returncode == 0 and "# drained" in errs
