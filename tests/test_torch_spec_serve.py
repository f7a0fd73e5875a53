"""The port's speculative serving against calm_tpu.serve on the CPU
(tests/test_serve.py:875-960): ``Server(draft_path=, gamma=)`` with a
perfect draft (the target itself) and a mismatched one gives the JAX
server's texts and counters and the plain server's texts; a sampled
request suspends the rounds and the greedy text stays exact; the prefix
cache composes; the depth adapts; a slot parked near the window's edge is
verified at a clamped start; ``spec_sampled`` runs; a paged server with a
draft is refused; and ``python -m calm_tpu_torch.httpd --draft --gamma
--spec-sampled`` serves with the ``speculative`` stats block."""

import json
import os
import re
import signal
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch

from calm_tpu import serve as JS
from calm_tpu_torch import serve as TS
from tests.modelgen import tiny_config, write_tiny_model

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPTS = ["hello world", "the quick", "pack my box"]


class _CopyingJnp:
    """``jax.numpy`` as ``calm_tpu.serve`` sees it in these tests, with
    ``asarray`` of a numpy array taken from a copy. On the CPU
    ``jnp.asarray`` can share the numpy buffer, and the JAX server writes
    ``_tokens``/``_pos`` in place (``calm_tpu/serve.py:645-646``,
    ``:722-723``, ``:938-939``) while a step dispatched asynchronously
    before (the draft's ``decode_step`` on a plain tick, ``:900-903``, whose
    result nothing waits for) may still read them: its counters then
    changed from run to run under load. Every other attribute is jnp's."""

    def __init__(self, jnp):
        self._jnp = jnp

    def __getattr__(self, name):
        return getattr(self._jnp, name)

    def asarray(self, a, *args, **kw):
        return self._jnp.asarray(a.copy() if isinstance(a, np.ndarray) else a, *args, **kw)


@pytest.fixture(scope="module", autouse=True)
def _jax_server_reads_copies():
    """The reference gives one answer a run: its host arrays reach JAX as
    copies (the flag that turns off the CPU's asynchronous dispatch is read
    only when JAX's CPU client is made, which another test file in the same
    worker may already have done)."""
    real = JS.jnp
    JS.jnp = _CopyingJnp(real)
    yield
    JS.jnp = real


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("sserve")
    out = {"target": str(d / "m.calm"), "other": str(d / "draft.calm"),
           "bad": str(d / "bad.calm")}
    write_tiny_model(out["target"], tiny_config(dtype="fp16", seq_len=64), seed=1)
    write_tiny_model(out["other"], tiny_config(dtype="fp16", seq_len=64), seed=9)
    write_tiny_model(out["bad"], tiny_config(dtype="fp16", seq_len=64), seed=77)
    out["self"] = out["target"]
    return out


def _run(S, path, reqs, batch=2, max_ticks=80, **kw):
    srv = S.Server(path, batch=batch, kv_dtype="fp16", **kw)
    out = [srv.submit(p, max_tokens=n, temperature=t, seed=sd) for p, n, t, sd in reqs]
    srv.run_until_drained(max_ticks=max_ticks)
    assert all(r.done for r in out)
    return srv, out


def _counters(srv):
    return srv.spec_rounds, srv.spec_accepted, srv.spec_emitted, srv._gamma_now


@pytest.mark.parametrize("draft,gamma", [("self", 4), ("other", 3)])
def test_speculative_server_matches_jax_and_plain(paths, draft, gamma):
    reqs = [(p, 8, 0.0, 1) for p in PROMPTS]
    js, jr = _run(JS, paths["target"], reqs, draft_path=paths[draft], gamma=gamma)
    ts, tr = _run(TS, paths["target"], reqs, draft_path=paths[draft], gamma=gamma,
                  device="cpu")
    _, pr = _run(TS, paths["target"], reqs, device="cpu")
    assert [r.text for r in tr] == [r.text for r in jr] == [r.text for r in pr]
    assert [r.ids for r in tr] == [r.ids for r in pr]
    assert _counters(ts) == _counters(js) and ts.spec_rounds > 0
    if draft == "self":
        assert ts.spec_accepted == ts.spec_emitted  # a perfect draft


def test_mixed_sampled_and_greedy(paths):
    """A sampled request suspends the rounds (plain ticks step the draft
    too); the greedy text is exact and the rounds resume after it, as
    JAX's; the sampled text is the plain server's."""
    reqs = [("hello world", 10, 0.0, 1), ("the quick", 4, 0.8, 3)]
    kw = dict(draft_path=paths["self"], gamma=4)
    js, jr = _run(JS, paths["target"], reqs, **kw)
    ts, tr = _run(TS, paths["target"], reqs, device="cpu", **kw)
    _, pr = _run(TS, paths["target"], reqs, device="cpu")
    assert [r.text for r in tr] == [r.text for r in jr] == [r.text for r in pr]
    assert _counters(ts) == _counters(js) and ts.spec_rounds > 0


def test_prefix_cache_composes(paths):
    """The target admits through cached rows and a suffix prefill while the
    draft prefills the whole prompt; the texts stay exact and the cache
    hits, as JAX's."""
    sys_prompt = "abcd efgh " * 4
    out = []
    for S, kw in ((JS, {}), (TS, dict(device="cpu"))):
        srv = S.Server(paths["target"], batch=1, kv_dtype="fp16", draft_path=paths["self"],
                       gamma=4, prefix_cache_tokens=4096, **kw)
        texts = []
        for tail in ("one", "two"):
            r = srv.submit(sys_prompt + tail, max_tokens=6, temperature=0.0)
            srv.run_until_drained(max_ticks=40)
            texts.append(r.text)
        out.append((texts, r.cached_prefix, srv.prefix_cache.hits, _counters(srv)))
    _, plain = _run(TS, paths["target"], [(sys_prompt + t, 6, 0.0, 1)
                                                 for t in ("one", "two")],
                    batch=1, device="cpu")
    assert out[1] == out[0] and out[1][1] > 0 and out[1][2] == 1
    assert out[1][0] == [r.text for r in plain]


def test_gamma_adapts(paths):
    """A perfect draft holds the depth at gamma; a mismatching one shrinks
    it to 1; the texts stay exact either way."""
    req = [("hello world", 12, 0.0, 1)]
    good, _ = _run(TS, paths["target"], req, batch=1, draft_path=paths["self"],
                   gamma=4, device="cpu")
    assert good._gamma_now == 4
    bad, got = _run(TS, paths["target"], req, batch=1, draft_path=paths["bad"],
                    gamma=4, device="cpu")
    jbad, want = _run(JS, paths["target"], req, batch=1, draft_path=paths["bad"],
                      gamma=4)
    assert bad._gamma_now == jbad._gamma_now == 1
    assert got[0].text == want[0].text


def test_parked_slot_near_the_window_edge(paths):
    """A request that ends 3 rows below the window's edge parks its slot
    there while the other slot speculates: every verify covers the parked
    slot too, at a start clamped into the window (the JAX server clamps its
    write), and the texts are JAX's and the plain server's."""
    tok = TS.Server(paths["target"], batch=1, kv_dtype="fp16", device="cpu").engine.tokenizer
    edge = "x" * (64 - 1 - 3 - len(tok.encode("", bos=True)))  # parks at pos 61
    reqs = [(edge, 2, 0.0, 1), ("hello world", 16, 0.0, 1)]
    kw = dict(draft_path=paths["self"], gamma=4)
    seen = []
    real = TS.M.verify_once

    def spy(cfg, w, tokens, pos0, cache, *a):
        seen.append(list(pos0))
        return real(cfg, w, tokens, pos0, cache, *a)
    TS.M.verify_once = spy
    try:
        ts, tr = _run(TS, paths["target"], reqs, device="cpu", **kw)
    finally:
        TS.M.verify_once = real
    js, jr = _run(JS, paths["target"], reqs, **kw)
    _, pr = _run(TS, paths["target"], reqs, device="cpu")
    assert [r.text for r in tr] == [r.text for r in jr] == [r.text for r in pr]
    assert _counters(ts) == _counters(js)
    parked = [p[0] for p in seen if p[0] != 0]
    assert seen and parked and all(p + 5 <= 64 for p in parked)
    assert any(p == 64 - 5 for p in parked)  # clamped from 61


def test_spec_sampled_runs(paths):
    """Sampled requests inside rounds: deterministic per seed, the greedy
    request's text exact, rounds taken."""
    reqs = [("hello world", 10, 0.0, 1), ("the quick", 8, 0.9, 3)]
    runs = [_run(TS, paths["target"], reqs, device="cpu", draft_path=paths["self"],
                 gamma=3, spec_sampled=True) for _ in range(2)]
    _, pr = _run(TS, paths["target"], reqs, device="cpu")
    (a, ra), (_, rb) = runs
    assert [r.text for r in ra] == [r.text for r in rb]
    assert ra[0].text == pr[0].text and a.spec_rounds > 0 and ra[1].n_generated == 8


def test_paged_server_with_a_draft_is_refused(paths):
    """Dense only, as JAX asserts (calm_tpu/serve.py:328-329); a sharded
    server stays refused before its draft is read."""
    with pytest.raises(AssertionError):
        JS.Server(paths["target"], batch=2, page_rows=16, draft_path=paths["self"])
    with pytest.raises(ValueError):
        TS.Server(paths["target"], batch=2, page_rows=16, draft_path=paths["self"],
                  device="cpu")
    with pytest.raises(ValueError, match="speculative"):
        TS.Server(paths["target"], batch=2, mesh=object(), draft_path=paths["self"])


def test_httpd_draft_gamma_spec_sampled(paths):
    """The front end with --draft --gamma 3 --spec-sampled: a greedy
    generate gives the plain server's text, /v1/stats carries JAX's
    speculative keys with the server's counts, SIGTERM drains."""
    _, want = _run(TS, paths["target"], [("AB", 6, 0.0, 1)], device="cpu")
    env = dict(os.environ, CALM_CPU="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "calm_tpu_torch.httpd", paths["target"], "--port", "0",
         "--batch", "2", "--kv", "fp16", "--draft", paths["self"], "--gamma", "3",
         "--spec-sampled"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        proc.stdout.readline()  # the banner
        m = re.search(r"http://[\d.]+:(\d+)", proc.stdout.readline())
        assert m, proc.stderr.read()
        base = f"http://127.0.0.1:{m.group(1)}"
        body = json.dumps({"prompt": "AB", "max_tokens": 6, "temperature": 0.0}).encode()
        with urllib.request.urlopen(urllib.request.Request(
                f"{base}/v1/generate", data=body), timeout=120) as r:
            out = json.load(r)
        with urllib.request.urlopen(f"{base}/v1/stats", timeout=60) as r:
            spec = json.load(r)["speculative"]
        proc.send_signal(signal.SIGTERM)
        _, errs = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert out["text"] == want[0].text and out["tokens"] == 6
    assert set(spec) == {"rounds", "emitted", "acceptance"}
    assert spec["rounds"] > 0 and spec["acceptance"] == 1.0  # the draft is the target
    assert proc.returncode == 0 and "# drained" in errs
