"""The port's continuous-batching Server and HTTP front end against
calm_tpu.serve on the CPU: the same requests on one container give the
same texts, dense and paged, with and without the prefix cache, greedy
and host-sampled (per-request xorshift); mid-flight admission, slot reuse,
the truncation flag and pool pressure as JAX flags them; the request
lifecycle (timeouts, cancel, QueueFull, the finish sentinel, the
watchdog); device sampling; and the HTTP endpoints on port 0."""

import json
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from calm_tpu import serve as JS
from calm_tpu_torch import httpd as TH
from calm_tpu_torch import serve as TS
from calm_tpu_torch.sampler import device_sample
from tests.modelgen import tiny_config, write_tiny_model

torch.set_num_threads(1)

SYS = "abcd efgh " * 4  # a shared system prompt: two full 16-row pages
REQUESTS = [  # (prompt, max_tokens, temperature, seed)
    ("hello world", 8, 0.0, 1),
    (SYS + "one", 8, 0.9, 7),
    ("the quick", 10, 0.0, 1),
    (SYS + "two three", 6, 0.0, 1),
    ("pack my box", 6, 1.2, 3),
]
MODES = {
    "dense": {},
    "paged": dict(page_rows=16, pool_pages=6),
    "prefix": dict(prefix_cache_tokens=4096),
    "paged-prefix": dict(page_rows=16, pool_pages=8, prefix_cache_tokens=4096),
}


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("srv") / "m.calm")
    write_tiny_model(path, tiny_config(dtype="fp16", seq_len=64), seed=1)
    return path


def _serve(srv, reqs=REQUESTS, tick_between=0):
    out = []
    for prompt, n, temp, seed in reqs:
        out.append(srv.submit(prompt, max_tokens=n, temperature=temp, seed=seed))
        for _ in range(tick_between):
            srv.tick()
    srv.run_until_drained(max_ticks=200)
    assert all(r.done for r in out)
    return out


@pytest.fixture(scope="module")
def jax_runs(model_path):
    """Each mode's requests on the JAX server, once per module: batch 2,
    the third request admitted mid-flight into a reused slot."""
    runs = {}
    for mode, kw in MODES.items():
        srv = JS.Server(model_path, batch=2, kv_dtype="fp16", **kw)
        runs[mode] = [(r.text, r.n_generated, r.cached_prefix)
                      for r in _serve(srv, tick_between=1)]
    return runs


@pytest.mark.parametrize("mode", sorted(MODES))
def test_server_matches_jax(model_path, jax_runs, mode):
    srv = TS.Server(model_path, batch=2, kv_dtype="fp16", device="cpu", **MODES[mode])
    got = [(r.text, r.n_generated, r.cached_prefix)
           for r in _serve(srv, tick_between=1)]
    assert got == jax_runs[mode]
    assert len({t for t, _, _ in got}) == len(got)  # not degenerate
    if "prefix" in mode:
        assert got[3][2] >= 16 and srv.prefix_cache.hits >= 1
    if srv._paged is not None:
        assert srv._paged.pages_in_use() == 0  # every slot released
        dec = srv._paged
        assert len(dec.free_pages) + int((dec.page_refs > 0).sum()) == len(dec.page_refs)


def test_moe_server_matches_jax(tmp_path):
    path = str(tmp_path / "moe.calm")
    write_tiny_model(path, tiny_config(dtype="fp8", seq_len=64, moe=True), seed=2)
    reqs = REQUESTS[:3]
    want = [r.text for r in _serve(JS.Server(path, batch=2, kv_dtype="bf16"), reqs)]
    got = [r.text for r in _serve(TS.Server(path, batch=2, device="cpu"), reqs)]
    assert got == want


def test_prompt_truncation_flag(model_path):
    long_prompt = "word " * 30  # 151 tokens, a 64-token window
    want = _serve(JS.Server(model_path, batch=1), [(long_prompt, 2, 0.0, 1)])[0]
    got = _serve(TS.Server(model_path, batch=1, device="cpu"),
                 [(long_prompt, 2, 0.0, 1)])[0]
    assert got.truncated_prompt == want.truncated_prompt == 151 - 63
    assert got.text == want.text


def test_paged_pool_pressure(model_path):
    """A slot that needs a page from a dry pool finishes early, flagged,
    as the JAX server flags it."""
    reqs = [("hello world am a long prompt", 40, 0.0, 1),
            ("the quick brown fox jumps", 40, 0.0, 1)]
    kw = dict(batch=2, kv_dtype="fp16", page_rows=16, pool_pages=2)
    want = _serve(JS.Server(model_path, **kw), reqs)
    got = _serve(TS.Server(model_path, device="cpu", **kw), reqs)
    assert [(r.text, r.out_of_pages) for r in got] == [
        (r.text, r.out_of_pages) for r in want]
    assert any(r.out_of_pages for r in got)


def test_mid_flight_admission_and_slot_reuse(model_path):
    """Requests admitted while others decode, into freed slots, decode as
    they do alone."""
    srv = TS.Server(model_path, batch=2, kv_dtype="fp16", device="cpu")
    reqs = _serve(srv, REQUESTS[:4], tick_between=3)
    for (prompt, n, temp, seed), r in zip(REQUESTS[:4], reqs):
        solo = TS.Server(model_path, batch=1, kv_dtype="fp16", device="cpu")
        assert _serve(solo, [(prompt, n, temp, seed)])[0].text == r.text


def test_device_sampling_greedy_parity(model_path):
    reqs = [(p, n, 0.0, s) for p, n, _, s in REQUESTS[:3]]
    for kw in ({}, dict(page_rows=16, pool_pages=6)):
        host = _serve(TS.Server(model_path, batch=2, device="cpu", **kw), reqs)
        dev = _serve(TS.Server(model_path, batch=2, device="cpu",
                               device_sampling=True, **kw), reqs)
        assert [r.text for r in dev] == [r.text for r in host]


def test_device_sample_draws_inside_the_minp_set(rng):
    logits = torch.from_numpy(rng.standard_normal((4, 50)).astype(np.float32) * 3)
    temps = torch.tensor([0.0, 0.7, 1.5, 1.0])
    minps = torch.tensor([0.1, 0.2, 0.05, 1.0])
    gen = torch.Generator().manual_seed(0)
    top = logits.max(-1).values
    cutoff = top + torch.log(minps) * torch.where(temps > 0, temps, 1.0)
    seen = set()
    for _ in range(200):
        ids = device_sample(logits, gen, temps, minps)
        assert ids[0] == logits[0].argmax() and ids[3] == logits[3].argmax()
        for b in (1, 2):
            assert logits[b, ids[b]] >= cutoff[b]
            seen.add((b, int(ids[b])))
    keep = (logits[1] >= cutoff[1]).sum() + (logits[2] >= cutoff[2]).sum()
    assert len(seen) == int(keep)  # every kept id drawn in 200 tries


def test_queue_full_and_timeouts(model_path):
    srv = TS.Server(model_path, batch=1, kv_dtype="fp16", max_pending=2, device="cpu")
    pieces = []
    a = srv.submit("AB", max_tokens=4)
    late = srv.submit("CD", max_tokens=8, timeout_s=1e-9, on_piece=pieces.append)
    with pytest.raises(TS.QueueFull):
        srv.submit("EF", max_tokens=4)
    assert srv.rejected == 1
    srv.run_until_drained()
    assert a.done and not a.timed_out
    assert late.done and late.timed_out and not late.n_generated
    assert pieces == [None] and late.done_event.is_set()
    slow = srv.submit("AB", max_tokens=10_000, timeout_s=0.5)
    srv.run_until_drained()
    assert slow.timed_out and slow.n_generated >= 1
    assert not any(s.active for s in srv.slots)


def test_cancel_and_finish_sentinel(model_path):
    srv = TS.Server(model_path, batch=1, kv_dtype="fp16", device="cpu")
    pieces = []
    first = srv.submit("AB", max_tokens=10_000, on_piece=pieces.append)
    second = srv.submit("CD", max_tokens=4)
    srv.cancel(second)  # pending: finished at once
    assert second.done and second.cancelled and second.done_event.is_set()
    srv.tick()
    assert srv.slots[0].active
    srv.cancel(first)  # active: swept at the next tick
    assert not first.done
    srv.tick()
    assert first.done and first.cancelled and pieces[-1] is None
    assert "".join(p for p in pieces if p) == first.text
    done = srv.submit("AB", max_tokens=4, temperature=0.0)
    srv.run_until_drained()
    assert done.done and done.finished_at >= done.first_token_at >= done.submitted_at


def test_watchdog_fires_while_starved(model_path):
    srv = TS.Server(model_path, batch=1, kv_dtype="fp16", device="cpu")
    fired = []
    srv.watchdog_start(stall_s=0.1, on_stall=fired.append, poll_s=0.02)
    try:
        time.sleep(0.25)
        assert not fired  # idle
        req = srv.submit("AB", max_tokens=3, temperature=0.0)
        time.sleep(0.4)
        assert fired and fired[0] >= 0.1
        srv.run_until_drained()
        assert req.done
    finally:
        srv.watchdog_stop()


@pytest.mark.parametrize("kw", [dict(mesh=object()), dict(dp_devices=["cuda:0"])])
def test_unported_server_options_raise(model_path, kw):
    """Sharded and dp-paged serving run now (test_torch_shard_serve.py,
    test_torch_paged_group.py); beside a mesh or pages what stays refused
    is what JAX refuses, as a ValueError before anything loads: here
    speculative serving (calm_tpu/serve.py:328-329)."""
    with pytest.raises(ValueError, match="speculative"):
        TS.Server(model_path, page_rows=16, draft_path=model_path, device="cpu", **kw)


@pytest.mark.parametrize("flag", [["--dp", "2"]])
def test_httpd_unported_flags_exit_2(model_path, flag, capsys):
    """``--dp`` runs now; without ``--page-rows`` it exits 2, as JAX's
    asserts (calm_tpu/httpd.py:296-297)."""
    with pytest.raises(SystemExit) as e:
        TH.main([model_path] + flag)
    assert e.value.code == 2 and "--dp needs --page-rows" in capsys.readouterr().err


def test_scheduler_threads_stress(model_path):
    """More submitting threads than cores against the scheduler thread,
    with a short switch interval: every request ends, each rid is given
    once, and the rejected count adds up."""
    srv = TS.Server(model_path, batch=3, kv_dtype="fp16", max_pending=8, device="cpu")
    sched = TH._Scheduler(srv)
    sched.start()
    got, bounced, lock = [], [], threading.Lock()

    def client(k):
        for i in range(6):
            try:
                r = sched.submit(f"r{k}.{i}", max_tokens=2, temperature=0.0)
            except TS.QueueFull:
                with lock:
                    bounced.append(k)
                continue
            with lock:
                got.append(r)
            if i % 3 == 2:
                sched.cancel(r)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(k,)) for k in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert all(r.done_event.wait(timeout=60) for r in got)
    finally:
        sys.setswitchinterval(old)
        sched.stop()
        sched.join(timeout=30)
    assert not sched.is_alive()
    assert len({r.rid for r in got}) == len(got) == 72 - len(bounced)
    assert srv.rejected == len(bounced)


def _post(base, obj, timeout=60):
    r = urllib.request.Request(f"{base}/v1/generate", data=json.dumps(obj).encode(),
                               headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(r, timeout=timeout)


def test_http_front_end(model_path):
    """Health, plain and streamed generate (the JAX server's greedy text),
    stats, 400, 404, 429, then drain with the access log and 503."""
    want = _serve(JS.Server(model_path, batch=2, kv_dtype="fp16"),
                  [("AB", 6, 0.0, 1)])[0].text
    records = []
    srv = TS.Server(model_path, batch=1, kv_dtype="fp16", max_pending=1,
                    prefix_cache_tokens=1024, device="cpu")
    httpd = TH.serve_http(srv, port=0, access_log=records.append)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(f"{base}/v1/health", timeout=30) as r:
            assert json.load(r)["status"] == "ok"
        with _post(base, {"prompt": "AB", "max_tokens": 6, "temperature": 0.0}) as r:
            out = json.load(r)
        assert out["text"] == want and out["tokens"] == 6
        assert out["total_ms"] >= out["ttft_ms"] >= 0
        with _post(base, {"prompt": "AB", "max_tokens": 6, "temperature": 0.0,
                          "stream": True}) as r:
            assert r.read().decode() == want
        with urllib.request.urlopen(f"{base}/v1/stats", timeout=30) as r:
            stats = json.load(r)
        assert stats["slots"] == 1 and stats["active"] == 0
        assert stats["prefix_cache"]["entries"] == 0  # "AB" is below one grain
        assert stats["pages_in_use"] is None
        for bad, code in ((lambda: _post(base, {"max_tokens": 3}), 400),
                          (lambda: urllib.request.urlopen(f"{base}/v1/nope"), 404)):
            with pytest.raises(urllib.error.HTTPError) as e:
                bad()
            assert e.value.code == code
        # 429: with the tick loop stopped, one request fills the queue
        httpd.scheduler.stop()
        httpd.scheduler.join(timeout=30)
        held = httpd.scheduler.submit("P", max_tokens=2)
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base, {"prompt": "Q", "max_tokens": 2})
        assert e.value.code == 429 and srv.rejected == 1
        srv.cancel(held)
        assert httpd.scheduler.drain(timeout_s=30)
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base, {"prompt": "AB", "max_tokens": 2})
        assert e.value.code == 503
        assert [r["state"] for r in records][:2] == ["ok", "ok"]
        assert "cancelled" in [r["state"] for r in records]
    finally:
        httpd.shutdown()
        httpd.scheduler.stop()
        httpd.server_close()
