"""The port's spans and counters (``ops.cost``) on the CPU: with no profiler
recording a tick, a generate and a prefill open no ``record_function``
range; under ``torch.profiler`` a Server's Chrome trace nests its tick's
phases and the admission's prefill as the benchmark reads them; the
counters give the admitted requests, prompt and prefix-hit tokens, queue
wait, ticks and occupancy, and the MoE prefill's host syncs; ``/v1/stats``
carries them."""

import json
import threading
import urllib.request

import pytest
import torch

from calm_tpu_torch import httpd as TH
from calm_tpu_torch import model as TM
from calm_tpu_torch import serve as TS
from calm_tpu_torch.engine import Engine
from calm_tpu_torch.ops import cost
from tests.modelgen import tiny_config, write_tiny_model

torch.set_num_threads(1)

SYS = "abcd efgh " * 4  # a shared prefix of two 16-token grains
PROMPTS = [SYS + "one", SYS + "two three", "hello world", SYS + "four"]


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("spans") / "m.calm")
    write_tiny_model(path, tiny_config(dtype="fp16", seq_len=128), seed=1)
    return path


@pytest.fixture(scope="module")
def moe_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("spans_moe") / "m.calm")
    write_tiny_model(path, tiny_config(dtype="fp16", seq_len=128, moe=True), seed=2)
    return path


def _server(path, **kw):
    return TS.Server(path, batch=2, kv_dtype="fp16", device="cpu", **kw)


def _drain(srv, prompts=PROMPTS, n=4):
    reqs = [srv.submit(p, max_tokens=n, temperature=0.0) for p in prompts]
    srv.run_until_drained(max_ticks=100)
    assert all(r.done for r in reqs)
    return reqs


def test_spans_off_enter_no_range(model_path, monkeypatch):
    """With no profiler recording, a tick, a generate and a prefill enter
    no ``record_function``; under a profiler the same calls do."""
    entered = []
    real = cost.record_function

    def counting(name, *a):
        entered.append(name)
        return real(name, *a)
    monkeypatch.setattr(cost, "record_function", counting)
    srv = _server(model_path, prefix_cache_tokens=1024)
    eng = Engine(model_path, kv_dtype="fp16", device="cpu")

    def work():
        srv.submit(SYS + "x", max_tokens=2, temperature=0.0)
        srv.tick()
        eng.generate("hello", steps=4, temperature=0.0)
        TM.prefill(eng.cfg, eng.weights, torch.tensor([[5, 6, 7]]), [0], eng.cache)
    work()
    assert entered == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        work()
    assert {"calm.serve.tick", "calm.engine.generate", "calm.model.prefill"} <= set(entered)


def _spans(prof, tmp_path):
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
            if e.get("ph") == "X" and e.get("name", "").startswith("calm.")]


def _inside(spans, name, outer):
    """Every ``name`` span lies inside some ``outer`` span, and there is
    at least one."""
    inner = [s for s in spans if s[2] == name]
    outers = [s for s in spans if s[2] == outer]
    return bool(inner) and all(any(o[0] <= a and b <= o[1] for o in outers)
                               for a, b, _ in inner)


def test_served_trace_nests_the_tick(model_path, tmp_path):
    """A tiny Server's Chrome trace: ``calm.serve.tick`` holds the sweep,
    admission, step, readback and sampling; the admission holds each
    request's tokenize, prefix copy, prefill (``calm.model.prefill``) and
    prefix save."""
    srv = _server(model_path, prefix_cache_tokens=1024)
    _drain(srv, PROMPTS[:1])  # the shared prefix is stored
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _drain(srv, PROMPTS[1:])
    spans = _spans(prof, tmp_path)
    for name in ("sweep", "admit", "step", "readback", "sample"):
        assert _inside(spans, f"calm.serve.{name}", "calm.serve.tick"), name
    for name in ("calm.serve.tokenize", "calm.serve.prefix_copy", "calm.model.prefill",
                 "calm.serve.prefix_save"):
        assert _inside(spans, name, "calm.serve.admit"), name
    names = [s[2] for s in spans]
    assert names.count("calm.serve.tick") == names.count("calm.serve.sweep") > 0
    # the step, its readback and the sampling follow each other in a tick
    step = min(s for s in spans if s[2] == "calm.serve.step")
    back = min(s for s in spans if s[2] == "calm.serve.readback" and s[0] >= step[1])
    samp = min(s for s in spans if s[2] == "calm.serve.sample" and s[0] >= back[1])
    assert step[1] <= back[0] <= back[1] <= samp[0]


def test_generate_trace_nests(model_path, tmp_path):
    """``Engine.generate``'s trace: the prefill, chunks, readbacks and
    emits inside ``calm.engine.generate``, the model's prefill inside the
    engine's."""
    eng = Engine(model_path, kv_dtype="fp16", device="cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.generate("hello world, once more", steps=40, temperature=0.0)
    spans = _spans(prof, tmp_path)
    for name in ("prefill", "chunk", "readback", "emit"):
        assert _inside(spans, f"calm.engine.{name}", "calm.engine.generate"), name
    assert _inside(spans, "calm.model.prefill", "calm.engine.prefill")
    assert sum(1 for s in spans if s[2] == "calm.engine.chunk") >= 2


def test_served_counters(model_path):
    """After N requests the counters give N submitted and admitted, their
    prompt tokens, the prefix cache's hit tokens, a queue wait of 0 or
    more, and the slots active over the ticks."""
    srv = _server(model_path, prefix_cache_tokens=1024)
    before = cost.counters()
    reqs = _drain(srv)
    got = {k: v - before.get(k, 0) for k, v in cost.counters().items()}
    tok = srv.engine.tokenizer
    assert got["serve.submitted"] == got["serve.admitted"] == len(PROMPTS)
    assert got["serve.prompt_tokens"] == sum(len(tok.encode(p, bos=True)) - 1 for p in PROMPTS)
    hits = sum(r.cached_prefix for r in reqs)
    assert got["serve.prefix_hit_tokens"] == hits > 0
    assert got["serve.queue_wait_s"] >= 0
    assert all(r.submitted_at <= r.admitted_at <= r.first_token_at for r in reqs)
    # each request holds a slot one tick a token, two slots a tick at most
    tokens = sum(r.n_generated for r in reqs)
    assert got["serve.slot_ticks"] == tokens
    assert 2 * got["serve.ticks"] >= tokens


def test_moe_prefill_counts_its_host_syncs(moe_path, tmp_path):
    """A MoE prefill past the sweep's rows groups its rows by expert: one
    host sync a layer (``model.host_syncs``), each in a
    ``calm.model.expert_sizes`` span inside ``calm.model.prefill``."""
    eng = Engine(moe_path, kv_dtype="fp16", device="cpu")
    tokens = torch.arange(3, 3 + 80).reshape(1, -1)
    assert not TM.moe_sweeps(eng.weights.layers, tokens.shape[1])
    before = cost.counters().get("model.host_syncs", 0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        TM.prefill(eng.cfg, eng.weights, tokens, [0], eng.cache)
    assert cost.counters()["model.host_syncs"] - before == eng.cfg.n_layers
    spans = _spans(prof, tmp_path)
    assert _inside(spans, "calm.model.expert_sizes", "calm.model.prefill")
    assert sum(1 for s in spans if s[2] == "calm.model.expert_sizes") == eng.cfg.n_layers


def test_http_stats_carry_the_counters(model_path):
    """``/v1/stats`` keeps its keys and adds the process's counters."""
    srv = _server(model_path, prefix_cache_tokens=1024)
    httpd = TH.serve_http(srv, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        body = json.dumps({"prompt": SYS + "hi", "max_tokens": 3, "temperature": 0.0})
        req = urllib.request.Request(f"{base}/v1/generate", data=body.encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert json.load(r)["tokens"] == 3
        with urllib.request.urlopen(f"{base}/v1/stats", timeout=30) as r:
            stats = json.load(r)
    finally:
        httpd.shutdown()
        httpd.scheduler.stop()
        httpd.server_close()
    assert {"slots", "active", "pending", "rejected", "prefix_cache", "pages_in_use",
            "speculative"} <= set(stats)
    c = stats["counters"]
    assert c["serve.admitted"] >= 1 and c["serve.prompt_tokens"] >= 1
    assert c == {k: v for k, v in c.items() if isinstance(v, (int, float))}
