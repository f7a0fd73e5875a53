"""The compiled decode step on the CPU: the device-state step (tokens and
positions as tensors, a static ``rolling``) against calm_tpu's
``decode_step`` and ``paged_decode_step`` through the sink wrap, the body
a CUDA graph captures run eagerly against ``decode_loop`` and JAX's
``decode_scan``, the sampling noise buffer, the warm-up's snapshot and
restore, and the counters of captures and replays. A CUDA graph itself
needs the card: ``chip_smoke.py`` replays it there against the eager
step."""

import functools
import types
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calm_tpu import model as JM
from calm_tpu import paged as JP
from calm_tpu.container import TensorFile as JTensorFile
from calm_tpu_torch import graphs as G
from calm_tpu_torch import model as TM
from calm_tpu_torch import paged as TP
from calm_tpu_torch.container import TensorFile
from calm_tpu_torch.ops import cost, hopper_qmm
from calm_tpu_torch.sampler import device_sample
from tests.modelgen import tiny_config, write_tiny_model
from tests.test_torch_model import jax_leaves

torch.set_num_threads(1)

S, STEPS, PR = 32, 40, 8  # window, steps (through the wrap), page rows
CASES = {
    "fp8": dict(dtype="fp8"),
    "fp16": dict(dtype="fp16"),
    "gf4": dict(dtype="gf4", dim=64, hidden_dim=64, head_dim=16, rotary_dim=16),
}
STAGGERED = [0, 20, 35]  # B=3: slot 2 past the window at the start, 1 wraps later


@functools.lru_cache(maxsize=None)
def _models(name, tmp):
    cfg = tiny_config(seq_len=S, **CASES[name])
    path = f"{tmp}/{name}.calm"
    write_tiny_model(path, cfg, seed=7)
    jtf = JTensorFile(path)
    cfg_j = JM.ModelConfig.from_metadata(jtf.metadata)
    wj = JM.load_weights(jtf, cfg_j)
    cfg_t = TM.ModelConfig.from_metadata(TensorFile(path).metadata)
    return (cfg_j, wj), (cfg_t, TM.weights_from_numpy(jax_leaves(wj), cfg_t))


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return str(tmp_path_factory.mktemp("graph"))


def _close(got, want, tol=1e-4):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    scale = np.abs(want).max(axis=-1, keepdims=True)
    assert (np.abs(got - want) / scale).max() < tol
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def _page_table(B):
    """Each slot's S / PR pages, scrambled over a pool of B * S / PR + 1."""
    nb = S // PR
    return np.random.default_rng(B).permutation(B * nb).reshape(B, nb).astype(np.int32)


def _random_cache(cache, seed=0):
    g = torch.Generator().manual_seed(seed)
    for buf in (cache.k, cache.v):
        buf.copy_(torch.randn(buf.shape, generator=g))
    return cache


def _clone(cache):
    return TM.KVCache(cache.k.clone(), cache.v.clone())


def _equal(a, b):
    return torch.equal(a.k, b.k) and torch.equal(a.v, b.v)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("B,paged", [(1, False), (3, False), (1, True), (3, True)])
def test_device_state_step_matches_jax(tmp, name, B, paged):
    """The step on (B,) token and int32 pos tensors, ``rolling`` picked as
    the JAX server picks it, against JAX's decode_step (paged_decode_step)
    with per-slot positions: 40 steps of a 32-row window, every slot
    through the wrap. The cache is fp16: the two f32 paths compute a fresh
    row a few f32 ulps apart, and where that straddles a rounding boundary
    a bf16 row lands one bf16 step (2^-8) apart, which moves the later
    logits of that slot by ~1e-4 of their scale; fp16 steps are 8x finer."""
    (cfg_j, wj), (cfg, w) = _models(name, tmp)
    pos = torch.tensor([0] if B == 1 else STAGGERED, dtype=torch.int32)
    tok = torch.arange(5, 5 + B)
    if paged:
        pt = _page_table(B)
        P = pt.size + 1
        cj = JP.create_pool(cfg_j, P, PR, jnp.float16)
        ct = TP.create_pool(cfg, P, PR, torch.float16)
    else:
        cj = JM.KVCache.create(cfg_j, B, jnp.float16)
        ct = TM.KVCache.create(cfg, B, torch.float16)
    for _ in range(STEPS):
        rolling = bool((pos + 1 >= S).any())
        jt, jp = jnp.asarray(tok.numpy(), jnp.int32), jnp.asarray(pos.numpy())
        if paged:
            want, cj = JP.paged_decode_step(cfg_j, wj, jt, jp, cj, jnp.asarray(pt))
            got, ct = TM.paged_decode_step(cfg, w, tok, pos, ct, torch.from_numpy(pt),
                                           rolling)
        else:
            want, cj = JM.decode_step(cfg_j, wj, jt, jp, cj)
            got, ct = TM.decode_step(cfg, w, tok, pos, ct, rolling=rolling)
        _close(got, want)
        tok = torch.from_numpy(np.asarray(want).argmax(-1)).long()
        pos = pos + 1
    np.testing.assert_allclose(ct.k.float().numpy(), np.asarray(cj.k, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_decode_indices_on_tensors_match_jax():
    cfg = tiny_config(seq_len=8)
    pos = np.arange(0, 40, dtype=np.int32)
    kp, kl = TM.decode_indices(cfg, torch.from_numpy(pos))
    jp, jl = JM.decode_indices(cfg, jnp.asarray(pos))
    assert kp.dtype == kl.dtype == torch.int32
    np.testing.assert_array_equal(kp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(kl.numpy(), np.asarray(jl))
    assert [TM.decode_indices(cfg, int(p)) for p in pos] == list(
        zip(kp.tolist(), kl.tolist()))


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("paged", [False, True])
def test_rolling_false_equals_rolling_true_below_the_window(tmp, name, paged):
    """Where no slot is past the window, leaving the sink rotation out
    gives the same logits and cache bit for bit (on a cache of random
    rows, so a stray sink write would show)."""
    _, (cfg, w) = _models(name, tmp)
    B = 3
    pt = torch.from_numpy(_page_table(B)) if paged else None
    if paged:
        base = _random_cache(TP.create_pool(cfg, pt.numel() + 1, PR))
    else:
        base = _random_cache(TM.KVCache.create(cfg, B))
    a, b = _clone(base), _clone(base)
    tok, pos = torch.tensor([5, 6, 7]), torch.tensor([0, 10, 24], dtype=torch.int32)
    for _ in range(7):  # the last step at 30: no slot reaches 32
        la, lb = (TM._decode(cfg, w, tok, pos, c, rolling, pt)
                  for c, rolling in ((a, True), (b, False)))
        assert torch.equal(la, lb)
        tok, pos = la.argmax(-1), pos + 1
    assert _equal(a, b)


def _body_run(g, n, generator=None):
    """The captured body run eagerly n times on the graph's buffers,
    the noise drawn before each run as a replay draws it."""
    toks, logits = [], []
    for _ in range(n):
        if g.sampled:
            torch.rand(g.noise.shape, generator=generator, out=g.noise)
        logits.append(g.body())
        toks.append(g.token.clone())
    return torch.stack(toks, 1), torch.stack(logits)


@pytest.mark.parametrize("name", sorted(CASES))
def test_captured_body_equals_decode_loop_and_jax_scan(tmp, name):
    """The graph's body, run eagerly 40 times from its static token and
    pos through the wrap, gives decode_loop's ids, logits and cache bit for
    bit, and JAX decode_scan's greedy ids."""
    (cfg_j, wj), (cfg, w) = _models(name, tmp)
    a, b = TM.KVCache.create(cfg, 1), TM.KVCache.create(cfg, 1)
    tok = torch.tensor([9])
    g = TM.step_graph(cfg, w, a, 1, rolling=True)
    g.load(tok, 0)
    toks, logits = _body_run(g, STEPS)
    want_t, _, want_l = TM.decode_loop(cfg, w, tok, 0, b, STEPS)
    assert torch.equal(toks, want_t) and torch.equal(logits, want_l)
    assert _equal(a, b)
    assert torch.equal(g.pos, torch.tensor([STEPS], dtype=torch.int32))
    jt, _, _ = JM.decode_scan(cfg_j, wj, jnp.array([9], jnp.int32), jnp.array([0], jnp.int32),
                              JM.KVCache.create(cfg_j, 1, jnp.bfloat16), STEPS)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jt))


@pytest.mark.parametrize("name", ["fp8", "gf4"])
def test_sampled_body_draws_decode_loops_ids(tmp, name):
    """Sampled: the body on the static noise, filled from a generator
    before each run, draws decode_loop's ids from the same seed (B=3,
    per-slot temperature and min-p, slot 1 greedy)."""
    _, (cfg, w) = _models(name, tmp)
    temps, minps = torch.tensor([0.8, 0.0, 1.2]), torch.tensor([0.05, 0.1, 0.2])

    def sampling():
        return torch.Generator().manual_seed(11), temps, minps
    a, b = TM.KVCache.create(cfg, 3), TM.KVCache.create(cfg, 3)
    tok = torch.tensor([4, 5, 6])
    smp = sampling()
    g = TM.step_graph(cfg, w, a, 3, rolling=True, sampled=True)
    g.load(tok, 0, smp)
    toks, logits = _body_run(g, STEPS, smp[0])
    want_t, _, want_l = TM.decode_loop(cfg, w, tok, 0, b, STEPS, sampling())
    assert torch.equal(toks, want_t) and torch.equal(logits, want_l)
    assert len(set(toks[0].tolist())) > 3  # the draws are not the argmax
    assert torch.equal(toks[1], logits[:, 1].argmax(-1))


def test_noise_buffer_draws_equal_the_generator_draws():
    """device_sample on uniforms drawn into a buffer with out= equals
    device_sample drawing them itself, from the same seed, draw after
    draw."""
    logits = torch.randn(4, 300, generator=torch.Generator().manual_seed(1))
    temps, minps = torch.tensor([0.7, 1.0, 0.0, 2.0]), torch.tensor([0.1, 0.01, 0.1, 0.3])
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    u = torch.empty(4, 300)
    for _ in range(6):
        want = device_sample(logits, g1, temps, minps)
        torch.rand(u.shape, generator=g2, out=u)
        assert torch.equal(device_sample(logits, None, temps, minps, u=u), want)


@pytest.mark.parametrize("paged", [False, True])
def test_snapshot_restore_leaves_the_cache_bit_identical(tmp, paged):
    """A warm-up step that wraps (its sink rotation not idempotent) changes
    the cache; the snapshot taken before it puts every byte back."""
    _, (cfg, w) = _models("fp8", tmp)
    B = 3
    pt = torch.from_numpy(_page_table(B)) if paged else None
    if paged:
        cache = _random_cache(TP.create_pool(cfg, pt.numel() + 1, PR), 2)
    else:
        cache = _random_cache(TM.KVCache.create(cfg, B), 2)
    before = _clone(cache)
    pos = torch.tensor(STAGGERED, dtype=torch.int32)
    restore = TM._snapshot(cfg, cache, True)(pos, pt)
    TM._decode(cfg, w, torch.tensor([5, 6, 7]), pos, cache, True, pt)
    assert not _equal(cache, before)
    sinks = TM._sink_slots(cache, B, pt)
    assert not torch.equal(cache.k[:, sinks, :, :2], before.k[:, sinks, :, :2])
    restore()
    assert _equal(cache, before)


def test_replays_count_the_captured_launches(monkeypatch):
    """A capture counts itself and its seconds, a replay counts itself in
    ``ops.cost``'s counters; neither moves a kernel wrapper's launch
    count (a replay runs no wrapper)."""
    def body():
        hopper_qmm.qmm_decode.launches += 3
        return "logits"

    def fake_capture(b, device):  # a capture runs the body twice: warm-up, capture
        return types.SimpleNamespace(replay=lambda: None), (b(), b())[1]
    monkeypatch.setattr(G, "capture", fake_capture)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    g = G.StepGraph(None, lambda pos, pt: lambda: None, 1, 8, "cpu")
    monkeypatch.setattr(g, "body", body)
    c0, q0 = cost.counters(), hopper_qmm.qmm_decode.launches
    g.capture()
    assert g.logits == "logits" and g.capture_s > 0
    assert hopper_qmm.qmm_decode.launches == q0 + 6  # warm-up and capture, as issued
    for _ in range(5):
        g.replay()
    assert hopper_qmm.qmm_decode.launches == q0 + 6
    c = cost.counters()
    assert c["graph.captures"] - c0.get("graph.captures", 0) == 1
    assert c["graph.capture_s"] - c0.get("graph.capture_s", 0) == pytest.approx(g.capture_s)
    assert c["graph.replays"] - c0.get("graph.replays", 0) == 5
    v = G.VerifyGraph(None, lambda pos0: lambda: None, 1, 2, "cpu")
    v.graph = types.SimpleNamespace(replay=lambda: None)
    v.replay()
    assert cost.counters()["graph.replays"] - c0.get("graph.replays", 0) == 6
    hopper_qmm.qmm_decode.launches = q0


def test_graphs_live_on_the_cache(tmp):
    """A cache's graphs are keyed by B, rolling, ROTATED_DECODE, sampled and
    paged, hold their weights, and go when the cache goes."""
    _, (cfg, w) = _models("fp8", tmp)
    cache = TM.KVCache.create(cfg, 2)
    g = TM.step_graph(cfg, w, cache, 2, True)
    assert TM.step_graph(cfg, w, cache, 2, True) is g
    others = {TM.step_graph(cfg, w, cache, 2, False), TM.step_graph(cfg, w, cache, 1, True),
              TM.step_graph(cfg, w, cache, 2, True, sampled=True),
              TM.step_graph(cfg, w, cache, 2, True, pt=torch.zeros((2, 4), dtype=torch.int32))}
    was, TM.ROTATED_DECODE = TM.ROTATED_DECODE, not TM.ROTATED_DECODE
    try:
        others.add(TM.step_graph(cfg, w, cache, 2, True))
    finally:
        TM.ROTATED_DECODE = was
    assert g not in others and len(others) == 5 and len(cache.graphs) == 6
    cache.k = cache.k.clone()  # the buffers a graph was captured on are gone
    with pytest.raises(RuntimeError):
        TM.step_graph(cfg, w, cache, 2, True)
    gone = weakref.ref(g)
    w2 = TM.Weights(w.embed, w.layers, w.final_norm, w.output)
    held = weakref.ref(w2)
    cache2 = TM.KVCache.create(cfg, 1)
    TM.step_graph(cfg, w2, cache2, 1, True)
    del w2, g, others
    assert held() is not None  # the graph holds its weights
    del cache, cache2
    assert gone() is None and held() is None


def test_decode_once_on_the_cpu_is_the_eager_step(tmp):
    """decode_once from host ints: decode_step's logits and their argmax."""
    _, (cfg, w) = _models("fp8", tmp)
    a, b = TM.KVCache.create(cfg, 2), TM.KVCache.create(cfg, 2)
    logits, nxt = TM.decode_once(cfg, w, [3, 4], [31, 2], a, True)
    want, _ = TM.decode_step(cfg, w, [3, 4], [31, 2], b)
    assert torch.equal(logits, want) and torch.equal(nxt, want.argmax(-1))
    assert _equal(a, b)
