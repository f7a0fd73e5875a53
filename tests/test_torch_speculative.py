"""The port's speculative decoding against calm_tpu.speculative on the CPU:
greedy chains with the target as its own draft, a mismatched draft and a
gf4 twin of the target at gamma 1, 3 and 7 (ids, text, rounds and
acceptance equal to JAX's, ids equal to the port's plain greedy), the
window-edge fallback, rejection sampling (deterministic per seed, its first
token distributed as the target's min-p distribution within JAX's own
bound), and the verify a CUDA graph captures: its key, its static inputs
and a body that reads no device value on the host (the capture itself
needs the card: ``chip_smoke.py`` replays it there against the eager
forward). The draft tree is ``test_torch_tree_speculative.py``'s."""

import contextlib
import functools

import numpy as np
import pytest
import torch

from calm_tpu import model as JM
from calm_tpu import speculative as JS
from calm_tpu.engine import Engine as JEngine
from calm_tpu.container import TensorFile as JTensorFile
from calm_tpu_torch import model as TM
from calm_tpu_torch import speculative as TS
from calm_tpu_torch.container import TensorFile
from calm_tpu_torch.engine import Engine as TEngine
from calm_tpu_torch.ops import hopper_attn
from tests.modelgen import tiny_config, write_tiny_model
from tests.test_torch_model import jax_leaves

torch.set_num_threads(1)

PROMPT = "hello world"
STEPS = 24


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The JAX tests' containers (tests/test_speculative.py): a target, a
    draft of other random weights and the target's gf4 twin (same seed)."""
    d = tmp_path_factory.mktemp("tspec")
    paths = {"target": str(d / "target.calm"), "other": str(d / "draft.calm"),
             "gf4": str(d / "draft_gf4.calm")}
    write_tiny_model(paths["target"], tiny_config(dtype="fp16"), seed=11)
    write_tiny_model(paths["other"], tiny_config(dtype="fp16"), seed=77)
    write_tiny_model(paths["gf4"], tiny_config(dtype="gf4"), seed=11)
    paths["self"] = paths["target"]
    return paths


def _engines(models, draft):
    return ((JEngine(models["target"]), JEngine(models[draft])),
            (TEngine(models["target"], device="cpu"), TEngine(models[draft], device="cpu")))


@functools.lru_cache(maxsize=None)
def _plain(path, steps):
    """The port's plain greedy ids of PROMPT."""
    return TEngine(path, device="cpu").generate(PROMPT, steps, temperature=0).ids


def _same_run(got, want):
    assert got.ids == want.ids and got.text == want.text
    assert got.tokens == want.tokens and got.rounds == want.rounds
    assert got.acceptance == want.acceptance


@pytest.mark.parametrize("gamma", [1, 3, 7])
@pytest.mark.parametrize("draft", ["self", "other", "gf4"])
def test_greedy_matches_jax_and_plain_greedy(models, draft, gamma):
    (jt, jd), (tt, td) = _engines(models, draft)
    want = JS.speculative_generate(jt, jd, PROMPT, steps=STEPS, gamma=gamma)
    got = TS.speculative_generate(tt, td, PROMPT, steps=STEPS, gamma=gamma)
    _same_run(got, want)
    assert got.ids == _plain(models["target"], STEPS)
    if draft == "self":  # a draft that IS the target agrees on every proposal
        n = len(got.ids)  # every round but the last emits gamma tokens
        assert got.acceptance == 1.0 and got.rounds == -(-n // gamma)
    if draft == "gf4":  # a correlated draft
        assert got.acceptance > 0.0


def test_window_edge_fallback(models):
    """Speculation near the window's edge falls back to target steps and
    still gives plain greedy's ids (which cross the window via the sinks)."""
    (jt, jd), (tt, td) = _engines(models, "other")
    steps = tt.cfg.seq_len - 2
    want = JS.speculative_generate(jt, jd, PROMPT, steps=steps, gamma=4)
    got = TS.speculative_generate(tt, td, PROMPT, steps=steps, gamma=4)
    _same_run(got, want)
    assert got.ids == _plain(models["target"], steps)


def test_sampled_runs_and_differs_by_seed(models):
    def run(seed):
        _, (tt, td) = _engines(models, "other")
        return TS.speculative_generate(tt, td, PROMPT, steps=STEPS, gamma=4,
                                       temperature=0.9, minp=0.05, seed=seed)

    a1, a2, b = run(3), run(3), run(4)
    assert a1.ids == a2.ids and a1.text == a2.text  # deterministic per seed
    assert a1.ids != b.ids  # seeds differ
    n_prompt = len(TEngine(models["target"], device="cpu").tokenizer.encode(PROMPT, bos=True))
    assert a1.rounds > 0 and a1.tokens == STEPS and len(a1.ids) == STEPS - n_prompt + 1


def test_sampled_first_token_matches_target_distribution(models):
    """One speculative-sampled step reproduces the target's min-p
    distribution, checked empirically with JAX's trials and bound
    (tests/test_speculative.py:99-127); the distribution is JAX's
    ``_minp_probs`` of JAX's logits, and the port's ``_minp_probs`` equals
    it on the same logits."""
    temperature, minp = 1.0, 0.02
    eng = JEngine(models["target"])
    toks = eng.tokenizer.encode(PROMPT, bos=True)
    for p, t in enumerate(toks):
        logits = eng.step(t, p)
    p_true = JS._minp_probs(logits, temperature, minp)
    np.testing.assert_array_equal(TS._minp_probs(logits, temperature, minp), p_true)

    counts = np.zeros_like(p_true)
    _, (tt, td) = _engines(models, "other")
    for seed in range(300):
        tt.reset()
        td.reset()
        st = TS.speculative_generate(tt, td, PROMPT, steps=len(toks), gamma=2,
                                     temperature=temperature, minp=minp, seed=seed + 1)
        counts[st.ids[0]] += 1
    emp = counts / counts.sum()
    support = p_true > 0.01
    assert np.abs(emp[support] - p_true[support]).max() < 0.12


@functools.lru_cache(maxsize=None)
def _pair(path):
    jtf = JTensorFile(path)
    cfg_j = JM.ModelConfig.from_metadata(jtf.metadata)
    wj = JM.load_weights(jtf, cfg_j)
    cfg_t = TM.ModelConfig.from_metadata(TensorFile(path).metadata)
    return (cfg_j, wj), (cfg_t, TM.weights_from_numpy(jax_leaves(wj), cfg_t))


def _tree_inputs(cfg, rng, k, m):
    N = 1 + k * (m - 1)
    tree = TS._tree_mask(k, m)
    depth = np.asarray([0] + [d for _ in range(k) for d in range(1, m)], np.int32)
    toks = rng.integers(3, cfg.vocab_size, (1, N))
    return N, tree, depth, toks


def _rand_cache(rng, shape, dtype):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)


@contextlib.contextmanager
def no_host_reads():
    """Raise at any device value read on the host or any host upload, as a
    CUDA graph capture would fail on them."""
    def refuse(*a, **k):
        raise AssertionError("a host read or upload inside the captured forward")

    names = ("item", "tolist", "numpy", "__bool__", "__int__", "__index__", "__float__")
    saved = {n: getattr(torch.Tensor, n) for n in names}
    up = TM.upload
    try:
        for n in names:
            setattr(torch.Tensor, n, refuse)
        TM.upload = refuse
        yield
    finally:
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)
        TM.upload = up


@pytest.mark.parametrize("fmt,tree", [("fp8", False), ("gf4", False), ("fp8", True)])
def test_verify_graph_body_is_the_eager_verify(tmp_path, rng, monkeypatch, fmt, tree):
    """A VerifyGraph's body, run eagerly from its static inputs (B=2
    linear, or the k=3, m=4 tree), reads no device value on the host and
    gives the eager forward's logits and cache rows bit for bit; its
    snapshot puts back every row the warm-up wrote. A linear forward's
    attention is K13 on the card, which takes its bounds on the device;
    here its plain version stands in, over every row of the window (the
    plain version sizes its read by kv_len on the host)."""
    S = tiny_config().seq_len
    monkeypatch.setattr(TM, "prefill_attention",
                        lambda *a: hopper_attn.prefill_attention_plain(*a, rows=S))
    kw = dict(dim=64, hidden_dim=64, head_dim=16, rotary_dim=16) if fmt == "gf4" else {}
    path = str(tmp_path / f"{fmt}.calm")
    write_tiny_model(path, tiny_config(dtype=fmt, **kw), seed=5)
    _, (cfg, w) = _pair(path)
    B = 1 if tree else 2
    base = _rand_cache(rng, (cfg.n_layers, B, cfg.n_kv_heads, cfg.seq_len, cfg.head_dim),
                       torch.bfloat16)
    a = TM.KVCache(base.clone(), base.clone() * 0.5)
    b = TM.KVCache(a.k.clone(), a.v.clone())
    if tree:
        T, mask, depth, toks = _tree_inputs(cfg, rng, 3, 4)
        starts = [7]
        want = TM.tree_verify(cfg, w, torch.from_numpy(toks), starts,
                              torch.from_numpy(depth), torch.from_numpy(mask), b)[0]
    else:
        T, mask, depth = 5, None, None
        toks = rng.integers(3, cfg.vocab_size, (B, T))
        starts = [3, 20]
        want = TM.prefill(cfg, w, torch.from_numpy(toks), starts, b, "all")[0]
    g = TM.verify_graph(cfg, w, a, B, T, tree)
    g.load(toks, starts, depth, mask)
    restore = g.snapshot(g.pos0)
    before = (a.k.clone(), a.v.clone())
    with no_host_reads():
        got = g.body()
    assert torch.equal(got, want)
    assert torch.equal(a.k, b.k) and torch.equal(a.v, b.v)
    restore()
    assert torch.equal(a.k, before[0]) and torch.equal(a.v, before[1])


def test_verify_graphs_live_on_the_cache(tmp_path):
    """A cache's verify graphs are keyed by B, T, the tree's shape,
    ROTATED_DECODE, the precise mode and the KV dtype, beside its step
    graphs; another cache buffer is refused."""
    path = str(tmp_path / "fp8.calm")
    write_tiny_model(path, tiny_config(dtype="fp8"), seed=5)
    _, (cfg, w) = _pair(path)
    cache = TM.KVCache.create(cfg, 2)
    g = TM.verify_graph(cfg, w, cache, 2, 5)
    assert TM.verify_graph(cfg, w, cache, 2, 5) is g
    assert g.depth is None and tuple(g.tokens.shape) == (2, 5)
    others = {TM.verify_graph(cfg, w, cache, 2, 4), TM.verify_graph(cfg, w, cache, 2, 5, True),
              TM.step_graph(cfg, w, cache, 2, False)}
    from calm_tpu_torch.ops import qmm as tqmm
    was = tqmm._PRECISE
    tqmm.enable_precise(not was)
    try:
        others.add(TM.verify_graph(cfg, w, cache, 2, 5))
    finally:
        tqmm.enable_precise(was)
    assert g not in others and len(cache.graphs) == 5
    t = TM.verify_graph(cfg, w, cache, 2, 5, True)
    assert tuple(t.depth.shape) == (5,) and tuple(t.tree.shape) == (5, 5)
    with pytest.raises(ValueError):
        t.load(np.zeros((2, 5), np.int64), [0, 0])  # a tree graph needs its tree
    c16 = TM.KVCache.create(cfg, 2, torch.float16)
    assert TM.verify_graph(cfg, w, c16, 2, 5) is not g
    cache.k = cache.k.clone()
    with pytest.raises(RuntimeError):
        TM.verify_graph(cfg, w, cache, 2, 5)


def test_verify_once_on_the_cpu_is_the_eager_forward(tmp_path, rng):
    """verify_once from host numbers: prefill's "all" logits, or
    tree_verify's; a start past the window raises."""
    path = str(tmp_path / "fp16.calm")
    write_tiny_model(path, tiny_config(dtype="fp16"), seed=5)
    _, (cfg, w) = _pair(path)
    a, b = TM.KVCache.create(cfg, 2), TM.KVCache.create(cfg, 2)
    toks = rng.integers(3, cfg.vocab_size, (2, 4))
    got = TM.verify_once(cfg, w, toks.tolist(), [0, 6], a)
    want = TM.prefill(cfg, w, torch.from_numpy(toks), [0, 6], b, "all")[0]
    assert torch.equal(got, want) and torch.equal(a.k, b.k)
    with pytest.raises(ValueError):
        TM.verify_once(cfg, w, toks.tolist(), [0, cfg.seq_len - 3], a)
