"""Parallel-norm (Cohere-style, ``norm_type=layernorm_par``) models and
the CALM_ROT=0 decode on the port, against calm_tpu on the CPU: the
weights, including the JAX engine's fused gf4 layouts; decode steps
(gf4 also against the JAX fused path with gf4_ffn, K6, in Pallas
interpret mode), prefill, perplexity and a served drain of norm_par
containers; decode with ROTATED_DECODE off, gf4 against the JAX planed
path (gf4_offn, K7, in interpret mode). The kernels themselves are held
to their Pallas versions in tests/test_torch_gf4_ffn.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calm_tpu import engine as JE
from calm_tpu import model as JM
from calm_tpu import serve as JS
from calm_tpu.container import TensorFile as JTensorFile
from calm_tpu.ops import pallas_attn, pallas_qmm
from calm_tpu.ops import qmm as jqmm
from calm_tpu_torch import engine as TE
from calm_tpu_torch import model as TM
from calm_tpu_torch import serve as TS
from calm_tpu_torch.container import TensorFile
from calm_tpu_torch.utils.synth import synth_container, weight_bytes
from tests.modelgen import tiny_config, write_tiny_model
from tests.test_torch_model import _assert_same_weights, _run_both, jax_leaves

torch.set_num_threads(1)


@pytest.fixture
def interpret():
    pallas_qmm.set_interpret(True)
    pallas_attn.set_interpret(True)
    yield
    pallas_qmm.set_interpret(False)
    pallas_attn.set_interpret(False)


# -- weights --------------------------------------------------------------------


NP_CASES = {
    "fp16": dict(dtype="fp16"),
    "fp8": dict(dtype="fp8"),
    "fp16-gelu": dict(dtype="fp16", act_gelu=True),
    "gf4": dict(dtype="gf4", dim=64, hidden_dim=64, head_dim=16, rotary_dim=16),
}


def _np_model(tmp_path, name, seed=9, seq_len=32, **write_kw):
    cfg = tiny_config(seq_len=seq_len, norm_ln=True, norm_par=True, **NP_CASES[name])
    path = str(tmp_path / f"np-{name}.calm")
    write_tiny_model(path, cfg, seed=seed, **write_kw)
    return path


def _both_weights(path):
    jtf = JTensorFile(path)
    jcfg = JM.ModelConfig.from_metadata(jtf.metadata)
    tf = TensorFile(path)
    cfg = TM.ModelConfig.from_metadata(tf.metadata)
    return jcfg, JM.load_weights(jtf, jcfg), cfg, TM.load_weights(tf, cfg)


@pytest.mark.parametrize("name", ["fp8", "gf4"])
def test_norm_par_weights_load_with_zero_ffn_norm(tmp_path, name):
    """No mlp.norm.weight in the container: zeros, as the JAX package; the
    weights equal JAX's bit for bit, and the JAX engine's fused gf4 tier
    for norm_par (w1p/w3p, w2t, wqkv, natural wo) undoes to them."""
    jcfg, wj, cfg, wt = _both_weights(_np_model(tmp_path, name))
    assert cfg.norm_par and cfg.norm_ln
    assert not wt.layers.ffn_norm.any()
    _assert_same_weights(TM.weights_from_numpy(jax_leaves(wj), cfg), wt)
    if name == "gf4":
        leaves = jax_leaves(JM.fuse_gf4_weights(wj, jcfg))
        assert {"layers.w1p", "layers.w3p", "layers.w2t", "layers.wqkv",
                "layers.wo"} <= leaves.keys() and "layers.w1" not in leaves
        _assert_same_weights(TM.weights_from_numpy(leaves, cfg), wt)


def test_weights_from_numpy_takes_the_offn_tier(tmp_path):
    """A dense gf4 model's fused tier (wo_p, w2tp, an_pl, fn_pl beside
    w1p/w3p and wqkv): the naturals come back bit for bit."""
    cfg = tiny_config(dtype="gf4", seq_len=32, dim=64, hidden_dim=64, head_dim=16,
                      rotary_dim=16)
    path = str(tmp_path / "offn.calm")
    write_tiny_model(path, cfg, seed=4)
    jcfg, wj, tcfg, wt = _both_weights(path)
    leaves = jax_leaves(JM.fuse_gf4_weights(wj, jcfg))
    assert {"layers.wo_p", "layers.w2tp", "layers.an_pl", "layers.fn_pl"} <= leaves.keys()
    assert "layers.wo" not in leaves and "layers.w2t" not in leaves
    _assert_same_weights(TM.weights_from_numpy(leaves, tcfg), wt)


def test_synth_container_and_bytes_for_norm_par(tmp_path):
    """synth_container writes no mlp.norm.weight for norm_par (and no
    output with ``tied``); weight_bytes counts what such a container
    holds, as the Engine's accounting reads it."""
    cfg = tiny_config(dtype="fp8", norm_ln=True, norm_par=True)
    path = str(tmp_path / "s.calm")
    synth_container(path, cfg, seed=2, random=True)
    tf = TensorFile(path)
    assert tf.find("model.layers.%d.mlp.norm.weight", 0) is None
    eng = TE.Engine(path, device="cpu")
    assert weight_bytes(cfg) == (eng.n_bytes, eng.n_bandwidth)
    tied = str(tmp_path / "t.calm")
    synth_container(tied, cfg, seed=2, random=True, tied=True)
    te = TE.Engine(tied, device="cpu")
    assert te.weights.output is te.weights.embed
    assert te.n_bandwidth == eng.n_bandwidth


# -- decode ---------------------------------------------------------------------


@pytest.mark.parametrize("name,kv", [("fp16", "bf16"), ("fp8", "fp16"),
                                     ("fp16-gelu", "bf16"), ("gf4", "bf16")])
def test_norm_par_decode_steps_match_jax(tmp_path, name, kv):
    """40 steps at seq_len 32 (through the sinks and the rolling write),
    f32 on both sides; gf4 in the JAX engine's fused layouts."""
    got, want = _run_both(_np_model(tmp_path, name), kv, 40, JM.decode_step)
    err = np.abs(got - want).max(axis=-1) / np.abs(want).max(axis=-1)
    assert err.max() < 1e-4, err
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_norm_par_ignores_ffn_norm(tmp_path):
    """The FFN reads the attn-normed input, never ffn-norm(x + wo att):
    a nonzero ffn_norm in the arrays leaves the logits as they were."""
    jcfg, wj, cfg, _ = _both_weights(_np_model(tmp_path, "fp16"))
    leaves = jax_leaves(wj)
    leaves["layers.ffn_norm"] = np.full_like(leaves["layers.ffn_norm"], 3.0)
    wt = TM.weights_from_numpy(leaves, cfg)
    want, _ = JM.decode_step(jcfg, wj, jnp.array([5], jnp.int32), jnp.array([0], jnp.int32),
                             JM.KVCache.create(jcfg, 1, jnp.bfloat16))
    got, _ = TM.decode_step(cfg, wt, torch.tensor([5]), 0, TM.KVCache.create(cfg, 1))
    want = np.asarray(want, np.float32)
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() < 1e-4


def _spy(monkeypatch, name):
    calls = []
    real = getattr(pallas_qmm, name)

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(pallas_qmm, name, spy)
    return calls


@pytest.fixture
def pallas_on(interpret):
    jqmm.enable_pallas(True)
    yield
    jqmm.enable_pallas(False)


def test_norm_par_gf4_decode_matches_jax_gf4_ffn_interpret(tmp_path, monkeypatch,
                                                           pallas_on):
    """The JAX engine's fused norm_par tier with its Pallas kernels in
    interpret mode (gf4_ffn, K6, on every layer; bf16 operands there)
    against the port on the weights weights_from_numpy carries over (its
    plain gf4_ffn, K6's function)."""
    cfg = tiny_config(dtype="gf4", seq_len=32, dim=128, hidden_dim=256, head_dim=32,
                      rotary_dim=32, n_heads=4, n_kv_heads=2, norm_ln=True,
                      norm_par=True)
    path = str(tmp_path / "np-k6.calm")
    write_tiny_model(path, cfg, seed=22)  # top-2 logits >= 3% of scale apart
    calls = _spy(monkeypatch, "gf4_ffn")
    step = jax.jit(JM.decode_step_fn, static_argnames=("cfg",))
    got, want = _run_both(path, "bf16", 6, step)
    assert calls, "the JAX side did not take gf4_ffn"
    err = np.abs(got - want).max(axis=-1) / np.abs(want).max(axis=-1)
    assert err.max() < 5e-2, err
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.fixture
def unrotated(monkeypatch):
    """ROTATED_DECODE off in both packages; JAX's is read at trace time,
    so its jit caches are cleared on both sides of the flip."""
    jax.clear_caches()
    monkeypatch.setattr(JM, "ROTATED_DECODE", False)
    monkeypatch.setattr(TM, "ROTATED_DECODE", False)
    yield
    jax.clear_caches()


def test_unrotated_gf4_decode_matches_jax_gf4_offn_interpret(tmp_path, monkeypatch,
                                                             pallas_on, unrotated):
    """CALM_ROT=0: the JAX planed path runs gf4_offn (K7) on every layer,
    in interpret mode; the port runs its own gf4_offn (plain) after each
    layer's q/k/v, and no rotated carry."""
    cfg = tiny_config(dtype="gf4", seq_len=32, dim=256, hidden_dim=384, head_dim=64,
                      rotary_dim=64, n_heads=4, n_kv_heads=2)
    path = str(tmp_path / "rot0.calm")
    write_tiny_model(path, cfg, seed=14)
    tf = TensorFile(path)
    tcfg = TM.ModelConfig.from_metadata(tf.metadata)
    wt = TM.load_weights(tf, tcfg)
    assert TM._offn(tcfg, wt, 1) and not TM._fused(tcfg, wt, 1)
    calls = _spy(monkeypatch, "gf4_offn")
    qkv_calls = _spy(monkeypatch, "gf4_offn_qkv")
    tcalls = []
    real = TM.gf4_offn

    def tspy(*a, **k):
        tcalls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(TM, "gf4_offn", tspy)
    step = jax.jit(JM.decode_step_fn, static_argnames=("cfg",))
    got, want = _run_both(path, "bf16", 6, step)
    assert calls and not qkv_calls, "the JAX side did not take gf4_offn alone"
    assert len(tcalls) == 6 * cfg.n_layers
    err = np.abs(got - want).max(axis=-1) / np.abs(want).max(axis=-1)
    assert err.max() < 5e-2, err
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("fmt", ["fp8", "gf4"])
def test_unrotated_decode_matches_jax_f32(tmp_path, fmt, unrotated):
    """CALM_ROT=0 on the f32 path: fp8 per op (no fused carry), gf4 through
    K7's plain version, both against the JAX f32 decode."""
    cfg = tiny_config(dtype=fmt, seq_len=32, dim=256, hidden_dim=384, head_dim=64,
                      rotary_dim=64, n_heads=4, n_kv_heads=2)
    path = str(tmp_path / f"rot0-{fmt}.calm")
    # a seed whose bf16 cache rows round alike on both sides (at seed 15 one
    # f32 sum order flips a row's rounding and moves fp8 logits by 1.2e-4)
    write_tiny_model(path, cfg, seed=16)
    tf = TensorFile(path)
    tcfg = TM.ModelConfig.from_metadata(tf.metadata)
    wt = TM.load_weights(tf, tcfg)
    assert not TM._fused(tcfg, wt, 1) and TM._offn(tcfg, wt, 1) == (fmt == "gf4")
    got, want = _run_both(path, "bf16", 36, JM.decode_step)
    err = np.abs(got - want).max(axis=-1) / np.abs(want).max(axis=-1)
    assert err.max() < 1e-4, err
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


# -- prefill, perplexity, serving ----------------------------------------------


@pytest.mark.parametrize("name,T,starts", [("fp16", 20, [0, 3]), ("gf4", 20, [0, 3]),
                                           ("gf4", 7, [2])])
def test_norm_par_prefill_matches_jax(tmp_path, rng, name, T, starts):
    """logits "all": 40 rows (the product kernels' path) or 7 rows (K6's
    plain version, as the JAX package's gf4_ffn at <= 16 rows)."""
    jcfg, wj, cfg, wt = _both_weights(_np_model(tmp_path, name))
    toks = rng.integers(3, cfg.vocab_size, (len(starts), T))
    want, _ = JM.prefill(jcfg, wj, jnp.asarray(toks, jnp.int32),
                         jnp.asarray(starts, jnp.int32),
                         JM.KVCache.create(jcfg, len(starts), jnp.bfloat16),
                         logits_mode="all")
    got, _ = TM.prefill(cfg, wt, torch.from_numpy(toks), starts,
                        TM.KVCache.create(cfg, len(starts)), "all")
    want = np.asarray(want, np.float32)
    scale = np.abs(want).max(axis=-1, keepdims=True)
    assert (np.abs(got.numpy() - want) / scale).max() < 1e-4
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("name", ["fp8", "gf4"])
def test_norm_par_perplexity_matches_jax(tmp_path, name):
    path = _np_model(tmp_path, name)
    text = "the quick brown fox jumps over the lazy dog, again."
    want = JE.Engine(path).perplexity(text, steps=16)
    got = TE.Engine(path, device="cpu").perplexity(text, steps=16)
    assert got[2] == want[2]
    np.testing.assert_allclose(got[:2], want[:2], rtol=1e-4)


def test_norm_par_server_matches_jax(tmp_path):
    """One drain of three requests (greedy and host-sampled, the third
    admitted into a reused slot) on a tied norm_par container."""
    path = _np_model(tmp_path, "fp16", seq_len=64, tied=True)
    reqs = [("hello world", 8, 0.0, 1), ("the quick", 10, 0.9, 7), ("pack my box", 6, 0.0, 1)]

    def drain(srv):
        out = [srv.submit(p, max_tokens=n, temperature=t, seed=s) for p, n, t, s in reqs]
        srv.run_until_drained(max_ticks=200)
        assert all(r.done for r in out)
        return [(r.text, r.n_generated) for r in out]
    want = drain(JS.Server(path, batch=2, kv_dtype="fp16"))
    got = drain(TS.Server(path, batch=2, kv_dtype="fp16", device="cpu"))
    assert got == want and len({t for t, _ in got}) == len(got)


def test_norm_par_config_roundtrip():
    cfg = tiny_config(norm_ln=True, norm_par=True)
    md = cfg.to_metadata()
    assert md["norm_type"] == "layernorm_par"
    tcfg = TM.ModelConfig.from_metadata(md)
    assert tcfg.norm_par and tcfg.norm_ln
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(
        JM.ModelConfig.from_metadata(md))
