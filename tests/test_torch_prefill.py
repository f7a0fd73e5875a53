"""The port's batched prefill against calm_tpu on the CPU: the plain K13
(``prefill_attention_plain``) against the Pallas prefill kernel in
interpret mode and an exact numpy softmax, and ``model.prefill`` against
``calm_tpu.model.prefill`` for fp8, fp16 and gf4, logits "last" and "all",
from position 0 and on a cache an earlier prefill filled."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calm_tpu import engine as JE
from calm_tpu import model as JM
from calm_tpu.container import TensorFile as JTensorFile
from calm_tpu.ops import pallas_attn
from calm_tpu_torch import engine as TE
from calm_tpu_torch import model as TM
from calm_tpu_torch.container import TensorFile
from calm_tpu_torch.ops import hopper_attn
from tests.modelgen import tiny_config, write_tiny_model
from tests.test_torch_model import jax_leaves

torch.set_num_threads(1)

_JKV = {"bf16": jnp.bfloat16, "fp16": jnp.float16, "fp8": jnp.float8_e5m2,
        "f32": jnp.float32}
_TKV = {**TM.KV_DTYPES, "f32": torch.float32}  # f32: a cache that rounds nothing


def _to_torch(x, kv: str) -> torch.Tensor:
    a = np.asarray(x)
    if kv == "fp8":
        return torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e5m2)
    return torch.from_numpy(a.astype(np.float32)).to(TM.KV_DTYPES[kv])  # exact


@pytest.mark.parametrize("kv", ["bf16", "fp8"])
@pytest.mark.parametrize("pos0", [0, 5])
def test_prefill_attention_plain(rng, kv, pos0):
    """As tests/test_pallas_attn.py:88-142, with B=2 and ragged starts."""
    B, T, KVH, M, hd, S, L = 2, 8, 2, 2, 32, 32, 3
    layer = 1
    starts = np.array([pos0, pos0 + 3], np.int32)
    kv_len = starts + T
    q = rng.standard_normal((B, T, KVH, M, hd)).astype(np.float32)
    kc = jnp.asarray(rng.standard_normal((L, B, KVH, S, hd)) * 0.5, _JKV[kv])
    vc = jnp.asarray(rng.standard_normal((L, B, KVH, S, hd)) * 0.5, _JKV[kv])
    got = hopper_attn.prefill_attention(
        torch.from_numpy(q), _to_torch(kc, kv), _to_torch(vc, kv),
        torch.from_numpy(starts), torch.from_numpy(kv_len), layer).numpy()

    pallas_attn.set_interpret(True)
    try:
        pal = np.asarray(pallas_attn.prefill_attention(
            jnp.asarray(q), kc, vc, jnp.asarray(starts), jnp.asarray(kv_len),
            jnp.int32(layer)))
    finally:
        pallas_attn.set_interpret(False)
    # the Pallas side rounds q and p to bf16 for its products; the test of
    # the kernel itself holds it at 3e-2 (tests/test_pallas_attn.py:118)
    np.testing.assert_allclose(got, pal, rtol=3e-2, atol=3e-2)

    # and the exact masked softmax, in numpy, over the same rows
    k = np.asarray(kc[layer], np.float32)
    v = np.asarray(vc[layer], np.float32)
    for b in range(B):
        for h in range(KVH):
            rows = k[b, h]
            for m in range(M):
                for t in range(T):
                    sc = rows @ q[b, t, h, m] / math.sqrt(hd)
                    ok = (np.arange(S) < kv_len[b]) & (np.arange(S) <= starts[b] + t)
                    p = np.exp(np.where(ok, sc - sc[ok].max(), -np.inf))
                    np.testing.assert_allclose(got[b, t, h, m], p @ v[b, h] / p.sum(),
                                               rtol=1e-5, atol=1e-5)


def test_prefill_attention_row_with_nothing_visible():
    """A query with no visible cache row (kv_len 0) gets 0, not NaN: the
    shift is clamped and the sum divided by max(l, 1e-37), as in
    pallas_attn.py:374-390."""
    q = torch.randn(1, 3, 1, 2, 64)
    kc = torch.randn(1, 1, 1, 8, 64).to(torch.bfloat16)
    out = hopper_attn.prefill_attention(
        q, kc, kc, torch.tensor([0], dtype=torch.int32),
        torch.tensor([0], dtype=torch.int32), 0)
    assert torch.equal(out, torch.zeros_like(out))


CASES = {
    "fp8": dict(dtype="fp8"),
    "fp16": dict(dtype="fp16"),
    "gf4": dict(dtype="gf4", dim=64, hidden_dim=64, head_dim=16, rotary_dim=16),
    # Phi-3-mini's and Gemma's head dims (96, 256), and 8 query heads a kv
    # head, as Gemma-2B
    "hd96": dict(dtype="fp16", dim=192, hidden_dim=128, head_dim=96, n_heads=2,
                 n_kv_heads=2, rotary_dim=96),
    "hd256": dict(dtype="fp8", dim=128, hidden_dim=128, head_dim=256, n_heads=8,
                  n_kv_heads=1, rotary_dim=256, act_gelu=True),
}
# the cache of each row: fp8 for fp16 weights, f32 for the head-dim rows
# (their logits at 1e-4 of scale hold the model's f32 math; with a 16-bit
# cache, K/V that differ by a few f32 ulps round to different bf16 values
# now and then, which test_prefill_head_dim_cache_differs_by_roundings
# accounts for), bf16 else
CACHE = {"fp16": "fp8", "hd96": "f32", "hd256": "f32"}


def _models(tmp_path, name, seed=3):
    """The JAX weights from a container, and the port's built from their
    leaves by ``weights_from_numpy``."""
    cfg = tiny_config(seq_len=32, **CASES[name])
    path = str(tmp_path / f"{name}.calm")
    write_tiny_model(path, cfg, seed=seed)
    jtf = JTensorFile(path)
    cfg_j = JM.ModelConfig.from_metadata(jtf.metadata)
    wj = JM.load_weights(jtf, cfg_j)
    cfg_t = TM.ModelConfig.from_metadata(TensorFile(path).metadata)
    return (cfg_j, wj), (cfg_t, TM.weights_from_numpy(jax_leaves(wj), cfg_t))


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("mode", ["last", "all"])
def test_prefill_matches_jax(tmp_path, rng, name, mode):
    """Two slots at starts 0 and 2 (T=11), then a second prefill on the
    filled cache at starts 11 and 13 (T=9), on the row's cache (CACHE)."""
    (cfg_j, wj), (cfg_t, wt) = _models(tmp_path, name)
    kv = CACHE.get(name, "bf16")
    cj = JM.KVCache.create(cfg_j, 2, _JKV[kv])
    ct = TM.KVCache.create(cfg_t, 2, _TKV[kv])
    for T, starts in ((11, [0, 2]), (9, [11, 13])):
        toks = rng.integers(3, cfg_t.vocab_size, (2, T))
        want, cj = JM.prefill(cfg_j, wj, jnp.asarray(toks, jnp.int32),
                              jnp.asarray(starts, jnp.int32), cj, logits_mode=mode)
        got, ct = TM.prefill(cfg_t, wt, torch.from_numpy(toks), starts, ct, mode)
        want = np.asarray(want, np.float32)
        assert got.shape == want.shape
        # f32 on both sides, sums in another order
        scale = np.abs(want).max(axis=-1, keepdims=True)
        assert (np.abs(got.numpy() - want) / scale).max() < 1e-4
        np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))
    for b in range(2):  # the written rows, in the cache dtype
        hi = [11 + 9, 13 + 9][b]
        np.testing.assert_allclose(
            ct.k[:, b, :, :hi].float().numpy(),
            np.asarray(cj.k[:, b, :, :hi], np.float32), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("name", ["hd96", "hd256"])
def test_prefill_head_dim_cache_differs_by_roundings(tmp_path, rng, name):
    """At head dims 96 and 256 (fp8 weights at 256) the port's f32 K and V
    agree with the JAX package's within a few f32 ulps of their scale in
    every layer (an f32 cache on both sides); with a bf16 cache each side
    writes the round-to-nearest-even of its own f32 rows, so layer 0's rows
    differ only where the two f32 values, within 2 ulps of scale of each
    other, straddle a bf16 rounding boundary, and in few elements. Those
    flips, carried into the next layer and the next prefill, are what keeps
    a bf16 cache's logits from the f32 cache's agreement."""
    (cfg_j, wj), (cfg_t, wt) = _models(tmp_path, name)
    toks = rng.integers(3, cfg_t.vocab_size, (2, 11))
    rows = {}
    for kv in ("f32", "bf16"):
        cj = JM.KVCache.create(cfg_j, 2, _JKV[kv])
        ct = TM.KVCache.create(cfg_t, 2, _TKV[kv])
        _, cj = JM.prefill(cfg_j, wj, jnp.asarray(toks, jnp.int32),
                           jnp.asarray([0, 2], jnp.int32), cj)
        _, ct = TM.prefill(cfg_t, wt, torch.from_numpy(toks), [0, 2], ct)
        rows[kv] = [(torch.from_numpy(np.asarray(a, np.float32)), b.float())
                    for a, b in ((cj.k, ct.k), (cj.v, ct.v))]
    flips = 0
    for (j32, t32), (j16, t16) in zip(rows["f32"], rows["bf16"]):
        for layer in range(cfg_t.n_layers):
            ulp = float(np.spacing(np.float32(j32[layer].abs().max())))
            assert (t32[layer] - j32[layer]).abs().max() <= 32 * ulp
        ulp = float(np.spacing(np.float32(j32[0].abs().max())))
        assert torch.equal(t16[0], t32[0].bfloat16().float())
        assert torch.equal(j16[0], j32[0].bfloat16().float())
        diff = t16[0] != j16[0]
        assert bool(((t32[0] - j32[0]).abs()[diff] <= 2 * ulp).all())
        flips += int(diff.sum())
    assert flips <= 2e-3 * 2 * j32[0].numel()



def test_prefill_none_mode_and_window_check(tmp_path):
    (_, _), (cfg, w) = _models(tmp_path, "fp8")
    cache = TM.KVCache.create(cfg, 1)
    out, cache = TM.prefill(cfg, w, torch.tensor([[5, 6, 7]]), [0], cache, "none")
    assert out is None and cache.k[:, 0, :, :3].abs().sum() > 0
    with pytest.raises(ValueError):
        TM.prefill(cfg, w, torch.ones(1, 4, dtype=torch.int64), [29], cache)


def test_engine_prefill_chunks_and_window(tmp_path, monkeypatch):
    """Chunked prefill (PREFILL_CHUNK 4) equals one chunk and the JAX
    engine's, and a prompt past the window is stepped as JAX steps it."""
    path = str(tmp_path / "m.calm")
    write_tiny_model(path, tiny_config(dtype="fp8", seq_len=16), seed=4)
    toks = [1] + list(range(40, 60))  # 21 tokens: 5 past the window
    want = JE.Engine(path).prefill_tokens(toks)
    te = TE.Engine(path, device="cpu")
    whole = te.prefill_tokens(toks)
    monkeypatch.setattr(TE.Engine, "PREFILL_CHUNK", 4)
    te.reset()
    chunked = te.prefill_tokens(toks)
    scale = np.abs(want).max()
    assert np.abs(whole - want).max() / scale < 1e-4
    assert np.abs(chunked - whole).max() / scale < 1e-5
