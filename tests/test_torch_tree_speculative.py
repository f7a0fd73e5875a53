"""The port's draft-tree speculation against calm_tpu on the CPU:
``tree_verify``'s logits and rows against ``calm_tpu.model.tree_verify``,
``cache_move_rows``/``cache_bcast_rows`` bit for bit (overlapping ranges
and clamped offsets included), the tree mask, and
``tree_speculative_generate`` greedy-exact against JAX's loop and the
port's plain greedy, with its acceptance on the gf4 twin of the target
(tests/test_speculative.py:133-215)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calm_tpu import model as JM
from calm_tpu import speculative as JS
from calm_tpu_torch import model as TM
from calm_tpu_torch import speculative as TS
from tests.modelgen import tiny_config, write_tiny_model
from tests.test_torch_speculative import (PROMPT, STEPS, _engines, _pair, _plain,  # noqa: F401
                                          _rand_cache, _same_run, _tree_inputs, models)

torch.set_num_threads(1)


@pytest.mark.parametrize("k,m", [(1, 3), (2, 2), (3, 4), (4, 5)])
def test_tree_mask_equals_jax(k, m):
    np.testing.assert_array_equal(TS._tree_mask(k, m), JS._tree_mask(k, m))


@pytest.mark.parametrize("fmt", ["fp16", "fp8", "gf4"])
def test_tree_verify_matches_jax(tmp_path, rng, fmt):
    """A 9-token prefill, then one tree of k=3, m=4 (10 nodes) from pos0 =
    9: logits within the prefill parity tests' 1e-4 of scale and the same
    argmaxes, every node's K/V row where JAX writes it."""
    kw = dict(dim=64, hidden_dim=64, head_dim=16, rotary_dim=16) if fmt == "gf4" else {}
    path = str(tmp_path / f"{fmt}.calm")
    write_tiny_model(path, tiny_config(dtype=fmt, **kw), seed=3)
    (cfg_j, wj), (cfg, w) = _pair(path)
    pre = rng.integers(3, cfg.vocab_size, (1, 9))
    cj = JM.KVCache.create(cfg_j, 1, jnp.float32)
    ct = TM.KVCache.create(cfg, 1, torch.float32)
    _, cj = JM.prefill(cfg_j, wj, jnp.asarray(pre, jnp.int32), jnp.array([0], jnp.int32), cj)
    TM.prefill(cfg, w, torch.from_numpy(pre), [0], ct)
    N, tree, depth, toks = _tree_inputs(cfg, rng, 3, 4)
    want, cj = JM.tree_verify(cfg_j, wj, jnp.asarray(toks, jnp.int32), jnp.array([9], jnp.int32),
                              jnp.asarray(depth), jnp.asarray(tree), cj)
    got, ct = TM.tree_verify(cfg, w, torch.from_numpy(toks), [9], torch.from_numpy(depth),
                             torch.from_numpy(tree), ct)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape == (1, N, cfg.vocab_size)
    scale = np.abs(want).max(axis=-1, keepdims=True)
    assert (np.abs(got.numpy() - want) / scale).max() < 1e-4
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(ct.k[:, :, :, :9 + N].numpy(),
                               np.asarray(cj.k[:, :, :, :9 + N]), rtol=1e-4, atol=1e-4)
    # a chain-shaped tree (one lane) is the causal verify of the same tokens
    chain = np.tril(np.ones((4, 4), bool))
    c2 = TM.KVCache(ct.k.clone(), ct.v.clone())
    c3 = TM.KVCache(ct.k.clone(), ct.v.clone())
    lin = TM.prefill(cfg, w, torch.from_numpy(toks[:, :4]), [9], c2, "all")[0]
    tv = TM.tree_verify(cfg, w, torch.from_numpy(toks[:, :4]), [9],
                        torch.arange(4, dtype=torch.int32), torch.from_numpy(chain), c3)[0]
    assert (tv - lin).abs().max() / lin.abs().max() < 1e-5


@pytest.mark.parametrize("dtype", ["bf16", "fp8"])
def test_cache_row_moves_bit_equal_jax(rng, dtype):
    """cache_move_rows and cache_bcast_rows on the same bytes as JAX's
    functions: disjoint and overlapping ranges both ways, offsets past the
    window (clamped as JAX's dynamic slices clamp), in place."""
    tdt = TM.KV_DTYPES[dtype]
    jdt = {"bf16": jnp.bfloat16, "fp8": jnp.float8_e5m2}[dtype]
    shape = (2, 3, 2, 20, 4)
    k, v = _rand_cache(rng, shape, tdt), _rand_cache(rng, shape, tdt)

    def jax_of(t):
        a = (t.view(torch.uint8).numpy() if dtype == "fp8" else t.float().numpy())
        return jnp.asarray(a.view(jnp.float8_e5m2) if dtype == "fp8" else a, jdt)

    def same(tc, jc):
        for a, b in ((tc.k, jc.k), (tc.v, jc.v)):
            b = np.asarray(b)
            if dtype == "fp8":
                np.testing.assert_array_equal(a.view(torch.uint8).numpy(), b.view(np.uint8))
            else:
                np.testing.assert_array_equal(a.float().numpy(), b.astype(np.float32))

    tc = TM.KVCache(k.clone(), v.clone())
    jc = JM.KVCache(jax_of(k), jax_of(v))
    for src0, dst0, n in ((10, 2, 3), (4, 6, 5), (7, 5, 6), (18, 1, 4), (3, 19, 3)):
        kbuf = tc.k
        out = TM.cache_move_rows(tc, src0, dst0, n)
        assert out.k is kbuf  # in place
        jc = JM.cache_move_rows(jc, jnp.int32(src0), jnp.int32(dst0), n)
        same(tc, jc)
    for lane, row0, n in ((2, 5, 4), (0, 3, 2), (1, 18, 4)):
        TM.cache_bcast_rows(tc, lane, row0, n)
        jc = JM.cache_bcast_rows(jc, jnp.int32(lane), jnp.int32(row0), n)
        same(tc, jc)


@pytest.mark.parametrize("k,m", [(1, 3), (2, 2), (4, 5)])
def test_tree_greedy_exact_and_jax(models, k, m):
    (jt, jd), (tt, td) = _engines(models, "other")
    want = JS.tree_speculative_generate(jt, jd, PROMPT, steps=STEPS, k=k, m=m)
    got = TS.tree_speculative_generate(tt, td, PROMPT, steps=STEPS, k=k, m=m)
    _same_run(got, want)
    assert got.ids == _plain(models["target"], STEPS)


def test_tree_self_draft_accepts_everything(models):
    _, (tt, td) = _engines(models, "self")
    got = TS.tree_speculative_generate(tt, td, PROMPT, steps=STEPS, k=2, m=4)
    assert got.ids == _plain(models["target"], STEPS) and got.acceptance == 1.0


def test_tree_acceptance_gf4_twin(models):
    """The gf4 twin, a correlated draft: the k=3 tree accepts at least as
    much as the k=1 chain, and more than nothing; both as JAX's."""
    accs = {}
    for kk in (1, 3):
        (jt, jd), (tt, td) = _engines(models, "gf4")
        want = JS.tree_speculative_generate(jt, jd, PROMPT, steps=32, k=kk, m=4)
        got = TS.tree_speculative_generate(tt, td, PROMPT, steps=32, k=kk, m=4)
        _same_run(got, want)
        accs[kk] = got.acceptance
    assert accs[3] >= accs[1] and accs[3] > 0.0, accs
