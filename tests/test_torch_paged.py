"""The port's paged pool and multi-slot decode against calm_tpu on the CPU:
the plain K12 in paged mode against the Pallas kernel's paged grid in
interpret mode and a numpy oracle on scrambled pages, the plain K13 from a
slot offset, ``decode_step`` with a position per slot (one slot past the
window), ``prefill_slot``, ``paged_decode_step`` and ``PagedDecoder``
against their JAX counterparts on the same admissions."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calm_tpu import model as JM
from calm_tpu import paged as JP
from calm_tpu.container import TensorFile as JTensorFile
from calm_tpu.ops import pallas_attn
from calm_tpu_torch import model as TM
from calm_tpu_torch import paged as TP
from calm_tpu_torch.container import TensorFile
from calm_tpu_torch.ops import hopper_attn
from tests.modelgen import tiny_config, write_tiny_model
from tests.test_torch_model import jax_leaves

torch.set_num_threads(1)

PR = 8  # page rows, as tests/test_paged.py:14
_JKV = {"bf16": jnp.bfloat16, "fp16": jnp.float16, "fp8": jnp.float8_e5m2}


def _to_torch(x, kv: str) -> torch.Tensor:
    a = np.asarray(x)
    if kv == "fp8":
        return torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e5m2)
    return torch.from_numpy(a.astype(np.float32)).to(TM.KV_DTYPES[kv])  # exact


def _pool(rng, shape, kv):
    """A random pool in the cache dtype with finite values only (e5m2
    codes 0x7c-0x7f and 0xfc-0xff are inf/nan)."""
    if kv == "fp8":
        bits = rng.integers(0, 256, shape).astype(np.uint8) & 0xBB
        return jnp.asarray(bits).view(jnp.float8_e5m2)
    return jnp.asarray(rng.standard_normal(shape) * 0.5, _JKV[kv])


def _gather(pool_plane, pt):
    """numpy oracle: (P, KVH, PR, hd) through pt (B, nb) -> (B, KVH, S, hd)."""
    B, nb = pt.shape
    g = pool_plane[pt]                                   # (B, nb, KVH, PR, hd)
    return g.transpose(0, 2, 1, 3, 4).reshape(B, g.shape[2], nb * g.shape[3], -1)


@pytest.mark.parametrize("kv,fresh", [("bf16", False), ("bf16", True),
                                      ("fp8", True), ("fp16", False)])
def test_decode_attention_paged_plain(rng, kv, fresh):
    """Scrambled pages, a dead entry at the parking page past kv_len, kv_len
    off a page boundary and the stale row inside a page."""
    B, KVH, M, hd, nb, L, P = 3, 2, 2, 16, 4, 2, 13
    layer = 1
    kp, vp = _pool(rng, (L, P, KVH, PR, hd), kv), _pool(rng, (L, P, KVH, PR, hd), kv)
    pt = rng.permutation(P - 1)[:B * nb].reshape(B, nb).astype(np.int32)
    pt[2, 3] = P - 1                                     # parked, past kv_len
    kv_len = np.array([11, 32, 19], np.int32)
    kv_pos = np.array([10, 5, 13], np.int32)
    q = rng.standard_normal((B, KVH * M, hd)).astype(np.float32)
    fk = _pool(rng, (B, KVH, hd), kv)
    fv = _pool(rng, (B, KVH, hd), kv)
    jfresh = (fk, fv, jnp.asarray(kv_pos)) if fresh else None
    tfresh = ((_to_torch(fk, kv), _to_torch(fv, kv), torch.from_numpy(kv_pos))
              if fresh else None)
    got = hopper_attn.decode_attention(
        torch.from_numpy(q), _to_torch(kp, kv), _to_torch(vp, kv),
        torch.from_numpy(kv_len), layer, tfresh, pt=torch.from_numpy(pt)).numpy()

    pallas_attn.set_interpret(True)
    try:
        pal = np.asarray(pallas_attn.decode_attention(
            jnp.asarray(q), kp, vp, jnp.asarray(kv_len), jnp.int32(layer),
            fresh=jfresh, pt=jnp.asarray(pt)))
    finally:
        pallas_attn.set_interpret(False)
    np.testing.assert_allclose(got, pal, rtol=3e-2, atol=3e-2)

    # the exact masked softmax over the gathered windows, in numpy
    k = _gather(np.asarray(kp[layer], np.float32), pt)
    v = _gather(np.asarray(vp[layer], np.float32), pt)
    S = nb * PR
    for b in range(B):
        ok = np.arange(S) < kv_len[b]
        if fresh:
            ok &= np.arange(S) != kv_pos[b]
        for h in range(KVH):
            for m in range(M):
                qv = q[b, h * M + m]
                sc = np.where(ok, k[b, h] @ qv, -np.inf) / math.sqrt(hd)
                vals = v[b, h]
                if fresh:
                    sc = np.concatenate([[np.asarray(fk[b, h], np.float32) @ qv
                                          / math.sqrt(hd)], sc])
                    vals = np.concatenate([np.asarray(fv[b, h], np.float32)[None], vals])
                p = np.exp(sc - sc.max())
                np.testing.assert_allclose(got[b, h * M + m], p @ vals / p.sum(),
                                           rtol=1e-5, atol=1e-5)


def test_decode_attention_paged_equals_dense(rng):
    """The same rows held densely and paged give the same output."""
    B, KVH, M, hd, nb, L = 2, 2, 4, 16, 3, 1
    dense = torch.randn(L, B, KVH, nb * PR, hd).to(torch.bfloat16)
    dv = torch.randn(L, B, KVH, nb * PR, hd).to(torch.bfloat16)
    perm = torch.from_numpy(rng.permutation(B * nb).astype(np.int32)).reshape(B, nb)
    pk = torch.empty(L, B * nb, KVH, PR, hd, dtype=torch.bfloat16)
    pv = torch.empty_like(pk)
    for b in range(B):
        for j in range(nb):
            pk[:, perm[b, j]] = dense[:, b, :, j * PR:(j + 1) * PR]
            pv[:, perm[b, j]] = dv[:, b, :, j * PR:(j + 1) * PR]
    q = torch.randn(B, KVH * M, hd)
    kl = torch.tensor([13, 24], dtype=torch.int32)
    want = hopper_attn.decode_attention(q, dense, dv, kl, 0)
    got = hopper_attn.decode_attention(q, pk, pv, kl, 0, pt=perm)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kv", ["bf16", "fp8"])
def test_prefill_attention_plain_batch_off(rng, kv):
    """K13's plain version on slot 3 of a 5-slot cache against the Pallas
    prefill kernel on that slot sliced out (the JAX way)."""
    B, Bc, off, T, KVH, M, hd, S, L = 1, 5, 3, 7, 2, 2, 32, 32, 2
    layer = 1
    q = rng.standard_normal((B, T, KVH, M, hd)).astype(np.float32)
    kc = _pool(rng, (L, Bc, KVH, S, hd), kv)
    vc = _pool(rng, (L, Bc, KVH, S, hd), kv)
    starts = np.array([6], np.int32)
    kv_len = starts + T
    got = hopper_attn.prefill_attention(
        torch.from_numpy(q), _to_torch(kc, kv), _to_torch(vc, kv),
        torch.from_numpy(starts), torch.from_numpy(kv_len), layer, batch_off=off)
    pallas_attn.set_interpret(True)
    try:
        pal = np.asarray(pallas_attn.prefill_attention(
            jnp.asarray(q), kc[:, off:off + B], vc[:, off:off + B],
            jnp.asarray(starts), jnp.asarray(kv_len), jnp.int32(layer)))
    finally:
        pallas_attn.set_interpret(False)
    np.testing.assert_allclose(got.numpy(), pal, rtol=3e-2, atol=3e-2)
    whole = hopper_attn.prefill_attention(
        torch.from_numpy(q), _to_torch(kc[:, off:off + B], kv),
        _to_torch(vc[:, off:off + B], kv), torch.from_numpy(starts),
        torch.from_numpy(kv_len), layer)
    assert torch.equal(got, whole)


CASES = {
    "fp8": dict(dtype="fp8"),
    "fp16": dict(dtype="fp16"),
    "gf4": dict(dtype="gf4", dim=64, hidden_dim=64, head_dim=16, rotary_dim=16),
    "moe": dict(dtype="fp8", moe=True),
}


def _models(tmp_path, name, seq_len=16, seed=3):
    cfg = tiny_config(seq_len=seq_len, **CASES[name])
    path = str(tmp_path / f"{name}.calm")
    write_tiny_model(path, cfg, seed=seed)
    jtf = JTensorFile(path)
    cfg_j = JM.ModelConfig.from_metadata(jtf.metadata)
    wj = JM.load_weights(jtf, cfg_j)
    cfg_t = TM.ModelConfig.from_metadata(TensorFile(path).metadata)
    return (cfg_j, wj), (cfg_t, TM.weights_from_numpy(jax_leaves(wj), cfg_t))


def _close(got, want, tol=1e-4):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    scale = np.abs(want).max(axis=-1, keepdims=True)
    assert (np.abs(got - want) / scale).max() < tol
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("name", sorted(CASES))
def test_decode_step_per_slot_positions_matches_jax(tmp_path, name):
    """Three slots at positions 0, 5 and 13 of a 16-row window, 10 steps:
    slot 2 wraps at its third step and rotates its sinks alone."""
    (cfg_j, wj), (cfg_t, wt) = _models(tmp_path, name)
    cj = JM.KVCache.create(cfg_j, 3, jnp.bfloat16)
    ct = TM.KVCache.create(cfg_t, 3)
    toks, pos = [1, 40, 90], [0, 5, 13]
    for _ in range(10):
        want, cj = JM.decode_step(cfg_j, wj, jnp.asarray(toks, jnp.int32),
                                  jnp.asarray(pos, jnp.int32), cj)
        got, ct = TM.decode_step(cfg_t, wt, toks, pos, ct)
        _close(got, want)
        toks = [int(t) for t in np.asarray(want).argmax(-1)]
        pos = [p + 1 for p in pos]
    np.testing.assert_allclose(ct.k.float().numpy(), np.asarray(cj.k, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_decode_step_rows_go_to_their_slots(tmp_path):
    """Each slot's fresh row lands at its own (slot, row) in every layer:
    with L = B the transposed write of the advanced index would be silent."""
    (_, _), (cfg, w) = _models(tmp_path, "fp8")
    assert cfg.n_layers == 2
    ct = TM.KVCache.create(cfg, 2)
    TM.decode_step(cfg, w, [5, 9], [3, 11], ct)
    for b, row in ((0, 3), (1, 11)):
        assert ct.k[:, b, :, row].abs().sum() > 0
        ct.k[:, b, :, row] = 0
    assert ct.k.abs().sum() == 0


@pytest.mark.parametrize("name", ["fp8", "gf4"])
def test_prefill_slot_matches_jax(tmp_path, rng, name):
    """Slot 1 of 3, prefilled from 0 and then from pos0 = 9 (the JAX side
    right-pads to 16 rows and counts n_valid); other slots untouched."""
    (cfg_j, wj), (cfg_t, wt) = _models(tmp_path, name, seq_len=32)
    cj = JM.KVCache.create(cfg_j, 3, jnp.bfloat16)
    ct = TM.KVCache.create(cfg_t, 3)
    for pos0, T in ((0, 9), (9, 6)):
        toks = rng.integers(3, cfg_t.vocab_size, T)
        padded = np.zeros((1, 16), np.int32)
        padded[0, :T] = toks
        want, cj = JM.prefill_slot(cfg_j, wj, jnp.asarray(padded), jnp.int32(T),
                                   jnp.int32(1), cj, pos0=jnp.int32(pos0))
        got, ct = TM.prefill_slot(cfg_t, wt, torch.from_numpy(toks[None]), 1, ct,
                                  pos0=pos0)
        _close(got[None], np.asarray(want)[None])
    np.testing.assert_allclose(ct.k[:, 1, :, :15].float().numpy(),
                               np.asarray(cj.k[:, 1, :, :15], np.float32),
                               rtol=2e-2, atol=2e-2)
    assert ct.k[:, [0, 2]].abs().sum() == 0


@pytest.mark.parametrize("name", ["fp16", "moe"])
def test_paged_decode_step_matches_jax(tmp_path, name):
    """Scrambled pages for two slots, one of them parked (its row at the
    parking page), 10 steps from positions 10 and 12 of a 16-row window:
    slot 0 wraps and rotates the sinks in its page 3."""
    (cfg_j, wj), (cfg_t, wt) = _models(tmp_path, name)
    nb, P = cfg_t.seq_len // PR, 6
    pt = np.array([[3, 0], [5, 5]], np.int32)            # slot 1 parked on 5
    pj = JP.create_pool(cfg_j, P, PR)
    ptt = TP.create_pool(cfg_t, P, PR)
    toks, pos = [7, 60], [10, 12]
    for _ in range(10):
        want, pj = JP.paged_decode_step(cfg_j, wj, jnp.asarray(toks, jnp.int32),
                                        jnp.asarray(pos, jnp.int32), pj,
                                        jnp.asarray(pt))
        got, ptt = TM.paged_decode_step(cfg_t, wt, toks, pos, ptt,
                                        torch.from_numpy(pt))
        _close(got[:1], np.asarray(want)[:1])
        toks = [int(t) for t in np.asarray(want).argmax(-1)]
        pos = [p + 1 for p in pos]
    assert nb == 2
    for page in (3, 0):
        np.testing.assert_allclose(ptt.k[:, page].float().numpy(),
                                   np.asarray(pj.k[:, page], np.float32),
                                   rtol=2e-2, atol=2e-2)


def _run(dec, prompts, n, every=None):
    got = [[] for _ in prompts]
    for i in range(n):
        logits = dec.step()
        for b in range(len(prompts)):
            nxt = int(np.argmax(logits[b]))
            got[b].append(nxt)
            dec.slots[b].token = nxt
        if every:
            every(i)
    return got


@pytest.fixture(scope="module")
def decoders(tmp_path_factory):
    (cfg_j, wj), (cfg_t, wt) = _models(tmp_path_factory.mktemp("pg"), "fp16",
                                       seq_len=32)

    def make(n_pages, batch):
        return (JP.PagedDecoder(cfg_j, wj, n_pages, PR, batch=batch),
                TP.PagedDecoder(cfg_t, wt, n_pages, PR, batch=batch))
    return make, (cfg_t, wt)


def test_paged_decoder_matches_jax(decoders):
    """Three slots, prompts of 5, 3 and 10 tokens, 30 steps: past the
    32-row window (sink rotation on each slot's own page 0), lazy growth."""
    make, _ = decoders
    jd, td = make(12, 3)
    prompts = [[1, 5, 9, 2, 7], [3, 3, 4], [11, 40, 41, 42, 43, 44, 45, 46, 47, 48]]
    for b, p in enumerate(prompts):
        assert jd.admit(b, p) and td.admit(b, p)
    assert td.pages_in_use() == jd.pages_in_use() == 4
    assert _run(td, prompts, 30) == _run(jd, prompts, 30)
    np.testing.assert_array_equal(td.pt, jd.pt)
    assert max(len(s.pages) for s in td.slots) == 4


def test_inactive_slot_does_not_corrupt_active_pages(decoders):
    """tests/test_paged.py:111-139 on the port: a never-admitted slot and a
    released one write at the parking page every tick, so slot 0 decodes
    as it does alone, across the window."""
    make, (cfg, w) = decoders
    prompt = [1, 5, 9, 2, 7]
    n = cfg.seq_len + 4 - len(prompt)
    _, solo = make(8, 1)
    assert solo.admit(0, prompt)
    want = _run(solo, [prompt], n)[0]

    _, dec = make(8, 3)
    assert dec.admit(0, prompt)
    assert dec.parking not in [p for s in dec.slots for p in s.pages]
    assert dec.admit(2, [3, 3, 4])
    dec.release(2)
    assert (dec.pt[1] == dec.parking).all() and (dec.pt[2] == dec.parking).all()
    got = []
    for _ in range(n):
        logits = dec.step()
        got.append(int(np.argmax(logits[0])))
        dec.slots[0].token = got[-1]
    assert got == want


def test_lazy_growth_release_and_exhaustion(decoders):
    make, _ = decoders
    jd, td = make(6, 2)
    for d in (jd, td):
        assert d.admit(0, [1, 2, 3])               # 1 page
        assert d.admit(1, [4] * (PR + 2))          # 2 pages
        assert d.pages_in_use() == 3
    assert _run(td, [[1], [4]], PR) == _run(jd, [[1], [4]], PR)
    assert td.pages_in_use() == jd.pages_in_use() == 5  # both slots grew
    for d in (jd, td):
        d.release(1)
        assert d.pages_in_use() == 2
        assert d.admit(1, [7] * (2 * PR))          # reuses the freed pages
    assert _run(td, [[1], [7]], 3) == _run(jd, [[1], [7]], 3)
    jd, td = make(1, 2)
    for d in (jd, td):
        assert d.admit(0, [1, 2]) and not d.admit(1, [3, 4])
        for _ in range(PR - 1):
            d.step()
        with pytest.raises(RuntimeError):
            d.step()                               # slot 0 needs a 2nd page


def test_shared_prefix_and_copy_on_write(decoders):
    """Slot 0 pins its prompt pages; slot 1 maps them read-only, prefills
    only its suffix and copies block 0 once it wraps (the sink rotation
    writes it); the pinned pages stay as they were."""
    make, _ = decoders
    jd, td = make(14, 2)
    pre = list(range(20, 37))                      # 17 rows: 2 full pages
    outs = []
    for d in (jd, td):
        assert d.admit(0, pre + [50])
        rows, pages = d.pin_prompt(0, len(pre))
        assert rows == 2 * PR and len(pages) == 2
        before = np.asarray(d.pool.k[:, pages[0]], np.float32).copy() \
            if d is jd else d.pool.k[:, pages[0]].float().numpy().copy()
        assert d.admit(1, pre + [60, 61], shared_pages=pages, hit_rows=rows)
        assert d.slots[1].pages[:2] == pages and d.slots[1].shared == {0, 1}
        outs.append(_run(d, [[50], [61]], 20))
        assert pages[0] not in d.slots[1].pages    # copied on the wrap
        after = (np.asarray(d.pool.k[:, pages[0]], np.float32) if d is jd
                 else d.pool.k[:, pages[0]].float().numpy())
        np.testing.assert_array_equal(after, before)
        d.release(0)
        d.release(1)
        d.unpin_pages(pages)
        assert sorted(d.free_pages) == list(range(14))
    assert outs[0] == outs[1]
