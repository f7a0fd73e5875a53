"""K13's split-S route (a speculative verify's few query rows, and the
draft tree's nodes) on the CPU.

- :func:`hopper_attn.verify_plan`, a pure function of the shapes, over
  every shape ``chip_smoke.py`` drives the route with: chunks are whole
  tiles and cover the window once, whatever kv_len; row groups hold every
  (query, head) row once in 16-row tiles; the warps split a tile's
  sub-tiles evenly; the blocks fill one wave where the window allows; the
  workspace and tickets match the grid; :func:`split_route` picks as
  documented.
- The kernel's visibility rule, written out as ``verify_kernel`` reads it
  (``seen``, the rows any and every query of a group sees), against
  ``calm_tpu.speculative._tree_mask`` for (k, m) up to the CLI default and
  beyond, and against the causal rule.
- The kernel's arithmetic written out in PyTorch (chunks, row groups, the
  warps' sub-tiles and merge, bf16 operands, the fold in chunk order)
  against ``prefill_attention_plain``.
- ``prefill_attention_plain``, causal at T = 1-5 and with ``tree`` at 10
  and 13 nodes, ragged kv_len, ``batch_off`` and B = 1-2, against
  ``calm_tpu.ops.pallas_attn.prefill_attention`` in interpret mode and
  ``calm_tpu.model._attention(..., tree=)``; and ``tree_attention`` on the
  CPU is that plain version.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from calm_tpu import model as JM
from calm_tpu import speculative as JS
from calm_tpu.ops import pallas_attn
from calm_tpu_torch import speculative as TS
from calm_tpu_torch.ops import hopper_attn
from calm_tpu_torch.ops.hopper_attn import (MIN_TILES, SMS, SPLIT_MAX_ROWS, VA_MAX_CHUNKS,
                                           VA_ROWS, split_route, verify_plan)
from tests.modelgen import tiny_config

torch.set_num_threads(1)

# beyond chip_smoke.py's: long windows, many sequences, 1 row, many heads
EXTRA = [(1, 1, 8, 4, 32768, 128), (64, 5, 8, 4, 4096, 128), (1, 1, 1, 1, 16, 64),
         (3, 7, 2, 32, 640, 96), (1, 40, 1, 8, 1000, 256)]


@pytest.mark.parametrize("B,T,KVH,M,S,hd", chip_smoke.SPLIT_SHAPES + EXTRA)
def test_plan_covers_the_window_and_the_rows(B, T, KVH, M, S, hd):
    p = verify_plan(B, T, KVH, M, S, hd)
    assert p.tile_rows == (32 if hd > 128 else 64)
    # chunks: whole tiles, the window once, at most the fold's weights
    assert p.chunk_rows % p.tile_rows == 0
    assert (p.chunks - 1) * p.chunk_rows < S <= p.chunks * p.chunk_rows
    assert 1 <= p.chunks <= VA_MAX_CHUNKS
    # row groups: every (query, head) row once, in 16-row tiles, at most 64
    rows = T * M
    assert 1 <= p.row_tiles <= VA_ROWS // 16
    assert (p.row_groups - 1) * p.row_tiles * 16 < rows <= p.row_groups * p.row_tiles * 16
    assert p.row_groups == -(-rows // VA_ROWS)  # as few groups as hold the rows
    # warps: the row tiles times an even split of a tile's sub-tiles; a
    # merge of at most six row tiles' states (four at hd 256: csrc SLOTS)
    assert p.threads % (32 * p.row_tiles) == 0 and p.threads <= 256
    ws = p.threads // 32 // p.row_tiles
    assert (p.tile_rows // 16) % ws == 0 and (ws - 1) * p.row_tiles <= (4 if hd > 128 else 6)
    # the grid, workspace and tickets
    groups = B * KVH * p.row_groups
    assert p.blocks == p.chunks * groups
    assert p.pacc == p.blocks * p.row_tiles * 16 * hd
    assert p.pml == p.blocks * p.row_tiles * 16
    assert p.tickets == groups


@pytest.mark.parametrize("B,T,KVH,M,S,hd", chip_smoke.SPLIT_SHAPES + EXTRA)
def test_plan_fills_one_wave_where_the_window_allows(B, T, KVH, M, S, hd):
    """About one block an SM, no more than a wave unless one chunk a group
    already makes more; fewer only where a chunk would drop below MIN_TILES
    tiles or the window has too few tiles."""
    p = verify_plan(B, T, KVH, M, S, hd)
    groups = B * KVH * p.row_groups
    tiles = -(-S // p.tile_rows)
    if groups <= SMS:
        assert p.blocks <= SMS
    else:
        assert p.chunks == 1
    ct = p.chunk_rows // p.tile_rows
    if p.blocks < SMS // 2 and groups <= SMS // 2:
        # a longer chunk only to keep MIN_TILES tiles, or the whole window
        assert ct <= max(MIN_TILES, -(-tiles // VA_MAX_CHUNKS)) or p.chunks == 1


def test_plan_depends_on_shapes_alone():
    """The plan takes no kv_len or pos0 (the kernel's sums keep one order
    for a shape), and its blocks are the same across calls."""
    import inspect

    assert list(inspect.signature(verify_plan).parameters) == ["B", "T", "KVH", "M", "S", "hd"]
    assert verify_plan(1, 5, 8, 4, 4096, 128) == verify_plan(1, 5, 8, 4, 4096, 128)


def test_the_route_threshold():
    """T * M (query, head) rows a kv head up to SPLIT_MAX_ROWS take the
    split-S route, one row group; the rest the persistent kernel."""
    assert SPLIT_MAX_ROWS <= VA_ROWS
    for T, M in ((1, 4), (4, 4), (5, 4), (16, 4), (1, 64), (2, 32), (8, 8)):
        assert split_route(T, M) == (T * M <= SPLIT_MAX_ROWS)
    assert split_route(5, 4) and split_route(13, 4) is (13 * 4 <= SPLIT_MAX_ROWS)
    assert not split_route(2048, 4) and not split_route(17, 4)


# ---------------------------------------------------------------------------
# the visibility rule as the kernel reads it
# ---------------------------------------------------------------------------


def kernel_seen(T, M, R0, Rn, pos0, kv_len, S, tree):
    """(Rn, S) bool: which cache rows the rows R0..R0 + Rn of one group
    see, by ``verify_kernel``'s own steps: ``lim`` (rows any of them sees),
    ``c_all`` (rows every one sees, where the kernel skips the mask), then
    ``seen`` on the rest; the tree read as bytes tree[t * T + col - base]."""
    kvl = min(kv_len, S)
    base = kvl - T
    lim = kvl if tree is not None else max(0, min(kvl, pos0 + (R0 + Rn - 1) // M + 1))
    c_all = max(0, base) if tree is not None else max(0, min(kvl, pos0 + R0 // M + 1))
    flat = None if tree is None else np.asarray(tree, np.uint8).reshape(-1)
    out = np.zeros((Rn, S), bool)
    for r in range(Rn):
        t = (R0 + r) // M
        for col in range(S):
            if col >= lim:
                continue
            if col < c_all:
                out[r, col] = True
            elif tree is None:
                out[r, col] = col <= pos0 + t
            else:
                out[r, col] = col < base or flat[t * T + (col - base)] != 0
    return out


@pytest.mark.parametrize("k,m", [(1, 2), (2, 3), (3, 4), (3, 5), (4, 5), (5, 7)])
def test_tree_rule_against_jax_tree_mask(k, m):
    """Node t sees every row below the tree and, inside it, the nodes
    calm_tpu's ancestor-or-self mask marks; nothing at or past kv_len; at
    any row group split."""
    mask = JS._tree_mask(k, m)
    np.testing.assert_array_equal(TS._tree_mask(k, m), mask)
    T = mask.shape[0]
    S, kv_len = 96, 80
    for M in (1, 4, 8):
        want = np.zeros((T * M, S), bool)
        for R in range(T * M):
            t = R // M
            want[R, :kv_len - T] = True
            want[R, kv_len - T:kv_len] = mask[t]
        for R0 in range(0, T * M, 16):
            Rn = min(16, T * M - R0)
            np.testing.assert_array_equal(
                kernel_seen(T, M, R0, Rn, 0, kv_len, S, mask), want[R0:R0 + Rn])


@pytest.mark.parametrize("T,M,pos0,kv_len", [(1, 4, 30, 31), (5, 4, 40, 45), (5, 4, 10, 13),
                                            (3, 2, 0, 3), (4, 1, 50, 200), (2, 8, 0, 0)])
def test_causal_rule(T, M, pos0, kv_len):
    S = 64
    want = np.zeros((T * M, S), bool)
    for R in range(T * M):
        want[R] = (np.arange(S) < min(kv_len, S)) & (np.arange(S) <= pos0 + R // M)
    np.testing.assert_array_equal(kernel_seen(T, M, 0, T * M, pos0, kv_len, S, None), want)


# ---------------------------------------------------------------------------
# the kernel's arithmetic, written out
# ---------------------------------------------------------------------------


def _bf16(x):
    return x.to(torch.bfloat16).float()


def emulate(q, kc, vc, pos0, kv_len, layer, boff=0, tree=None):
    """``verify_kernel``'s steps in PyTorch: q, K and V rounded to bf16 (K/V
    through f32, as the fragments widen them), each block's chunk walked in
    tiles and 16-row sub-tiles, sub-tile i of a tile by warp split i % WS,
    an online softmax in base 2 with p rounded to bf16 for P V, the splits
    merged, the chunks folded in chunk order."""
    B, T, KVH, M, hd = q.shape
    S = kc.shape[3]
    p = verify_plan(B, T, KVH, M, S, hd)
    GR, TR, CS = p.row_tiles * 16, p.tile_rows, p.chunk_rows
    WS = p.threads // 32 // p.row_tiles
    sl2 = math.log2(math.e) / math.sqrt(hd)
    out = torch.zeros_like(q)
    inf = float("inf")
    for b in range(B):
        kvl, p0 = min(int(kv_len[b]), S), int(pos0[b])
        for h in range(KVH):
            K = _bf16(kc[layer, boff + b, h].float())
            V = _bf16(vc[layer, boff + b, h].float())
            for g in range(p.row_groups):
                R0 = g * GR
                Rn = min(GR, T * M - R0)
                Q = _bf16(torch.stack([q[b, R // M, h, R % M] for R in range(R0, R0 + Rn)]))
                vis = torch.from_numpy(kernel_seen(T, M, R0, Rn, p0, kvl, S, tree))
                lim = (kvl if tree is not None
                       else max(0, min(kvl, p0 + (R0 + Rn - 1) // M + 1)))
                chunks = []
                for c in range(p.chunks):
                    s0, s1 = c * CS, min(c * CS + CS, lim)
                    if s0 >= s1:
                        continue
                    parts = []
                    for w in range(WS):
                        m = torch.full((Rn,), -inf)
                        l = torch.zeros(Rn)
                        o = torch.zeros(Rn, hd)
                        for t0 in range(s0, s1, TR):
                            for sub in range(w, TR // 16, WS):
                                c0 = t0 + sub * 16
                                if c0 >= s1:
                                    break
                                c1 = min(c0 + 16, s1)
                                sc = Q @ K[c0:c1].T
                                sc = torch.where(vis[:, c0:c1], sc, torch.tensor(-inf))
                                mn = torch.maximum(m, sc.max(1).values)
                                shift = torch.where(mn == -inf, torch.zeros(()), mn * sl2)
                                alpha = torch.where(m == -inf, torch.zeros(()),
                                                    torch.exp2(m * sl2 - shift))
                                pr = torch.exp2(sc * sl2 - shift[:, None])
                                l = l * alpha + pr.sum(1)
                                o = o * alpha[:, None] + _bf16(pr) @ V[c0:c1]
                                m = mn
                        parts.append((m, l, o))
                    m, l, o = parts[0]
                    for mw, lw, ow in parts[1:]:
                        mn = torch.maximum(m, mw)
                        f0 = torch.where(m == -inf, torch.zeros(()), torch.exp2((m - mn) * sl2))
                        f1 = torch.where(mw == -inf, torch.zeros(()), torch.exp2((mw - mn) * sl2))
                        l, o, m = l * f0 + lw * f1, o * f0[:, None] + ow * f1[:, None], mn
                    chunks.append((m, l, o))
                acc = torch.zeros(Rn, hd)
                den = torch.zeros(Rn)
                if chunks:
                    mx = torch.stack([c[0] for c in chunks]).max(0).values
                    for m, l, o in chunks:
                        f = torch.where(m == -inf, torch.zeros(()), torch.exp2((m - mx) * sl2))
                        acc, den = acc + o * f[:, None], den + l * f
                res = acc / den.clamp_min(1e-37)[:, None]
                for i, R in enumerate(range(R0, R0 + Rn)):
                    out[b, R // M, h, R % M] = res[i]
    return out


def _caches(rng, L, Bc, KVH, S, hd, dtype):
    kc = torch.from_numpy(rng.standard_normal((L, Bc, KVH, S, hd)).astype(np.float32) * 0.5)
    vc = torch.from_numpy(rng.standard_normal((L, Bc, KVH, S, hd)).astype(np.float32))
    return kc.to(dtype), vc.to(dtype)


# (B, T, KVH, M, S, hd, cache dtype, starts, batch_off, tree (k, m) or None)
EMULATED = [
    (1, 5, 2, 4, 600, 64, torch.bfloat16, [595], 0, None),   # 3 chunks, the window's end
    (2, 4, 1, 4, 600, 128, torch.float16, [3, 300], 1, None),  # ragged, a slot offset
    (2, 3, 2, 1, 300, 96, torch.float8_e5m2, [0, 250], 0, None),
    (1, 2, 1, 8, 200, 256, torch.bfloat16, [150], 0, None),   # 32-row tiles, two splits
    (1, 10, 2, 4, 600, 64, torch.bfloat16, [580], 0, (3, 4)),  # 40 rows: three row tiles
    (1, 13, 1, 8, 700, 64, torch.float16, [660], 0, (3, 5)),  # 104 rows: two row groups
]


@pytest.mark.parametrize("B,T,KVH,M,S,hd,dt,starts,boff,km", EMULATED)
def test_emulated_kernel_against_the_plain_version(rng, B, T, KVH, M, S, hd, dt, starts,
                                                  boff, km):
    """The kernel's order of work and rounding against the f32 plain
    version, at the tolerance chip_smoke.py holds the kernel to (TOL_ATT of
    max |out|: q, K/V and p rounded once to bf16)."""
    kc, vc = _caches(rng, 2, B + boff, KVH, S, hd, dt)
    q = torch.from_numpy(rng.standard_normal((B, T, KVH, M, hd)).astype(np.float32))
    p0 = torch.tensor(starts, dtype=torch.int32)
    kl = p0 + T
    tree = None if km is None else torch.from_numpy(JS._tree_mask(*km))
    got = emulate(q, kc, vc, p0, kl, 1, boff, None if tree is None else tree.numpy())
    want = hopper_attn.prefill_attention_plain(q, kc, vc, p0, kl, 1, boff, tree=tree,
                                               rows=None if tree is None else S)
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= chip_smoke.TOL_ATT, err
    assert torch.isfinite(got).all()


def test_emulated_kernel_sees_nothing_past_kv_len(rng):
    """Rows at and past kv_len hold NaN: nothing of them reaches the output
    (the kernel zeroes V rows past a chunk and masks their scores), and a
    sequence with kv_len 0 gets 0."""
    kc, vc = _caches(rng, 1, 2, 1, 300, 64, torch.bfloat16)
    kl = torch.tensor([150, 0], dtype=torch.int32)
    kc[0, 0, :, 150:] = float("nan")
    vc[0, 0, :, 150:] = float("nan")
    q = torch.from_numpy(rng.standard_normal((2, 3, 1, 4, 64)).astype(np.float32))
    p0 = torch.tensor([147, 0], dtype=torch.int32)
    got = emulate(q, kc, vc, p0, kl, 0)
    assert torch.isfinite(got).all() and torch.equal(got[1], torch.zeros_like(got[1]))
    want = hopper_attn.prefill_attention_plain(q, kc, vc, p0, kl, 0)
    assert float((got - want).abs().max() / want.abs().max()) <= chip_smoke.TOL_ATT


# ---------------------------------------------------------------------------
# the plain version against JAX
# ---------------------------------------------------------------------------


def _jkv(t: torch.Tensor):
    return jnp.asarray(t.float().numpy(), jnp.bfloat16)


@pytest.mark.parametrize("T", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("B,boff", [(1, 0), (2, 1)])
def test_plain_causal_against_pallas_interpret(rng, T, B, boff):
    """A verify's T rows from ragged starts, against the Pallas prefill
    kernel in interpret mode (which rounds q and p to bf16: its own test
    holds it at 3e-2, tests/test_pallas_attn.py:118) on the slots from
    ``batch_off`` (the Pallas kernel takes none)."""
    KVH, M, S, hd, L = 2, 4, 48, 64, 2
    kc, vc = _caches(rng, L, B + boff, KVH, S, hd, torch.bfloat16)
    q = rng.standard_normal((B, T, KVH, M, hd)).astype(np.float32)
    starts = np.array([S - T, 7][:B], np.int32)
    kv_len = starts + T
    got = hopper_attn.prefill_attention(torch.from_numpy(q), kc, vc, torch.from_numpy(starts),
                                        torch.from_numpy(kv_len), 1, boff).numpy()
    pallas_attn.set_interpret(True)
    try:
        pal = np.asarray(pallas_attn.prefill_attention(
            jnp.asarray(q), _jkv(kc[:, boff:]), _jkv(vc[:, boff:]), jnp.asarray(starts),
            jnp.asarray(kv_len), jnp.int32(1)))
    finally:
        pallas_attn.set_interpret(False)
    np.testing.assert_allclose(got, pal, rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("k,m", [(3, 4), (3, 5)])
@pytest.mark.parametrize("B,boff", [(1, 0), (2, 1)])
def test_plain_tree_against_jax_attention(rng, k, m, B, boff):
    """The tree's plain attention (10 and 13 nodes), ragged kv_len and a
    slot offset, against ``calm_tpu.model._attention(..., tree=)`` on the
    CPU (f32 there): within 1e-5 of max |out|; ``tree_attention`` on the
    CPU gives the same tensor."""
    mask = JS._tree_mask(k, m)
    T, KVH, M, S, hd, L = mask.shape[0], 2, 4, 64, 64, 2
    kc, vc = _caches(rng, L, B + boff, KVH, S, hd, torch.bfloat16)
    q = rng.standard_normal((B, T, KVH, M, hd)).astype(np.float32)
    starts = np.array([S - T, 20][:B], np.int32)
    kv_len = starts + T
    depth = np.array([0] + [d for _ in range(k) for d in range(1, m)], np.int32)
    tq, tm = torch.from_numpy(q), torch.from_numpy(mask)
    p0, kl = torch.from_numpy(starts), torch.from_numpy(kv_len)
    got = hopper_attn.prefill_attention_plain(tq, kc, vc, p0, kl, 1, boff, tree=tm,
                                              rows=S).numpy()
    assert torch.equal(hopper_attn.tree_attention(tq, kc, vc, p0, kl, 1, tm, boff),
                       torch.from_numpy(got))
    cfg = tiny_config()
    ref = np.asarray(JM._attention(
        cfg, jnp.asarray(q.reshape(B, T, KVH * M, hd)), _jkv(kc), _jkv(vc), 1,
        jnp.asarray(starts[:, None] + depth[None, :]), jnp.asarray(kv_len),
        batch_off=jnp.int32(boff), tree=jnp.asarray(mask))).reshape(got.shape)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_tree_attention_on_the_cpu_counts_nothing(rng):
    kc, vc = _caches(rng, 1, 1, 1, 32, 64, torch.bfloat16)
    mask = torch.from_numpy(JS._tree_mask(2, 3))
    T = mask.shape[0]
    before = (hopper_attn.tree_attention.launches, hopper_attn.prefill_attention.split_launches)
    hopper_attn.tree_attention(torch.randn(1, T, 1, 2, 64), kc, vc,
                               torch.tensor([10], dtype=torch.int32),
                               torch.tensor([10 + T], dtype=torch.int32), 0, mask)
    assert (hopper_attn.tree_attention.launches,
            hopper_attn.prefill_attention.split_launches) == before
