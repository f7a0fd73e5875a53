"""K12's tiling and its slot offset on the CPU.

- :func:`hopper_attn.decode_plan`, the decode kernel's chunk and tile plan,
  a pure function of the shapes: chunks are whole tiles and cover the
  window once, the rows a chunk reads never depend on the page size, a
  tile never straddles a page that is a multiple of it, the blocks fill
  the card in one resident wave where the window allows, and the
  workspace sizes match the grid; over every ragged (S, page rows,
  kv_len) that ``chip_smoke.py`` drives the kernel with.
- ``batch_off``: local row b reads cache slot batch_off + b, in plain,
  fresh and partials mode, against ``pallas_attn.decode_attention(...,
  batch_off=)`` in interpret mode (B=2 from slot 1 of a 4-slot cache).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calm_tpu.ops import pallas_attn
from calm_tpu_torch.ops import hopper_attn
from calm_tpu_torch.ops.hopper_attn import (MAX_CHUNKS, MIN_TILES, SMS, TARGET_BLOCKS,
                                           decode_plan)

torch.set_num_threads(1)

# (B, KVH, M, S, hd) of chip_smoke.py's K12 rows and checks, and a few
# more: Mistral-7B single stream and serving tick, the partials shards, the
# ragged, paged and head-dim checks, long windows and one kv head
SHAPES = [
    (1, 8, 4, 4096, 128), (8, 8, 4, 4096, 128), (1, 8, 4, 2048, 128),
    (8, 8, 4, 2048, 128), (1, 8, 4, 1024, 128), (2, 2, 16, 1000, 64),
    (2, 2, 8, 1000, 128), (1, 2, 16, 1024, 64), (3, 2, 4, 1024, 128),
    (16, 2, 16, 1024, 64), (2, 32, 1, 640, 96), (2, 16, 1, 640, 256),
    (2, 1, 8, 640, 256), (2, 2, 32, 640, 128), (5, 2, 4, 512, 128),
    (1, 1, 4, 32768, 128), (1, 8, 4, 131072, 128), (32, 8, 4, 4096, 128),
    (1, 8, 4, 64, 128), (1, 8, 4, 100, 128), (2, 2, 4, 48, 64),
]
# (S, page rows) of the paged rows and checks, and pages shorter than a tile
PAGED = [(4096, 512), (4096, 64), (4096, 16), (4096, 32), (4096, 1024),
         (1024, 16), (1024, 64), (1024, 512), (640, 64), (1024, 32)]


def _tiles(plan: hopper_attn.DecodePlan, kv_len: int):
    """The (chunk, first row, rows) of every tile the kernel reads for a
    slot of kv_len rows, in the order its chunks are folded."""
    out = []
    for c in range(plan.chunks):
        s0 = c * plan.chunk_rows
        s1 = min(s0 + plan.chunk_rows, kv_len)
        for t0 in range(s0, s1, plan.tile_rows):
            out.append((c, t0, min(plan.tile_rows, s1 - t0)))
    return out


@pytest.mark.parametrize("B,KVH,M,S,hd", SHAPES)
def test_plan_covers_the_window_in_whole_tiles(B, KVH, M, S, hd):
    p = decode_plan(B, KVH, M, S, hd)
    assert p.tile_rows == (32 if hd > 128 else 64)
    assert p.row_tile == (4 if M <= 4 else 8)
    assert (p.row_tiles - 1) * p.row_tile < M <= p.row_tiles * p.row_tile
    assert p.chunk_rows % p.tile_rows == 0
    assert (p.chunks - 1) * p.chunk_rows < S <= p.chunks * p.chunk_rows
    assert 1 <= p.chunks <= MAX_CHUNKS
    groups = B * KVH * p.row_tiles
    assert p.tickets == groups
    assert p.blocks == groups * p.chunks
    assert p.pacc == p.blocks * p.row_tile * hd
    assert p.pml == p.blocks * p.row_tile


@pytest.mark.parametrize("B,KVH,M,S,hd", SHAPES)
def test_plan_fills_the_card_in_one_wave(B, KVH, M, S, hd):
    """Two blocks an SM at most while the groups fit; chunks of MIN_TILES
    tiles or more, unless that would leave the card half idle; at least
    half a block an SM where the window has tiles enough; and every tile
    its own chunk where it has no more tiles than the card has SMs."""
    p = decode_plan(B, KVH, M, S, hd)
    tiles = -(-S // p.tile_rows)
    per_chunk = p.chunk_rows // p.tile_rows
    if p.tickets <= TARGET_BLOCKS:
        assert p.blocks <= TARGET_BLOCKS
    if p.tickets * tiles >= SMS:
        assert p.blocks >= SMS // 2
    if p.tickets * tiles <= SMS:
        assert per_chunk == 1 and p.chunks == tiles
    if per_chunk < MIN_TILES:
        assert per_chunk == 1 or p.blocks >= SMS // 2


def test_plan_at_the_timed_shapes():
    """Mistral-7B's decode (8 kv heads, 4 query rows, hd 128): one block an
    SM of four tiles at B=1, two an SM at the 8-slot serving tick, and a
    2048-row sp shard in chunks of two tiles."""
    assert decode_plan(1, 8, 4, 4096, 128)[3:6] == (256, 16, 128)
    assert decode_plan(8, 8, 4, 4096, 128)[3:6] == (1024, 4, 256)
    assert decode_plan(1, 8, 4, 2048, 128)[3:6] == (128, 16, 128)


@pytest.mark.parametrize("S,PR", PAGED)
def test_plan_rows_do_not_depend_on_the_page_size(S, PR):
    """Paged mode is held torch.equal to dense mode on the card: the same
    chunks and tiles in the same order for a window of S rows, whatever
    the page size; a tile never straddles a page that is a multiple of
    it, and spans whole pages of one shorter than it."""
    for B, KVH, M, hd in ((1, 8, 4, 128), (8, 8, 4, 128), (3, 2, 16, 64), (2, 1, 8, 256)):
        p = decode_plan(B, KVH, M, S, hd)
        assert p == decode_plan(B, KVH, M, (S // PR) * PR, hd)
        for t0 in range(0, S, p.tile_rows):
            pages = {s // PR for s in range(t0, min(t0 + p.tile_rows, S))}
            if PR % p.tile_rows == 0:
                assert len(pages) == 1
            elif p.tile_rows % PR == 0:
                assert len(pages) == p.tile_rows // PR


KV_LENS = [1, 5, 31, 32, 33, 63, 64, 65, 100, 333, 640, 700, 1000, 1019, 1024,
           1500, 2047, 2048, 2500, 3000, 4095, 4096]


@pytest.mark.parametrize("S", [640, 1000, 1024, 2048, 4096])
def test_plan_reads_each_live_row_once_and_nothing_past_kv_len(S):
    """Every row below kv_len lies in exactly one tile, every tile starts
    on a tile boundary, and the chunks the kernel folds are the ones that
    start below kv_len (what its last block computes from kv_len alone)."""
    for B, KVH, M, hd in ((1, 8, 4, 128), (8, 8, 4, 128), (2, 2, 16, 64), (2, 16, 1, 256)):
        p = decode_plan(B, KVH, M, S, hd)
        for kv_len in [k for k in KV_LENS if k <= S]:
            tiles = _tiles(p, kv_len)
            rows = [s for _, t0, n in tiles for s in range(t0, t0 + n)]
            assert rows == list(range(kv_len))
            assert all(t0 % p.tile_rows == 0 for _, t0, _ in tiles)
            live = {c for c, _, _ in tiles}
            assert live == set(range(-(-kv_len // p.chunk_rows)))


def test_plan_is_pure():
    assert decode_plan(1, 8, 4, 4096, 128) == decode_plan(1, 8, 4, 4096, 128)
    assert decode_plan(1, 8, 4, 4096, 128).blocks <= TARGET_BLOCKS
    assert decode_plan(1, 8, 4, 4096, 128).blocks >= SMS // 2


# -- batch_off against the JAX kernel -----------------------------------------


def _cache(rng, kv, shape):
    if kv == "fp8":
        bits = rng.integers(0, 256, shape).astype(np.uint8) & 0xBB  # finite codes
        j = jnp.asarray(bits).view(jnp.float8_e5m2)
        return j, torch.from_numpy(bits).view(torch.float8_e5m2)
    j = jnp.asarray(rng.standard_normal(shape) * 0.5, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).bfloat16()


@pytest.fixture
def interpret():
    pallas_attn.set_interpret(True)
    yield
    pallas_attn.set_interpret(False)


L, SLOTS, OFF, B, KVH, M, S, HD = 2, 4, 1, 2, 2, 4, 256, 64


def _inputs(rng, kv):
    q = rng.standard_normal((B, KVH * M, HD)).astype(np.float32)
    kj, kt = _cache(rng, kv, (L, SLOTS, KVH, S, HD))
    vj, vt = _cache(rng, kv, (L, SLOTS, KVH, S, HD))
    kv_len = np.array([100, 256], np.int32)
    return q, kj, kt, vj, vt, kv_len


@pytest.mark.parametrize("kv", ["bf16", "fp8"])
@pytest.mark.parametrize("fresh", [False, True])
def test_batch_off_matches_jax_interpret(rng, interpret, kv, fresh):
    """Plain and fresh mode from slot 1 of a 4-slot cache: the port's plain
    version against the Pallas kernel (which rounds q and p to bf16, hence
    the tolerance), equal to the slots sliced out, and exact in numpy."""
    q, kj, kt, vj, vt, kv_len = _inputs(rng, kv)
    layer = 1
    jfresh = tfresh = None
    kv_pos = np.array([37, 255], np.int32)
    if fresh:
        fkj, fkt = _cache(rng, kv, (B, KVH, HD))
        fvj, fvt = _cache(rng, kv, (B, KVH, HD))
        jfresh = (fkj, fvj, jnp.asarray(kv_pos))
        tfresh = (fkt, fvt, torch.from_numpy(kv_pos))
    got = hopper_attn.decode_attention(torch.from_numpy(q), kt, vt, torch.from_numpy(kv_len),
                                       layer, tfresh, batch_off=OFF)
    pal = np.asarray(pallas_attn.decode_attention(
        jnp.asarray(q), kj, vj, jnp.asarray(kv_len), jnp.int32(layer), batch_off=OFF,
        fresh=jfresh))
    np.testing.assert_allclose(got.numpy(), pal, rtol=3e-2, atol=3e-2)
    sl = slice(OFF, OFF + B)
    whole = hopper_attn.decode_attention(
        torch.from_numpy(q), kt[:, sl].contiguous(), vt[:, sl].contiguous(),
        torch.from_numpy(kv_len), layer, tfresh)
    assert torch.equal(got, whole)
    kf = np.asarray(kj[layer, sl], np.float32)
    vf = np.asarray(vj[layer, sl], np.float32)
    for b in range(B):
        ok = np.arange(S) < kv_len[b]
        if fresh:
            ok &= np.arange(S) != kv_pos[b]
        for hq in range(KVH * M):
            h = hq // M
            sc = np.where(ok, kf[b, h] @ q[b, hq], -np.inf) / math.sqrt(HD)
            vals = vf[b, h]
            if fresh:
                fk = np.asarray(jfresh[0][b, h], np.float32)
                sc = np.concatenate([[fk @ q[b, hq] / math.sqrt(HD)], sc])
                vals = np.concatenate([np.asarray(jfresh[1][b, h], np.float32)[None], vals])
            p = np.exp(sc - sc.max())
            np.testing.assert_allclose(got[b, hq].numpy(), p @ vals / p.sum(),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kv", ["bf16", "fp8"])
def test_batch_off_partials_matches_jax_interpret(rng, interpret, kv):
    """Partials mode from slot 1 of 4, one slot with nothing visible: the
    unnormalised (acc, m, l) against the Pallas kernel in interpret mode,
    and equal to the slots sliced out."""
    q, kj, kt, vj, vt, kv_len = _inputs(rng, kv)
    kv_len = np.array([0, 200], np.int32)
    layer = 0
    acc, m, l = hopper_attn.decode_attention(torch.from_numpy(q), kt, vt,
                                             torch.from_numpy(kv_len), layer,
                                             partials=True, batch_off=OFF)
    ja, jm, jl = (np.asarray(t) for t in pallas_attn.decode_attention(
        jnp.asarray(q), kj, vj, jnp.asarray(kv_len), jnp.int32(layer), batch_off=OFF,
        partials=True))
    assert np.all(np.isneginf(m[0].numpy())) and np.all(np.isneginf(jm[0]))
    assert not l[0].any() and not acc[0].any() and not jl[0].any() and not ja[0].any()
    np.testing.assert_allclose(m[1].numpy(), jm[1], rtol=2e-2, atol=2e-2)
    sa = np.exp(m[1].numpy() - jm[1])
    np.testing.assert_allclose(l[1].numpy() * sa, jl[1], rtol=3e-2)
    np.testing.assert_allclose(acc[1].numpy() * sa, ja[1], rtol=3e-2,
                               atol=3e-2 * np.abs(ja[1]).max())
    sl = slice(OFF, OFF + B)
    whole = hopper_attn.decode_attention(
        torch.from_numpy(q), kt[:, sl].contiguous(), vt[:, sl].contiguous(),
        torch.from_numpy(kv_len), layer, partials=True)
    for g, w in zip((acc, m, l), whole):
        assert torch.equal(g, w)


def test_batch_off_is_refused_in_paged_mode():
    q = torch.zeros((1, 2, 64))
    pool = torch.zeros((1, 3, 1, 8, 64), dtype=torch.bfloat16)
    kv_len = torch.tensor([3], dtype=torch.int32)
    with pytest.raises(ValueError, match="batch_off"):
        hopper_attn.decode_attention(q, pool, pool, kv_len, 0,
                                     pt=torch.zeros((1, 1), dtype=torch.int32), batch_off=1)
