"""K13's block plan on the CPU.

:func:`hopper_attn.prefill_plan` is the prefill kernel's launch order, a
pure function of the shapes: one block a (query tile of 128 (query, head)
rows, kv head, sequence), each exactly once, the heaviest query tiles
first, each with the cache rows its causal range reaches. Held here over
odd T, starts past 0, up to 8 query heads a kv head and every head dim;
and the causal limit against ``prefill_attention_plain``: cache rows at or
past a block's limit do not change that block's outputs.
"""

import numpy as np
import pytest
import torch

from calm_tpu_torch.ops import hopper_attn
from calm_tpu_torch.ops.hopper_attn import (HEAD_DIMS, PF_ROWS, prefill_block_items,
                                           prefill_item, prefill_plan)

torch.set_num_threads(1)

# (B, T, KVH, M, hd, pos0): Mistral-7B's 2048-token prefill, chip_smoke.py's
# ragged and head-dim shapes, odd T, starts past 0, M = 1, 3, 4, 8
CASES = [
    (1, 2048, 8, 4, 128, 0), (1, 512, 8, 4, 128, 1024), (2, 37, 2, 4, 128, 100),
    (2, 100, 2, 8, 64, 37), (1, 129, 3, 1, 96, 5), (2, 77, 2, 3, 256, 130),
    (2, 37, 32, 1, 96, 0), (2, 37, 16, 1, 256, 100), (1, 33, 2, 4, 128, 300),
    (3, 1, 2, 8, 64, 17),
]


def _ids(c):
    return "B{}-T{}-KVH{}-M{}-hd{}-p{}".format(*c)


@pytest.mark.parametrize("B,T,KVH,M,hd,pos0", CASES, ids=[_ids(c) for c in CASES])
def test_plan_covers_every_tile_once(B, T, KVH, M, hd, pos0):
    p = prefill_plan(B, T, KVH, M, hd, pos0)
    assert p.rows == PF_ROWS
    assert p.q_tiles == -(-T * M // PF_ROWS)
    assert p.items == len(p.order) == p.q_tiles * KVH * B
    seen = sorted((qt, h, b) for qt, h, b, _ in p.order)
    assert seen == sorted((qt, h, b) for qt in range(p.q_tiles)
                          for h in range(KVH) for b in range(B))
    for i, (qt, h, b, _) in enumerate(p.order):  # the kernel's own arithmetic
        assert prefill_item(i, p.q_tiles, KVH, B) == (qt, h, b)


@pytest.mark.parametrize("B,T,KVH,M,hd,pos0", CASES, ids=[_ids(c) for c in CASES])
def test_plan_gives_each_tile_its_causal_limit(B, T, KVH, M, hd, pos0):
    """A block's limit is the most cache rows any of its (query, head) rows
    sees: query R // M at position pos0 + R // M sees rows up to itself,
    never past kv_len = pos0 + T."""
    p = prefill_plan(B, T, KVH, M, hd, pos0)
    for qt, _, _, lim in p.order:
        rows = range(qt * PF_ROWS, min((qt + 1) * PF_ROWS, T * M))
        assert lim == max(min(pos0 + T, pos0 + r // M + 1) for r in rows)
        assert 1 <= lim <= pos0 + T


@pytest.mark.parametrize("B,T,KVH,M,hd,pos0", CASES, ids=[_ids(c) for c in CASES])
def test_plan_orders_the_heaviest_tiles_first(B, T, KVH, M, hd, pos0):
    p = prefill_plan(B, T, KVH, M, hd, pos0)
    lims = [lim for *_, lim in p.order]
    assert lims == sorted(lims, reverse=True)
    assert p.order[0][0] == p.q_tiles - 1 and p.order[-1][0] == 0
    per = KVH * B  # every kv head and sequence of a query tile launch together
    assert all(p.order[i][0] == p.q_tiles - 1 - i // per for i in range(p.items))


@pytest.mark.parametrize("B,T,KVH,M,hd,pos0", CASES, ids=[_ids(c) for c in CASES])
def test_persistent_blocks_take_every_item_once(B, T, KVH, M, hd, pos0):
    """One block an SM (at most one an item) walks the order in a snake:
    every item once, each block's items in the order's (heaviest first)."""
    p = prefill_plan(B, T, KVH, M, hd, pos0)
    assert p.grid == min(p.items, 132) == len(p.blocks)
    taken = sorted(i for blk in p.blocks for i in blk)
    assert taken == list(range(p.items))
    for g, blk in enumerate(p.blocks):
        assert list(blk) == sorted(blk) and list(blk) == prefill_block_items(g, p.grid, p.items)


def test_persistent_blocks_share_the_work_evenly():
    """Mistral-7B's 2048-token prefill: 512 items of 1-32 tiles on 132
    blocks. The snake gives every block within a few tiles of the mean,
    where a plain stride would give the first blocks 1.4x the last's or
    more (80 tiles against 48)."""
    p = prefill_plan(1, 2048, 8, 4, 128, 0)
    tiles = [-(-p.order[i][3] // p.tile_rows) for i in range(p.items)]
    load = [sum(tiles[i] for i in blk) for blk in p.blocks]
    mean = sum(tiles) / p.grid
    assert max(load) <= mean + 2.5 and min(load) >= mean - 4.5
    stride = [sum(tiles[i] for i in range(g, p.items, p.grid)) for g in range(p.grid)]
    assert max(stride) > 1.4 * min(stride)


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_plan_tiles_by_head_dim(hd):
    """64-row K/V tiles, 32 at hd 256 (its O accumulator alone takes 128
    registers a thread, its two Q tiles 128 KB); the 128-byte swizzle in
    64-column blocks, the 64-byte one in 32-column blocks at hd 96."""
    p = prefill_plan(1, 64, 2, 4, hd)
    assert p.tile_rows == (32 if hd == 256 else 64)
    assert p.swizzle == (64 if hd == 96 else 128)
    assert hd % (p.swizzle // 2) == 0


@pytest.mark.parametrize("B,T,KVH,M,hd,pos0", CASES[2:6], ids=[_ids(c) for c in CASES[2:6]])
def test_rows_past_a_blocks_limit_leave_its_outputs_alone(B, T, KVH, M, hd, pos0):
    """Large values in the cache rows at and past a block's limit (its
    slot, its kv head) change none of that block's outputs in the plain
    version: the limit is the kernel's whole read."""
    rng = np.random.default_rng(T)
    S = pos0 + T + 16
    q = torch.from_numpy(rng.standard_normal((B, T, KVH, M, hd)).astype(np.float32))
    kc = torch.from_numpy(rng.standard_normal((1, B, KVH, S, hd)).astype(np.float32))
    vc = torch.from_numpy(rng.standard_normal((1, B, KVH, S, hd)).astype(np.float32))
    p0 = torch.full((B,), pos0, dtype=torch.int32)
    kl = p0 + T
    base = hopper_attn.prefill_attention(q, kc, vc, p0, kl, 0)
    p = prefill_plan(B, T, KVH, M, hd, pos0)
    for qt, h, b, lim in p.order[::max(1, p.items // 6)]:
        k2, v2 = kc.clone(), vc.clone()
        k2[0, b, h, lim:] = 1e4
        v2[0, b, h, lim:] = 1e4
        got = hopper_attn.prefill_attention(q, k2, v2, p0, kl, 0)
        for r in range(qt * PF_ROWS, min((qt + 1) * PF_ROWS, T * M)):
            assert torch.equal(got[b, r // M, h, r % M], base[b, r // M, h, r % M])
    assert hopper_attn.prefill_attention.launches == 0  # the CPU: plain
