"""Flash attention on Hopper: the ports of pallas_attn's two kernels.

- :func:`decode_attention` replaces ``_attn_body``
  (``calm_tpu/ops/pallas_attn.py:77``) in its plain and fresh modes, over
  a dense cache or, with a page table, over a page pool (paged mode,
  ``:168-174``, ``:203-211``), and in partials mode
  (``_attn_kernel_partials :57``), which returns the unnormalised flash
  state that sequence-parallel decode merges across shards;
- :func:`prefill_attention` replaces ``_prefill_kernel`` (``:326``): causal
  attention of T queries against the carried cache, from any slot on.

Both kernels live in ``csrc/attn.cu``. Each wrapper takes its plain PyTorch
version (``*_plain``, f32) for tensors on the CPU, and launches the kernel
for CUDA tensors or raises; it counts its launches in ``.launches``
(:func:`decode_attention` those in paged mode also in ``.paged_launches``,
those in partials mode apart, in ``.partials_launches``). Both take head
dims 64, 96, 128 and 256 and any number of query heads per kv head, and
both read from a slot offset (``batch_off``) of a dense cache. While a
profiler trace is open each launch's bytes and operations are recorded
(``ops/cost.py``).

:func:`decode_plan` is the decode kernel's tiling, a pure function of the
shapes: the kernel launches one block a (chunk, kv head, slot, row tile)
and folds the chunks in the same launch (``csrc/attn.cu``'s note).
:func:`prefill_plan` is the prefill kernel's: work items of a (query tile
of 128 (query, head) rows, kv head, sequence), heaviest query tiles first,
taken by one persistent block an SM, on TMA and ``wgmma`` at every head
dim. :func:`verify_plan` is the tiling of the prefill kernel's split-S
route, which takes a call of few (query, head) rows a kv head (a
speculative verify: :func:`split_route`) and, through
:func:`tree_attention`, the draft tree's nodes: blocks of a (chunk of the
window, kv head, sequence, row group of up to 64 rows) on ``mma.sync``,
their chunks folded in the same launch.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from calm_tpu_torch.ops import build, cost

_KV_CODE = {torch.float16: 0, torch.bfloat16: 1, torch.float8_e5m2: 2}
SMS = 132  # an H100's streaming multiprocessors
TARGET_BLOCKS = 2 * SMS  # decode: two resident blocks an SM
MIN_TILES = 4  # decode: the least tiles a chunk, where the card allows
MAX_CHUNKS = 256  # csrc/attn.cu DA_MAX_CHUNKS: the merge's weights in shared memory
HEAD_DIMS = (64, 96, 128, 256)  # what the kernels are built for
PF_ROWS = 128  # csrc/attn.cu PF_ROWS: (query, head) rows a prefill work item
VA_ROWS = 64  # csrc/attn.cu VA_ROWS: (query, head) rows a split-S block at most
VA_MAX_CHUNKS = 64  # csrc/attn.cu VA_MAX_CHUNKS: the fold's weights in shared memory
# The split-S route takes a call of at most SPLIT_MAX_ROWS (query, head) rows
# a kv head (T * M), one row group; past it the persistent kernel reads each
# tile once for 128 rows. Set from the crossover timed on the card
# (chip_smoke.split_route_sweep; H100 80GB HBM3 at 700 W, Mistral-7B heads,
# bf16 KV, ms split-S / persistent): at the window's end B=8 64 rows
# 0.0640 / 0.0692 but 96 rows 0.1093 / 0.0697 (two row groups read every
# tile twice), B=1 128 rows 0.0268 / 0.0676; from position 0 the split-S
# route is the faster at 16-128 rows (0.0060-0.0078 / 0.0066-0.0101).
SPLIT_MAX_ROWS = 64


def _cost_attention(kernel: str, q, k_cache, kv_len, pos0=None, tree=None) -> None:
    """A launch's bytes and operations while a profiler trace is open
    (``ops/cost.py``): q read and the output written in f32, each
    sequence's K and V rows below kv_len read once; 4 operations a (query,
    key) pair a head dim, the pairs causal from pos0 (a tree's: the rows
    below it and its mask's). kv_len, pos0 and the mask are read when the
    trace ends."""
    if not cost.active():
        return
    KVH, hd = k_cache.shape[2], k_cache.shape[4]
    qh = q.numel() // (q.shape[0] * hd)  # (query, head) rows a sequence
    H = qh if pos0 is None else q.shape[2] * q.shape[3]
    T = qh // H
    row = 2 * KVH * hd * k_cache.element_size()

    def pairs():
        kl = kv_len.long()
        if pos0 is None:
            return int(kl.sum())
        if tree is not None:
            return int((kl - T).clamp_min(0).sum()) * T + kl.shape[0] * int(tree.sum())
        t = torch.arange(T, device=kl.device)
        return int(torch.minimum(pos0.long()[:, None] + t + 1, kl[:, None]).sum())
    cost.record(kernel, lambda: 8 * q.numel() + row * int(kv_len.long().sum()),
                lambda: 4 * hd * H * pairs())


def paged_view(pool_plane: torch.Tensor, pt: torch.Tensor) -> torch.Tensor:
    """One layer's pool (P, KVH, PR, hd) through the page table (B, nb) ->
    the slots' dense (B, KVH, nb * PR, hd) windows (a gather, as the jnp
    oracle does, ``calm_tpu/model.py:580-588``)."""
    B, nb = pt.shape
    _, KVH, PR, hd = pool_plane.shape
    return (pool_plane[pt.long()].transpose(1, 2)
            .reshape(B, KVH, nb * PR, hd))


def decode_attention_plain(q, k_cache, v_cache, kv_len, layer, fresh=None,
                           pt=None, batch_off=0):
    B, H, hd = q.shape
    KVH = k_cache.shape[2]
    M = H // KVH
    scale = 1.0 / math.sqrt(hd)
    qg = q.float().reshape(B, KVH, M, hd)
    kc, vc = k_cache[int(layer)], v_cache[int(layer)]
    if pt is not None:
        kc, vc = paged_view(kc, pt), paged_view(vc, pt)
    else:
        slots = slice(int(batch_off), int(batch_off) + B)
        kc, vc = kc[slots], vc[slots]
    kc, vc = kc.float(), vc.float()                      # (B, KVH, S, hd)
    S = kc.shape[2]
    scores = torch.einsum("bkmh,bksh->bkms", qg, kc) * scale
    col = torch.arange(S, device=q.device)
    live = col[None, :] < kv_len.to(q.device).long()[:, None]   # (B, S)
    if fresh is not None:
        fk, fv, kv_pos = fresh                            # (B, KVH, hd), (B,)
        live = live & (col[None, :] != kv_pos.to(q.device).long()[:, None])
        fs = (qg * fk.float()[:, :, None, :]).sum(-1, keepdim=True) * scale
        scores = torch.cat([fs, scores], dim=-1)
        vc = torch.cat([fv.float()[:, :, None, :], vc], dim=2)
        live = torch.cat([torch.ones_like(live[:, :1]), live], dim=1)
    scores = scores.masked_fill(~live[:, None, None, :], float("-inf"))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bkms,bksh->bkmh", p, vc).reshape(B, H, hd)


def decode_attention_partials_plain(q, k_cache, v_cache, kv_len, layer,
                                    batch_off=0):
    """The unnormalised flash state of the rows s < kv_len in f32, in the
    JAX convention (``pallas_attn.py:154-159``, ``:284-287``): acc (B, H,
    hd) = sum_s exp(score_s - m) v_s, m (B, H, 1) = the max of the scaled
    scores, l (B, H, 1) = sum_s exp(score_s - m); a row with nothing
    visible gives m = -inf, l = 0, acc = 0. Local row b reads cache slot
    batch_off + b."""
    B, H, hd = q.shape
    KVH = k_cache.shape[2]
    qg = q.float().reshape(B, KVH, H // KVH, hd)
    slots = slice(int(batch_off), int(batch_off) + B)
    kc = k_cache[int(layer), slots].float()
    vc = v_cache[int(layer), slots].float()
    scores = torch.einsum("bkmh,bksh->bkms", qg, kc) / math.sqrt(hd)
    col = torch.arange(kc.shape[2], device=q.device)
    live = col[None, :] < kv_len.to(q.device).long()[:, None]   # (B, S)
    scores = scores.masked_fill(~live[:, None, None, :], float("-inf"))
    m = scores.amax(-1, keepdim=True)                          # (B, KVH, M, 1)
    p = torch.exp(scores - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    acc = torch.einsum("bkms,bksh->bkmh", p, vc)
    return (acc.reshape(B, H, hd), m.reshape(B, H, 1),
            p.sum(-1, keepdim=True).reshape(B, H, 1))


class DecodePlan(NamedTuple):
    """The decode kernel's tiling of one call (``csrc/attn.cu``)."""
    tile_rows: int    # cache rows a shared-memory tile (TR)
    row_tile: int     # query rows a block (MM): 4, or 8 past 4
    row_tiles: int    # row tiles a kv head (NT)
    chunk_rows: int   # cache rows a block (CS), a multiple of tile_rows
    chunks: int       # chunks of the window (NC)
    blocks: int       # NC * B * KVH * NT
    pacc: int         # workspace floats: acc of every block
    pml: int          # workspace floats: m (and again l) of every block
    tickets: int      # ints, one a (b, kv head, row tile)


def decode_plan(B: int, KVH: int, M: int, S: int, hd: int) -> DecodePlan:
    """Tiles and chunks of the decode kernel for a window of S rows: about
    TARGET_BLOCKS blocks (two an SM, one resident wave) while that leaves
    a block MIN_TILES tiles or more; else about one block an SM, so that a
    short window is not cut into chunks whose fold costs more than their
    rows (at B=1 the chunks of one tile or two lose to four, on the card).
    At most MAX_CHUNKS chunks, a chunk a whole number of tiles. It depends
    on the logical window alone, never on kv_len or the page size, so paged
    and dense mode sum the same rows in the same order."""
    tr = 32 if hd > 128 else 64
    mm = 4 if M <= 4 else 8
    nt = -(-M // mm)
    groups = B * KVH * nt
    tiles = -(-S // tr)

    def chunk_tiles(target: int) -> int:
        want = max(1, target // groups)
        return max(-(-tiles // want), -(-tiles // MAX_CHUNKS))

    ct = chunk_tiles(TARGET_BLOCKS)
    if ct < MIN_TILES:
        ct = min(chunk_tiles(SMS), max(ct, MIN_TILES))
    cs = tr * ct
    nc = -(-S // cs)
    return DecodePlan(tr, mm, nt, cs, nc, groups * nc, groups * nc * mm * hd,
                      groups * nc * mm, groups)


_tickets: dict[torch.device, list[torch.Tensor]] = {}


def _ticket_buffer(dev: torch.device, n: int) -> torch.Tensor:
    """The decode kernel's chunk tickets, zeroed once and left zeroed by
    every launch (the last block of a group resets its own), so a call
    adds no fill launch. One buffer a device in use: calls on one stream
    only. A call that needs more adds a larger buffer and keeps the
    smaller ones, which a captured decode step may still address."""
    bufs = _tickets.setdefault(dev, [])
    if not bufs or bufs[-1].numel() < n:
        bufs.append(torch.zeros(max(n, 4096), dtype=torch.int32, device=dev))
    return bufs[-1]


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


@cost.ranged
def decode_attention(q, k_cache, v_cache, kv_len, layer, fresh=None, pt=None,
                     partials: bool = False, batch_off: int = 0):
    """q (B, H, hd) f32; caches (L, Bc, KVH, S, hd) in bf16/fp16/fp8-e5m2
    with ``layer`` selecting the plane; kv_len (B,) int32 -> (B, H, hd) f32.
    Local row b reads cache slot ``batch_off`` + b (pipeline microbatches
    address a slice of the full cache, as JAX's ``batch_off``).

    ``fresh`` = (fresh_k (B, KVH, hd) in the cache dtype, fresh_v, kv_pos
    (B,) int32): the current token's rows join the softmax directly and the
    stale cache row kv_pos is masked (deferred-write decode).

    ``pt`` (B, n_blocks) int32: paged mode. The caches are a page pool
    (L, P, KVH, PR, hd) and logical row s of slot b lives at page
    pt[b, s // PR], row s % PR; kv_len and kv_pos are logical rows. Every
    entry must lie in [0, P); entries past kv_len are never read. The page
    table addresses the slots, so ``batch_off`` must be 0.

    ``partials``: return the unnormalised state (acc (B, H, hd), m (B, H,
    1), l (B, H, 1)) of :func:`decode_attention_partials_plain` instead;
    it takes neither ``fresh`` nor ``pt``, as in JAX (``:230-232``)."""
    if partials and (fresh is not None or pt is not None):
        raise ValueError("partials mode composes with neither fresh rows nor paging")
    if pt is not None and batch_off:
        raise ValueError("paged mode addresses slots through its page table: batch_off must be 0")
    if q.device.type == "cpu":
        if partials:
            return decode_attention_partials_plain(q, k_cache, v_cache, kv_len, layer,
                                                   batch_off)
        return decode_attention_plain(q, k_cache, v_cache, kv_len, layer, fresh, pt,
                                      batch_off)
    B, H, hd = q.shape
    L, NP, KVH, PR, hd_c = k_cache.shape
    _check(q.dtype == torch.float32 and q.is_contiguous(), "q must be contiguous float32")
    _check(k_cache.dtype in _KV_CODE and v_cache.dtype == k_cache.dtype,
           f"no CUDA kernel for a {k_cache.dtype} cache")
    _check(tuple(v_cache.shape) == tuple(k_cache.shape) and hd_c == hd
           and (pt is not None or 0 <= batch_off <= NP - B), "cache shape mismatch")
    S = PR
    if pt is not None:
        _check(pt.dtype == torch.int32 and pt.dim() == 2 and pt.shape[0] == B
               and pt.is_contiguous() and pt.device == q.device,
               "pt must be a contiguous (B, n_blocks) int32 tensor on the card")
        S = pt.shape[1] * PR
    _check(k_cache.is_contiguous() and v_cache.is_contiguous(), "caches must be contiguous")
    _check(hd in HEAD_DIMS, f"the attention kernel takes head_dim {HEAD_DIMS}")
    _check(H % KVH == 0, "query heads must be a multiple of kv heads")
    _check(0 <= int(layer) < L, f"layer {layer} out of range for {L}")
    _check(kv_len.dtype == torch.int32 and tuple(kv_len.shape) == (B,)
           and kv_len.device == q.device, "kv_len must be (B,) int32 on the card")
    for t in (k_cache, v_cache, kv_len):
        _check(t.device == q.device, "all inputs must be on one device")
    fk = fv = kv_pos = None
    if fresh is not None:
        fk, fv, kv_pos = fresh
        for t in (fk, fv):
            _check(t.dtype == k_cache.dtype and tuple(t.shape) == (B, KVH, hd)
                   and t.is_contiguous() and t.device == q.device,
                   "fresh rows must be contiguous (B, KVH, hd) in the cache dtype")
        _check(kv_pos.dtype == torch.int32 and tuple(kv_pos.shape) == (B,)
               and kv_pos.device == q.device, "kv_pos must be (B,) int32 on the card")
    M = H // KVH
    plan = decode_plan(B, KVH, M, S, hd)
    dev = q.device
    pacc = torch.empty(plan.pacc, dtype=torch.float32, device=dev)
    pm = torch.empty(plan.pml, dtype=torch.float32, device=dev)
    pl = torch.empty(plan.pml, dtype=torch.float32, device=dev)
    tickets = _ticket_buffer(dev, plan.tickets)
    out = torch.empty((B, H, hd), dtype=torch.float32, device=dev)
    mo = lo = None
    if partials:
        mo = torch.empty((B, H, 1), dtype=torch.float32, device=dev)
        lo = torch.empty((B, H, 1), dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = build.lib("attn").calm_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), kv_len.data_ptr(),
        ptr(fk), ptr(fv), ptr(kv_pos), ptr(pt), pacc.data_ptr(), pm.data_ptr(),
        pl.data_ptr(), tickets.data_ptr(), out.data_ptr(), ptr(mo), ptr(lo), B, KVH,
        M, S, hd, int(layer), plan.chunk_rows, _KV_CODE[k_cache.dtype], NP, PR,
        plan.row_tile, int(batch_off), torch.cuda.current_stream(dev).cuda_stream)
    build.check("attn", rc)
    _cost_attention("attn_decode_kernel", q, k_cache, kv_len)
    if partials:
        decode_attention.partials_launches += 1
        return out, mo, lo
    decode_attention.launches += 1
    decode_attention.paged_launches += pt is not None
    return out


decode_attention.launches = 0
decode_attention.paged_launches = 0  # the launches in paged mode
decode_attention.partials_launches = 0  # the launches in partials mode


# ---------------------------------------------------------------------------
# K13: prefill_attention
# ---------------------------------------------------------------------------


class PrefillPlan(NamedTuple):
    """The prefill kernel's tiling of one call (``csrc/attn.cu``)."""
    rows: int         # (query, head) rows a work item, R = t * M + m (PF_ROWS)
    tile_rows: int    # cache rows a K/V tile: 64, or 32 at hd 256
    swizzle: int      # bytes a row of a swizzled column block: 128, or 64 at hd 96
    q_tiles: int      # query tiles a (kv head, sequence)
    items: int        # q_tiles * KVH * B work items
    order: tuple      # item i -> (query tile, kv head, b, cache rows it reads)
    grid: int         # persistent blocks: one an SM, at most one an item
    blocks: tuple     # block -> its items, in the order it takes them


def prefill_item(i: int, q_tiles: int, KVH: int, B: int) -> tuple[int, int, int]:
    """(query tile, kv head, b) of work item i: the heaviest query tiles
    first, every kv head and sequence of one query tile together (the
    kernel's own arithmetic)."""
    per = KVH * B
    return q_tiles - 1 - i // per, i % per % KVH, i % per // KVH


def prefill_block_items(block: int, grid: int, items: int) -> list[int]:
    """The items a persistent block takes, in order: band k of ``grid``
    items is walked forwards when k is even and backwards when it is odd,
    so each block pairs a heavy item with a light one (the kernel's
    ``item_pos``)."""
    out = []
    for k in range(-(-items // grid)):
        pos = k * grid + (grid - 1 - block if k % 2 else block)
        if pos < items:
            out.append(pos)
    return out


def prefill_grid(B: int, T: int, KVH: int, M: int, sms: int = SMS) -> int:
    """The prefill kernel's persistent blocks: one an SM, at most one an item."""
    return min(-(-T * M // PF_ROWS) * KVH * B, sms)


def prefill_plan(B: int, T: int, KVH: int, M: int, hd: int, pos0_max: int = 0,
                 sms: int = SMS) -> PrefillPlan:
    """The prefill kernel's work items in order, each with the cache rows
    it reads when every sequence starts at ``pos0_max`` with the T fresh rows
    its last (kv_len = pos0 + T): min(kv_len, pos0 + t_last + 1) for the
    item's last query t_last. An item's causal range grows with its query
    tile, so the last query tile comes first; one persistent block an SM
    takes them in a snake over the order."""
    tm = T * M
    nq = -(-tm // PF_ROWS)
    items = nq * KVH * B
    order = []
    for i in range(items):
        qt, h, b = prefill_item(i, nq, KVH, B)
        t_last = (min((qt + 1) * PF_ROWS, tm) - 1) // M
        order.append((qt, h, b, min(pos0_max + T, pos0_max + t_last + 1)))
    grid = prefill_grid(B, T, KVH, M, sms)
    return PrefillPlan(PF_ROWS, 64 if hd <= 128 else 32, 128 if hd % 64 == 0 else 64,
                       nq, items, tuple(order), grid,
                       tuple(tuple(prefill_block_items(g, grid, items)) for g in range(grid)))


def prefill_attention_plain(q, k_cache, v_cache, pos0, kv_len, layer,
                            batch_off=0, tree=None, rows=None):
    """Masked softmax in f32 over the cache rows any query can see: the
    first ``rows`` (a host int; from kv_len on the host when None, which
    reads a device value).

    With ``tree`` (T, T) bool, the queries are a speculation tree's nodes
    in cache rows [kv_len - T, kv_len): a node sees the context below the
    tree and, inside it, the nodes ``tree`` marks (its ancestors and
    itself), as ``calm_tpu/model.py:613-630`` masks them (JAX runs that
    in jnp, ``:1051-1064``). This is the plain version of both routes of
    the prefill kernel, the split-S route's tree mode included
    (:func:`tree_attention`); it reads no device value on the host when
    ``rows`` is given."""
    B, T, KVH, M, hd = q.shape
    n = max(1, min(k_cache.shape[3], int(kv_len.max()) if rows is None else int(rows)))
    dev = q.device
    slots = slice(batch_off, batch_off + B)
    kc = k_cache[int(layer), slots, :, :n].float()        # (B, KVH, n, hd)
    vc = v_cache[int(layer), slots, :, :n].float()
    scores = torch.einsum("btkmh,bksh->bkmts", q.float(), kc) / math.sqrt(hd)
    col = torch.arange(n, device=dev)[None, None, :]
    end = kv_len.to(dev).long()[:, None, None]
    if tree is None:
        qpos = pos0.to(dev).long()[:, None] + torch.arange(T, device=dev)  # (B, T)
        ok = (col < end) & (col <= qpos[:, :, None])       # (B, T, n)
    else:
        if tree.shape != (T, T):
            raise ValueError(f"tree verify needs one query per node (T={T}, "
                             f"tree {tuple(tree.shape)})")
        p0 = end - T                                       # (B, 1, 1)
        node = (col - p0).clamp(0, T - 1).expand(B, T, n)
        seen = torch.gather(tree.to(dev)[None].expand(B, T, T), 2, node)
        ok = (col < end) & torch.where(col >= p0, seen, col < p0)
    scores = scores.masked_fill(~ok[:, None, None], float("-inf"))
    m = scores.amax(-1, keepdim=True)
    p = torch.exp(scores - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    out = torch.einsum("bkmts,bksh->btkmh", p, vc)
    l = p.sum(-1).permute(0, 3, 1, 2)[..., None]           # (B, T, KVH, M, 1)
    return out / l.clamp_min(1e-37)


@cost.ranged
def prefill_attention(q, k_cache, v_cache, pos0, kv_len, layer, batch_off=0):
    """q (B, T, KVH, M, hd) f32; caches (L, Bc, KVH, S, hd) in
    bf16/fp16/fp8-e5m2 holding the T fresh rows already, sequence b in slot
    batch_off + b; pos0, kv_len (B,) int32 -> (B, T, KVH, M, hd) f32. Query
    t of sequence b sits at position pos0[b] + t and sees cache rows col <
    kv_len[b], col <= pos0[b] + t. On the card K/V enter the tensor cores as
    bf16 (exact for bf16 and e5m2 caches, rounded for fp16), and q and p
    rounded once to bf16, as the TPU kernel rounds them; sums in f32. A call
    of at most SPLIT_MAX_ROWS rows a kv head (:func:`split_route`) takes the
    split-S route (:func:`verify_plan`, counted in ``.split_launches``); the
    rest the persistent kernel (:func:`prefill_plan`, ``.launches``)."""
    if q.device.type == "cpu":
        return prefill_attention_plain(q, k_cache, v_cache, pos0, kv_len, layer,
                                       batch_off)
    _check_prefill(q, k_cache, v_cache, pos0, kv_len, layer, batch_off)
    if split_route(q.shape[1], q.shape[3]):
        out = _split_launch(q, k_cache, v_cache, pos0, kv_len, layer, batch_off, None)
        prefill_attention.split_launches += 1
        return out
    out = _persistent_launch(q, k_cache, v_cache, pos0, kv_len, layer, batch_off)
    prefill_attention.launches += 1
    return out


prefill_attention.launches = 0  # the persistent kernel's launches
prefill_attention.split_launches = 0  # the split-S route's


def _persistent_launch(q, k_cache, v_cache, pos0, kv_len, layer, batch_off):
    """One launch of the persistent kernel on checked inputs."""
    B, T, KVH, M, hd = q.shape
    L, Bc, _, S, _ = k_cache.shape
    out = torch.empty_like(q)
    rc = build.lib("attn").calm_prefill_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos0.data_ptr(),
        kv_len.data_ptr(), out.data_ptr(), B, T, KVH, M, S, hd, int(layer),
        _KV_CODE[k_cache.dtype], L, Bc, int(batch_off), prefill_grid(B, T, KVH, M),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check("attn", rc)
    _cost_attention("prefill_kernel", q, k_cache, kv_len, pos0)
    return out


def _check_prefill(q, k_cache, v_cache, pos0, kv_len, layer, batch_off):
    """What both routes of the prefill kernel take on the card; raises
    ValueError on the rest."""
    B, T, KVH, M, hd = q.shape
    L, Bc, KVHc, S, hd_c = k_cache.shape
    _check(q.dtype == torch.float32 and q.is_contiguous(), "q must be contiguous float32")
    _check(k_cache.dtype in _KV_CODE and v_cache.dtype == k_cache.dtype,
           f"no CUDA kernel for a {k_cache.dtype} cache")
    _check(tuple(v_cache.shape) == tuple(k_cache.shape) and 0 <= batch_off
           and batch_off + B <= Bc and KVHc == KVH and hd_c == hd,
           "cache shape mismatch")
    _check(k_cache.is_contiguous() and v_cache.is_contiguous(), "caches must be contiguous")
    _check(hd in HEAD_DIMS, f"the attention kernel takes head_dim {HEAD_DIMS}")
    _check(M >= 1, "the prefill kernel needs a query head per kv head")
    _check(0 <= int(layer) < L, f"layer {layer} out of range for {L}")
    for t in (pos0, kv_len):
        _check(t.dtype == torch.int32 and tuple(t.shape) == (B,) and t.device == q.device,
               "pos0 and kv_len must be (B,) int32 on the card")
    _check(k_cache.device == q.device and v_cache.device == q.device,
           "all inputs must be on one device")
    _check(all(t.data_ptr() % 16 == 0 for t in (q, k_cache, v_cache)),
           "q and the caches must be 16-byte aligned (TMA, cp.async)")


# ---------------------------------------------------------------------------
# K13's split-S route: a speculative verify's few rows, and the draft tree
# ---------------------------------------------------------------------------


class VerifyPlan(NamedTuple):
    """The split-S route's tiling of one call (``csrc/attn.cu``
    ``verify_kernel``)."""
    tile_rows: int    # cache rows a K/V tile (TR): 64, or 32 at hd 256
    row_tiles: int    # 16-row tiles of (query, head) rows a block (RT)
    row_groups: int   # blocks a (chunk, kv head, sequence) (NG): RT * 16 rows each
    threads: int      # RT x WS warps: WS split a tile's 16-row sub-tiles
    chunk_rows: int   # cache rows a block (CS), a multiple of tile_rows
    chunks: int       # chunks of the window (NC)
    blocks: int       # NC * KVH * B * NG
    pacc: int         # workspace floats: acc of every block's rows
    pml: int          # workspace floats: m (and again l) of every block's rows
    tickets: int      # ints, one a (b, kv head, row group)


def split_route(T: int, M: int) -> bool:
    """Whether :func:`prefill_attention` takes the split-S route: T * M
    (query, head) rows a kv head, at most SPLIT_MAX_ROWS (one row group)."""
    return T * M <= SPLIT_MAX_ROWS


def verify_plan(B: int, T: int, KVH: int, M: int, S: int, hd: int) -> VerifyPlan:
    """Tiles, row groups and chunks of the split-S route for a window of S
    rows. A kv head's T * M rows go in row groups of up to VA_ROWS, as few
    as hold them, split evenly into 16-row tiles; a block's warps are its
    row tiles times the splits of a tile's 16-row sub-tiles (four for one
    or two row tiles, else two; at most the sub-tiles). Chunks aim at one
    resident wave of about SMS blocks while a chunk keeps MIN_TILES tiles
    (a short chunk's fold costs more than its rows), at most VA_MAX_CHUNKS,
    a whole number of tiles. A pure function of the shapes: never of kv_len
    or pos0, so every call of a shape sums the same rows in the same
    order."""
    tr = 32 if hd > 128 else 64
    tiles16 = -(-(T * M) // 16)
    ng = -(-tiles16 // (VA_ROWS // 16))
    rt = -(-tiles16 // ng)
    ws = min(4 if rt <= 2 else 2, tr // 16)
    groups = B * KVH * ng
    tiles = -(-S // tr)
    want = max(1, SMS // groups)
    ct = max(-(-tiles // want), -(-tiles // VA_MAX_CHUNKS), min(MIN_TILES, tiles))
    cs = tr * ct
    nc = -(-S // cs)
    rows = rt * 16
    return VerifyPlan(tr, rt, ng, 32 * rt * ws, cs, nc, groups * nc, groups * nc * rows * hd,
                      groups * nc * rows, groups)


def _split_launch(q, k_cache, v_cache, pos0, kv_len, layer, batch_off, tree):
    """One launch of the split-S route on checked inputs."""
    B, T, KVH, M, hd = q.shape
    _, Bc, _, S, _ = k_cache.shape
    plan = verify_plan(B, T, KVH, M, S, hd)
    dev = q.device
    pacc = torch.empty(plan.pacc, dtype=torch.float32, device=dev)
    pm = torch.empty(plan.pml, dtype=torch.float32, device=dev)
    pl = torch.empty(plan.pml, dtype=torch.float32, device=dev)
    tickets = _ticket_buffer(dev, plan.tickets)
    out = torch.empty_like(q)
    rc = build.lib("attn").calm_verify_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos0.data_ptr(),
        kv_len.data_ptr(), None if tree is None else tree.data_ptr(), pacc.data_ptr(),
        pm.data_ptr(), pl.data_ptr(), tickets.data_ptr(), out.data_ptr(), B, T, KVH, M, S,
        hd, int(layer), _KV_CODE[k_cache.dtype], Bc, int(batch_off), plan.chunk_rows,
        plan.row_tiles, plan.row_groups, plan.threads,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check("attn", rc)
    _cost_attention("verify_kernel", q, k_cache, kv_len, pos0, tree)
    return out


@cost.ranged
def tree_attention(q, k_cache, v_cache, pos0, kv_len, layer, tree, batch_off=0):
    """The draft tree's attention: q (B, T, KVH, M, hd) f32, one query a
    node; caches as :func:`prefill_attention`'s, holding the T nodes' rows
    at [kv_len - T, kv_len); tree (T, T) bool, node t's ancestors-or-self.
    Node t sees the context below the tree and, inside it, the nodes
    ``tree[t]`` marks (``calm_tpu/model.py:613-630``). JAX runs this in jnp:
    no TPU kernel. On the card it is the split-S route of the prefill kernel
    with the tree's mask read on the device, at any node count (row groups),
    reading only the rows below kv_len; counted in ``.launches``. On the
    CPU its plain version over every row of the window."""
    if q.device.type == "cpu":
        return prefill_attention_plain(q, k_cache, v_cache, pos0, kv_len, layer, batch_off,
                                       tree=tree, rows=k_cache.shape[3])
    _check_prefill(q, k_cache, v_cache, pos0, kv_len, layer, batch_off)
    T = q.shape[1]
    _check(tree.dtype == torch.bool and tuple(tree.shape) == (T, T) and tree.is_contiguous()
           and tree.device == q.device,
           f"the tree mask must be a contiguous ({T}, {T}) bool tensor on the card")
    out = _split_launch(q, k_cache, v_cache, pos0, kv_len, layer, batch_off, tree)
    tree_attention.launches += 1
    return out


tree_attention.launches = 0
