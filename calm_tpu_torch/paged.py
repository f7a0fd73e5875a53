"""Paged KV cache: decode slots draw pages from one shared pool (the port
of ``calm_tpu.paged`` on one device).

Slots hold pages of ``page_rows`` rows instead of a dense ``seq_len``
window each, so device memory follows the sum of live context lengths,
not slots x seq_len. Layout: pool (L, n_pages + 1, KVH, PR, hd); slot b's
logical window row r lives in page pt[b, r // PR] at row r % PR. The sinks
and the rolling window keep their logical index math
(``model.decode_indices``): a wrap reuses the slot's pages, so a slot
never holds more than seq_len / PR pages however long it decodes.

On this card a page may be any size that divides the window: the
attention kernel (``csrc/attn.cu``, paged mode) addresses each row
through the table. The TPU package's >= 512-row pages
(``calm_tpu/paged.py:8-14``) are a Mosaic DMA size.

Against the JAX decoder: the admission scratch (L, 1, KVH, S, hd) is
allocated once per decoder, not per admission; the page table lives in
one device buffer, written again in place only when a row of it changes
(the captured step reads it there); row and page copies are tensor slice
copies. On the card every step replays the pool's captured step
(``model.decode_once``). ``mesh``/``plan`` sharding and
``PagedGroup`` (one decoder per device) wait for the parallel slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from calm_tpu_torch import model as M
from calm_tpu_torch.config import ModelConfig


def create_pool(cfg: ModelConfig, n_pages: int, page_rows: int,
                dtype=torch.bfloat16, device="cpu") -> M.KVCache:
    shape = (cfg.n_layers, n_pages, cfg.n_kv_heads, page_rows, cfg.head_dim)
    return M.KVCache(torch.zeros(shape, dtype=dtype, device=device),
                     torch.zeros(shape, dtype=dtype, device=device))


@dataclasses.dataclass
class _PagedSlot:
    active: bool = False
    pages: list = dataclasses.field(default_factory=list)
    pos: int = 0
    token: int = 0
    # block indices mapped to shared (prefix-cache-pinned) pages: read-only
    # for this slot; a write there copies the page first
    shared: set = dataclasses.field(default_factory=set)


class PagedDecoder:
    """Multi-slot decode over a shared page pool (``calm_tpu/paged.py:106``).

    * ``n_pages`` bounds the total context across slots: n_pages *
      page_rows rows, against the dense layout's batch * seq_len.
      Admission returns False when the pool cannot cover it.
    * admission prefills the prompt into the one-slot scratch, then copies
      the rows page by page into the pool.
    * every tick runs one paged decode step for all slots.
    """

    def __init__(self, cfg: ModelConfig, weights: M.Weights, n_pages: int,
                 page_rows: int = 512, kv_dtype=torch.bfloat16, batch: int = 4):
        if cfg.seq_len % page_rows:
            raise ValueError(f"seq_len {cfg.seq_len} does not tile into "
                             f"pages of {page_rows} rows")
        self.cfg = cfg
        self.weights = weights
        self.device = weights.embed.data.device  # the pool lives with the weights
        self.page_rows = page_rows
        self.n_blocks = cfg.seq_len // page_rows
        self.batch = batch
        self.kv_dtype = kv_dtype
        # +1: the last page is the parking page, never handed out. The step
        # writes every slot's row (and a wrapped slot's sink rotation
        # rewrites page pt[b, 0]) whether or not the slot is active, so an
        # empty slot's table row points at a page no request owns
        self.parking = n_pages
        self.pool = create_pool(cfg, n_pages + 1, page_rows, kv_dtype, self.device)
        self.scratch = M.KVCache.create(cfg, 1, kv_dtype, self.device)
        self.free_pages = list(range(n_pages - 1, -1, -1))
        # refs[p]: users of page p (slots mapping it shared + prefix-cache
        # entries pinning it); a page with refs > 0 is never free
        self.page_refs = np.zeros(n_pages, np.int32)
        self.slots = [_PagedSlot() for _ in range(batch)]
        # dead entries point at the slot's own page 0 (reads there lie past
        # kv_len; writes never land past the slot's blocks), or at the
        # parking page when the slot holds nothing
        self.pt = np.full((batch, self.n_blocks), self.parking, np.int32)
        # the device copy, one buffer for the decoder's life
        self._pt_dev = torch.tensor(self.pt, device=self.device)
        self._pt_stale = False

    # -- page bookkeeping ---------------------------------------------------

    def _alloc(self, n: int):
        if len(self.free_pages) < n:
            return None
        return [self.free_pages.pop() for _ in range(n)]

    def _sync_pt_row(self, b: int):
        slot = self.slots[b]
        first = slot.pages[0] if slot.pages else self.parking
        row = [slot.pages[j] if j < len(slot.pages) else first
               for j in range(self.n_blocks)]
        if list(self.pt[b]) != row:
            self.pt[b] = row
            self._pt_stale = True

    def page_table(self) -> torch.Tensor:
        """The (B, n_blocks) int32 table on the device: always the same
        buffer, written again in place (one copy, no sync) only after a row
        changed."""
        if self._pt_stale:
            self._pt_dev.copy_(torch.from_numpy(self.pt), non_blocking=True)
            self._pt_stale = False
        return self._pt_dev

    def pages_in_use(self) -> int:
        return sum(len(s.pages) for s in self.slots)

    # -- admission ----------------------------------------------------------

    def admit(self, b: int, tokens: list[int], shared_pages=(),
              hit_rows: int = 0) -> bool:
        """Prefill ``tokens[:-1]`` into slot b's pages; the last token is
        the first decode input. Pages come lazily: ceil((len + 1) / PR) now,
        one more as decode crosses each block boundary. False when the pool
        cannot cover the admission itself.

        ``shared_pages``/``hit_rows``: a prefix-cache hit. The first
        hit_rows (a page multiple) prompt rows already live in those pinned
        pages; the slot maps them read-only and prefills only the suffix,
        on a scratch seeded from the shared pages so that it attends them."""
        slot = self.slots[b]
        assert not slot.active
        PR = self.page_rows
        assert hit_rows % PR == 0
        n_pre = min(len(tokens) - 1, self.cfg.seq_len - 1)
        if hit_rows > n_pre:  # an over-long stored prefix: its aligned part
            hit_rows = n_pre // PR * PR
            shared_pages = shared_pages[:hit_rows // PR]
        sblocks = hit_rows // PR
        need = max(1, -(-(n_pre + 1) // PR)) - sblocks
        pages = self._alloc(max(need, 0))
        if pages is None:
            return False
        slot.pages = list(shared_pages[:sblocks]) + pages
        slot.shared = set(range(sblocks))
        for p in shared_pages[:sblocks]:
            self.page_refs[p] += 1
        slot.active = True
        slot.token = tokens[-1]
        slot.pos = n_pre
        self._sync_pt_row(b)

        if n_pre > hit_rows:
            sk, sv, pk, pv = self.scratch.k, self.scratch.v, self.pool.k, self.pool.v
            for blk in range(sblocks):  # seed the shared prefix rows
                rows = slice(blk * PR, (blk + 1) * PR)
                sk[:, 0, :, rows] = pk[:, slot.pages[blk]]
                sv[:, 0, :, rows] = pv[:, slot.pages[blk]]
            toks = torch.tensor([tokens[hit_rows:n_pre]], dtype=torch.int64,
                                device=self.device)
            M.prefill(self.cfg, self.weights, toks, [hit_rows], self.scratch, "none")
            for blk in range(sblocks, -(-n_pre // PR)):
                rows = slice(blk * PR, (blk + 1) * PR)
                pk[:, slot.pages[blk]] = sk[:, 0, :, rows]
                pv[:, slot.pages[blk]] = sv[:, 0, :, rows]
        return True

    def pin_prompt(self, b: int, n_rows: int):
        """Pin the pages fully covering the first ``n_rows`` prompt rows as
        a shareable prefix, in place; the slot keeps them mapped read-only
        (its own later writes copy first). Returns (rows pinned, pages);
        rows pinned is n_rows cut to a page multiple."""
        slot = self.slots[b]
        full = min(n_rows // self.page_rows, len(slot.pages))
        if full == 0:
            return 0, []
        pages = slot.pages[:full]
        for j, p in enumerate(pages):
            self.page_refs[p] += 1          # the cache entry's reference
            if j not in slot.shared:
                self.page_refs[p] += 1      # the slot's mapping becomes shared
                slot.shared.add(j)
        return full * self.page_rows, pages

    def unpin_pages(self, pages):
        """Drop a prefix-cache entry's references (its eviction)."""
        for p in pages:
            self.page_refs[p] -= 1
            if self.page_refs[p] == 0:
                self.free_pages.append(p)

    def _cow(self, b: int, blk: int) -> bool:
        """Slot b is about to write shared block ``blk``: give it a private
        copy of the page first. False when the pool is dry."""
        slot = self.slots[b]
        got = self._alloc(1)
        if got is None:
            return False
        src, dst = slot.pages[blk], got[0]
        self.pool.k[:, dst] = self.pool.k[:, src]
        self.pool.v[:, dst] = self.pool.v[:, src]
        slot.pages[blk] = dst
        slot.shared.discard(blk)
        self.page_refs[src] -= 1
        if self.page_refs[src] == 0:
            self.free_pages.append(src)
        self._sync_pt_row(b)
        return True

    def release(self, b: int):
        slot = self.slots[b]
        for j, p in enumerate(slot.pages):
            if j in slot.shared:
                self.page_refs[p] -= 1      # shared: drop our mapping only
                if self.page_refs[p] == 0:
                    self.free_pages.append(p)
            else:
                self.free_pages.append(p)
        slot.pages = []
        slot.shared = set()
        slot.active = False
        self._sync_pt_row(b)

    # -- decode -------------------------------------------------------------

    def ensure_capacity(self, b: int) -> bool:
        """Grow slot b's pages to cover its next write row, and copy any
        shared page this step writes (the write row's block; once the slot
        wraps, block 0 too, which the sink rotation rewrites). False when
        the pool is dry: the caller decides (the server finishes the
        request early and flags it)."""
        s = self.slots[b]
        if not s.active:
            return True
        blk = M.decode_indices(self.cfg, s.pos)[0] // self.page_rows
        while len(s.pages) <= blk:  # grow across a block boundary
            got = self._alloc(1)
            if got is None:
                return False
            s.pages.extend(got)
            self._sync_pt_row(b)
        if blk in s.shared and not self._cow(b, blk):
            return False
        if s.pos + 1 >= self.cfg.seq_len and 0 in s.shared and not self._cow(b, 0):
            return False
        return True

    def _step(self, sampling=None):
        """One decode step for every slot: (logits (B, V), next ids (B,))
        on the device, the ids argmax or drawn by ``sampling``."""
        for b in range(self.batch):
            if not self.ensure_capacity(b):
                raise RuntimeError("page pool exhausted mid-decode")
        S = self.cfg.seq_len
        out = M.decode_once(self.cfg, self.weights, [s.token for s in self.slots],
                            [s.pos for s in self.slots], self.pool,
                            any(s.pos + 1 >= S for s in self.slots), self.page_table(),
                            sampling)
        for s in self.slots:
            if s.active:
                s.pos += 1
        return out

    def step(self, host: bool = True):
        """One decode step for every slot; logits (B, V) as f32 numpy when
        ``host``, else on the device (a copy). Inactive slots decode garbage
        at their parked position; their table rows point at the parking
        page. Raises RuntimeError when an active slot needs a page and the
        pool is dry (call ensure_capacity first for a gentler policy)."""
        logits = self._step()[0]
        return logits.float().cpu().numpy() if host else logits.clone()

    def set_token(self, b: int, tok: int):
        self.slots[b].token = tok

    def step_sampled(self, generator: torch.Generator, temps: torch.Tensor,
                     minps: torch.Tensor) -> list[int]:
        """One decode step and min-p sampling on the device: only the (B,)
        ids reach the host."""
        return self._step((generator, temps, minps))[1].tolist()


class PagedGroup:
    """dp-sharded paging (one decoder per device) belongs to the parallel
    slice of the port."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "PagedGroup (paged serving over several devices) is not ported yet")
