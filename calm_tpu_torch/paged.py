"""Paged KV cache: decode slots draw pages from one shared pool (the port
of ``calm_tpu.paged``).

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
copies. On the card every step of an unsharded decoder replays the pool's
captured step (``model.decode_once``).

Three ways to place a decoder (``calm_tpu/paged.py:121-187``):

- on its weights' device, the default;
- ``device=``: the pool and the compute pinned to that device (the
  weights moved there, or shared when they lie there already);
- ``mesh=``/``plan=``: one rank's share of a tp/ep-sharded decoder. Each
  rank holds its local weights and the pool's kv heads over tp, the page
  table is the same on every rank, an admission prefills through
  ``parallel.sharding.sharded_prefill`` into a scratch laid out as the
  sharded cache, and the logits are gathered over tp. That step runs
  eagerly (its collectives go through ``torch.distributed``) and samples
  on the host.

:class:`PagedGroup` holds one independent decoder per listed device.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from calm_tpu_torch import model as M
from calm_tpu_torch.config import ModelConfig
from calm_tpu_torch.ops.cost import span


def create_pool(cfg: ModelConfig, n_pages: int, page_rows: int,
                dtype=torch.bfloat16, device="cpu", kv_heads: int | None = None) -> M.KVCache:
    """A zero pool of ``n_pages`` pages of ``kv_heads`` heads (a tp rank's
    share; all of them when None)."""
    shape = (cfg.n_layers, n_pages, kv_heads or cfg.n_kv_heads, page_rows, cfg.head_dim)
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

    ``device`` pins the pool and the compute to one device; ``mesh`` and
    ``plan`` (tp/ep only, weights already this rank's shard) make this one
    rank's share of a sharded decoder (the module's docstring)."""

    def __init__(self, cfg: ModelConfig, weights: M.Weights, n_pages: int,
                 page_rows: int = 512, kv_dtype=torch.bfloat16, batch: int = 4,
                 device=None, mesh=None, plan=None):
        if cfg.seq_len % page_rows:
            raise ValueError(f"seq_len {cfg.seq_len} does not tile into "
                             f"pages of {page_rows} rows")
        if mesh is not None and device is not None:
            raise ValueError("a decoder on a mesh computes on the mesh's device")
        if mesh is not None and (plan is None or plan.dp is not None or plan.sp is not None
                                 or plan.pp is not None):
            raise ValueError("paged decode on a mesh takes tp/ep plans "
                             "(calm_tpu/paged.py:140-143)")
        self.cfg = cfg
        self.mesh, self.plan = mesh, plan
        if mesh is not None:
            self.device = mesh.device
        elif device is not None:
            self.device = torch.device(device)
            weights = M.weights_to(weights, self.device)
        else:
            self.device = weights.embed.data.device  # the pool lives with the weights
        self.weights = weights
        self.page_rows = page_rows
        self.n_blocks = cfg.seq_len // page_rows
        self.batch = batch
        self.kv_dtype = kv_dtype
        # +1: the last page is the parking page, never handed out. The step
        # writes every slot's row (and a wrapped slot's sink rotation
        # rewrites page pt[b, 0]) whether or not the slot is active, so an
        # empty slot's table row points at a page no request owns
        self.parking = n_pages
        if mesh is not None:
            from calm_tpu_torch.parallel.sharding import local_cache, sharded_prefill
            kv_heads = cfg.n_kv_heads // mesh.axis_size(plan.tp)
            self.scratch = local_cache(cfg, 1, kv_dtype, mesh, plan)
            self._prefill = sharded_prefill(cfg, mesh, plan, "none")
        else:
            kv_heads = cfg.n_kv_heads
            self.scratch = M.KVCache.create(cfg, 1, kv_dtype, self.device)
        self.pool = create_pool(cfg, n_pages + 1, page_rows, kv_dtype, self.device, kv_heads)
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

    def _on_device(self):
        """Make this decoder's device the current one while it computes:
        the kernel wrappers launch on the current device's stream."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

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
            with self._on_device():
                sk, sv, pk, pv = self.scratch.k, self.scratch.v, self.pool.k, self.pool.v
                for blk in range(sblocks):  # seed the shared prefix rows
                    rows = slice(blk * PR, (blk + 1) * PR)
                    sk[:, 0, :, rows] = pk[:, slot.pages[blk]]
                    sv[:, 0, :, rows] = pv[:, slot.pages[blk]]
                toks = torch.tensor([tokens[hit_rows:n_pre]], dtype=torch.int64,
                                    device=self.device)
                if self.mesh is not None:  # the sharded scratch, prefilled over the mesh
                    self._prefill(self.weights, toks, [hit_rows], self.scratch)
                else:
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
        with self._on_device():
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
        on the device, the ids argmax or drawn by ``sampling``. On a mesh
        the step runs eagerly and its logits are gathered over tp."""
        for b in range(self.batch):
            if not self.ensure_capacity(b):
                raise RuntimeError("page pool exhausted mid-decode")
        S = self.cfg.seq_len
        tokens, pos = [s.token for s in self.slots], [s.pos for s in self.slots]
        rolling = any(s.pos + 1 >= S for s in self.slots)
        with self._on_device():
            if self.mesh is not None:
                if sampling is not None:
                    raise ValueError("paged decode on a mesh samples on the host "
                                     "(calm_tpu/serve.py:255-256)")
                logits, _ = M.paged_decode_step(self.cfg, self.weights, tokens, pos,
                                                self.pool, self.page_table(), rolling,
                                                self.plan, self.mesh)
                logits = self.mesh.all_gather(logits, self.plan.tp, dim=-1)
                out = logits, logits.argmax(-1)
            else:
                out = M.decode_once(self.cfg, self.weights, tokens, pos, self.pool, rolling,
                                    self.page_table(), sampling)
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
        if not host:
            return logits.clone()
        with span("serve.readback"):
            return logits.float().cpu().numpy()

    def set_token(self, b: int, tok: int):
        self.slots[b].token = tok

    def _sampling(self, generator, temps, minps):
        """The sampling triple of ``model.decode_once`` with temps and minps
        on this decoder's device (tensors there already are kept)."""
        return (generator, torch.as_tensor(temps, dtype=torch.float32).to(self.device),
                torch.as_tensor(minps, dtype=torch.float32).to(self.device))

    def step_sampled(self, generator: torch.Generator, temps, minps) -> list[int]:
        """One decode step and min-p sampling on the device: only the (B,)
        ids reach the host. ``temps`` and ``minps`` (B,): tensors on this
        decoder's device, or host numbers."""
        ids = self._step(self._sampling(generator, temps, minps))[1]
        with span("serve.readback"):
            return ids.tolist()


class PagedGroup:
    """dp-sharded paging (``calm_tpu/paged.py:417-492``): one independent
    :class:`PagedDecoder` (pool and compute) a listed device, slots split
    contiguously over them: slot b (a global id) is local slot (b -
    own_lo) % per_shard of decoder (b - own_lo) // per_shard.

    Decode is batch-local, so the decoders need no collective: ``step`` and
    ``step_sampled`` dispatch every decoder before reading any result, and
    return only the group's own slots' rows. The list may repeat a device
    (one card): decoders there share the weights (``model.weights_to``
    makes no second copy of tensors already on the device) and each keeps
    its own pool and captured step."""

    def __init__(self, cfg: ModelConfig, weights: M.Weights, pool_pages: int,
                 page_rows: int, kv_dtype, per_shard: int, devices, own_lo: int = 0):
        self.page_rows = page_rows
        self.per = per_shard
        self.own_lo = own_lo
        self.decs = [PagedDecoder(cfg, weights, pool_pages, page_rows, kv_dtype, per_shard,
                                  device=d) for d in devices]

    def _loc(self, b: int):
        d, r = divmod(b - self.own_lo, self.per)
        return self.decs[d], r

    def set_token(self, b: int, tok: int):
        dec, lb = self._loc(b)
        dec.slots[lb].token = tok

    def admit(self, b, tokens, shared_pages=(), hit_rows: int = 0) -> bool:
        dec, lb = self._loc(b)
        return dec.admit(lb, tokens, shared_pages, hit_rows)

    def release(self, b: int):
        dec, lb = self._loc(b)
        dec.release(lb)

    def ensure_capacity(self, b: int) -> bool:
        dec, lb = self._loc(b)
        return dec.ensure_capacity(lb)

    def pin_prompt(self, b: int, n_rows: int):
        dec, lb = self._loc(b)
        return dec.pin_prompt(lb, n_rows)

    def shard_of(self, b: int) -> int:
        """The decoder that serves global slot b (prefix caches are one a
        decoder: pinned page ids mean something only in their own pool)."""
        return (b - self.own_lo) // self.per

    def pages_in_use(self) -> int:
        return sum(d.pages_in_use() for d in self.decs)

    def step(self) -> np.ndarray:
        """One step of every decoder: the own slots' logits (B, V), f32 on
        the host."""
        outs = [d._step()[0] for d in self.decs]  # every decoder dispatched first
        with span("serve.readback"):
            return np.concatenate([o.float().cpu().numpy() for o in outs], axis=0)

    def step_sampled(self, generator: torch.Generator, temps, minps) -> list[int]:
        """One step and a min-p draw on each decoder's device, each decoder
        with its own generator seeded from ``generator`` (as JAX splits
        its key); temps and minps are the own slots' (B,) host numbers."""
        seeds = torch.randint(0, 2 ** 62, (len(self.decs),), generator=generator,
                              device=generator.device).tolist()
        outs = []
        for i, (d, seed) in enumerate(zip(self.decs, seeds)):
            sl = slice(i * self.per, (i + 1) * self.per)
            gen = torch.Generator(device=d.device)
            gen.manual_seed(seed)
            outs.append(d._step(d._sampling(gen, temps[sl], minps[sl]))[1])
        with span("serve.readback"):
            return [t for o in outs for t in o.tolist()]
