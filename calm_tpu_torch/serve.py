"""Continuous-batching serving loop (the port of ``calm_tpu.serve``).

- B decode slots share one decode step a tick; finished slots take new
  requests mid-flight;
- the KV cache is one dense (L, B, KVH, S, hd) buffer whose slots are
  prefilled in place (``model.prefill_slot``), or with ``page_rows`` the
  paged pool of :class:`calm_tpu_torch.paged.PagedDecoder`;
- free slots decode garbage at their parked position: the batched
  products pay for them anyway, and their rows are masked or overwritten
  on reuse (a paged slot's table row points at the parking page);
- the prefix cache keeps prompt-prefix rows (dense) or pins prompt pages
  (paged) so that a later request with the same prefix prefills only its
  suffix;
- sampling runs on the host per slot (greedy, or min-p with the
  reference's xorshift64* stream per request, bit-compatible with the JAX
  server's) or, with ``device_sampling``, on the device, so that only the
  (B,) ids reach the host each tick;
- on the card a tick replays the cache's captured step of B slots
  (``model.decode_once``): the host copies the tokens and positions in
  and reads the logits or ids out. It keeps the sink rotation only when a
  slot reaches the window's edge, as ``calm_tpu/serve.py:890`` picks
  ``rolling``;
- with a draft model (``draft_path``, or ``draft_engine`` built in
  memory) a tick is a speculative round while every active request is
  greedy (or sampled, with ``spec_sampled``) and away from the window's
  edge (``calm_tpu/serve.py:514-664``): one (B, g) draft loop, one (B,
  g+1) verify of every slot (on the card the target cache's captured
  verify, replayed), acceptance per slot and an adaptive depth g in [1,
  gamma]; plain ticks step the draft's cache beside the target's. Dense
  only, as JAX's.
- a tick is traced (``ops.cost.span``, only while a profiler records) as
  ``calm.serve.tick`` over ``sweep``, ``admit`` (each admission's
  ``tokenize``, ``prefix_copy``, ``calm.model.prefill`` and
  ``prefix_save``), ``step``, ``readback`` and ``sample``, and counted
  (``ops.cost.counters``, always): requests submitted and admitted, their
  queue wait (``Request.admitted_at`` − ``submitted_at``), prompt and
  prefix-hit tokens, ticks and the slots active in them.

Prompts are prefilled at their exact length: the JAX server pads them to
buckets so that XLA compiles once per bucket, which eager PyTorch does not
need.

Several devices (``calm_tpu/serve.py:196-306``):

- ``dp_devices`` with ``page_rows``: one independent paged decoder a
  listed device (:class:`~calm_tpu_torch.paged.PagedGroup`), the slots
  split contiguously over them; one process drives them all. The list may
  repeat a device.
- ``mesh`` and ``plan``: a sharded model, dense (tp/ep/dp: slots over
  dp) or paged (tp/ep). JAX drives a mesh from one controller; here a
  mesh is one process a rank (``parallel.mesh``), so this Server is SPMD.
  **Every rank of the mesh constructs it with the same arguments, gets
  the same ``submit()`` and ``cancel()`` calls between the same ticks,
  and calls ``tick()`` (or ``run_until_drained()``) in lockstep**: each
  tick issues the same collectives on every rank. Each rank loads only
  its shard of the weights (``Engine(lazy_weights=True)`` and
  ``parallel.sharding.load_weights_sharded``). The ranks hold the same
  host state and own every slot: the step's logits are gathered to every
  rank, so each samples every slot with the same streams (on the device,
  with generators seeded alike) and emits the same ids. Deadlines are
  agreed: a request that one rank finds past its ``timeout_s`` ends on
  every rank at the same tick.
- Several hosts (JAX's multi-process mode): when the launcher says a
  host runs ``LOCAL_WORLD_SIZE`` of the ``WORLD_SIZE`` ranks
  (``parallel.mesh.host_layout``), each host admits its own requests into
  its own contiguous slot range (batch / hosts slots) and reads only its
  own slots' results. The ranks of one host are replicas as above; what
  differs across hosts is gathered each tick: the admissions, which every
  rank prefills in the same order (``sharded_prefill_slot`` reduces its
  logits over dp), the tokens and positions, and whether any slot is
  live. ``parallel.mesh.make_multihost_mesh`` puts dp across hosts. Paged
  serving across hosts takes ``dp_devices`` (each host its own group of
  decoders) and no mesh.

Refused, as JAX refuses them: a batch that does not split over dp,
paged serving across hosts without ``dp_devices``, ``dp_devices`` or
device sampling beside a mesh-paged pool, and speculative serving with a
mesh or pages.
"""

from __future__ import annotations

import dataclasses
import sys
import threading
import time
from collections import OrderedDict, deque
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from calm_tpu_torch import model as M
from calm_tpu_torch.engine import Engine
from calm_tpu_torch.ops.cost import count, span
from calm_tpu_torch.paged import PagedDecoder, PagedGroup
from calm_tpu_torch.parallel.mesh import host_layout
from calm_tpu_torch.sampler import Sampler, device_sample

DEAD_PER_TICK = 64  # the most ended requests the ranks agree on in one tick


class QueueFull(Exception):
    """Raised by submit() when the pending queue is at max_pending."""


@dataclasses.dataclass
class Request:
    rid: int
    prompt: str
    max_tokens: int = 128
    temperature: float = 1.0
    minp: float = 0.1
    seed: int = 42
    # called with each decoded text piece, then once with None when the
    # request reaches a terminal state (done, timeout, cancel)
    on_piece: Callable[[str | None], None] | None = None
    timeout_s: float = 0.0  # deadline from submit (0: none)
    # results
    text: str = ""
    done: bool = False
    cancelled: bool = False  # the client went away: freed at the next tick
    timed_out: bool = False
    n_generated: int = 0
    ids: list = dataclasses.field(default_factory=list)  # generated token ids
    cached_prefix: int = 0  # prompt tokens served from the prefix cache
    truncated_prompt: int = 0  # prompt tokens dropped to fit the window
    out_of_pages: bool = False  # paged: finished early under pool pressure
    submitted_at: float = 0.0
    admitted_at: float = 0.0  # taken off the queue into a slot (perf_counter)
    first_token_at: float = 0.0
    finished_at: float = 0.0
    # set once, at the terminal state; waiters block here
    done_event: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False, compare=False)


class PrefixCache:
    """LRU store of prompt-prefix KV (``calm_tpu/serve.py:98-153``).
    Entries are keyed by the token prefix from position 0 (RoPE'd keys are
    position-absolute, so a block serves any prompt that starts with those
    tokens) and hold (k, v) row blocks on the device, or in paged mode the
    pinned page list, whose eviction calls ``on_evict``."""

    GRAIN = 16  # saved prefixes are cut to a multiple of this

    def __init__(self, capacity_tokens: int = 16384, on_evict=None):
        self.capacity = capacity_tokens
        self.tokens = 0
        self.hits = 0
        self.hit_tokens = 0
        self._entries: OrderedDict[tuple, tuple] = OrderedDict()
        # length -> stored keys of that length: a match probes one hash per
        # distinct stored length
        self._lengths: dict[int, set] = {}
        self._on_evict = on_evict

    def match(self, toks) -> tuple[int, tuple | None]:
        """Longest stored prefix of ``toks``; marks the entry most recent."""
        for n in sorted(self._lengths, reverse=True):
            if n > len(toks):
                continue
            key = tuple(toks[:n])
            if key in self._lengths[n]:
                self._entries.move_to_end(key)
                self.hits += 1
                self.hit_tokens += n
                return n, self._entries[key]
        return 0, None

    def put(self, toks, *payload):
        key = tuple(toks)
        if key in self._entries:
            return
        self._entries[key] = payload if len(payload) != 1 else payload[0]
        self._lengths.setdefault(len(key), set()).add(key)
        self.tokens += len(key)
        while self.tokens > self.capacity and len(self._entries) > 1:
            old, pay = self._entries.popitem(last=False)
            self.tokens -= len(old)
            bucket = self._lengths.get(len(old))
            if bucket is not None:
                bucket.discard(old)
                if not bucket:
                    del self._lengths[len(old)]
            if self._on_evict is not None:
                self._on_evict(pay)


@dataclasses.dataclass
class _Slot:
    active: bool = False
    req: Request | None = None
    pos: int = 0
    token: int = 0
    sampler: Sampler | None = None
    out: bytearray = dataclasses.field(default_factory=bytearray)
    _save_prefix: list | None = None  # prefix save, after the admission prefill


class Server:
    """Batched multi-request decode on one Engine.

    ``device_sampling=True`` samples min-p on the device
    (``sampler.device_sample``): only (B,) ids cross to the host each tick.
    ``seed`` then seeds the server's generator instead of a per-request
    xorshift stream; leave it off for draws bit-compatible with the JAX
    server's host sampling. ``engine`` hands the server an Engine built
    already (one made in memory); ``device`` selects the CPU for tests.

    ``draft_path`` serves speculatively with that draft model (made as
    JAX's: the target's context, ``kv_dtype`` and slot count), proposing
    up to ``gamma`` tokens a round; ``spec_sampled`` rejection-samples the
    sampled requests inside rounds (distributionally exact; texts differ
    from the plain server's by design). ``draft_engine`` hands in a draft
    Engine built already, as ``engine`` does for the target.

    ``mesh``/``plan`` shard the model, ``dp_devices`` spreads paged slots
    over devices: the module's docstring says what each rank's caller
    must do."""

    def __init__(self, path: str | None = None, batch: int = 4, context: int = 0,
                 kv_dtype: str | None = None, device_sampling: bool = False,
                 seed: int = 42, mesh=None, plan=None,
                 prefix_cache_tokens: int = 0, page_rows: int = 0,
                 pool_pages: int = 0, max_pending: int = 0, dp_devices=None,
                 draft_path: str | None = None, gamma: int = 4,
                 spec_sampled: bool = False, device=None,
                 engine: Engine | None = None, draft_engine: Engine | None = None):
        speculative = draft_path is not None or draft_engine is not None
        self._sharded = mesh is not None
        if speculative and (page_rows or self._sharded):
            raise ValueError("speculative serving is dense single-device, as "
                             "calm_tpu's (calm_tpu/serve.py:328-329)")
        if self._sharded and (plan is None or engine is not None):
            raise ValueError("a sharded server takes a plan and a container path: "
                             "each rank loads only its shard")
        if self._sharded and plan.dp is not None and batch % mesh.axis_size(plan.dp):
            raise ValueError(f"batch {batch} does not split over dp="
                             f"{mesh.axis_size(plan.dp)} (calm_tpu/serve.py:214-216)")
        self._mesh, self._plan = mesh, plan
        self._world = mesh.world_group if self._sharded else None
        # hosts: each admits into and reads its own slot range; the ranks
        # of one host are replicas
        self._nproc, self._pid = host_layout(self._world)
        self._spmd = self._sharded or self._nproc > 1
        if self._nproc > 1 and page_rows and not dp_devices:
            raise ValueError("paged serving across hosts needs dp_devices "
                             "(calm_tpu/serve.py:249-250)")
        if self._sharded and page_rows and (dp_devices is not None or self._nproc > 1
                                            or device_sampling):
            raise ValueError("a mesh-paged pool is tp/ep-sharded on one host and samples "
                             "on the host (calm_tpu/serve.py:254-256)")
        if dp_devices is not None and device is None and engine is None:
            device = dp_devices[0]
        if engine is None:
            # a paged or sharded server keeps no dense cache of its own
            # size here: a one-slot engine, its cache replaced below
            engine = Engine(path, context=context, kv_dtype=kv_dtype,
                            device=mesh.device if self._sharded else device,
                            batch=1 if page_rows or self._sharded else batch,
                            lazy_weights=self._sharded)
        elif not page_rows and engine.batch != batch:
            raise ValueError(f"the engine has {engine.batch} slots, not {batch}")
        self.engine = engine
        self.batch = batch
        eng = engine
        # the own slot range: every slot on one host, batch / hosts each
        per = batch // self._nproc
        if per * self._nproc != batch:
            raise ValueError(f"batch {batch} does not split over {self._nproc} hosts")
        self._own_lo, self._own_hi = self._pid * per, (self._pid + 1) * per
        if self._sharded:
            from calm_tpu_torch.parallel.sharding import (load_weights_sharded, local_cache,
                                                          sharded_decode_step,
                                                          sharded_prefill_slot)
            eng.weights = load_weights_sharded(eng.tf, eng.cfg, mesh, plan)
            if not page_rows:
                eng.cache = local_cache(eng.cfg, batch, eng._kv_torch, mesh, plan)
                self._decode_fn = sharded_decode_step(eng.cfg, mesh, plan)
                self._prefill_slot_fn = sharded_prefill_slot(eng.cfg, mesh, plan)
        self._paged = None
        self._paged_group = False
        if page_rows:
            own = self._own_hi - self._own_lo
            if self._sharded:
                if not pool_pages:
                    pool_pages = batch * (eng.cfg.seq_len // page_rows)
                self._paged = PagedDecoder(eng.cfg, eng.weights, pool_pages, page_rows,
                                           eng._kv_torch, batch, mesh=mesh, plan=plan)
            elif dp_devices is not None and (len(dp_devices) > 1 or self._nproc > 1):
                if own % len(dp_devices):
                    raise ValueError(f"{own} slots do not split over {len(dp_devices)} "
                                     "dp devices")
                per = own // len(dp_devices)
                if not pool_pages:  # a pool a decoder
                    pool_pages = per * (eng.cfg.seq_len // page_rows)
                self._paged = PagedGroup(eng.cfg, eng.weights, pool_pages, page_rows,
                                         eng._kv_torch, per, dp_devices, own_lo=self._own_lo)
                self._paged_group = True
            else:
                if not pool_pages:
                    pool_pages = batch * (eng.cfg.seq_len // page_rows)
                self._paged = PagedDecoder(eng.cfg, eng.weights, pool_pages, page_rows,
                                           eng._kv_torch, batch,
                                           device=dp_devices[0] if dp_devices else None)
            eng.cache = None  # the pool replaces the dense cache
        # paged mode shares pages: a hit maps pinned pool pages, a save pins
        # the slot's prompt pages in place, an eviction unpins them. A
        # group keeps one cache a decoder (page ids are pool-local); a
        # dense sharded cache keeps none (calm_tpu/serve.py:282-306)
        self.prefix_cache = None
        self._prefix_caches = None
        if prefix_cache_tokens and (not self._sharded or self._paged is not None):
            if self._paged_group:
                self._prefix_caches = [PrefixCache(prefix_cache_tokens, on_evict=d.unpin_pages)
                                       for d in self._paged.decs]
            else:
                self.prefix_cache = PrefixCache(
                    prefix_cache_tokens,
                    on_evict=None if self._paged is None else self._paged.unpin_pages)
        # speculative continuous batching (calm_tpu/serve.py:306-336): the
        # draft proposes g tokens a slot in one batched loop, the target
        # verifies every slot's chain in one (B, g+1) forward, each slot
        # emits its longest matching prefix and the target's correction
        self._draft = None
        self.spec_sampled = spec_sampled
        self.gamma = gamma          # the most tokens a round drafts
        self._gamma_now = gamma     # adaptive: shrinks at low acceptance
        self.spec_rounds = self.spec_accepted = self.spec_emitted = 0
        if speculative:
            self._draft = draft_engine or Engine(draft_path, context=eng.cfg.seq_len,
                                                 kv_dtype=kv_dtype, batch=batch,
                                                 device=eng.device)
            if self._draft.batch != batch:
                raise ValueError(f"the draft has {self._draft.batch} slots, not {batch}")
            if self._draft.cfg.vocab_size != eng.cfg.vocab_size:
                raise ValueError("draft and target must share the vocabulary")
            self._spec_gen = torch.Generator(device=eng.device)
            self._spec_gen.manual_seed(seed ^ 0x5BD1)
        self.slots = [_Slot() for _ in range(batch)]
        self.pending: deque[Request] = deque()
        self.max_pending = max_pending  # 0: unbounded
        self.rejected = 0  # submit() calls bounced on a full queue
        self._next_rid = 0
        # parked decode state per slot
        self._tokens = np.zeros(batch, np.int64)
        self._pos = np.zeros(batch, np.int64)
        self.device_sampling = device_sampling
        self._temps = np.zeros(batch, np.float32)  # parked slots: greedy
        self._minps = np.ones(batch, np.float32)
        self._sampling_dev = None  # device copies of temps/minps; None: stale
        if device_sampling:
            # seeded alike on every rank: the ranks draw the same ids
            self._gen = torch.Generator(device=eng.device)
            self._gen.manual_seed(seed)
        self._last_tick_at = time.monotonic()  # watchdog liveness stamp
        self._wd_thread = None

    # -- client api ---------------------------------------------------------

    def submit(self, prompt: str, **kw) -> Request:
        if self.max_pending and len(self.pending) >= self.max_pending:
            self.rejected += 1
            raise QueueFull(f"pending queue full ({self.max_pending})")
        req = Request(rid=self._next_rid, prompt=prompt, **kw)
        req.submitted_at = time.perf_counter()
        self._next_rid += 1
        self.pending.append(req)
        count("serve.submitted")
        return req

    def cancel(self, req: Request):
        """The client went away: a pending request ends now; an active one
        is swept (its slot freed) at the start of the next tick."""
        req.cancelled = True
        if not req.done and any(r is req for r in self.pending):
            self.pending = deque(r for r in self.pending if r is not req)
            self._finish(req, None, time.perf_counter())

    def _set_sampling(self, b: int, temperature: float, minp: float):
        self._temps[b] = temperature
        self._minps[b] = minp
        self._sampling_dev = None

    def _own(self):
        """The own slots: (index, slot) of the host's range."""
        return ((b, self.slots[b]) for b in range(self._own_lo, self._own_hi))

    def _busy(self) -> bool:
        return bool(self.pending) or any(s.active for _, s in self._own())

    def _finish(self, req: Request, b: int | None, now: float, *,
                timed_out: bool = False, out_of_pages: bool = False):
        """The one terminal path: park the slot, flag the request, fire the
        on_piece(None) sentinel, set the done_event."""
        if b is not None:
            slot = self.slots[b]
            req.text = slot.out.decode("utf-8", errors="replace")
            slot.active = False
            slot.req = None
            self._set_sampling(b, 0.0, 1.0)  # park greedy
            if self._paged is not None:
                self._paged.release(b)  # pages back to the pool
        req.timed_out = timed_out
        req.out_of_pages = out_of_pages
        req.done = True
        req.finished_at = now
        if req.on_piece:
            req.on_piece(None)
        req.done_event.set()

    def _sweep(self):
        """Free slots whose request was cancelled or passed its deadline,
        and drop dead pending requests, before admission. Under SPMD the
        ranks agree first: a request ends on every rank of its host when
        one of them finds it dead (by its id, which the replicas share)."""
        now = time.perf_counter()

        def late(req):
            return req.timeout_s > 0 and now - req.submitted_at >= req.timeout_s
        live_reqs = list(self.pending) + [s.req for _, s in self._own() if s.active]
        ended = {r.rid for r in live_reqs if r.cancelled or late(r)}
        if self._spmd:
            ended = self._agree_ended(sorted(ended)[:DEAD_PER_TICK])

        def finish(req, b):  # ended and not cancelled: late on some rank
            self._finish(req, b, now, timed_out=late(req) or not req.cancelled)
        live = deque()
        for req in self.pending:
            if req.rid in ended:
                finish(req, None)
            else:
                live.append(req)
        self.pending = live
        for b, slot in self._own():
            if slot.active and slot.req.rid in ended:
                finish(slot.req, b)

    # -- SPMD exchanges ---------------------------------------------------------

    def _gather(self, row: np.ndarray) -> np.ndarray:
        """Every rank's ``row`` (int64, the same length on every rank) over
        the server's ranks: (ranks, n). One all-gather, on the rank's
        device (gloo and NCCL both take it there)."""
        t = torch.as_tensor(np.ascontiguousarray(row, np.int64)).to(self.engine.device)
        n = dist.get_world_size(self._world)
        out = t.new_empty(n * t.numel())
        dist.all_gather_into_tensor(out, t, group=self._world)
        return out.cpu().numpy().reshape(n, -1)

    def _hosts(self, rows: np.ndarray) -> np.ndarray:
        """One row a host from a gather: its first rank's (its replicas
        hold the same)."""
        return rows[::rows.shape[0] // self._nproc]

    def _agree_ended(self, rids: list[int]) -> set[int]:
        """The ids some rank of this host found dead this tick."""
        row = np.full(1 + DEAD_PER_TICK, -1, np.int64)
        row[0] = self._pid
        row[1:1 + len(rids)] = rids
        rows = self._gather(row)
        mine = rows[rows[:, 0] == self._pid, 1:]
        return {int(r) for r in mine.reshape(-1) if r >= 0}

    def _any_host(self, flag: bool) -> bool:
        """``flag`` of any host (multi-host), else this host's own."""
        if self._nproc == 1:
            return flag
        return bool(self._gather(np.array([flag], np.int64))[:, 0].any())

    def _merge_admissions(self, local):
        """One host: its own admissions. Several hosts: every host's, in
        host then slot order, so every rank runs the same prefills
        (``calm_tpu/serve.py:779-804``)."""
        if self._nproc == 1:
            return local
        S = self.engine.cfg.seq_len
        cap = self._own_hi - self._own_lo
        buf = np.full((cap, 3 + S), -1, np.int64)
        for i, (b, suffix, hit) in enumerate(local):
            buf[i, :3] = (b, len(suffix), hit)
            buf[i, 3:3 + len(suffix)] = suffix
        merged = []
        for host in self._hosts(self._gather(buf.reshape(-1))).reshape(self._nproc, cap, -1):
            merged += [(int(e[0]), [int(t) for t in e[3:3 + e[1]]], int(e[2]))
                       for e in host if e[0] >= 0]
        return merged

    def _global_state(self, active: bool):
        """(any slot live on any host, tokens (B,), positions (B,)): this
        host's own, or with several hosts each host's own rows assembled
        (``calm_tpu/serve.py:806-814``, ``:847-852``)."""
        if self._nproc == 1:
            return active, self._tokens, self._pos
        lo, hi = self._own_lo, self._own_hi
        rows = self._hosts(self._gather(np.concatenate(
            [[active], self._tokens[lo:hi], self._pos[lo:hi]])))
        per = hi - lo
        return (bool(rows[:, 0].any()), rows[:, 1:1 + per].reshape(-1),
                rows[:, 1 + per:].reshape(-1))

    # -- liveness watchdog ----------------------------------------------------

    def watchdog_start(self, stall_s: float = 60.0,
                       on_stall: Callable[[float], None] | None = None,
                       poll_s: float | None = None):
        """Start a liveness watchdog: while requests are in flight and no
        tick() has completed within ``stall_s``, ``on_stall(age_seconds)``
        fires (default: a line on stderr), then re-arms. Idempotent; stop
        with watchdog_stop()."""
        if self._wd_thread is not None:
            return
        self._wd_stop = threading.Event()
        self._wd_fired = 0

        def _default(age: float):
            print(f"# watchdog: serving loop stalled for {age:.1f}s "
                  f"({sum(1 for s in self.slots if s.active)} active slots, "
                  f"{len(self.pending)} pending)", file=sys.stderr)

        cb = on_stall or _default
        poll = poll_s if poll_s is not None else max(stall_s / 4, 0.01)

        def _loop():
            while not self._wd_stop.wait(poll):
                if not self._busy():
                    continue
                age = time.monotonic() - self._last_tick_at
                if age >= stall_s:
                    self._wd_fired += 1
                    try:
                        cb(age)
                    except Exception:
                        pass
                    self._last_tick_at = time.monotonic()  # re-arm

        self._last_tick_at = time.monotonic()
        self._wd_thread = threading.Thread(target=_loop, daemon=True,
                                           name="calm-serve-watchdog")
        self._wd_thread.start()

    def watchdog_stop(self):
        if self._wd_thread is not None:
            self._wd_stop.set()
            self._wd_thread.join(timeout=5)
            self._wd_thread = None

    def run_until_drained(self, max_ticks: int | None = None):
        """Tick until no host has a pending request or a live slot (every
        rank calls it, in lockstep)."""
        ticks = 0
        while self._any_host(self._busy()):
            self.tick()
            ticks += 1
            if max_ticks is not None and ticks >= max_ticks:
                break

    # -- scheduler ----------------------------------------------------------

    def _slot_prefix_cache(self, b: int):
        """The prefix cache that can serve slot b: a group keeps one a
        decoder."""
        if self._prefix_caches is not None:
            return self._prefix_caches[self._paged.shard_of(b)]
        return self.prefix_cache

    def _admit(self):
        eng = self.engine
        S = eng.cfg.seq_len
        admissions: list[tuple[int, list[int], int]] = []
        draft_pre: list[tuple[int, list[int]]] = []
        for b, slot in self._own():
            if slot.active or not self.pending:
                continue
            req = self.pending.popleft()
            req.admitted_at = time.perf_counter()
            with span("serve.tokenize"):
                toks = eng.tokenizer.encode(req.prompt, bos=True)
            if not toks:
                toks = [max(eng.tokenizer.bos_id, 0)]
            if len(toks) > S - 1:
                # clamp absurd prompts to the window minus generation room
                req.truncated_prompt = len(toks) - (S - 1)
                toks = toks[:S - 1]
            pre = toks[:-1]

            if self._paged is not None:
                with span("serve.prefix_copy"):
                    pc = self._slot_prefix_cache(b)
                    hit, pages = pc.match(pre) if pc is not None else (0, ())
                    if not self._paged.admit(b, toks, shared_pages=pages or (),
                                             hit_rows=hit):
                        self.pending.appendleft(req)  # pool full: retry later
                        break
                    req.cached_prefix = min(hit, len(pre))
                    if pc is not None:  # pin the full prompt pages in place
                        pr = self._paged.page_rows
                        key = tuple(pre[:len(pre) // pr * pr])
                        if key and key not in pc._entries:
                            _, pinned = self._paged.pin_prompt(b, len(key))
                            if pinned:
                                pc.put(key, pinned)
            elif pre:
                hit = 0
                if self.prefix_cache is not None:
                    with span("serve.prefix_copy"):
                        hit, kv = self.prefix_cache.match(pre)
                        if hit:
                            # the cached rows go in before the suffix
                            # prefill, which attends them
                            eng.cache.k[:, b:b + 1, :, :hit] = kv[0]
                            eng.cache.v[:, b:b + 1, :, :hit] = kv[1]
                    slot._save_prefix = pre  # saved after the prefill below
                req.cached_prefix = hit
                if pre[hit:]:
                    admissions.append((b, pre[hit:], hit))
                if self._draft is not None:
                    # the draft has no prefix cache: it prefills the whole
                    # prompt into its own slot
                    draft_pre.append((b, pre))

            count("serve.admitted")
            count("serve.queue_wait_s", req.admitted_at - req.submitted_at)
            count("serve.prompt_tokens", len(pre))
            count("serve.prefix_hit_tokens", req.cached_prefix)
            slot.active = True
            slot.req = req
            slot.sampler = Sampler(eng.cfg.vocab_size, req.seed,
                                   req.temperature, req.minp)
            self._set_sampling(b, req.temperature, req.minp)
            slot.out = bytearray()
            slot.token = toks[-1]
            slot.pos = len(toks) - 1
            self._tokens[b] = slot.token
            self._pos[b] = slot.pos

        if self._sharded:
            # every rank prefills every admission of every host, in order
            # (a mesh-paged pool admitted its own above: none here)
            for b, suffix, _ in self._merge_admissions(admissions):
                self._prefill_slot_fn(eng.weights, torch.tensor([suffix]), len(suffix), b,
                                      eng.cache)
        else:
            for b, suffix, hit in admissions:
                M.prefill_slot(eng.cfg, eng.weights,
                               torch.tensor([suffix], dtype=torch.int64, device=eng.device),
                               b, eng.cache, pos0=hit)
        for b, pre in draft_pre:
            d = self._draft
            M.prefill_slot(d.cfg, d.weights,
                           torch.tensor([pre], dtype=torch.int64, device=d.device),
                           b, d.cache)

        if self.prefix_cache is not None and self._paged is None:
            for b, slot in self._own():
                pre, slot._save_prefix = slot._save_prefix, None
                if pre is None:
                    continue
                n = len(pre) // PrefixCache.GRAIN * PrefixCache.GRAIN
                key = tuple(pre[:n])
                if n and key not in self.prefix_cache._entries:
                    with span("serve.prefix_save"):
                        self.prefix_cache.put(key, eng.cache.k[:, b:b + 1, :, :n].clone(),
                                              eng.cache.v[:, b:b + 1, :, :n].clone())

    def tick(self):
        """One scheduler tick: sweep, admit, one decode step for all. Under
        a mesh or several hosts every rank calls it in lockstep."""
        with span("serve.tick"):
            self._tick()
        # stamped after a tick that returned only: a loop that retries a
        # raising tick must look stalled to the watchdog
        self._last_tick_at = time.monotonic()

    def _sampling_tensors(self):
        if self._sampling_dev is None:
            dev = self.engine.device
            self._sampling_dev = (M.upload(self._temps, dev, torch.float32),
                                  M.upload(self._minps, dev, torch.float32))
        return self._sampling_dev

    def _tick(self):
        count("serve.ticks")
        with span("serve.sweep"):
            self._sweep()
        with span("serve.admit"):
            self._admit()
        lo, hi = self._own_lo, self._own_hi
        live = sum(s.active for _, s in self._own())
        count("serve.slot_ticks", live)
        active, tokens, pos = self._global_state(live > 0)
        if not active:
            return
        eng = self.engine
        sampled = logits = None
        if self._paged is not None:
            now0 = time.perf_counter()
            for b, slot in self._own():
                if not slot.active:
                    continue
                self._paged.set_token(b, slot.token)
                if not self._paged.ensure_capacity(b):
                    # pool pressure: finish this request with what it has
                    # (flagged) instead of stalling the whole batch
                    self._finish(slot.req, b, now0, out_of_pages=True)
            # a mesh-paged pool's ranks hold the same slots: they return
            # here together
            if not any(s.active for _, s in self._own()):
                return
            # the own slots' rows: a group returns its own decoders', a
            # single decoder's batch is the own range
            # the decoders read their results back inside (serve.readback)
            with span("serve.step"):
                if self.device_sampling:
                    sampled = (self._paged.step_sampled(self._gen, self._temps[lo:hi],
                                                        self._minps[lo:hi])
                               if self._paged_group else
                               self._paged.step_sampled(self._gen,
                                                        *self._sampling_tensors()))
                else:
                    logits = self._paged.step()
        elif self._sharded:
            # eager: the step's collectives go through torch.distributed;
            # its logits are gathered to every rank
            with span("serve.step"):
                out, _ = self._decode_fn(eng.weights, torch.as_tensor(tokens),
                                         torch.as_tensor(pos), eng.cache)
                if self.device_sampling:
                    out = device_sample(out, self._gen, *self._sampling_tensors())
            with span("serve.readback"):
                if self.device_sampling:
                    sampled = out.tolist()[lo:hi]
                else:
                    logits = out.float().cpu().numpy()[lo:hi]
        elif self._draft is not None and self._spec_ready():
            self._tick_speculative()
            return
        else:
            rolling = bool(np.any(self._pos + 1 >= eng.cfg.seq_len))
            with span("serve.step"):
                out, nxt = M.decode_once(
                    eng.cfg, eng.weights, self._tokens, self._pos, eng.cache, rolling,
                    sampling=((self._gen,) + self._sampling_tensors()
                              if self.device_sampling else None))
                if self._draft is not None:
                    # the draft's cache steps beside the target's through
                    # plain ticks (a sampled request or the window's edge
                    # stops the rounds, not the draft); the rolling
                    # mechanics follow pos, so both caches stay consistent
                    d = self._draft
                    M.decode_once(d.cfg, d.weights, self._tokens, self._pos, d.cache,
                                  rolling)
            with span("serve.readback"):
                if self.device_sampling:
                    sampled = nxt.tolist()
                else:
                    logits = out.float().cpu().numpy()
        with span("serve.sample"):
            self._emit(sampled, logits)

    def _emit(self, sampled, logits):
        """Each own active slot's next token (``sampled``, or drawn from its
        row of ``logits`` on the host), its text piece, and its end."""
        lo = self._own_lo
        tok = self.engine.tokenizer
        now = time.perf_counter()
        for b, slot in self._own():
            if not slot.active:
                continue
            req = slot.req
            nxt = (int(sampled[b - lo]) if sampled is not None
                   else slot.sampler.sample(logits[b - lo]))
            if req.n_generated == 0:
                req.first_token_at = now
            slot.pos += 1
            req.n_generated += 1
            req.ids.append(nxt)
            if (nxt in (tok.bos_id, tok.eos_id, tok.eot_id)
                    or req.n_generated >= req.max_tokens):
                self._finish(req, b, now)
                continue
            piece = tok.decode_piece(slot.token, nxt)
            slot.out += piece
            if req.on_piece:
                req.on_piece(piece.decode("utf-8", errors="replace"))
            slot.token = nxt
            self._tokens[b] = nxt
            self._pos[b] = slot.pos

    # -- speculative rounds ---------------------------------------------------

    def _spec_ready(self) -> bool:
        """Speculate this tick? Every active request must be greedy, or
        sampled with ``spec_sampled`` on, and far enough from the window's
        edge for a full round and the bonus row (``calm_tpu/serve.py
        :514-528``)."""
        S = self.engine.cfg.seq_len
        act = [s for s in self.slots if s.active]
        if not act:
            return False
        for s in act:
            if s.req.temperature != 0.0 and not self.spec_sampled:
                return False
            if s.pos + self._gamma_now + 2 >= S:
                return False
        return True

    def _tick_speculative(self):
        """One speculative round for the whole batch (``calm_tpu/serve.py
        :530-664``): a (B, g) draft loop, ONE (B, g+1) target verify,
        acceptance per slot on the host.

        Per slot the rule is greedy (the longest argmax-matching prefix and
        the target's correction: only target argmaxes are emitted) or, for
        sampled requests under ``spec_sampled``, rejection sampling with the
        slot's own xorshift stream. A fully accepting slot takes a bonus
        token from verify row g, and the draft writes the row its loop never
        wrote. Every slot is verified, parked ones too: a parked slot's
        start is clamped so that its g+1 rows stay in the window, as JAX's
        ``dynamic_update_slice`` clamps its write (its rows and logits are
        never read). Cache rows past a slot's stop are masked and written
        again later."""
        eng, draft, g = self.engine, self._draft, self._gamma_now
        S = eng.cfg.seq_len
        pos_before = self._pos.copy()
        tokens = M.upload(self._tokens, draft.device, torch.int64)
        sampled_round = any(s.active and s.req.temperature > 0.0 for s in self.slots)
        # 1) the draft proposes g tokens a slot (replays of its step):
        #    argmaxes, or per-slot min-p draws (parked and greedy slots have
        #    temperature 0: the argmax) with each step's logits kept for q
        with span("serve.step"):
            d_toks, draft.cache, d_logits = M.decode_loop(
                draft.cfg, draft.weights, tokens, self._pos.tolist(), draft.cache, g,
                ((self._spec_gen,) + self._sampling_tensors()) if sampled_round else None,
                rolling=False)
        with span("serve.readback"):
            d_logits = d_logits.float().cpu().numpy() if sampled_round else None  # (g, B, V)
            proposal = d_toks.cpu().numpy()                                     # (B, g)
        # 2) the target scores every slot's chain in one forward: row i
        #    judges proposal[i]; row g is the bonus distribution
        verify = np.concatenate([self._tokens[:, None], proposal], axis=1)
        starts = np.minimum(self._pos, S - (g + 1)).tolist()
        with span("serve.step"):
            t_dev = M.verify_once(eng.cfg, eng.weights, verify, starts, eng.cache)
        with span("serve.readback"):
            t_np = t_dev.float().cpu().numpy()                              # (B, g+1, V)
        # 3) acceptance per slot
        with span("serve.sample"):
            full_accept = self._accept(proposal, t_np, d_logits, g)
        # 4) the draft rows the loop never wrote: a fully accepting slot's
        #    proposal[-1] row at p0+g would stay a hole; the other slots
        #    write their current token at its own position again, which the
        #    next round writes the same
        if full_accept.any():
            bf_tok = np.where(full_accept, proposal[:, -1], self._tokens)
            bf_pos = np.where(full_accept, pos_before + g, self._pos)
            with span("serve.step"):
                M.decode_once(draft.cfg, draft.weights, bf_tok.tolist(), bf_pos.tolist(),
                              draft.cache, False)

    def _accept(self, proposal, t_np, d_logits, g: int) -> np.ndarray:
        """A round's acceptance per slot: each slot's tokens emitted, the
        draft's depth adapted; returns which slots accepted all g."""
        from calm_tpu_torch.speculative import _draw, _minp_probs

        tok = self.engine.tokenizer
        t_args = t_np.argmax(-1)
        now = time.perf_counter()
        self.spec_rounds += 1
        round_match = round_seen = 0
        full_accept = np.zeros(self.batch, bool)
        for b, slot in enumerate(self.slots):
            if not slot.active:
                continue
            req = slot.req
            emitted: list[int] = []
            n_match = 0
            if req.temperature == 0.0:
                for i in range(g):
                    nxt = int(t_args[b, i])
                    emitted.append(nxt)
                    if nxt != int(proposal[b, i]):
                        break
                    n_match += 1
                else:
                    emitted.append(int(t_args[b, g]))  # bonus
            else:
                rng = slot.sampler.rng
                for i in range(g):
                    p = _minp_probs(t_np[b, i], req.temperature, req.minp)
                    q = _minp_probs(d_logits[i, b], req.temperature, req.minp)
                    x = int(proposal[b, i])
                    if q[x] > 0 and rng.next_f32() < min(1.0, float(p[x] / q[x])):
                        emitted.append(x)
                        n_match += 1
                        continue
                    resid = np.maximum(p - q, 0.0)
                    s = resid.sum(dtype=np.float32)
                    if s <= 0:
                        resid, s = p, p.sum(dtype=np.float32)
                    emitted.append(_draw(resid, rng.next_f32() * s))
                    break
                else:
                    p = _minp_probs(t_np[b, g], req.temperature, req.minp)
                    emitted.append(_draw(p, rng.next_f32() * p.sum()))
            full_accept[b] = n_match == g
            self.spec_accepted += n_match
            self.spec_emitted += min(len(emitted), g)
            round_match += n_match
            round_seen += min(len(emitted), g)
            for nxt in emitted:
                if req.n_generated == 0:
                    req.first_token_at = now
                slot.pos += 1
                req.n_generated += 1
                req.ids.append(nxt)
                if (nxt in (tok.bos_id, tok.eos_id, tok.eot_id)
                        or req.n_generated >= req.max_tokens):
                    self._finish(req, b, now)
                    break
                piece = tok.decode_piece(slot.token, nxt)
                slot.out += piece
                if req.on_piece:
                    req.on_piece(piece.decode("utf-8", errors="replace"))
                slot.token = nxt
                self._tokens[b] = nxt
                self._pos[b] = slot.pos
        # the draft's depth follows the round's acceptance, within [1, gamma]
        rate = round_match / max(round_seen, 1)
        if rate >= 0.8:
            self._gamma_now = min(self.gamma, self._gamma_now + 1)
        elif rate < 0.4:
            self._gamma_now = max(1, self._gamma_now - 1)
        return full_accept
