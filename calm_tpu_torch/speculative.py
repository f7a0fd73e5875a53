"""Speculative decoding with a draft model (the port of
``calm_tpu.speculative``).

A small draft model proposes ``gamma`` tokens with its own decode loop
(``model.decode_loop``: on the card, replays of the draft cache's captured
step), the target scores all of them in ONE forward that returns every
row's logits (``model.verify_once``: on the card, a replay of the target
cache's captured verify), and the longest draft prefix matching the
target's argmaxes is accepted, plus one token from the target's own
logits at the first mismatch. The output is the target's greedy chain:
the acceptance rule only ever emits target argmaxes, so the draft changes
the speed, never the content.

- :func:`speculative_generate`: greedy, the longest matching prefix and
  the target's correction; near the window's edge it falls back to plain
  target steps (``calm_tpu/speculative.py:47-177``).
- ``temperature > 0``: speculative rejection sampling
  (:func:`_speculative_sampled`, ``:180-330``).
- :func:`tree_speculative_generate`: k root-branched draft chains verified
  in one tree-masked forward (``:338-522``).

Cache bookkeeping needs no rewind: rejected draft and target rows sit at
positions the next round writes again, and the kv_len mask hides every row
until its position is reached.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from calm_tpu_torch import model as M
from calm_tpu_torch.engine import Engine, GenStats, kv_cache_bytes
from calm_tpu_torch.sampler import XorshiftRng


def _minp_probs(logits: np.ndarray, temperature: float, minp: float) -> np.ndarray:
    """The engine's sampling distribution as an explicit prob vector:
    min-p cutoff in logit space, temperature softmax over survivors
    (``calm_tpu/speculative.py:36-44``, the host sampler's rule)."""
    m = float(logits.max())
    cutoff = m + np.log(minp) * temperature
    p = np.where(logits >= cutoff,
                 np.exp((logits - m) / temperature, dtype=np.float32), 0.0)
    return p / p.sum(dtype=np.float32)


def _draw(probs: np.ndarray, r: float) -> int:
    """The index where the cumulative sum of ``probs`` passes ``r``."""
    return int(min(np.searchsorted(np.cumsum(probs), r), len(probs) - 1))


class _Run:
    """What the three loops share: the prompt, the emitted text, the ids
    and the perf accounting, as ``calm_tpu/speculative.py`` keeps them."""

    def __init__(self, target: Engine, prompt: str, echo: bool, on_piece):
        tok = self.tok = target.tokenizer
        self.prompt_tokens = tok.encode(prompt, bos=True)
        if not self.prompt_tokens:
            self.prompt_tokens = [tok.bos_id if tok.bos_id >= 0 else 0]
        self.stops = (tok.bos_id, tok.eos_id, tok.eot_id)
        self.on_piece = on_piece
        self.out = bytearray()
        self.ids: list[int] = []
        self.read_bytes = 0
        self.logits_last = None
        self.rounds = self.accepted = self.emitted = 0
        if echo and self.prompt_tokens[0] != tok.bos_id:
            self.emit(tok.decode_piece(tok.bos_id, self.prompt_tokens[0]))
        if target.device.type == "cuda":
            torch.cuda.synchronize(target.device)
        self.start = time.perf_counter()

    def emit(self, piece: bytes):
        self.out.extend(piece)
        if self.on_piece:
            self.on_piece(piece.decode("utf-8", errors="replace"))

    def prefill(self, engines, pos_offset: int, echo: bool) -> int:
        """Every engine prefills the prompt but its last token; returns
        the position of that token."""
        pt = self.prompt_tokens
        if len(pt) <= 1:
            return 0
        for eng in engines:
            eng.prefill_tokens(pt[:-1], pos_offset)
            self.read_bytes += (len(pt) - 1) * eng.n_bandwidth
        if echo:
            for p in range(len(pt) - 1):
                self.emit(self.tok.decode_piece(pt[p], pt[p + 1]))
        return len(pt) - 1

    def take(self, token: int, nxt: int) -> bool:
        """Record ``nxt`` after ``token``; True at a stop token."""
        self.ids.append(nxt)
        if nxt in self.stops:
            return True
        self.emit(self.tok.decode_piece(token, nxt))
        return False

    def stats(self, pos: int) -> GenStats:
        seconds = time.perf_counter() - self.start
        h = M.logits_hash(self.logits_last) if self.logits_last is not None else 0
        st = GenStats(tokens=pos, seconds=seconds, read_bytes=self.read_bytes,
                      logits_hash=h, text=self.out.decode("utf-8", errors="replace"),
                      ids=self.ids)
        st.acceptance = self.accepted / max(self.emitted, 1)
        st.rounds = self.rounds
        return st


def _host(logits: torch.Tensor) -> np.ndarray:
    return logits.float().cpu().numpy()


def speculative_generate(target: Engine, draft: Engine, prompt: str = "",
                         steps: int = 256, *, gamma: int = 4,
                         temperature: float = 0.0, minp: float = 0.1,
                         seed: int = 42, pos_offset: int = 0,
                         echo: bool = False, on_piece=None) -> GenStats:
    """Decode the target, accelerated by the draft
    (``calm_tpu/speculative.py:47-177``). temperature == 0 uses the greedy
    longest-matching-prefix rule (the ids are plain greedy's);
    temperature > 0 uses speculative rejection sampling
    (:func:`_speculative_sampled`). Mirrors ``Engine.generate``'s loop
    contract (stop tokens, perf accounting, hash); the stats also carry
    ``acceptance`` (accepted draft tokens over emitted) and ``rounds``."""
    if temperature > 0.0:
        return _speculative_sampled(target, draft, prompt, steps, gamma=gamma,
                                    temperature=temperature, minp=minp,
                                    seed=seed, pos_offset=pos_offset,
                                    echo=echo, on_piece=on_piece)
    run = _Run(target, prompt, echo, on_piece)
    pos = run.prefill((target, draft), pos_offset, echo)
    token = run.prompt_tokens[-1]
    stopped = False
    # speculation must stay inside the un-rolled window of both models
    horizon = min(target.cfg.seq_len, draft.cfg.seq_len)

    while not stopped and (pos < steps or steps < 0):
        budget = gamma if steps < 0 else max(1, min(gamma, steps - pos))
        if pos + pos_offset + budget + 1 >= horizon:
            # near the window edge: fall back to plain target stepping
            logits = target.step(token, pos + pos_offset)
            draft.step(token, pos + pos_offset)
            run.read_bytes += target.n_bandwidth + draft.n_bandwidth
            run.logits_last = logits
            nxt = int(np.argmax(logits))
            pos += 1
            if run.take(token, nxt):
                break
            token = nxt
            continue

        # 1) the draft proposes `budget` tokens (replays of its step)
        d_toks, draft.cache, _ = M.decode_loop(
            draft.cfg, draft.weights, draft._token(token), pos + pos_offset,
            draft.cache, budget, rolling=False)  # the guard above keeps us below S
        proposal = d_toks[0].tolist()
        run.read_bytes += budget * draft.n_bandwidth

        # 2) the target scores [token] + proposal[:-1] in one forward:
        #    logits[i] is its next-token distribution after position pos+i,
        #    i.e. its verdict on proposal[i]
        t_logits = _host(M.verify_once(target.cfg, target.weights,
                                       [[token] + proposal[:-1]], [pos + pos_offset],
                                       target.cache)[0])            # (budget, V)
        run.read_bytes += target.n_bandwidth + kv_cache_bytes(
            target.cfg, target.kv_bits, pos + pos_offset + budget)

        # 3) accept the longest matching prefix; the target's argmax
        #    replaces the first mismatch
        run.rounds += 1
        emitted = []
        for i in range(budget):
            t_arg = int(np.argmax(t_logits[i]))
            emitted.append(t_arg)
            run.logits_last = t_logits[i]
            if t_arg != proposal[i]:
                break
            run.accepted += 1

        for nxt in emitted:
            pos += 1
            run.emitted += 1
            if run.take(token, nxt):
                stopped = True
                break
            token = nxt
        # the draft cache holds rows of ITS proposal; they differ from the
        # accepted chain only from the mismatch on, which the next round's
        # draft loop writes again (it starts from the corrected token there)
    return run.stats(pos)


def _speculative_sampled(target: Engine, draft: Engine, prompt: str,
                         steps: int, *, gamma: int, temperature: float,
                         minp: float, seed: int, pos_offset: int,
                         echo: bool, on_piece) -> GenStats:
    """Speculative rejection sampling (``calm_tpu/speculative.py:180-330``):
    draft token x is accepted with probability min(1, p(x) / q(x)); a
    rejection resamples from max(p - q, 0); a round whose every draft token
    was accepted takes a bonus token from the target's last row and writes
    the draft row its loop never wrote. The draft draws on the device
    (``decode_loop``'s sampling, a ``torch.Generator`` seeded from
    ``seed``), the accept/reject and resample coins come from
    ``sampler.XorshiftRng(seed)``, as in JAX. JAX's draft draws come from
    ``jax.random``, whose bits a torch generator cannot reproduce: the
    emitted ids differ from JAX's draw for draw, while their distribution is
    the target's, as JAX's is."""
    run = _Run(target, prompt, echo, on_piece)
    rng = XorshiftRng(seed)
    dev = draft.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    sampling = (gen, torch.full((1,), temperature, device=dev),
                torch.full((1,), minp, device=dev))
    pos = run.prefill((target, draft), pos_offset, echo)
    token = run.prompt_tokens[-1]
    stopped = False
    horizon = min(target.cfg.seq_len, draft.cfg.seq_len)

    while not stopped and (pos < steps or steps < 0):
        budget = gamma if steps < 0 else max(1, min(gamma, steps - pos))
        if pos + pos_offset + budget + 2 >= horizon:
            # window edge: a plain target sampling step
            logits = target.step(token, pos + pos_offset)
            draft.step(token, pos + pos_offset)
            run.read_bytes += target.n_bandwidth + draft.n_bandwidth
            run.logits_last = logits
            probs = _minp_probs(logits, temperature, minp)
            nxt = _draw(probs, rng.next_f32() * probs.sum())
            pos += 1
            if run.take(token, nxt):
                break
            token = nxt
            continue

        # 1) the draft samples `budget` tokens from its own distribution;
        #    its logits come back for the q(x) terms
        d_toks, draft.cache, d_logits = M.decode_loop(
            draft.cfg, draft.weights, draft._token(token), pos + pos_offset,
            draft.cache, budget, sampling, rolling=False)
        proposal = d_toks[0].tolist()
        d_logits = _host(d_logits[:, 0])                            # (budget, V)
        run.read_bytes += budget * draft.n_bandwidth

        # 2) the target scores [token] + proposal: logits[i] is p after
        #    position pos+i (i = 0..budget)
        t_logits = _host(M.verify_once(target.cfg, target.weights,
                                       [[token] + proposal], [pos + pos_offset],
                                       target.cache)[0])            # (budget+1, V)
        run.read_bytes += target.n_bandwidth + kv_cache_bytes(
            target.cfg, target.kv_bits, pos + pos_offset + budget)

        # 3) rejection-sample the longest accepted prefix
        run.rounds += 1
        p0 = pos  # the round's start (for the full-accept backfill)
        full_accept = False
        emitted = []
        for i in range(budget):
            p = _minp_probs(t_logits[i], temperature, minp)
            q = _minp_probs(d_logits[i], temperature, minp)
            x = proposal[i]
            run.logits_last = t_logits[i]
            if q[x] > 0 and rng.next_f32() < min(1.0, float(p[x] / q[x])):
                emitted.append(x)
                run.accepted += 1
                continue
            # rejected: resample from the residual max(p - q, 0)
            resid = np.maximum(p - q, 0.0)
            s = resid.sum(dtype=np.float32)
            if s <= 0:
                resid, s = p, p.sum(dtype=np.float32)
            emitted.append(_draw(resid, rng.next_f32() * s))
            break
        else:
            # every draft token accepted: one bonus token from the target's
            # distribution after the proposal
            full_accept = True
            p = _minp_probs(t_logits[budget], temperature, minp)
            run.logits_last = t_logits[budget]
            emitted.append(_draw(p, rng.next_f32() * p.sum()))

        if full_accept:
            # the loop wrote draft rows p0..p0+budget-1 for [token,
            # proposal[:-1]]; after a full accept and the bonus the next
            # round starts at p0+budget+1, so proposal[-1]'s row at
            # p0+budget would stay a hole the draft attends for the rest of
            # the window (acceptance would drop; the output stays exact)
            draft.step(proposal[-1], p0 + pos_offset + budget)
            run.read_bytes += draft.n_bandwidth

        for nxt in emitted:
            pos += 1
            run.emitted += 1
            if run.take(token, nxt):
                stopped = True
                break
            token = nxt
    return run.stats(pos)


# ---------------------------------------------------------------------------
# draft-TREE speculation: k root-branched chains verified in one forward
# ---------------------------------------------------------------------------


def _tree_mask(k: int, m: int) -> np.ndarray:
    """Ancestor-or-self reachability of the root-branched tree
    (``calm_tpu/speculative.py:338-349``): node 0 is the root; lane i holds
    nodes 1 + i*(m-1) + (0..m-2) at depths 1..m-1. (N, N) bool, static per
    (k, m)."""
    n = 1 + k * (m - 1)
    t = np.zeros((n, n), bool)
    t[:, 0] = True  # everyone sees the root
    for i in range(k):
        base = 1 + i * (m - 1)
        for d in range(m - 1):
            t[base + d, base:base + d + 1] = True  # own lane, shallower and self
    return t


def tree_speculative_generate(target: Engine, draft: Engine,
                              prompt: str = "", steps: int = 256, *,
                              k: int = 3, m: int = 5,
                              pos_offset: int = 0, echo: bool = False,
                              on_piece=None) -> GenStats:
    """Greedy draft-tree decoding (``calm_tpu/speculative.py:352-522``): the
    draft proposes its top-k first tokens and rolls a greedy chain of ``m``
    tokens from each. The k lanes ride the batch axis of a local lane
    cache, broadcast once from the draft's after the prompt: one batched
    root step, then one batched chain of m - 1 steps (on the card, replays
    of the lane cache's captured step). The target verifies all 1 + k(m-1)
    nodes in ONE tree-masked forward (``model.verify_once`` with the tree:
    each node attends to the context and its own ancestors, RoPE positions
    follow depth, KV rows land flat), the tree is walked along the target's
    argmaxes, the winning lane's rows move onto the contiguous accepted
    span (``model.cache_move_rows``) and its chain becomes every lane's
    history (``model.cache_bcast_rows``).

    Greedy-exact: the ids are plain greedy's; the tree changes the speed.
    The lane cache is made anew each call, so its step graph is captured
    anew each call (``StepGraph.capture_s`` holds the time); it is not
    kept across calls, as JAX keeps none. The draft Engine's own cache is
    left as the prompt's prefill left it."""
    run = _Run(target, prompt, echo, on_piece)
    pos = run.prefill((target, draft), pos_offset, echo)

    # lanes ride the draft's batch axis: one broadcast copy of the prompt's
    # KV, then every round's k chains run as ONE batched loop
    dcache = M.KVCache(draft.cache.k.repeat_interleave(k, dim=1),
                       draft.cache.v.repeat_interleave(k, dim=1))
    tree = _tree_mask(k, m)
    depth = np.asarray([0] + [d for _ in range(k) for d in range(1, m)], np.int32)
    N = 1 + k * (m - 1)
    token = run.prompt_tokens[-1]
    stopped = False
    horizon = min(target.cfg.seq_len, draft.cfg.seq_len)

    while not stopped and (pos < steps or steps < 0):
        room = steps - pos if steps >= 0 else m
        if pos + pos_offset + max(N, m + 1) + 1 >= horizon or room < m:
            # window edge or tail: plain target stepping
            logits = target.step(token, pos + pos_offset)
            run.read_bytes += target.n_bandwidth
            run.logits_last = logits
            nxt = int(np.argmax(logits))
            pos += 1
            if run.take(token, nxt):
                break
            token = nxt
            continue

        p = pos + pos_offset
        # 1) the draft's root step, batched over lanes (identical inputs):
        #    writes row p in every lane; its logits give the top-k fan-out
        d_log, _ = M.decode_once(draft.cfg, draft.weights, [token] * k, [p] * k,
                                 dcache, False)
        run.read_bytes += draft.n_bandwidth
        firsts = np.argsort(_host(d_log[0]))[-k:][::-1].astype(np.int64)

        # 2) k greedy chains, one batched loop: lane i rolls from firsts[i]
        d_toks, dcache, _ = M.decode_loop(
            draft.cfg, draft.weights, torch.from_numpy(firsts.copy()).to(dcache.k.device),
            p + 1, dcache, m - 1, rolling=False)
        chains = np.concatenate([firsts[:, None], d_toks.cpu().numpy()], axis=1)  # (k, m)
        run.read_bytes += (m - 1) * draft.n_bandwidth

        # 3) one tree-masked target forward over all nodes
        flat = [token] + [int(t) for i in range(k) for t in chains[i, :m - 1]]
        t_logits = _host(M.verify_once(target.cfg, target.weights, [flat], [p],
                                       target.cache, depth, tree)[0])  # (N, V)
        run.read_bytes += target.n_bandwidth + kv_cache_bytes(
            target.cfg, target.kv_bits, p + N)

        # 4) walk the tree along the target's argmaxes (greedy-exact)
        run.rounds += 1
        emitted = []
        a = int(np.argmax(t_logits[0]))
        run.logits_last = t_logits[0]
        emitted.append(a)
        lane = next((i for i in range(k) if int(chains[i, 0]) == a), None)
        if lane is not None:
            run.accepted += 1
            for d in range(1, m):
                node = 1 + lane * (m - 1) + (d - 1)
                a = int(np.argmax(t_logits[node]))
                run.logits_last = t_logits[node]
                emitted.append(a)
                if a != int(chains[lane, d]):
                    break
                run.accepted += 1
        # 5) relocate the winning lane's rows onto the contiguous span and
        #    share its chain history across draft lanes (the next round's
        #    loop must see the accepted context in every lane)
        #
        # INVARIANT (overwrite-before-read): all m-1 lane rows move, even
        # past the accepted span — the stale tail rows are safe only
        # because every later round REWRITES rows >= the new position
        # before anything attends to them (each round writes its full
        # k*(m-1) tree block at the current frontier, and N >= m). A change
        # that lets a round attend beyond its own frontier (variable tree
        # shapes, skipping the verify) must mask or zero the moved tail.
        lane_i = 0 if lane is None else lane
        M.cache_move_rows(target.cache, p + 1 + lane_i * (m - 1), p + 1, m - 1)
        M.cache_bcast_rows(dcache, lane_i, p + 1, m - 1)

        for nxt in emitted:
            pos += 1
            run.emitted += 1
            if run.take(token, nxt):
                stopped = True
                break
            token = nxt
    return run.stats(pos)
