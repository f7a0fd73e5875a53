"""The compiled decode step and verify forward: each captured as a CUDA
graph and replayed (the port of ``calm_tpu``'s jitted ``decode_step``,
``decode_scan`` and ``decode_scan_sampled``, ``calm_tpu/model.py
:1428-1455``, ``:1500-1522``, ``:1573-1575``, and of its jitted
``prefill`` with ``logits_mode="all"`` and ``tree_verify``, ``:1576-1583``,
as speculative decoding runs them).

An eager step issues a few hundred launches from Python a token; the
card then waits on the host (PERF.md §5). A :class:`StepGraph` captures
the step once and replays it: every launch of the step, the choice of the
next token and the advance of the position, with no host work between
replays.

- Static inputs: token (B,) int64, pos (B,) int32, the page table when
  paged (the caller's buffer, updated in place), and when sampled the
  uniform noise (B, V) and per-slot temperature and min-p (B,).
- The captured body (:meth:`StepGraph.body`) runs the step, picks the
  next token (argmax, or ``sampler.device_sample`` on the static noise),
  writes it into the token input and adds 1 to pos, so N replays decode N
  tokens. The noise is drawn eagerly before each replay from the caller's
  generator, so replayed draws equal the eager step's bit for bit.
- Capture: one eager warm-up on a side stream first (it builds the
  kernels, sets their attributes and sizes their buffers; nothing of that
  may happen under capture), then the capture. The cache rows the warm-up
  wrote (each layer's kv_pos row, and the sinks under ``rolling``, whose
  rotation is not idempotent) are restored from a snapshot, so the cache
  is bit-identical afterwards.
- Launch counts: the wrappers count launches in Python, which a replay
  never runs. The counts a capture added are taken back and added again
  on every replay; :attr:`StepGraph.replays` counts replays.

A :class:`VerifyGraph` captures a static-shape (B, T) forward that
returns every row's logits: the speculative verify (``model.verify_once``).
Its static inputs are tokens (B, T) int64 and pos0 (B,) int32, and for a
tree the nodes' depth (T,) int32 and the mask (T, T) bool; the RoPE
positions and the cache rows are computed from them inside the graph. Its
warm-up's rows (pos0 + [0, T) of every slot and layer) are restored the
same way.

A failed capture or replay raises: nothing falls back to eager on the
card. The graphs of a cache live on its ``KVCache`` (``model.step_graph``,
``model.verify_graph``) and go with it.
"""

from __future__ import annotations

import numbers
import time

import torch

from calm_tpu_torch.sampler import device_sample


def counters() -> list[tuple[object, str]]:
    """Every launch count of the kernel wrappers: (wrapper, attribute) for
    each int attribute named ``*launches`` of a function in the ops
    modules, each once."""
    from calm_tpu_torch.ops import (hopper_attn, hopper_collectives, hopper_qmm,
                                    hopper_stream)
    found = {}
    for mod in (hopper_attn, hopper_collectives, hopper_qmm, hopper_stream):
        for f in vars(mod).values():
            for a, v in getattr(f, "__dict__", {}).items():
                if a.endswith("launches") and isinstance(v, int):
                    found[(id(f), a)] = (f, a)
    return list(found.values())


def uncounted(fn):
    """``fn()`` with the launches it counted taken back off the counters
    (a capture launches nothing): (its result, [(wrapper, attribute,
    launches)] of each count it moved)."""
    before = [(f, a, getattr(f, a)) for f, a in counters()]
    out = fn()
    moved = [(f, a, getattr(f, a) - n) for f, a, n in before if getattr(f, a) != n]
    for f, a, n in before:
        setattr(f, a, n)
    return out, moved


def capture(body, device):
    """Warm ``body`` up eagerly on a side stream (it builds the kernels, sets
    their attributes and sizes their buffers, which may not happen under
    capture), then capture it: (graph, its output, [(wrapper, attribute,
    launches)] a replay makes, seconds)."""
    t0 = time.perf_counter()
    side = torch.cuda.Stream(device=device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out, launches = uncounted(body)
    return graph, out, launches, t0


def _count(launches) -> None:
    """Add a replay's launches to the wrappers' counters."""
    for f, a, n in launches:
        setattr(f, a, getattr(f, a) + n)


def _fill(dst: torch.Tensor, src) -> None:
    """A static input from a tensor, an int for every element, or host
    numbers (one copy, no sync)."""
    if isinstance(src, torch.Tensor):
        dst.copy_(src)
    elif isinstance(src, numbers.Integral):
        dst.fill_(int(src))
    else:
        dst.copy_(torch.as_tensor(src, dtype=dst.dtype), non_blocking=True)


class StepGraph:
    """One decode step for B slots, captured on first use and replayed.

    ``step(token, pos, pt) -> logits (B, V)`` is the step on device state
    (``model._decode`` with its weights, cache and ``rolling`` bound);
    ``snapshot(pos, pt)`` saves the cache rows a step at ``pos`` writes and
    returns the function that puts them back. ``graph`` is None until
    :meth:`capture`."""

    replays = 0  # replays of every graph since the count was last set

    def __init__(self, step, snapshot, B: int, vocab: int, device,
                 sampled: bool = False, pt: torch.Tensor | None = None, keep=()):
        self.step, self.snapshot = step, snapshot
        self.keep = keep  # what the captured addresses belong to: held
        self.sampled = sampled
        self.token = torch.zeros(B, dtype=torch.int64, device=device)
        self.pos = torch.zeros(B, dtype=torch.int32, device=device)
        self.pt = pt
        self.noise = self.temperature = self.minp = None
        if sampled:
            self.noise = torch.zeros((B, vocab), dtype=torch.float32, device=device)
            self.temperature = torch.zeros(B, dtype=torch.float32, device=device)
            self.minp = torch.ones(B, dtype=torch.float32, device=device)
        self.logits = None  # the captured step's output, (B, V) f32
        self.graph = None
        self.launches: list = []  # (wrapper, counter, launches a replay makes)
        self.capture_s = 0.0

    def body(self) -> torch.Tensor:
        """The captured work: one step, the next token chosen on the
        device and fed back, the position advanced."""
        logits = self.step(self.token, self.pos, self.pt)
        if self.sampled:
            nxt = device_sample(logits, None, self.temperature, self.minp, u=self.noise)
        else:
            nxt = logits.argmax(-1)  # first max wins, like jnp.argmax
        self.token.copy_(nxt)
        self.pos.add_(1)
        return logits

    def load(self, token, pos, sampling=None) -> None:
        """Set the static inputs: token and pos as host ints or tensors,
        ``sampling`` = (generator, temperature (B,), minp (B,))."""
        _fill(self.token, token)
        _fill(self.pos, pos)
        if sampling is not None:
            self.temperature.copy_(sampling[1])
            self.minp.copy_(sampling[2])

    def capture(self) -> None:
        """Warm up eagerly, capture the body, then put back the cache rows
        and the inputs the warm-up changed."""
        restore = self.snapshot(self.pos, self.pt)
        token, pos = self.token.clone(), self.pos.clone()
        self.graph, self.logits, self.launches, t0 = capture(self.body, self.token.device)
        restore()
        self.token.copy_(token)
        self.pos.copy_(pos)
        torch.cuda.synchronize(self.token.device)
        self.capture_s = time.perf_counter() - t0

    def replay(self, generator: torch.Generator | None = None) -> None:
        """One step: draw the noise from ``generator`` when sampled, replay,
        and count the launches the replay made."""
        if self.sampled:
            torch.rand(self.noise.shape, generator=generator, device=self.noise.device,
                       out=self.noise)
        self.graph.replay()
        _count(self.launches)
        StepGraph.replays += 1


class VerifyGraph:
    """One (B, T) forward with every row's logits, captured on first use
    and replayed: the speculative verify.

    ``forward(tokens, pos0, depth, tree) -> logits (B, T, V)`` is the
    forward on device state (``model._forward`` with its weights and cache
    bound; depth and tree None for a linear verify); ``snapshot(pos0)``
    saves the rows it writes and returns the function that puts them
    back."""

    replays = 0  # replays of every verify graph since the count was last set

    def __init__(self, forward, snapshot, B: int, T: int, device, tree: bool = False,
                 keep=()):
        self.forward, self.snapshot = forward, snapshot
        self.keep = keep  # what the captured addresses belong to: held
        self.tokens = torch.zeros((B, T), dtype=torch.int64, device=device)
        self.pos0 = torch.zeros(B, dtype=torch.int32, device=device)
        self.depth = torch.zeros(T, dtype=torch.int32, device=device) if tree else None
        self.tree = torch.zeros((T, T), dtype=torch.bool, device=device) if tree else None
        self.logits = None  # the captured forward's output, (B, T, V) f32
        self.graph = None
        self.launches: list = []
        self.capture_s = 0.0

    def body(self) -> torch.Tensor:
        return self.forward(self.tokens, self.pos0, self.depth, self.tree)

    def load(self, tokens, pos0, depth=None, tree=None) -> None:
        """Set the static inputs (tensors or host numbers); a tree graph
        takes its depth and mask too."""
        _fill(self.tokens, tokens)
        _fill(self.pos0, pos0)
        if (depth is None) != (self.depth is None) or (tree is None) != (self.tree is None):
            raise ValueError("a tree verify graph takes depth and tree, a linear one neither")
        if depth is not None:
            _fill(self.depth, depth)
            self.tree.copy_(torch.as_tensor(tree, dtype=torch.bool), non_blocking=True)

    def capture(self) -> None:
        """Warm up eagerly, capture the forward, then put back the cache
        rows the warm-up wrote."""
        restore = self.snapshot(self.pos0)
        self.graph, self.logits, self.launches, t0 = capture(self.body, self.tokens.device)
        restore()
        torch.cuda.synchronize(self.tokens.device)
        self.capture_s = time.perf_counter() - t0

    def replay(self) -> None:
        """One forward, and the launches it made counted."""
        self.graph.replay()
        _count(self.launches)
        VerifyGraph.replays += 1
