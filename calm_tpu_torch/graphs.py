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
- Counters (``ops.cost``): ``graph.captures`` and ``graph.capture_s``
  (warm-up included) a capture, ``graph.replays`` a replay. The kernel
  wrappers count launches in Python, so their counters hold a capture's
  warm-up and its captured body, and no replay.

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

from calm_tpu_torch.ops.cost import count, span
from calm_tpu_torch.sampler import device_sample


def capture(body, device):
    """Warm ``body`` up eagerly on a side stream (it builds the kernels, sets
    their attributes and sizes their buffers, which may not happen under
    capture), then capture it: (graph, its output)."""
    side = torch.cuda.Stream(device=device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = body()
    return graph, out


def _captured(g, restore, device) -> None:
    """Capture ``g``'s body, put back what its warm-up changed
    (``restore()``), and count the capture and its seconds."""
    t0 = time.perf_counter()
    with span("graph.capture"):
        g.graph, g.logits = capture(g.body, device)
        restore()
        torch.cuda.synchronize(device)
    g.capture_s = time.perf_counter() - t0
    count("graph.captures")
    count("graph.capture_s", g.capture_s)


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
        restore_rows = self.snapshot(self.pos, self.pt)
        token, pos = self.token.clone(), self.pos.clone()

        def restore():
            restore_rows()
            self.token.copy_(token)
            self.pos.copy_(pos)
        _captured(self, restore, self.token.device)

    def replay(self, generator: torch.Generator | None = None) -> None:
        """One step: draw the noise from ``generator`` when sampled, then
        replay."""
        if self.sampled:
            torch.rand(self.noise.shape, generator=generator, device=self.noise.device,
                       out=self.noise)
        self.graph.replay()
        count("graph.replays")


class VerifyGraph:
    """One (B, T) forward with every row's logits, captured on first use
    and replayed: the speculative verify.

    ``forward(tokens, pos0, depth, tree) -> logits (B, T, V)`` is the
    forward on device state (``model._forward`` with its weights and cache
    bound; depth and tree None for a linear verify); ``snapshot(pos0)``
    saves the rows it writes and returns the function that puts them
    back."""

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
        _captured(self, self.snapshot(self.pos0), self.tokens.device)

    def replay(self) -> None:
        """One forward."""
        self.graph.replay()
        count("graph.replays")
