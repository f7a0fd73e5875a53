"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from ``calm_tpu_torch/csrc``, holds each
against its plain PyTorch version at Mistral-7B, Mixtral 8x7B and the
tools' shapes and ragged ones (K12 and K13 also at the head dims of the
converter's Phi-3-mini and Gemma containers and at 32 query rows a kv
head; K12 at the corners of its tiles and chunks, pages shorter and longer
than a tile and a slot offset; K4/K5 at 32 rows; K13 at the corners of
its TMA + wgmma tiles at every head dim and cache dtype; K2 and K9 on
their multi-row tensor-core path at B = 2..16, fp8 and fp16, SiLU and
GELU, with and without the mean subtracted, a ragged 32001 x 4112, and
slots 2^20 apart in scale, each held to its own; K8 and K6 on the same
path on gf4 words, slots 2^20 apart and subnormal scale bytes included,
K6 also at a model width of 1032, an odd word count a row; K3 and K7 on
it too, K3 at the Aya 23 8B and Mistral-7B lm-heads and at d = 1000, n =
1032 and n = 8, K7 with Qd = 512 != D; K8, K7 and K6 at one row on the
one-row gf4 kernel, split by launch, its tiling swept, and at odd word
counts, n = 8 and 14336 and all-subnormal scale bytes; K10 and K11 on
the multi-row path at B = 2..16 in 8 expert slots at Mixtral 8x7B shapes
and ragged ones, a dead slot, ids repeated as under ep, odd word counts,
fp8 rows off the 16-value steps on moe.cu's loop; the fp8e4 routes, K2
at one row and 2-16, K10 at one row and the expert FFN at 8 rows, with
power-of-two scales that differ by layer and expert, planes of all 254
finite e4m3 bytes, each timed beside the e5m2 row of the same shape; the
``--precise`` path of K2 and K3 at 2-16 rows, the multi-row kernel as by
default, against f32 and the float64 product, and the entry points that
refuse 2-16 rows without a plan) and times it
beside its bound and its library call (kernel/library on each timed row),
after the redesigned kernels' ptxas report; runs both bandwidth tools
(``calm_tpu_torch.tools.dma_ceiling``, ``gf4_bound``), whose 3 GB rows
give the card's attainable HBM read rate; holds K12's partials mode
(Mistral-7B's decode split into 2 and 4 S-shards, their merge against
plain mode) and the two-shot all-reduce (K14, 2-8 logical ranks on the
card, bit-equal to its ring-order plain version, inputs untouched) and
times them; runs the
sharded model paths in ranks spawned on this one card over gloo (Mistral-7B
fp8 at 8 layers tp=2 x sp=2 through sp prefill and 32 steps, then
``sharded_decode_scan`` after the same prefill; Mixtral 8x7B fp8 at 4
layers ep=2; 2 layers at ctx 64 sp=2 across the window wrap; the pipeline
stages: pp=4, GPipe pp=2 x tp=2 over 4 slots in 2 microbatches, Mixtral pp=2
x ep=2; the ring sp prefill over sp=4 of a 2048-token window, then sp
decode, beside the all-gather path) against the same weights unsharded,
and in the same ranks the SPMD ``Server(mesh, plan)`` on an 8-layer
Mistral-7B-width fp8 container (tp=2 x dp=2 with a mid-flight admission;
the mesh-paged pool at tp=4 with a prefix-cache hit; two hosts of tp=2,
each submitting its own requests), each rank holding about 1/tp of the
weights (``Engine(lazy_weights=True)``), held to the unsharded ``Server``;
builds the native host library (native/*.cc, g++) and holds its parser
and tokenizer to the Python ones on every container written; drives ``Engine.generate`` (batched prefill,
then decode; sampled on the device by default, each id checked against
its step's min-p set), ``prefill_tokens``, ``perplexity`` and the CLI
(generate, ``-x``, ``-y``) on 2-layer Mistral-7B-width fp8 and gf4
containers (gf4 also with ROTATED_DECODE off, as CALM_ROT=0; both also
under ``--precise``, its logits' error against the CPU beside the
default's) and an fp8e4 one, 2-layer Aya 23 8B-width parallel-norm
(Cohere) gf4 and fp8 containers, 2-layer Phi-3-mini- and Gemma-2B-width
fp8 ones and 2-layer Mixtral-width (4 experts, top-2) fp8, gf4 and fp8e4
MoE containers, each checked against the CPU plain path (gf4's on the
exact fp16 decode of its words); runs a 2048-token prefill and the
``bench.py`` decode protocol on Mistral-7B (fp8, gf4, fp8e4; fp8 also
under ``--precise``, and a 17-token prompt's prefill under ``--precise``
for fp8 and gf4), Aya 23 8B (fp8, gf4) and Mixtral 8x7B (fp8, gf4,
fp8e4); serves the
containers through ``Server`` (dense, paged, prefix cache) against the
CPU's server and through ``python -m calm_tpu_torch.httpd`` (also with
``--dp``, the card count, and ``--page-rows``); serves 16
requests on a 32-layer Mistral-7B with 8 slots, dense and paged (fp8),
then on two paged decoders of 4 slots sharing the weights on this card
(``dp_devices=[cuda, cuda]``, host and device sampling),
and on 32-layer Mistral-7B and Aya 23 8B gf4, dense (the gf4 serving
ticks: K8, and K6 and K3, at 8 rows), and on the gf4 Mistral-7B again
with ROTATED_DECODE off (K3 and K7 at 8 rows), on the 32-layer
Mistral-7B fp8e4 (K2's e4m3 body at 8 rows), and on the 16-layer
Mixtral 8x7B fp8, gf4 and fp8e4 of the decode phase (the expert sweep at
8 rows: K10's and K11's multi-row FFN; each sweep's live experts counted);
checks speculative decoding: K13's split-S route at a verify's T (1-5
query rows at the window's end, B = 1, 2 and 8) and the draft tree's
attention on it (10 and 13 nodes) against their plain version, timed
beside SDPA, T launches of K12 and the persistent kernel, the route's
corners at every head dim and cache dtype and its crossover; the
captured verify replayed bit for bit
against the eager forward (2-layer fp8 and gf4: linear B = 1 and 3, the
k=3, m=4 tree; every full-width verify); the CLI's ``--draft`` on the
2-layer Mistral-width fp8 container with itself and its gf4 twin, a
``Server`` and ``httpd`` with a draft, held to the CPU path; and on the
32-layer fp8 Mistral-7B the linear loop at gamma 4 (the target as draft,
and a TinyLlama-1.1B-shaped draft), the tree (k=3, m=4) and an 8-slot
drain of 8 greedy requests with the target as draft, ids held to plain
replayed greedy up to near-ties, each self-draft rejection at a near-tie;
runs ``python -m calm_tpu_torch.tools.perf`` on the full-width fp8
Mistral-7B (its roofline report against this run's attainable rate and the
trace table of one eager run, held to ``profiler.step_bytes``, the phase's
first32 and the HBM rate) and on the 2-layer container's 2048-token
prefill, and ``tools.sol`` beside the measured first32;
runs the repo's tools on the port as a user runs them, each in its own
process: ``tools.convert`` of a BF16 ``MistralForCausalLM`` checkpoint
of Mistral-7B's widths at 2 layers, written with torch alone, to fp8 and
gf4 (each container held to the CPU path), ``tools.accept`` on four tiny
BF16 checkpoints (configs 1-4: PASS, the cross-check on the card's
near-tie rule), ``tools.quality`` on the card's kernels, ``tools.bench``
on the 32-layer Mistral-7B (fp8, its first32 between the full-width
phase's first32 and last32; fp16; ``--kv fp8``; ``--prefill 2048``) and
``tools.serve_bench`` on the 2-layer fp8 container;
and ends with a ``kernels`` JSON line and
``{"ok": true, "device": ...}``. The containers' CPU side runs in a worker
process from the start. Any failure exits non-zero before the last line;
without a GPU it exits 1 at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request
from typing import NamedTuple

import numpy as np
import torch

PEAK_F32 = 67e12  # H100 SXM, f32 outside the tensor cores (NVIDIA data sheet)
PEAK_BF16 = 989e12  # H100 SXM, dense bf16 tensor cores (NVIDIA data sheet)
MISTRAL = dict(dim=4096, hidden_dim=14336, head_dim=128, n_layers=32,
               n_heads=32, n_kv_heads=8, vocab_size=32000)
D, HID, Q, KV = 4096, 14336, 4096, 1024  # Mistral-7B dim, hidden, q and kv width
ROOT = os.path.dirname(os.path.abspath(__file__))


def log(*a):
    print(*a, flush=True)


WORKERS = []  # the process pools this run started: ended at a failure


def fail(msg: str):
    log(f"FAIL: {msg}")
    for pool in WORKERS:
        pool.terminate()
    sys.exit(1)


def _short(kernel: str) -> str:
    """'void (anonymous namespace)::qmv_kernel<1, 0>(Args)' ->
    'qmv_kernel<1, 0>'."""
    k = kernel.replace("(anonymous namespace)::", "").removeprefix("void ")
    return k.split("(")[0][:60]


def _profile(run):
    """torch.profiler (CPU and CUPTI) over ``run()``, the card synchronised
    on both sides."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return prof


def _rows(prof) -> list[tuple[float, int, str]]:
    from torch.autograd import DeviceType

    return sorted(((e.self_device_time_total, e.count, _short(e.key))
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                   and not e.key.startswith("wrapper:")), reverse=True)


def kernel_rows(run) -> list[tuple[float, int, str]]:
    """(device us, launches, short name) of every kernel ``run`` launches,
    by torch.profiler (CUPTI), largest first."""
    return _rows(_profile(run))


def profile_wrappers(run, names) -> tuple[list, dict]:
    """``kernel_rows`` of ``run()``, and for each kernel wrapper in
    ``names`` (attributes of ``hopper_qmm``, none calling another) the
    device us of the kernels it launched in the run, by kernel. A
    torch.profiler range around each wrapper, in place for this run only
    (in ``hopper_qmm`` and in ``model``, which imports some by name), gives
    each call a span on the device's timeline; one stream runs in order, so
    the kernels inside a span are that call's."""
    import bisect

    from torch.autograd import DeviceType
    from torch.profiler import record_function

    from calm_tpu_torch import model as M
    from calm_tpu_torch.ops import hopper_qmm as hq

    def ranged(name, f):
        def g(*a, **k):
            with record_function(f"wrapper:{name}"):
                return f(*a, **k)
        g.__dict__ = f.__dict__  # the launch counters the wrapper bumps by its name
        return g
    saved = []
    for name in names:
        f = getattr(hq, name)
        for mod in (hq, M):
            if getattr(mod, name, None) is f:
                saved.append((mod, name, f))
                setattr(mod, name, ranged(name, f))
    try:
        prof = _profile(run)
    finally:
        for mod, name, f in saved:
            setattr(mod, name, f)
    dev_evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    ks = sorted((e.time_range.start, e.time_range.end, _short(e.name)) for e in dev_evs
                if not e.name.startswith("wrapper:"))
    starts = [k[0] for k in ks]
    per = {}
    for e in dev_evs:
        if e.name.startswith("wrapper:"):
            into = per.setdefault(e.name[len("wrapper:"):], {})
            s0, s1 = e.time_range.start, e.time_range.end
            for k0, k1, kname in ks[bisect.bisect_left(starts, s0):]:
                if k0 >= s1:
                    break
                if k1 <= s1:
                    into[kname] = into.get(kname, 0.0) + (k1 - k0)
    return _rows(prof), per


def timed_events(fn, iters: int = 20, warmup: int = 3) -> float:
    """ms per call by CUDA events around ``iters`` calls, host gaps
    included."""
    for i in range(warmup):
        fn(i)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed(fn, iters: int = 20, warmup: int = 3, floor: float | None = None
          ) -> tuple[float, str]:
    """(ms per call, how it was timed). "cupti": device time, the summed
    duration of the kernels that ``iters`` calls launch, so that the host's
    own pace (Python and wrapper checks between launches) does not enter.
    "events": CUDA events around the ``iters`` calls, host gaps included,
    when the profiler sees no device time twice (CUPTI drops a profile now
    and then) or sees less than ``floor`` ms a call, the least time the
    card can take for the work: then it missed part of the call."""
    for i in range(warmup):
        fn(i)

    def run():
        for i in range(iters):
            fn(i)
    for _ in range(2):
        rows = kernel_rows(run)
        if rows:
            ms = sum(r[0] for r in rows) / 1e3 / iters
            if floor is None or ms >= floor:
                return ms, "cupti"
            log(f"# timed: the profiler saw {ms:.4f} ms a call, below the bound "
                f"{floor:.4f} ms; CUDA events instead")
            break
    else:
        log("# timed: the profiler saw no device time; CUDA events instead")
    return timed_events(fn, iters, 0), "events"


def timings(kernel, plain, library=None, plain_iters: int = 5,
            bound: float | None = None) -> dict:
    """ms of a kernel's wrapper, its plain version and the library call
    (None without one); ``timed_by``: "cupti", or which of them fell back
    to CUDA events (``timed``: any call seen below ``bound``)."""
    hows = {}

    def t(key, fn, *a):
        ms, hows[key] = timed(fn, *a, floor=bound)
        return ms
    out = dict(ms=t("kernel", kernel), plain_ms=t("plain", plain, plain_iters, 1),
               library_ms=None if library is None else t("library", library))
    ev = [k for k, h in hows.items() if h == "events"]
    out["timed_by"] = f"events ({', '.join(ev)})" if ev else "cupti"
    out["kernel_timed_by"] = hows["kernel"]
    return out


def share(t: dict, b: float) -> str:
    """The bound's share of the kernel's device time; none for wall time."""
    if t["kernel_timed_by"] != "cupti":
        return "timed by CUDA events: no share of bound"
    return f"{100 * b / t['ms']:.1f}% of bound"


def ms_line(t: dict) -> str:
    lib = "n/a" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
    ratio = ("" if t["library_ms"] is None
             else f", kernel/library {t['ms'] / t['library_ms']:.2f}x")
    return (f"kernel_ms {t['ms']:.4f} plain_ms {t['plain_ms']:.4f} library_ms {lib}"
            f"{ratio} ({t['timed_by']})")


def bound_ms(nbytes: float, ops: float, gbps: float,
             peak: float = PEAK_F32) -> tuple[float, str]:
    tb, to = nbytes / (gbps * 1e9) * 1e3, ops / peak * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def rand_w(shape, fmt, dev):
    if fmt == "fp8":  # small finite e5m2 (exponent <= 7), random sign
        b = torch.randint(0, 256, shape, device=dev, dtype=torch.int32) & 0x9F
        return b.to(torch.uint8).view(torch.float8_e5m2)
    if fmt == "gf4":  # words: random codes, a positive e5m2 scale <= 1.75
        i = torch.randint(-2**31, 2**31 - 1, shape, device=dev, dtype=torch.int32)
        return (i & ~0xFF) | (i & 0x3F)
    return (torch.randn(shape, device=dev) * 0.02).half()


def max_err(got, want):
    if isinstance(got, (tuple, list)):
        return max(max_err(g, w) for g, w in zip(got, want))
    return (got.float() - want.float()).abs().max().item()


def scale_of(want):
    if isinstance(want, (tuple, list)):
        return max(scale_of(w) for w in want)
    return want.float().abs().max().item()


WORST_REL = {}  # kernel -> the largest max_abs_err / max |out| of its checks


def check(name, got, want, rel_tol):
    err, sc = max_err(got, want), scale_of(want)
    if not err <= rel_tol * sc:
        fail(f"{name}: max_abs_err {err:.3e} > {rel_tol:g} * {sc:.3e}")
    key = name.split()[0]
    WORST_REL[key] = max(WORST_REL.get(key, 0.0), err / sc)
    return err


def kernel_phase(gbps, dev):
    """Each kernel against its plain version, and timed, at 7B shapes."""
    import torch.nn.functional as F

    from calm_tpu_torch.ops import hopper_attn as ha
    from calm_tpu_torch.ops import hopper_qmm as hq
    from calm_tpu_torch.ops.qmm import QTensor, dequant

    rows = {}
    H, Qd, KVd, V = HID, Q, KV, 32000

    # K2 qmm_decode: lm-head (V x D) and wq (Qd x D); 8-plane stacks so a
    # timed launch does not find its plane in the 50 MB L2
    errs, best = [], None
    for fmt in ("fp8", "fp16"):
        esz = 1 if fmt == "fp8" else 2
        for name, d, L in (("lm-head", V, 1), ("wq", Qd, 8)):
            w = rand_w((L, d, D), fmt, dev)
            x = torch.randn(1, D, device=dev)
            errs.append(check(f"qmm_decode {fmt} {name}",
                              hq.qmm_decode(x, w, fmt, L - 1),
                              hq.qmm_decode_plain(x, w, fmt, L - 1), TOL_MV))
            wb = dequant(QTensor(w, fmt), torch.bfloat16)
            b, by = bound_ms(d * D * esz + 4 * (D + d), 2 * d * D, gbps)
            t = timings(lambda i: hq.qmm_decode(x, w, fmt, i % L),
                        lambda i: hq.qmm_decode_plain(x, w, fmt, i % L),
                        lambda i: torch.matmul(x.bfloat16(), wb[i % L].T), bound=b)
            log(f"# K2 qmm_decode {fmt} {name} {d}x{D} B=1: max_abs_err "
                f"{errs[-1]:.3e} (tol {TOL_MV:g} x max|y|); {ms_line(t)} (bf16 "
                f"matmul) bound_ms {b:.4f} ({by}); {share(t, b)}")
            if fmt == "fp8" and name == "lm-head":
                best = dict(t, bound_ms=b, bound_by=by)
    rows["qmm_decode"] = dict(best, max_abs_err=max(errs))

    # K9 qx_offn_qkv: one full Mistral-7B layer, 2-layer stacks (the clamp)
    errs, best = [], None
    for fmt in ("fp8", "fp16"):
        esz = 1 if fmt == "fp8" else 2
        L = 2
        ws = [rand_w(s, fmt, dev) for s in ((L, D, Qd), (L, H, D), (L, H, D),
                                             (L, D, H), (L, Qd, D), (L, KVd, D),
                                             (L, KVd, D))]
        g = 1 + 0.1 * torch.randn(L, D, device=dev)
        anx = 1 + 0.1 * torch.randn(L, D, device=dev)
        a, r = torch.randn(1, Qd, device=dev), torch.randn(1, D, device=dev)
        for layer in range(L):
            errs.append(check(
                f"qx_offn_qkv {fmt} layer {layer}",
                hq.qx_offn_qkv(a, r, g, anx, *ws, layer, fmt, False, 1e-5, False),
                hq.qx_offn_qkv_plain(a, r, g, anx, *ws, layer, fmt, False, 1e-5,
                                     False), TOL_MV))
        wb = [dequant(QTensor(w, fmt), torch.bfloat16) for w in ws]
        n_w = D * Qd + 3 * H * D + (Qd + 2 * KVd) * D
        b, by = bound_ms(n_w * esz + 4 * (3 * D + 2 * Qd + 2 * KVd), 2 * n_w, gbps)
        t = timings(lambda i: hq.qx_offn_qkv(a, r, g, anx, *ws, i % L, fmt,
                                             False, 1e-5, False),
                    lambda i: hq.qx_offn_qkv_plain(a, r, g, anx, *ws, i % L, fmt,
                                                   False, 1e-5, False),
                    epilogue_chain(a, r, g, anx, wb, L), bound=b)
        log(f"# K9 qx_offn_qkv {fmt} one layer D={D} H={H} Qd={Qd} KVd={KVd} "
            f"B=1: max_abs_err {max(errs):.3e} (tol {TOL_MV:g} x max|out|); "
            f"{ms_line(t)} (7 bf16 matmuls on pre-dequantized planes) bound_ms "
            f"{b:.4f} ({by}, {n_w * esz / 1e6:.1f} MB); {share(t, b)}")
        if fmt == "fp8":
            best = dict(t, bound_ms=b, bound_by=by)
        del ws, wb
    rows["qx_offn_qkv"] = dict(best, max_abs_err=max(errs))

    # K12 decode_attention, fresh mode: kv_len 32 and 4096, bf16 and fp8 KV
    errs, best = [], None
    B, KVH, M, S, hd, L = 1, 8, 4, 4096, 128, 8
    for kvd, kvname in ((torch.bfloat16, "bf16"), (torch.float8_e5m2, "fp8")):
        kc = (torch.randn(L, B, KVH, S, hd, device=dev) * 0.5).to(kvd)
        vc = torch.randn(L, B, KVH, S, hd, device=dev).to(kvd)
        q = torch.randn(B, KVH * M, hd, device=dev)
        fk = torch.randn(B, KVH, hd, device=dev).to(kvd)
        fv = torch.randn(B, KVH, hd, device=dev).to(kvd)
        esz = kc.element_size()
        for kv_len in (32, 4096):
            kl = torch.full((B,), kv_len, dtype=torch.int32, device=dev)
            kp = torch.full((B,), kv_len - 1, dtype=torch.int32, device=dev)
            fr = (fk, fv, kp)
            e = max_err(ha.decode_attention(q, kc, vc, kl, L - 1, fr),
                        ha.decode_attention_plain(q, kc, vc, kl, L - 1, fr))
            if not e <= TOL_DA:
                fail(f"decode_attention {kvname} kv_len {kv_len}: {e:.3e} > {TOL_DA}")
            errs.append(e)
            kb, vb = kc.bfloat16(), vc.bfloat16()
            q4 = q.reshape(B, KVH * M, 1, hd).bfloat16()
            nb = 2 * KVH * kv_len * hd * esz + 2 * KVH * hd * esz + 8 * B * KVH * M * hd
            b, by = bound_ms(nb, 4 * KVH * M * kv_len * hd, gbps)
            t = timings(lambda i: ha.decode_attention(q, kc, vc, kl, i % L, fr),
                        lambda i: ha.decode_attention_plain(q, kc, vc, kl, i % L, fr),
                        lambda i: F.scaled_dot_product_attention(
                            q4, kb[i % L, :, :, :kv_len], vb[i % L, :, :, :kv_len],
                            enable_gqa=True), bound=b)
            log(f"# K12 decode_attention fresh {kvname} KV kv_len {kv_len} "
                f"(B=1, KVH=8, M=4, hd=128, S=4096): max_abs_err {e:.3e} "
                f"(tol {TOL_DA:g}); {ms_line(t)} (bf16 SDPA) bound_ms {b:.4f} "
                f"({by}); {share(t, b)}")
            if kvname == "bf16" and kv_len == 4096:
                best = dict(t, bound_ms=b, bound_by=by)
        del kc, vc
    rows["decode_attention"] = dict(best, max_abs_err=max(errs))
    ragged_checks(dev)
    ragged_checks_heads(dev)
    rows.update(prefill_kernel_rows(gbps, dev))
    prefill_corner_checks(dev)
    rows.update(gf4_kernel_rows(gbps, dev))
    ragged_checks_prefill_gf4(dev)
    rows.update(moe_kernel_rows(gbps, dev))
    rows.update(moe_multirow_kernel_rows(gbps, dev))
    ragged_checks_moe(dev)
    rows.update(fp8e4_kernel_rows(gbps, dev))
    rows.update(precise_kernel_rows(gbps, dev))
    ragged_checks_fp8e4(dev)
    refused_without_a_plan(dev)
    rows.update(paged_kernel_rows(gbps, dev))
    rows.update(multirow_kernel_rows(gbps, dev))
    multirow_checks(dev)
    ragged_checks_paged(dev)
    ragged_checks_tilings(dev)
    rows.update(onerow_kernel_rows_gf4(gbps, dev))
    ragged_checks_onerow(dev)
    onerow_sweep(gbps, dev)
    rows.update(stream_kernel_rows(gbps, dev))
    ragged_checks_ffn_stream(dev)
    log("# max_abs_err / max|out|, worst of each kernel's checks: " + ", ".join(
        f"{k} {v:.3e}" for k, v in WORST_REL.items()))
    return rows


def kv_rand(shape, kvd, dev, scale=1.0):
    """Random cache values in ``kvd``; e5m2 from finite codes only (0x7c-0x7f
    and 0xfc-0xff are inf/nan)."""
    if kvd == torch.float8_e5m2:
        b = torch.randint(0, 256, shape, device=dev, dtype=torch.int32) & 0xBB
        return b.to(torch.uint8).view(torch.float8_e5m2)
    return (torch.randn(shape, device=dev) * scale).to(kvd)


def to_pages(dense, PR, order):
    """Dense rows (L, B, KVH, S, hd) -> a pool (L, B*S/PR + 1, KVH, PR, hd)
    holding block j of slot b at page order[b, j] (the last page parks)."""
    L, B, KVH, S, hd = dense.shape
    nb = S // PR
    pool = torch.zeros((L, B * nb + 1, KVH, PR, hd), dtype=dense.dtype, device=dense.device)
    blocks = dense.reshape(L, B, KVH, nb, PR, hd).permute(0, 1, 3, 2, 4, 5)
    pool[:, order.reshape(-1).long()] = blocks.reshape(L, B * nb, KVH, PR, hd)
    return pool


def paged_kernel_rows(gbps, dev):
    """K12 at the serving tick's shape (8 slots at kv_len 4096, 8 kv heads,
    hd 128, bf16): paged + fresh with scrambled tables of 512- and 64-row
    pages beside dense fresh mode."""
    import torch.nn.functional as F

    from calm_tpu_torch.ops import hopper_attn as ha

    rows = {}
    B, KVH, M, S, hd, L = 8, 8, 4, 4096, 128, 2
    kc = kv_rand((L, B, KVH, S, hd), torch.bfloat16, dev, 0.5)
    vc = kv_rand((L, B, KVH, S, hd), torch.bfloat16, dev)
    q = torch.randn(B, KVH * M, hd, device=dev)
    fr = (kv_rand((B, KVH, hd), torch.bfloat16, dev), kv_rand((B, KVH, hd), torch.bfloat16, dev),
          torch.randint(0, S, (B,), dtype=torch.int32, device=dev))
    kl = torch.full((B,), S, dtype=torch.int32, device=dev)
    q4 = q.reshape(B, KVH * M, 1, hd).bfloat16()

    def sdpa(i):  # the same rows held densely: the gather excluded
        return F.scaled_dot_product_attention(q4, kc[i % L], vc[i % L], enable_gqa=True)
    nbytes = 2 * B * KVH * S * hd * 2 + 2 * B * KVH * hd * 2 + 8 * B * KVH * M * hd
    b, by = bound_ms(nbytes, 4 * B * KVH * M * S * hd, gbps)
    want = ha.decode_attention(q, kc, vc, kl, L - 1, fr)
    e = max_err(want, ha.decode_attention_plain(q, kc, vc, kl, L - 1, fr))
    t = timings(lambda i: ha.decode_attention(q, kc, vc, kl, i % L, fr),
                lambda i: ha.decode_attention_plain(q, kc, vc, kl, i % L, fr), sdpa, bound=b)
    log(f"# K12 decode_attention fresh bf16 KV B=8 kv_len {S} (KVH=8, M=4, hd=128): "
        f"max_abs_err {e:.3e} (tol {TOL_DA:g}); {ms_line(t)} (bf16 SDPA) bound_ms "
        f"{b:.4f} ({by}, {nbytes / 1e6:.1f} MB); {share(t, b)}")
    gen = torch.Generator().manual_seed(3)
    for PR in (512, 64):
        nb = S // PR
        order = torch.randperm(B * nb, generator=gen).reshape(B, nb).to(torch.int32).to(dev)
        kp, vp = to_pages(kc, PR, order), to_pages(vc, PR, order)
        got = ha.decode_attention(q, kp, vp, kl, L - 1, fr, pt=order)
        e = max_err(got, ha.decode_attention_plain(q, kp, vp, kl, L - 1, fr, pt=order))
        if not e <= TOL_DA or not torch.equal(got, want):
            fail(f"decode_attention paged PR={PR}: {e:.3e} against the plain version, "
                 f"or not equal to dense mode on the same rows")
        t = timings(lambda i: ha.decode_attention(q, kp, vp, kl, i % L, fr, pt=order),
                    lambda i: ha.decode_attention_plain(q, kp, vp, kl, i % L, fr, pt=order),
                    sdpa, bound=b)
        log(f"# K12 decode_attention paged+fresh bf16 KV B=8 kv_len {S} PR={PR} "
            f"(scrambled table): max_abs_err {e:.3e} (tol {TOL_DA:g}), equal to dense "
            f"mode; {ms_line(t)} (bf16 SDPA on the rows held densely, gather excluded) "
            f"bound_ms {b:.4f} ({by}); {share(t, b)}")
        if PR == 512:
            rows["decode_attention_paged"] = dict(t, bound_ms=b, bound_by=by, max_abs_err=e)
        del kp, vp
    del kc, vc
    torch.cuda.empty_cache()
    return rows


MULTIROW_TIMED = (4, 8, 16)  # B of the multi-row path's timed rows; 8: the serving tick's


def multirow_kernel_rows(gbps, dev):
    """K9 (one Mistral-7B layer) and K2 (the lm-head), fp8, on the
    multi-row path at B = 4, 8 (the serving tick's 8 slots) and 16, each
    beside its bound, plain version and library call; the B = 8 rows go to
    the kernels line."""
    from calm_tpu_torch.ops import hopper_qmm as hq
    from calm_tpu_torch.ops.qmm import QTensor, dequant

    rows = {}
    H, V = HID, 32000
    ws = [rand_w(sh, "fp8", dev) for sh in ((2, D, Q), (2, H, D), (2, H, D), (2, D, H),
                                            (2, Q, D), (2, KV, D), (2, KV, D))]
    g = 1 + 0.1 * torch.randn(2, D, device=dev)
    anx = 1 + 0.1 * torch.randn(2, D, device=dev)
    wb = [dequant(QTensor(w, "fp8"), torch.bfloat16) for w in ws]
    n_w = D * Q + 3 * H * D + (Q + 2 * KV) * D
    for B in MULTIROW_TIMED:
        a, r = torch.randn(B, Q, device=dev), torch.randn(B, D, device=dev)
        e = check(f"qx_offn_qkv fp8 B={B}", hq.qx_offn_qkv(a, r, g, anx, *ws, 1, "fp8", False,
                                                          1e-5, False),
                  hq.qx_offn_qkv_plain(a, r, g, anx, *ws, 1, "fp8", False, 1e-5, False),
                  TOL_MV)
        # past one row, operations at the bf16 rate: the TPU kernels compute
        # these products on bf16 operands
        b, by = bound_ms(n_w + 4 * B * (3 * D + 2 * Q + 2 * KV), 2 * B * n_w, gbps, PEAK_BF16)
        t = timings(lambda i: hq.qx_offn_qkv(a, r, g, anx, *ws, i % 2, "fp8", False, 1e-5,
                                             False),
                    lambda i: hq.qx_offn_qkv_plain(a, r, g, anx, *ws, i % 2, "fp8", False,
                                                   1e-5, False),
                    epilogue_chain(a, r, g, anx, wb, 2), bound=b)
        log(f"# K9 qx_offn_qkv fp8 one layer B={B}: max_abs_err {e:.3e} (tol {TOL_MV:g} x "
            f"max|out|); {ms_line(t)} (7 bf16 matmuls) bound_ms {b:.4f} ({by}); {share(t, b)}")
        if B == 8:
            rows["qx_offn_qkv_multirow"] = dict(t, bound_ms=b, bound_by=by, max_abs_err=e)
            by_kernel(lambda i: hq.qx_offn_qkv(a, r, g, anx, *ws, i % 2, "fp8", False, 1e-5,
                                               False), "K9 fp8 one layer B=8")
    del ws, wb
    w = rand_w((1, V, D), "fp8", dev)
    wb = dequant(QTensor(w, "fp8"), torch.bfloat16)
    for B in MULTIROW_TIMED:
        x = torch.randn(B, D, device=dev)
        e = check(f"qmm_decode fp8 lm-head B={B}", hq.qmm_decode(x, w, "fp8", 0),
                  hq.qmm_decode_plain(x, w, "fp8", 0), TOL_MV)
        b, by = bound_ms(V * D + 4 * B * (D + V), 2 * B * V * D, gbps, PEAK_BF16)
        t = timings(lambda i: hq.qmm_decode(x, w, "fp8", 0),
                    lambda i: hq.qmm_decode_plain(x, w, "fp8", 0),
                    lambda i: torch.matmul(x.bfloat16(), wb[0].T), bound=b)
        log(f"# K2 qmm_decode fp8 lm-head {V}x{D} B={B}: max_abs_err {e:.3e} (tol "
            f"{TOL_MV:g} x max|y|); {ms_line(t)} (bf16 matmul) bound_ms {b:.4f} ({by}); "
            f"{share(t, b)}")
        if B == 8:
            rows["qmm_decode_multirow"] = dict(t, bound_ms=b, bound_by=by, max_abs_err=e)
    del w, wb
    rows.update(multirow_kernel_rows_gf4(gbps, dev))
    rows.update(multirow_kernel_rows_gf4_decode(gbps, dev))
    k3_split_sweep(gbps, dev)
    torch.cuda.empty_cache()
    return rows


def multirow_kernel_rows_gf4(gbps, dev):
    """K8 (one Mistral-7B layer) and K6 (one Aya 23 8B / Mistral-7B FFN,
    D 4096, H 14336) on gf4 words on the multi-row path at B = 4, 8 and 16,
    each beside its bound, plain version and library call (bf16 matmuls on
    planes dequantized beforehand); the B = 8 rows go to the kernels line,
    with K8's split by kernel."""
    import torch.nn.functional as F

    from calm_tpu_torch.ops import hopper_qmm as hq
    from calm_tpu_torch.ops.qmm import QTensor, dequant

    rows = {}
    H = HID
    ws = [rand_w((2, d, n // 8), "gf4", dev)
          for d, n in ((D, Q), (H, D), (H, D), (D, H), (Q, D), (KV, D), (KV, D))]
    g = 1 + 0.1 * torch.randn(2, D, device=dev)
    anx = 1 + 0.1 * torch.randn(2, D, device=dev)
    wb = [dequant(QTensor(w, "gf4"), torch.bfloat16) for w in ws]
    n_w = D * Q + 3 * H * D + (Q + 2 * KV) * D
    for B in MULTIROW_TIMED:
        a, r = torch.randn(B, Q, device=dev), torch.randn(B, D, device=dev)
        args = (a, r, g, anx, *ws, 1, False, 1e-5, False)
        e = check(f"gf4_offn_qkv B={B}", hq.gf4_offn_qkv(*args), hq.gf4_offn_qkv_plain(*args),
                  TOL_MV)
        b, by = bound_ms(n_w // 2 + 4 * B * (3 * D + 2 * Q + 2 * KV), 2 * B * n_w, gbps,
                         PEAK_BF16)
        t = timings(lambda i: hq.gf4_offn_qkv(a, r, g, anx, *ws, i % 2, False, 1e-5, False),
                    lambda i: hq.gf4_offn_qkv_plain(a, r, g, anx, *ws, i % 2, False, 1e-5,
                                                    False),
                    epilogue_chain(a, r, g, anx, wb, 2), bound=b)
        log(f"# K8 gf4_offn_qkv one layer B={B}: max_abs_err {e:.3e} (tol {TOL_MV:g} x "
            f"max|out|); {ms_line(t)} (7 bf16 matmuls) bound_ms {b:.4f} ({by}, "
            f"{n_w / 2e6:.1f} MB); {share(t, b)}")
        if B == 8:
            rows["gf4_offn_qkv_multirow"] = dict(t, bound_ms=b, bound_by=by, max_abs_err=e)
            by_kernel(lambda i: hq.gf4_offn_qkv(a, r, g, anx, *ws, i % 2, False, 1e-5, False),
                      "K8 gf4 one layer B=8")
    n_f = 3 * H * D
    for B in MULTIROW_TIMED:
        x = torch.randn(B, D, device=dev)
        xb = x.bfloat16()
        e = check(f"gf4_ffn B={B}", hq.gf4_ffn(x, *ws[1:4], 1, False),
                  hq.gf4_ffn_plain(x, *ws[1:4], 1, False), TOL_MV)
        b, by = bound_ms(n_f // 2 + 4 * 2 * B * D, 2 * B * n_f, gbps, PEAK_BF16)
        t = timings(lambda i: hq.gf4_ffn(x, *ws[1:4], i % 2, False),
                    lambda i: hq.gf4_ffn_plain(x, *ws[1:4], i % 2, False),
                    lambda i: torch.matmul(F.silu(torch.matmul(xb, wb[1][i % 2].T))
                                           * torch.matmul(xb, wb[2][i % 2].T),
                                           wb[3][i % 2].T), bound=b)
        log(f"# K6 gf4_ffn D={D} H={H} B={B}: max_abs_err {e:.3e} (tol {TOL_MV:g} x max|y|); "
            f"{ms_line(t)} (3 bf16 matmuls) bound_ms {b:.4f} ({by}, {n_f / 2e6:.1f} MB); "
            f"{share(t, b)}")
        if B == 8:
            rows["gf4_ffn_multirow"] = dict(t, bound_ms=b, bound_by=by, max_abs_err=e)
    del ws, wb
    torch.cuda.empty_cache()
    return rows


def by_kernel(fn, what: str, calls: int = 10):
    """Logs the device ms a call and launches a call of each kernel that
    ``fn(i)`` launches, over ``calls`` calls."""
    prof = kernel_rows(lambda: [fn(i) for i in range(calls)])
    log(f"# {what} by kernel (device ms a call, launches a call): " + "; ".join(
        f"{name} {us / 1e3 / calls:.4f} x{cnt / calls:g}" for us, cnt, name in prof))


def offn_library(wb, g, eps):
    """K7's library yardstick on bf16 planes dequantized beforehand (wo,
    w1, w3, w2; L layers): for (a, r), lib(i) on layer i % L = four bf16
    matmuls and an rms_norm."""
    import torch.nn.functional as F

    wo, w1, w3, w2 = wb
    L, D_ = wo.shape[:2]

    def for_inputs(a, r):
        ab = a.bfloat16()

        def lib(i):
            l = i % L
            r1 = r + torch.matmul(ab, wo[l].T)
            xb = F.rms_norm(r1, (D_,), g[l], eps).bfloat16()
            return torch.matmul(F.silu(torch.matmul(xb, w1[l].T)) * torch.matmul(xb, w3[l].T),
                                w2[l].T), r1
        return lib
    return for_inputs


def multirow_kernel_rows_gf4_decode(gbps, dev):
    """K3 on the Aya 23 8B lm-head (256000 x 4096, 524 MB of words) and on
    one Aya 23 8B q plane (4096 x 4096, 8 planes cycled past the 50 MB
    L2), and K7 at one Mistral-7B layer (2-layer stacks cycled), on the gf4
    multi-row path at B = 4, 8 and 16, each beside its bound, plain version
    and library call (bf16 matmuls on planes dequantized beforehand); the
    B = 8 rows of the lm-head and of K7 go to the kernels line, and each
    B = 8 row is split by kernel. Calls the wrappers only, so it also times
    an older tree's package in the same run."""
    from calm_tpu_torch.ops import hopper_qmm as hq
    from calm_tpu_torch.ops.qmm import QTensor, dequant

    rows = {}
    for name, d, L in (("aya lm-head", 256000, 1), ("aya q", Q, 8)):
        w = rand_w((L, d, D // 8), "gf4", dev)
        wb = dequant(QTensor(w, "gf4"), torch.bfloat16)
        for B in MULTIROW_TIMED:
            x = torch.randn(B, D, device=dev)
            xb = x.bfloat16()
            e = check(f"qmm_decode_gf4 {name} B={B}", hq.qmm_decode_gf4(x, w, L - 1),
                      hq.qmm_decode_gf4_plain(x, w, L - 1), TOL_MV)
            b, by = bound_ms(d * D // 2 + 4 * B * (D + d), 2 * B * d * D, gbps, PEAK_BF16)
            t = timings(lambda i: hq.qmm_decode_gf4(x, w, i % L),
                        lambda i: hq.qmm_decode_gf4_plain(x, w, i % L),
                        lambda i: torch.matmul(xb, wb[i % L].T), bound=b)
            log(f"# K3 qmm_decode_gf4 {name} {d}x{D} B={B}: max_abs_err {e:.3e} (tol "
                f"{TOL_MV:g} x max|y|); {ms_line(t)} (bf16 matmul, pre-dequantized) bound_ms "
                f"{b:.4f} ({by}, {d * D / 2e6:.1f} MB); {share(t, b)}")
            if B == 8:
                by_kernel(lambda i: hq.qmm_decode_gf4(x, w, i % L), f"K3 {name} B=8")
                if d == 256000:
                    rows["qmm_decode_gf4_multirow"] = dict(t, bound_ms=b, bound_by=by,
                                                           max_abs_err=e)
        del w, wb
        torch.cuda.empty_cache()

    L, eps = 2, 1e-5
    ws = [rand_w((L, d, n // 8), "gf4", dev) for d, n in ((D, Q), (HID, D), (HID, D), (D, HID))]
    g = 1 + 0.1 * torch.randn(L, D, device=dev)
    lib = offn_library([dequant(QTensor(w, "gf4"), torch.bfloat16) for w in ws], g, eps)
    n_w = 3 * HID * D + D * Q
    for B in MULTIROW_TIMED:
        a, r = torch.randn(B, Q, device=dev), torch.randn(B, D, device=dev)
        args = (a, r, g, *ws, 1, False, eps, False)
        e = max(check_offn(f"B={B}", hq.gf4_offn(*args), hq.gf4_offn_plain(*args)))
        b, by = bound_ms(n_w // 2 + 4 * B * (Q + 4 * D), 2 * B * n_w, gbps, PEAK_BF16)
        t = timings(lambda i: hq.gf4_offn(a, r, g, *ws, i % L, False, eps, False),
                    lambda i: hq.gf4_offn_plain(a, r, g, *ws, i % L, False, eps, False),
                    lib(a, r), bound=b)
        log(f"# K7 gf4_offn D={D} H={HID} Qd={Q} B={B}: max_abs_err {e:.3e} (tol {TOL_MV:g} "
            f"x max|out|, ffn and r1 each); {ms_line(t)} (4 bf16 matmuls + rms_norm) bound_ms "
            f"{b:.4f} ({by}, {n_w / 2e6:.1f} MB); {share(t, b)}")
        if B == 8:
            rows["gf4_offn_multirow"] = dict(t, bound_ms=b, bound_by=by, max_abs_err=e)
            by_kernel(lambda i: hq.gf4_offn(a, r, g, *ws, i % L, False, eps, False),
                      "K7 gf4 one layer B=8")
    del ws, lib
    torch.cuda.empty_cache()
    return rows


def k3_split_sweep(gbps, dev):
    """The lm-head's tiling: K3 at 256000 x 4096, B = 8, on qmv_plan's
    tiling (32 rows a warp, 8000 row groups, k whole: the groups alone pass
    MV_TARGET_WARPS) against k split over 2 and 4 warps (the warp target
    raised 4x and 8x) and 16 rows a warp; each checked, then timed."""
    from calm_tpu_torch.ops import hopper_qmm as hq

    d, B = 256000, 8
    w = rand_w((1, d, D // 8), "gf4", dev)
    x = torch.randn(B, D, device=dev)
    want = hq.qmm_decode_gf4_plain(x, w, 0)
    b, _ = bound_ms(d * D // 2 + 4 * B * (D + d), 2 * B * d * D, gbps, PEAK_BF16)
    base = (hq.MV_TARGET_WARPS, hq.MV_MT2_ROWS)
    out = []
    try:
        for target, mt2 in ((1, base[1]), (4, base[1]), (8, base[1]), (1, 1 << 30)):
            hq.MV_TARGET_WARPS, hq.MV_MT2_ROWS = base[0] * target, mt2
            hq._qmv_plan.cache_clear()
            hq._launch_plans.cache_clear()
            p = hq.qmv_plan(B, (d,), D, gf4=True)
            check(f"qmm_decode_gf4 lm-head B={B} mt={p.mt} ks={p.ks}",
                  hq.qmm_decode_gf4(x, w, 0), want, TOL_MV)
            ms, how = timed(lambda i: hq.qmm_decode_gf4(x, w, 0), floor=b)
            out.append(f"mt {p.mt} ks {p.ks} grid {p.grid}"
                       + (" (the plan)" if (target, mt2) == (1, base[1]) else "")
                       + f" {ms:.4f} ms ({how}, {100 * b / ms:.1f}% of bound)")
    finally:
        hq.MV_TARGET_WARPS, hq.MV_MT2_ROWS = base
        hq._qmv_plan.cache_clear()
        hq._launch_plans.cache_clear()
    log(f"# K3 lm-head {d}x{D} B={B} by tiling (bound_ms {b:.4f}): " + "; ".join(out))
    del w
    torch.cuda.empty_cache()


def check_rows(name, got, want, rel_tol):
    """``check`` with each row (slot) of each output held to its own max
    |out|: slots whose scales differ by 2^20 each keep their digits."""
    if isinstance(got, (tuple, list)):
        return max(check_rows(f"{name}[{i}]", g, w, rel_tol)
                   for i, (g, w) in enumerate(zip(got, want)))
    err = (got.float() - want.float()).abs().amax(-1)
    sc = want.float().abs().amax(-1)
    worst = (err / sc).max().item()
    if not (err <= rel_tol * sc).all() or not torch.isfinite(got).all():
        fail(f"{name}: a slot's max_abs_err is {worst:.3e} of its own max|out| > {rel_tol:g}")
    key = name.split()[0]
    WORST_REL[key] = max(WORST_REL.get(key, 0.0), worst)
    return err.max().item()


MULTIROW_B = (2, 3, 4, 8, 9, 16)  # one and two n-tiles, each side of 8


def multirow_checks(dev):
    """The multi-row path (2..16 rows, fp8 and fp16) against its plain
    version at TOL_MV: K9 at Mistral-7B widths with SiLU and GELU, with and
    without the mean subtracted (LayerNorm), K2 at the lm-head and wq and
    at a ragged 32001 x 4112 (k off the 64-value chunks), each at B = 2,
    3, 4, 8, 9, 16; then inputs whose slots differ in scale by 2^20 (1e-3
    beside 1e3, and chunks 1e4 apart within a row), each slot held to its
    own scale."""
    from calm_tpu_torch.ops import hopper_qmm as hq

    from calm_tpu_torch.ops.qmm import QTensor, dequant

    worst = {"qmm_decode": 0.0, "qx_offn_qkv": 0.0}
    n = 0
    exact = {}  # the lm-head's distance from the float64 product, kernel and plain

    def rel_to(y, ref):
        """max over rows of |y - ref| / max |ref|."""
        return ((y.double() - ref).abs().amax(-1) / ref.abs().amax(-1)).max().item()

    def spread(B, width):
        x = torch.randn(B, width, device=dev)
        x[0::2] *= 1e-3
        x[1::2] *= 1e3
        x[:, :64] *= 1e-4
        return x
    for fmt in ("fp8", "fp16"):
        L = 2
        ws = [rand_w(s, fmt, dev) for s in ((L, D, Q), (L, HID, D), (L, HID, D), (L, D, HID),
                                           (L, Q, D), (L, KV, D), (L, KV, D))]
        g = 1 + 0.1 * torch.randn(L, D, device=dev)
        anx = 1 + 0.1 * torch.randn(L, D, device=dev)
        for B in MULTIROW_B:
            for gelu, sub_mean in ((False, False), (True, False), (False, True), (True, True)):
                a, r = torch.randn(B, Q, device=dev), torch.randn(B, D, device=dev)
                args = (a, r, g, anx, *ws, 1, fmt, gelu, 1e-5, sub_mean)
                e = check(f"qx_offn_qkv {fmt} B={B} gelu={gelu} sub_mean={sub_mean}",
                          hq.qx_offn_qkv(*args), hq.qx_offn_qkv_plain(*args), TOL_MV)
                worst["qx_offn_qkv"], n = max(worst["qx_offn_qkv"], e), n + 1
            args = (spread(B, Q), spread(B, D), g, anx, *ws, 0, fmt, False, 1e-5, False)
            e = check_rows(f"qx_offn_qkv {fmt} B={B} slots 2^20 apart",
                           hq.qx_offn_qkv(*args), hq.qx_offn_qkv_plain(*args), TOL_MV)
            worst["qx_offn_qkv"], n = max(worst["qx_offn_qkv"], e), n + 1
        del ws
        for name, d, k in (("lm-head", 32000, D), ("wq", Q, D), ("ragged", 32001, 4112)):
            w = rand_w((2, d, k), fmt, dev)
            for B in MULTIROW_B:
                for xs, how in ((torch.randn(B, k, device=dev), ""),
                                (spread(B, k), " slots 2^20 apart")):
                    got, want = hq.qmm_decode(xs, w, fmt, 1), hq.qmm_decode_plain(xs, w, fmt, 1)
                    e = (check_rows if how else check)(
                        f"qmm_decode {fmt} {name} {d}x{k} B={B}{how}", got, want, TOL_MV)
                    worst["qmm_decode"], n = max(worst["qmm_decode"], e), n + 1
                    if name == "lm-head" and not how and B in (8, 16):
                        ref = xs.double() @ dequant(QTensor(w[1], fmt), torch.float32).double().T
                        exact[f"{fmt} B={B}"] = (rel_to(got, ref), rel_to(want, ref))
                        del ref
            del w
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"# multi-row path (B = {', '.join(map(str, MULTIROW_B))}; fp8, fp16): {n} checks "
        f"within {TOL_MV:g} of max|out| (slots 2^20 apart: of each slot's), max_abs_err "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()) + "; lm-head 32000x4096 "
        "against the float64 product, each row to its max (kernel / plain f32): "
        + ", ".join(f"{k} {a:.2e} / {b:.2e}" for k, (a, b) in exact.items()))
    multirow_checks_gf4(dev, spread, rel_to)
    multirow_checks_gf4_decode(dev, spread)


def subnormal_gf4(shape, dev):
    """gf4 words of random codes whose scale bytes are the subnormal e5m2
    ones, 0x01-0x03 and 0x81-0x83."""
    i = torch.randint(-2**31, 2**31 - 1, shape, device=dev, dtype=torch.int32)
    sb = torch.tensor([0x01, 0x02, 0x03, 0x81, 0x82, 0x83], dtype=torch.int32, device=dev)
    return (i & ~0xFF) | sb[torch.randint(0, 6, shape, device=dev)]


def multirow_checks_gf4(dev, spread, rel_to):
    """The multi-row path on gf4 words against the plain version at TOL_MV:
    K8 at Mistral-7B widths and K6 (D 4096, H 14336) at B = 2, 3, 4, 8, 9,
    16, SiLU and GELU (K8 also with the mean subtracted); then slots 2^20
    apart, and words whose scale bytes are all subnormal, each slot held to
    its own scale; K6 at B = 8 and 16 against the float64 product of the
    dequantized weights, kernel and plain version."""
    import torch.nn.functional as F

    from calm_tpu_torch.ops import hopper_qmm as hq
    from calm_tpu_torch.ops.qmm import QTensor, dequant

    worst = {"gf4_offn_qkv": 0.0, "gf4_ffn": 0.0}
    n, exact, L = 0, {}, 2
    shapes = ((D, Q), (HID, D), (HID, D), (D, HID), (Q, D), (KV, D), (KV, D))
    g = 1 + 0.1 * torch.randn(L, D, device=dev)
    anx = 1 + 0.1 * torch.randn(L, D, device=dev)
    for words in ("random", "subnormal"):
        ws = [(rand_w((L, d, k // 8), "gf4", dev) if words == "random"
               else subnormal_gf4((L, d, k // 8), dev)) for d, k in shapes]
        w1, w3, w2 = ws[1:4]
        for B in MULTIROW_B:
            cases = (((False, False), (True, False), (False, True), (True, True))
                     if words == "random" else ((False, False),))
            for gelu, sub_mean in cases:
                a, r = torch.randn(B, Q, device=dev), torch.randn(B, D, device=dev)
                args = (a, r, g, anx, *ws, 1, gelu, 1e-5, sub_mean)
                what = f"gf4_offn_qkv B={B} gelu={gelu} sub_mean={sub_mean} {words} scales"
                e = (check if words == "random" else check_rows)(
                    what, hq.gf4_offn_qkv(*args), hq.gf4_offn_qkv_plain(*args), TOL_MV)
                worst["gf4_offn_qkv"], n = max(worst["gf4_offn_qkv"], e), n + 1
            for gelu in ((False, True) if words == "random" else (False,)):
                x = torch.randn(B, D, device=dev)
                got, want = hq.gf4_ffn(x, w1, w3, w2, 1, gelu), hq.gf4_ffn_plain(x, w1, w3, w2,
                                                                                 1, gelu)
                e = (check if words == "random" else check_rows)(
                    f"gf4_ffn B={B} gelu={gelu} {words} scales", got, want, TOL_MV)
                worst["gf4_ffn"], n = max(worst["gf4_ffn"], e), n + 1
                if words == "random" and not gelu and B in (8, 16):
                    wd = [dequant(QTensor(w[1], "gf4"), torch.float32).double() for w in ws[1:4]]
                    xd = x.double()
                    ref = (F.silu(xd @ wd[0].T) * (xd @ wd[1].T)) @ wd[2].T
                    exact[f"B={B}"] = (rel_to(got, ref), rel_to(want, ref))
                    del wd, ref
            if words == "random":  # slots 2^20 apart
                args = (spread(B, Q), spread(B, D), g, anx, *ws, 0, False, 1e-5, False)
                e = check_rows(f"gf4_offn_qkv B={B} slots 2^20 apart", hq.gf4_offn_qkv(*args),
                               hq.gf4_offn_qkv_plain(*args), TOL_MV)
                worst["gf4_offn_qkv"], n = max(worst["gf4_offn_qkv"], e), n + 1
                x = spread(B, D)
                e = check_rows(f"gf4_ffn B={B} slots 2^20 apart", hq.gf4_ffn(x, w1, w3, w2, 0, False),
                               hq.gf4_ffn_plain(x, w1, w3, w2, 0, False), TOL_MV)
                worst["gf4_ffn"], n = max(worst["gf4_ffn"], e), n + 1
        del ws, w1, w3, w2
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"# multi-row path, gf4 (B = {', '.join(map(str, MULTIROW_B))}): {n} checks within "
        f"{TOL_MV:g} of max|out| (slots 2^20 apart and subnormal scales: of each slot's), "
        "max_abs_err " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + f"; K6 D={D} H={HID} against the float64 product, each row to its max (kernel / "
        "plain f32): " + ", ".join(f"{k} {a:.2e} / {b:.2e}" for k, (a, b) in exact.items()))


def multirow_checks_gf4_decode(dev, spread):
    """K3 and K7 on the gf4 multi-row path against their plain versions at
    TOL_MV, B = 2, 3, 4, 8, 9, 16. K3 at Aya 23 8B's q (4096 x 4096) and k
    (1024 x 4096), the Mistral-7B (32000 rows) and Aya 23 8B (256000)
    lm-heads, and ragged shapes: d = 1000, n = 1032 (an odd word count a
    row) and n = 8; each with random x and slots 2^20 apart, and but for
    the lm-heads with all-subnormal scale bytes. K7 at one Mistral-7B layer
    with SiLU and GELU, RMSNorm and LayerNorm, slots 2^20 apart and
    subnormal scale bytes, and at Qd = 512 != D. Slots 2^20 apart and
    subnormal scales are held each slot to its own max|out|; K7's ffn and
    r1 each to its own."""
    from calm_tpu_torch.ops import hopper_qmm as hq

    worst = {"qmm_decode_gf4": 0.0, "gf4_offn": 0.0}
    n_k3 = n_k7 = 0

    def words(kind, shape):
        return rand_w(shape, "gf4", dev) if kind == "random" else subnormal_gf4(shape, dev)
    for name, d, n in (("aya q", Q, D), ("aya k", KV, D), ("mistral lm-head", 32000, D),
                       ("aya lm-head", 256000, D), ("ragged", 1000, D),
                       ("odd words", Q, 1032), ("ragged", 1000, 8)):
        L = 1 if "lm-head" in name else 2
        for kind in ("random",) if L == 1 else ("random", "subnormal"):
            w = words(kind, (L, d, n // 8))
            for B in MULTIROW_B:
                cases = [("", torch.randn(B, n, device=dev))]
                if kind == "random":
                    cases.append((" slots 2^20 apart", spread(B, n)))
                for how, x in cases:
                    e = (check_rows if how or kind != "random" else check)(
                        f"qmm_decode_gf4 {name} {d}x{n} B={B} {kind} scales{how}",
                        hq.qmm_decode_gf4(x, w, L - 1), hq.qmm_decode_gf4_plain(x, w, L - 1),
                        TOL_MV)
                    worst["qmm_decode_gf4"], n_k3 = max(worst["qmm_decode_gf4"], e), n_k3 + 1
            del w
            torch.cuda.empty_cache()

    L, eps = 2, 1e-5
    g = 1 + 0.1 * torch.randn(L, D, device=dev)
    for kind in ("random", "subnormal"):
        ws = [words(kind, (L, d, k // 8)) for d, k in ((D, Q), (HID, D), (HID, D), (D, HID))]
        for B in MULTIROW_B:
            cases = (((False, False), (True, False), (False, True), (True, True))
                     if kind == "random" else ((False, False),))
            for gelu, sub_mean in cases:
                args = (torch.randn(B, Q, device=dev), torch.randn(B, D, device=dev), g, *ws,
                        1, gelu, eps, sub_mean)
                what = f"B={B} gelu={gelu} sub_mean={sub_mean} {kind} scales"
                got, want = hq.gf4_offn(*args), hq.gf4_offn_plain(*args)
                e = (max(check_offn(what, got, want)) if kind == "random"
                     else check_rows(f"gf4_offn {what}", got, want, TOL_MV))
                worst["gf4_offn"], n_k7 = max(worst["gf4_offn"], e), n_k7 + 1
            if kind == "random":
                args = (spread(B, Q), spread(B, D), g, *ws, 0, False, eps, False)
                e = check_rows(f"gf4_offn B={B} slots 2^20 apart", hq.gf4_offn(*args),
                               hq.gf4_offn_plain(*args), TOL_MV)
                worst["gf4_offn"], n_k7 = max(worst["gf4_offn"], e), n_k7 + 1
        if kind == "random":  # Qd = 512 != D, the same FFN
            wo = rand_w((L, D, 512 // 8), "gf4", dev)
            for B in MULTIROW_B:
                for gelu in (False, True):  # LayerNorm with GELU
                    args = (torch.randn(B, 512, device=dev), torch.randn(B, D, device=dev), g,
                            wo, *ws[1:], 1, gelu, eps, gelu)
                    e = max(check_offn(f"Qd=512 B={B} gelu={gelu}", hq.gf4_offn(*args),
                                       hq.gf4_offn_plain(*args)))
                    worst["gf4_offn"], n_k7 = max(worst["gf4_offn"], e), n_k7 + 1
            del wo
        del ws
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    log(f"# multi-row path, gf4 K3 and K7 (B = {', '.join(map(str, MULTIROW_B))}): {n_k3} K3 "
        f"and {n_k7} K7 checks within {TOL_MV:g} of max|out| (slots 2^20 apart and subnormal "
        "scales: of each slot's; K7's ffn and r1 each to its own), max_abs_err "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))


def ragged_checks_paged(dev):
    """K12 paged on shapes the serving row does not reach: pages of 16, 64
    and 512 rows, 1, 3 and 16 slots, kv_len off a page boundary, the stale
    row inside a page, dead entries at a parking page filled with large
    values (a read of it would show), head_dim 64 with 16 query rows per kv
    head, every cache dtype, plain and fresh mode; K13 on slots 3 and 3-4
    of a 5-slot cache."""
    from calm_tpu_torch.ops import hopper_attn as ha

    worst, n = 0.0, 0
    L, S = 2, 1024
    gen = torch.Generator().manual_seed(5)
    for kvd in (torch.float16, torch.bfloat16, torch.float8_e5m2):
        for hd, M in ((64, 16), (128, 4)):
            for PR in (16, 64, 512):
                for B in (1, 3, 16):
                    KVH, nb = 2, S // PR
                    parking = B * nb
                    kq = kv_rand((L, parking + 1, KVH, PR, hd), kvd, dev)
                    vq = kv_rand((L, parking + 1, KVH, PR, hd), kvd, dev)
                    kq[:, parking] = torch.full_like(kq[:, parking], 3e4, dtype=torch.float32)
                    vq[:, parking] = torch.full_like(vq[:, parking], 3e4, dtype=torch.float32)
                    order = torch.randperm(parking, generator=gen).reshape(B, nb)
                    kl = torch.randint(1, S + 1, (B,), generator=gen)
                    kl[0] = PR - 5                  # slot 0: one block, the rest dead
                    order[0, 1:] = parking
                    kp = (torch.rand(B, generator=gen) * kl).to(torch.int32).to(dev)
                    kl = kl.to(torch.int32).to(dev)
                    pt = order.to(torch.int32).to(dev)
                    q = torch.randn(B, KVH * M, hd, device=dev)
                    fr = (kv_rand((B, KVH, hd), kvd, dev), kv_rand((B, KVH, hd), kvd, dev), kp)
                    for fresh in (None, fr):
                        e = max_err(ha.decode_attention(q, kq, vq, kl, 1, fresh, pt=pt),
                                    ha.decode_attention_plain(q, kq, vq, kl, 1, fresh, pt=pt))
                        if not e <= TOL_DA:
                            fail(f"decode_attention paged {kvd} hd={hd} PR={PR} B={B} "
                                 f"fresh={fresh is not None}: {e:.3e} > {TOL_DA}")
                        worst, n = max(worst, e), n + 1
    e13 = 0.0
    for B in (1, 2):
        kc = kv_rand((2, 5, 2, 512, 128), torch.bfloat16, dev)
        vc = kv_rand((2, 5, 2, 512, 128), torch.bfloat16, dev)
        q = torch.randn(B, 37, 2, 4, 128, device=dev)
        p0 = torch.tensor([100, 7][:B], dtype=torch.int32, device=dev)
        e13 = max(e13, check(f"prefill_attention batch_off 3 of 5, B={B}",
                             ha.prefill_attention(q, kc, vc, p0, p0 + 37, 1, batch_off=3),
                             ha.prefill_attention_plain(q, kc, vc, p0, p0 + 37, 1, 3),
                             TOL_ATT))
    torch.cuda.synchronize()
    log(f"# ragged shapes (paged): {n} K12 paged checks, max_abs_err {worst:.3e} "
        f"(tol {TOL_DA:g}); K13 from slot 3 of 5, max_abs_err {e13:.3e} "
        f"(tol {TOL_ATT:g} x max|out|)")


def ragged_checks_tilings(dev):
    """The corners of K12's tiles and chunks and K4's tiles: kv_len below
    one tile and off a tile edge (64-row tiles; 32 at hd 256), the stale
    row on a tile edge, pages of 16 and 32 rows (shorter than a tile) and
    of 1024, each paged run torch.equal to dense mode on the same rows,
    every cache dtype; ``batch_off`` from slot 3 of 5 in plain, fresh and
    partials mode, equal to the slots sliced out; K4/K5 at R = 32 with d
    and the words a row off their tiles."""
    from calm_tpu_torch.ops import hopper_attn as ha
    from calm_tpu_torch.ops import hopper_qmm as hq

    worst, n = 0.0, 0
    gen = torch.Generator().manual_seed(17)
    L, S, KVH, M = 2, 2048, 2, 4
    for kvd in (torch.float16, torch.bfloat16, torch.float8_e5m2):
        for hd in (128, 256):
            tr = 32 if hd > 128 else 64
            kl = torch.tensor([1, tr - 1, tr + 1, 3 * tr, S - 1], dtype=torch.int32)
            kp = torch.tensor([0, tr - 2, tr, 2 * tr - 1, tr], dtype=torch.int32)
            B = len(kl)
            kc, vc = kv_rand((L, B, KVH, S, hd), kvd, dev), kv_rand((L, B, KVH, S, hd), kvd, dev)
            q = torch.randn(B, KVH * M, hd, device=dev)
            kl, kp = kl.to(dev), kp.to(dev)
            fr = (kv_rand((B, KVH, hd), kvd, dev), kv_rand((B, KVH, hd), kvd, dev), kp)
            for fresh in (None, fr):
                dense = ha.decode_attention(q, kc, vc, kl, 1, fresh)
                e = max_err(dense, ha.decode_attention_plain(q, kc, vc, kl, 1, fresh))
                if not e <= TOL_DA:
                    fail(f"decode_attention tiles {kvd} hd={hd} fresh={fresh is not None}: "
                         f"{e:.3e} > {TOL_DA}")
                worst, n = max(worst, e), n + 1
                for PR in (16, 32, 1024):
                    order = torch.randperm(B * (S // PR), generator=gen).reshape(B, -1)
                    pt = order.to(torch.int32).to(dev)
                    kq, vq = to_pages(kc, PR, pt), to_pages(vc, PR, pt)
                    got = ha.decode_attention(q, kq, vq, kl, 1, fresh, pt=pt)
                    e = max_err(got, ha.decode_attention_plain(q, kq, vq, kl, 1, fresh, pt=pt))
                    if not e <= TOL_DA or not torch.equal(got, dense):
                        fail(f"decode_attention paged PR={PR} {kvd} hd={hd} fresh="
                             f"{fresh is not None}: {e:.3e} against the plain version, or "
                             f"not equal to dense mode")
                    worst, n = max(worst, e), n + 1
                    del kq, vq
    # batch_off: two slots from slot 3 of a 5-slot cache
    for kvd in (torch.bfloat16, torch.float8_e5m2):
        B, off, hd = 2, 3, 128
        kc, vc = kv_rand((L, 5, KVH, S, hd), kvd, dev), kv_rand((L, 5, KVH, S, hd), kvd, dev)
        q = torch.randn(B, KVH * M, hd, device=dev)
        kl = torch.tensor([700, S], dtype=torch.int32, device=dev)
        fr = (kv_rand((B, KVH, hd), kvd, dev), kv_rand((B, KVH, hd), kvd, dev),
              torch.tensor([64, 5], dtype=torch.int32, device=dev))
        ks, vs = kc[:, off:off + B].contiguous(), vc[:, off:off + B].contiguous()
        for fresh in (None, fr):
            got = ha.decode_attention(q, kc, vc, kl, 1, fresh, batch_off=off)
            e = max_err(got, ha.decode_attention_plain(q, kc, vc, kl, 1, fresh, batch_off=off))
            if not e <= TOL_DA or not torch.equal(got, ha.decode_attention(q, ks, vs, kl, 1, fresh)):
                fail(f"decode_attention batch_off 3 of 5 {kvd} fresh={fresh is not None}: "
                     f"{e:.3e}, or not equal to the slots sliced out")
            worst, n = max(worst, e), n + 1
        kl0 = torch.tensor([0, 1500], dtype=torch.int32, device=dev)
        got = ha.decode_attention(q, kc, vc, kl0, 1, partials=True, batch_off=off)
        check_partials(f"decode_attention_partials batch_off 3 of 5 {kvd}", got,
                       ha.decode_attention_partials_plain(q, kc, vc, kl0, 1, batch_off=off))
        if not all(torch.equal(g, w) for g, w in zip(
                got, ha.decode_attention(q, ks, vs, kl0, 1, partials=True))):
            fail(f"decode_attention_partials batch_off {kvd}: not equal to the slots sliced out")
        n += 1
    e4 = 0.0
    for d, n8 in ((1003, 125), (4096, 1376), (200, 8)):
        w = rand_w((2, d, n8), "gf4", dev)
        x = torch.randn(32, 8 * n8, device=dev)
        for fn in (hq.qmm_prefill, hq.qmm_prefill_w2):
            e4 = max(e4, check(f"{fn.__name__} {d}x{8 * n8} R=32", fn(x, w, 1),
                               hq.qmm_prefill_plain(x, w, 1), TOL_MM))
    torch.cuda.synchronize()
    log(f"# ragged shapes (tiles): {n} K12 checks (kv_len below and off a tile, the stale "
        f"row on a tile edge, pages of 16/32/1024 rows equal to dense, batch_off 3 of 5), "
        f"max_abs_err {worst:.3e} (tol {TOL_DA:g}); K4/K5 at R=32, max_abs_err {e4:.3e} "
        f"(tol {TOL_MM:g} x max|y|)")


def epilogue_chain(a, r, g, anx, wb, L):
    """K8's and K9's function as bf16 torch.matmul calls on planes
    dequantized beforehand: wo + residual, ffn-norm, w1/w3 + SiLU, w2 +
    residual, attn-norm, q/k/v; the library yardstick of both."""
    import torch.nn.functional as F

    def chain(i):
        l = i % L
        r1 = r + torch.matmul(a.bfloat16(), wb[0][l].T)
        xn = (r1 * torch.rsqrt(r1.pow(2).mean(-1, keepdim=True) + 1e-5) * g[l]).bfloat16()
        h = F.silu(torch.matmul(xn, wb[1][l].T)) * torch.matmul(xn, wb[2][l].T)
        x = r1 + torch.matmul(h, wb[3][l].T)
        xq = (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-5) * anx[l]).bfloat16()
        return [torch.matmul(xq, w[l].T) for w in wb[4:]]
    return chain


EXPERTS = 8  # Mixtral 8x7B, 2 active (bench.py:54-56)


def moe_kernel_rows(gbps, dev):
    """K10 and K11 at Mixtral 8x7B shapes (dim 4096, hidden 14336, 8
    experts), B=1, two live slots: K10 fp8 and fp16 at w1 (shared x) and
    w2 (x per slot), its gf4 body at w1; K11 one layer's expert FFN. Two
    layer stacks cycled, so a call finds none of its planes in L2."""
    import torch.nn.functional as F

    from calm_tpu_torch.ops import hopper_qmm as hq
    from calm_tpu_torch.ops.qmm import QTensor, dequant

    rows = {}
    L, E, B = 2, EXPERTS, 1
    ids = torch.tensor([1, 5], dtype=torch.int32, device=dev)
    cnt = torch.tensor([2], dtype=torch.int32, device=dev)
    A = ids.shape[0]
    errs, best = [], None
    for fmt, name, d, n in (("fp8", "w1", HID, D), ("fp8", "w2", D, HID),
                            ("fp16", "w1", HID, D), ("fp16", "w2", D, HID),
                            ("gf4", "w1", HID, D)):
        gs = 8 if fmt == "gf4" else 1
        esz = {"fp8": 1, "fp16": 2, "gf4": 0.5}[fmt]
        w = rand_w((L, E, d, n // gs), fmt, dev)
        x = torch.randn(A if name == "w2" else 1, B, n, device=dev)
        got = hq.qmm_moe_dense(x, w, ids, cnt, fmt, L - 1)
        errs.append(check(f"qmm_moe_dense {fmt} {name}", got,
                          hq.qmm_moe_dense_plain(x, w, ids, cnt, fmt, L - 1), TOL_MV))
        wb = dequant(QTensor(w[:, ids.long()], fmt), torch.bfloat16).transpose(2, 3)
        xb = x.bfloat16().expand(A, -1, -1)
        b, by = bound_ms(A * d * n * esz + 4 * (x.numel() + A * B * d),
                         2 * A * B * d * n, gbps)
        t = timings(lambda i: hq.qmm_moe_dense(x, w, ids, cnt, fmt, i % L),
                    lambda i: hq.qmm_moe_dense_plain(x, w, ids, cnt, fmt, i % L),
                    lambda i: torch.bmm(xb, wb[i % L]), bound=b)
        log(f"# K10 qmm_moe_dense {fmt} {name} {d}x{n}, 2 of {E} experts, B=1, "
            f"Ax={x.shape[0]}: max_abs_err {errs[-1]:.3e} (tol {TOL_MV:g} x max|y|); "
            f"{ms_line(t)} (bf16 bmm, pre-dequantized live planes) bound_ms {b:.4f} "
            f"({by}, {A * d * n * esz / 1e6:.1f} MB); {share(t, b)}")
        if fmt == "fp8" and name == "w1":
            best = dict(t, bound_ms=b, bound_by=by)
        del w, wb
    rows["qmm_moe_dense"] = dict(best, max_abs_err=max(errs))

    # K11: one layer's expert FFN, gf4 words
    w1, w3 = (rand_w((L, E, HID, D // 8), "gf4", dev) for _ in range(2))
    w2 = rand_w((L, E, D, HID // 8), "gf4", dev)
    x = torch.randn(B, D, device=dev)
    err = check("gf4_moe_ffn Mixtral", hq.gf4_moe_ffn(x, w1, w3, w2, ids, cnt, L - 1, False),
                hq.gf4_moe_ffn_plain(x, w1, w3, w2, ids, cnt, L - 1, False), TOL_MV)
    wb = [dequant(QTensor(w[:, ids.long()], "gf4"), torch.bfloat16).transpose(2, 3)
          for w in (w1, w3, w2)]
    xb = x.bfloat16().expand(A, -1, -1)

    def bmm_chain(i):
        l = i % L
        h = F.silu(torch.bmm(xb, wb[0][l])) * torch.bmm(xb, wb[1][l])
        return torch.bmm(h, wb[2][l])
    n_w = A * 3 * HID * D
    b, by = bound_ms(n_w // 2 + 4 * (B * D + A * B * D), 2 * B * n_w, gbps)
    t = timings(lambda i: hq.gf4_moe_ffn(x, w1, w3, w2, ids, cnt, i % L, False),
                lambda i: hq.gf4_moe_ffn_plain(x, w1, w3, w2, ids, cnt, i % L, False),
                bmm_chain, bound=b)
    log(f"# K11 gf4_moe_ffn D={D} H={HID}, 2 of {E} experts, B=1: max_abs_err "
        f"{err:.3e} (tol {TOL_MV:g} x max|z|); {ms_line(t)} (3 bf16 bmm, "
        f"pre-dequantized live planes) bound_ms {b:.4f} ({by}, {n_w / 2e6:.1f} MB); "
        f"{share(t, b)}")
    rows["gf4_moe_ffn"] = dict(t, bound_ms=b, bound_by=by, max_abs_err=err)
    del w1, w3, w2, wb
    torch.cuda.empty_cache()
    return rows


def ragged_checks_moe(dev):
    """K10 and K11 on shapes the Mixtral rows do not reach: one row on
    ``csrc/moe.cu``'s loops, 2-16 rows on the multi-row path; B = 1, 2, 3,
    5 and 16; eight experts in four slots, the last one dead (ids [0, 3, 6,
    6], cnt 3: its output must be exactly 0), or all live with ids
    repeated as ep's fill repeats a local one ([5, 5, 2, 2], cnt 4); d =
    1003, a hidden width of 11008 (1376 words), model widths of 1040 (130
    words) and, for gf4, 1032 (129: an odd word count a row); x shared and
    per slot; SiLU and GELU. fp8 rows of 1044 values (not whole 16-value
    steps) stay on moe.cu's loop at every B, and the multi-row counters
    show which path each call took."""
    from calm_tpu_torch.ops import hopper_qmm as hq

    slot_sets = [(torch.tensor([0, 3, 6, 6], dtype=torch.int32, device=dev), 3),
                 (torch.tensor([5, 5, 2, 2], dtype=torch.int32, device=dev), 4)]
    worst = {"qmm_moe_dense": 0.0, "qmm_moe_ffn": 0.0, "gf4_moe_ffn": 0.0}
    n_checks = 0

    def dead_zero(what, out, live):
        if live < out.shape[0] and out[live:].abs().max().item() != 0:
            fail(f"{what}: the dead slot is not zero")

    def took(fn, before, want, what):  # the path the wrapper's counters show
        if fn.multirow_launches - before != want:
            fail(f"{what}: {fn.multirow_launches - before} multi-row launches, not {want}")

    for fmt, d, n in (("fp8", 1003, 1040), ("fp16", 1003, 1040), ("gf4", 1003, 11008),
                      ("gf4", 1003, 1032), ("fp8", 1003, 1044)):
        w = rand_w((2, EXPERTS, d, n // (8 if fmt == "gf4" else 1)), fmt, dev)
        for B in (1, 2, 3, 5, 16):
            multirow = hq.moe_multirow_supported(fmt, B, n)
            if multirow != (B > 1 and n != 1044):
                fail(f"qmm_moe_dense {fmt} n={n} B={B}: the path's choice is {multirow}")
            for Ax in (1, 4):
                for ids, cnt_n in slot_sets:
                    cnt = torch.tensor([cnt_n], dtype=torch.int32, device=dev)
                    x = torch.randn(Ax, B, n, device=dev)
                    before = hq.qmm_moe_dense.multirow_launches
                    got = hq.qmm_moe_dense(x, w, ids, cnt, fmt, 1)
                    took(hq.qmm_moe_dense, before, int(multirow), f"qmm_moe_dense {fmt} n={n}")
                    dead_zero(f"qmm_moe_dense {fmt} B={B}", got, cnt_n)
                    e = check(f"qmm_moe_dense {fmt} {d}x{n} B={B} Ax={Ax} cnt={cnt_n}", got,
                              hq.qmm_moe_dense_plain(x, w, ids, cnt, fmt, 1), TOL_MV)
                    worst["qmm_moe_dense"] = max(worst["qmm_moe_dense"], e)
                    n_checks += 1
        del w
    for fmt, Dm, Hm in (("fp8", 1040, 11008), ("fp16", 1040, 11008), ("gf4", 1040, 11008),
                        ("gf4", 1032, 11008)):
        gs = 8 if fmt == "gf4" else 1
        w1, w3 = (rand_w((2, EXPERTS, Hm, Dm // gs), fmt, dev) for _ in range(2))
        w2 = rand_w((2, EXPERTS, Dm, Hm // gs), fmt, dev)
        for B in ((1, 2, 3, 5, 16) if fmt == "gf4" else (2, 3, 5, 16)):
            for gelu in (False, True):
                for ids, cnt_n in slot_sets:
                    cnt = torch.tensor([cnt_n], dtype=torch.int32, device=dev)
                    x = torch.randn(B, Dm, device=dev)
                    if fmt == "gf4":
                        key, fn = "gf4_moe_ffn", hq.gf4_moe_ffn
                        before = fn.multirow_launches
                        got = fn(x, w1, w3, w2, ids, cnt, 1, gelu)
                        want = hq.gf4_moe_ffn_plain(x, w1, w3, w2, ids, cnt, 1, gelu)
                    else:
                        key, fn = "qmm_moe_ffn", hq.qmm_moe_ffn
                        before = fn.multirow_launches
                        got = fn(x, w1, w3, w2, ids, cnt, fmt, 1, gelu)
                        want = hq.qmm_moe_ffn_plain(x, w1, w3, w2, ids, cnt, fmt, 1, gelu)
                    took(fn, before, int(B > 1), f"{key} {fmt} B={B}")
                    dead_zero(f"{key} {fmt} B={B}", got, cnt_n)
                    e = check(f"{key} {fmt} D={Dm} H={Hm} B={B} gelu={gelu} cnt={cnt_n}", got,
                              want, TOL_MV)
                    worst[key] = max(worst[key], e)
                    n_checks += 1
        del w1, w3, w2
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"# ragged shapes (MoE): {n_checks} checks, max_abs_err " + ", ".join(
        f"{k} {v:.3e}" for k, v in worst.items()) + f" (tol {TOL_MV:g} x max|out|)")


MOE_SLOTS = 8  # the Mixtral serving tick's expert slots: min(8 experts, 8 rows x top-2)


def moe_ffn_wrapper(hq):
    """The fp8/fp16 expert FFN at 2-16 rows as ``model._moe_sweep`` calls
    it: ``qmm_moe_ffn``, or on a tree without it the three
    ``qmm_moe_dense`` launches and the activation it ran before."""
    f = getattr(hq, "qmm_moe_ffn", None)
    if f is not None:
        return f

    def three(x, w1, w3, w2, eidx, cnt, fmt, layer, act_gelu):
        x1 = x[None]
        h = (hq.act(hq.qmm_moe_dense(x1, w1, eidx, cnt, fmt, layer), act_gelu)
             * hq.qmm_moe_dense(x1, w3, eidx, cnt, fmt, layer))
        return hq.qmm_moe_dense(h, w2, eidx, cnt, fmt, layer)
    return three


def moe_ffn_plain(hq, x, w1, w3, w2, eidx, cnt, fmt, layer, act_gelu):
    """The expert FFN's plain version: three ``qmm_moe_dense_plain`` calls
    and the activation."""
    x1 = x[None]
    h = (hq.act(hq.qmm_moe_dense_plain(x1, w1, eidx, cnt, fmt, layer), act_gelu)
         * hq.qmm_moe_dense_plain(x1, w3, eidx, cnt, fmt, layer))
    return hq.qmm_moe_dense_plain(h, w2, eidx, cnt, fmt, layer)


def moe_multirow_kernel_rows(gbps, dev):
    """K10 and K11 at 2-16 rows on Mixtral 8x7B shapes (dim 4096, hidden
    14336, 8 experts) in MOE_SLOTS expert slots, all live (cnt 8) and one
    dead (cnt 7: its output must be exactly 0): K10 fp8 and fp16 at w1 (x
    shared, Ax = 1) and w2 (x per slot, Ax = A), its gf4 body at w1, the
    fp8 expert FFN as ``model._moe_sweep`` calls it (``moe_ffn_wrapper``),
    and K11 (one layer's gf4 expert FFN). B = 8 (the serving tick's rows)
    timed beside its bound (the live slots' weight bytes), plain version
    and library call (``torch.bmm`` on the live planes dequantized
    beforehand), B = 4 and 16 checked; two layer stacks cycled past the 50
    MB L2. Calls the wrappers only, so it also times an older tree's
    package (``chip_compare.py``). The B = 8, cnt = 8 FFN rows go to the
    kernels line."""
    import torch.nn.functional as F

    from calm_tpu_torch.ops import hopper_qmm as hq
    from calm_tpu_torch.ops.qmm import QTensor, dequant

    rows = {}
    L, E, A = 2, EXPERTS, MOE_SLOTS
    ids = torch.tensor([0, 1, 2, 3, 4, 5, 6, 7], dtype=torch.int32, device=dev)
    cnts = {n: torch.tensor([n], dtype=torch.int32, device=dev) for n in (A, A - 1)}
    esz = {"fp8": 1, "fp16": 2, "gf4": 0.5}

    def dead_zero(what, out, live):
        if live < A and out[live:].abs().max().item() != 0:
            fail(f"{what}: a dead slot is not zero")

    def lib_planes(w, fmt, live):  # (L, live, n, d) bf16
        return dequant(QTensor(w[:, ids[:live].long()], fmt), torch.bfloat16).transpose(2, 3)

    for fmt, name, d, n in (("fp8", "w1", HID, D), ("fp8", "w2", D, HID),
                            ("fp16", "w1", HID, D), ("fp16", "w2", D, HID),
                            ("gf4", "w1", HID, D)):
        gs = 8 if fmt == "gf4" else 1
        w = rand_w((L, E, d, n // gs), fmt, dev)
        Ax = A if name == "w2" else 1
        for live, cnt in cnts.items():
            wb = lib_planes(w, fmt, live)
            for B in (4, 8, 16):
                x = torch.randn(Ax, B, n, device=dev)
                got = hq.qmm_moe_dense(x, w, ids, cnt, fmt, L - 1)
                dead_zero(f"qmm_moe_dense {fmt} {name} B={B}", got, live)
                e = check(f"qmm_moe_dense {fmt} {name} B={B} cnt={live}", got,
                          hq.qmm_moe_dense_plain(x, w, ids, cnt, fmt, L - 1), TOL_MV)
                if B != 8:
                    continue
                xb = x.bfloat16()[:live] if Ax > 1 else x.bfloat16().expand(live, -1, -1)
                nb = live * d * n * esz[fmt]
                b, by = bound_ms(nb + 4 * (x.numel() + A * B * d), 2 * live * B * d * n,
                                 gbps, PEAK_BF16)
                t = timings(lambda i: hq.qmm_moe_dense(x, w, ids, cnt, fmt, i % L),
                            lambda i: hq.qmm_moe_dense_plain(x, w, ids, cnt, fmt, i % L),
                            lambda i: torch.bmm(xb, wb[i % L]), bound=b)
                log(f"# K10 qmm_moe_dense {fmt} {name} {d}x{n}, {live} live of {A} slots, "
                    f"B={B}, Ax={Ax}: max_abs_err {e:.3e} (tol {TOL_MV:g} x max|y|); "
                    f"{ms_line(t)} (bf16 bmm, pre-dequantized live planes) bound_ms {b:.4f} "
                    f"({by}, {nb / 1e6:.1f} MB); {share(t, b)}")
            del wb
        del w
        torch.cuda.empty_cache()

    # the expert FFN of one layer: fp8 as _moe_sweep calls it, and K11 (gf4)
    for fmt in ("fp8", "gf4"):
        gs = 8 if fmt == "gf4" else 1
        w1, w3 = (rand_w((L, E, HID, D // gs), fmt, dev) for _ in range(2))
        w2 = rand_w((L, E, D, HID // gs), fmt, dev)
        if fmt == "gf4":
            key, what, fn = "gf4_moe_ffn", "K11 gf4_moe_ffn", (
                lambda x, cnt, l: hq.gf4_moe_ffn(x, w1, w3, w2, ids, cnt, l, False))
            plain = lambda x, cnt, l: hq.gf4_moe_ffn_plain(x, w1, w3, w2, ids, cnt, l, False)
        else:
            key, what, ffn = "qmm_moe_ffn", "K10 fp8 expert FFN", moe_ffn_wrapper(hq)
            fn = lambda x, cnt, l: ffn(x, w1, w3, w2, ids, cnt, fmt, l, False)
            plain = lambda x, cnt, l: moe_ffn_plain(hq, x, w1, w3, w2, ids, cnt, fmt, l, False)
        for live, cnt in cnts.items():
            wb = [lib_planes(w, fmt, live) for w in (w1, w3, w2)]
            for B in (4, 8, 16):
                x = torch.randn(B, D, device=dev)
                got = fn(x, cnt, L - 1)
                dead_zero(f"{key} B={B}", got, live)
                e = check(f"{key} Mixtral B={B} cnt={live}", got, plain(x, cnt, L - 1), TOL_MV)
                if B != 8:
                    continue
                xb = x.bfloat16().expand(live, -1, -1)

                def bmm_chain(i, xb=xb, wb=wb):
                    l = i % L
                    h = F.silu(torch.bmm(xb, wb[0][l])) * torch.bmm(xb, wb[1][l])
                    return torch.bmm(h, wb[2][l])
                nb = live * 3 * HID * D * esz[fmt]
                b, by = bound_ms(nb + 4 * (B * D + A * B * D), 2 * B * live * 3 * HID * D,
                                 gbps, PEAK_BF16)
                t = timings(lambda i: fn(x, cnt, i % L), lambda i: plain(x, cnt, i % L),
                            bmm_chain, bound=b)
                log(f"# {what} D={D} H={HID}, {live} live of {A} slots, B={B}: max_abs_err "
                    f"{e:.3e} (tol {TOL_MV:g} x max|z|); {ms_line(t)} (3 bf16 bmm, "
                    f"pre-dequantized live planes) bound_ms {b:.4f} ({by}, {nb / 1e6:.1f} MB); "
                    f"{share(t, b)}")
                if live == A:
                    rows[key + "_multirow"] = dict(t, bound_ms=b, bound_by=by, max_abs_err=e)
                    by_kernel(lambda i: fn(x, cnt, i % L), f"{what} B=8 cnt={live}")
            del wb
        del w1, w3, w2
        torch.cuda.empty_cache()
    return rows


# -- the wide multi-row path: 17-64 rows (a verify's 8 x 5, ticks of 17-64) --

WIDE_B = (24, 40, 64)              # the wide path's timed rows; 40: a served verify's 8 x 5
WIDE_CHECK_B = (17, 24, 33, 40, 64)  # one n-tile past 16, each side of 32, the verify, the most
# the wide path's default: x in one f16 term with one scale a row (2^-12 of
# each value, rounded), f32 sums; a dropped row scale or term reads ~1
TOL_WIDE = 2e-3
OLMOE = dict(dim=2048, hidden_dim=1024, experts=64, topk=8)  # OLMoE-1B-7B (HF config)


def wide_count(hq) -> int:
    """The wide path's launches so far, over its wrappers."""
    return sum(getattr(f, "wide_launches", 0) for f in (
        hq.qmm_decode, hq.qmm_decode_gf4, hq.qmm_moe_dense, hq.qmm_moe_ffn, hq.gf4_moe_ffn))


def wide_took(hq, what, run, n: int = 1):
    """run() on the wide path: its wrappers' wide launches grow by n."""
    before = wide_count(hq)
    out = run()
    if wide_count(hq) != before + n:
        fail(f"{what}: {wide_count(hq) - before} wide launches, not {n}")
    return out


WIDE_TWICE = []  # the wide calls held bit-equal to an identical second call


def wide_twice(hq, what, run):
    """run() twice on the wide path, one wide launch each: the two results
    bit for bit the same (the k parts' sums meet in a fixed order, no
    atomics)."""
    a = wide_took(hq, what, run)
    b = wide_took(hq, what, run)
    if not torch.equal(a, b):
        fail(f"{what}: two identical calls differ, by {(a - b).abs().max().item():.3e}")
    WIDE_TWICE.append(what)
    return a


def wide_checks(dev):
    """The wide path (17-64 rows) against the plain versions on ragged
    shapes: K2 fp16/fp8/fp8e4 and K3 gf4 (rows of an odd word count, and
    of n % 32 != 0, on ``mmw_kernel``; the rest on ``wide_kernel``) at
    WIDE_CHECK_B rows, every third row 2^20 larger (each row to its own
    max, TOL_WIDE), each launch seen on ``.wide_launches``; under
    --precise at 40 rows against the plain f32 version (TOL_MV) and the
    float64 product (PRECISE_F64_LIMIT); the expert sweep (K10 with x
    shared and a slot's own, the fp8/fp8e4 expert FFN, K11) at 17, 40 and
    64 rows over 8 slots with one dead (exactly zero). Every call is made
    twice, the two results bit-equal (``wide_twice``)."""
    from calm_tpu_torch.ops import hopper_qmm as hq
    from calm_tpu_torch.ops import qmm as tqmm

    def spread(B, n):
        x = torch.randn(B, n, device=dev)
        x[::3] *= 2.0 ** 20
        return x

    for fmt in ("fp16", "fp8", "fp8e4", "gf4"):
        gs = 8 if fmt == "gf4" else 1
        for d, n in ((1000, 1040), (4096, 4096)) + (((24, 1032), (200, 8)) if fmt == "gf4"
                                                     else ()):
            w = (e4m3_rand((2, d, n), dev, True) if fmt == "fp8e4"
                 else rand_w((2, d, n // gs), fmt, dev))
            sc = pow2_scales((2, 1), dev, 1) if fmt == "fp8e4" else None
            for B in WIDE_CHECK_B:
                x = spread(B, n)
                got = wide_twice(hq, f"qmm_decode {fmt} {d}x{n} B={B}",
                                 lambda: hq.qmm_decode(x, w, fmt, 1, sc))
                check_rows(f"qmm_decode_wide {fmt} {d}x{n} B={B}", got,
                           hq.qmm_decode_plain(x, w, fmt, 1, sc), TOL_WIDE)
    log(f"# wide path (17-64 rows) K2/K3 checks: fp16/fp8/fp8e4/gf4, B in {WIDE_CHECK_B}, "
        f"rows 2^20 apart, ragged and odd-word shapes within TOL_WIDE {TOL_WIDE:g} of each "
        f"row's max; worst {WORST_REL.get('qmm_decode_wide', 0):.3e}")

    # --precise: x in hi + lo on the same launches
    B, d, n = 40, 4096, 4096
    for fmt in ("fp8", "gf4"):
        gs = 8 if fmt == "gf4" else 1
        w = rand_w((1, d, n // gs), fmt, dev)
        w64 = tqmm.dequant(tqmm.QTensor(w[0], fmt), torch.float32).double().T
        x = torch.randn(B, n, device=dev)
        tqmm.enable_precise(True)
        try:
            got = wide_twice(hq, f"qmm_decode {fmt} precise B={B}",
                             lambda: hq.qmm_decode(x, w, fmt, 0))
        finally:
            tqmm.enable_precise(False)
        e = check(f"qmm_decode_wide_precise {fmt} B={B}", got,
                  hq.qmm_decode_plain(x, w, fmt, 0), TOL_MV)
        exact = x.double() @ w64
        f64 = ((got.double() - exact).abs().amax(-1) / exact.abs().amax(-1)).max().item()
        one = hq.qmm_decode(x, w, fmt, 0)
        f64_one = ((one.double() - exact).abs().amax(-1) / exact.abs().amax(-1)).max().item()
        if f64 > PRECISE_F64_LIMIT:
            fail(f"qmm_decode {fmt} wide --precise B={B}: {f64:.3e} from the float64 "
                 f"product > {PRECISE_F64_LIMIT:g}")
        log(f"# wide path --precise {fmt} {d}x{n} B={B}: max_abs_err {e:.3e} against the "
            f"f32 plain version (tol {TOL_MV:g} x max|y|); from the float64 product, each "
            f"row to its max: {f64:.3e} (limit {PRECISE_F64_LIMIT:g}), the default's one "
            f"term {f64_one:.3e}")

    # the expert sweep: 8 slots, 7 live
    A = 8
    ids = torch.tensor([3, 0, 5, 1, 7, 2, 6, 4], dtype=torch.int32, device=dev)
    cnt = torch.tensor([7], dtype=torch.int32, device=dev)
    for fmt in ("fp8", "fp8e4", "gf4", "fp16"):
        gs = 8 if fmt == "gf4" else 1
        Dm, Hm = (1032, 1040) if fmt == "gf4" else (1024, 1040)
        mk = (lambda sh: e4m3_rand(sh, dev)) if fmt == "fp8e4" else (
            lambda sh: rand_w(sh, fmt, dev))
        w1, w3 = (mk((2, A, Hm, Dm // gs)) for _ in range(2))
        w2 = mk((2, A, Dm, Hm // gs))
        scs = tuple(pow2_scales((2, A, 1), dev, k) for k in range(3)) if fmt == "fp8e4" \
            else (None, None, None)
        for B in (17, 40, 64):
            for Ax in (1, A):
                x = torch.randn(Ax, B, Dm, device=dev)
                got = wide_twice(hq, f"qmm_moe_dense {fmt} B={B} Ax={Ax}",
                                 lambda: hq.qmm_moe_dense(x, w1, ids, cnt, fmt, 1, scs[0]))
                if got[7:].abs().max().item() != 0:
                    fail(f"qmm_moe_dense {fmt} wide B={B}: a dead slot is not zero")
                check_rows(f"qmm_moe_dense_wide {fmt} B={B} Ax={Ax}", got[:7],
                           hq.qmm_moe_dense_plain(x, w1, ids, cnt, fmt, 1, scs[0])[:7],
                           TOL_WIDE)
            if fmt == "fp16":
                continue
            x = torch.randn(B, Dm, device=dev)
            if fmt == "gf4":
                got = wide_twice(hq, f"gf4_moe_ffn B={B}",
                                 lambda: hq.gf4_moe_ffn(x, w1, w3, w2, ids, cnt, 1, False))
                want = hq.gf4_moe_ffn_plain(x, w1, w3, w2, ids, cnt, 1, False)
            else:
                got = wide_twice(hq, f"qmm_moe_ffn {fmt} B={B}",
                                 lambda: hq.qmm_moe_ffn(x, w1, w3, w2, ids, cnt, fmt, 1,
                                                        True, scs))
                want = hq.qmm_moe_ffn_plain(x, w1, w3, w2, ids, cnt, fmt, 1, True, scs)
            if got[7:].abs().max().item() != 0:
                fail(f"{fmt} expert FFN wide B={B}: a dead slot is not zero")
            # the FFN's h passes through a second staging: twice the one-term error
            check_rows(f"moe_ffn_wide {fmt} B={B}", got[:7], want[:7], 2 * TOL_WIDE)
        del w1, w3, w2
    log(f"# wide path expert sweep checks: K10 fp16/fp8/fp8e4/gf4 (x shared and a slot's "
        f"own), the fp8/fp8e4 FFN (GELU), K11, B = 17, 40, 64, 7 live of 8 slots, the dead "
        f"slot zero; worst rel. to a row's max: K10 {WORST_REL.get('qmm_moe_dense_wide', 0):.3e}, "
        f"FFN {WORST_REL.get('moe_ffn_wide', 0):.3e}; {len(WIDE_TWICE)} calls of "
        f"qmm_decode, qmm_moe_dense, qmm_moe_ffn and gf4_moe_ffn each bit-equal to a second "
        f"identical call")
    torch.cuda.empty_cache()


def grouped_library(w1, w3, w2, fmt, scales, E: int, B: int, topk: int, act_gelu=False):
    """The route the wide path replaced for an expert FFN of B rows
    (``model._moe_grouped`` through the library: each live expert's routed
    rows, a bf16 copy of each plane and ``torch.mm``, ``library_mm``), for
    routing that gives each of the E experts B topk / E rows: lib(i, x) over
    layer i % L."""
    from calm_tpu_torch.ops.hopper_qmm import act

    L = w1.shape[0]
    per = -(-B * topk // E)
    s1, s3, s2 = scales

    def lib(i, x):
        l = i % L
        out = torch.zeros_like(x)
        for e in range(E):
            rows = torch.arange(e * per, (e + 1) * per, device=x.device) % B
            xe = x.index_select(0, rows)
            q = [(w[l, e], None if s is None else s[l, e])
                 for w, s in ((w1, s1), (w3, s3), (w2, s2))]
            h = (act(library_mm(xe, q[0][0], fmt, None, q[0][1]), act_gelu)
                 * library_mm(xe, q[1][0], fmt, None, q[1][1]))
            out.index_add_(0, rows, library_mm(h, q[2][0], fmt, None, q[2][1]))
        return out
    return lib


def widened(w, fmt, scale=None):
    """A plane or stack in 16 bits, made beforehand for a library call
    (not timed): fp16 as it is, the 8-bit and gf4 formats dequantized to
    bf16 (fp8e4 times its power-of-two scale, exactly)."""
    from calm_tpu_torch.ops.qmm import QTensor, dequant

    if fmt == "fp16":
        return w
    wf = dequant(QTensor(w, fmt), torch.float32)
    return (wf if scale is None else wf * scale).bfloat16()


def moe_bmm(x, wbs, act_gelu=False):
    """The expert FFN of every live slot in one PyTorch call a product:
    x (B, D) against the live experts' 16-bit planes wbs = (w1, w3, w2),
    each (live, n, d) (``torch.bmm``; the activation between)."""
    from calm_tpu_torch.ops.hopper_qmm import act

    xb = x.to(wbs[0].dtype).expand(wbs[0].shape[0], -1, -1)
    h = act(torch.bmm(xb, wbs[0]), act_gelu) * torch.bmm(xb, wbs[1])
    return torch.bmm(h.to(wbs[2].dtype), wbs[2])


def wide_kernel_rows(gbps, dev):
    """The wide path's rows at WIDE_B (24, 40, 64) rows, each against its
    plain version (TOL_WIDE) and timed beside its bound, the library call
    (one PyTorch call of the same function on the planes widened to 16 bits
    beforehand: ``torch.matmul``, for the expert FFN ``torch.bmm`` a
    product over the live experts) and the parent's route (``route_ms``:
    ``library_mm``, a bf16 copy of the plane and ``torch.mm``; for the
    expert FFN ``model._moe_grouped``'s products through it): K2
    fp8/fp16/fp8e4 on the Mistral-7B lm-head (32000 x 4096), K3 gf4 there
    beside K4 (``qmm_prefill``) from 32 rows on the lm-head, a w1 and a w2
    plane (``model.mm_route``'s choice), the fp8 expert FFN
    (``qmm_moe_ffn``) and K11 on Mixtral 8x7B widths in 8 live slots, and
    the OLMoE-width sweep (D 2048, H 1024, 64 experts, top-8) at 40 rows,
    its slots from random routing. Two planes or layers cycled. The 40-row
    rows go to the kernels line. Calls the wrappers only (``chip_compare.py
    --wide`` times the parent's tree beside)."""
    from calm_tpu_torch import model as M
    from calm_tpu_torch.ops import hopper_qmm as hq

    rows = {}
    V = 32000
    keep = ("ms", "plain_ms", "library_ms", "route_ms", "bound_ms")
    for fmt, key in (("fp8", "qmm_decode_wide"), ("fp16", "qmm_decode_fp16_wide"),
                     ("fp8e4", "qmm_decode_fp8e4_wide"), ("gf4", "qmm_decode_gf4_wide")):
        gs, esz = (8, 0.5) if fmt == "gf4" else (1, 2 if fmt == "fp16" else 1)
        w = e4m3_rand((2, V, D), dev) if fmt == "fp8e4" else rand_w((2, V, D // gs), fmt, dev)
        sc = pow2_scales((2, 1), dev, 2) if fmt == "fp8e4" else None
        wl = [widened(w[l], fmt, None if sc is None else sc[l]) for l in range(2)]
        per_b = {}
        for B in WIDE_B:
            x = torch.randn(B, D, device=dev)
            x16 = x.to(wl[0].dtype)
            e = check(f"qmm_decode_wide {fmt} lm-head B={B}",
                      wide_took(hq, f"qmm_decode {fmt} B={B}",
                                lambda: hq.qmm_decode(x, w, fmt, 0, sc)),
                      hq.qmm_decode_plain(x, w, fmt, 0, sc), TOL_WIDE)
            b, by = bound_ms(V * D * esz + 4 * B * (D + V), 2 * B * V * D, gbps, PEAK_BF16)
            t = timings(lambda i: hq.qmm_decode(x, w, fmt, i % 2, sc),
                        lambda i: hq.qmm_decode_plain(x, w, fmt, i % 2, sc),
                        lambda i: torch.matmul(x16, wl[i % 2].T), bound=b)
            t["route_ms"] = timed(lambda i: library_mm(x, w, fmt, i % 2, sc), floor=b)[0]
            log(f"# K{3 if fmt == 'gf4' else 2} wide {fmt} lm-head {V}x{D} B={B}: max_abs_err "
                f"{e:.3e} (tol {TOL_WIDE:g} x max|y|); {ms_line(t)} (one {x16.dtype} matmul on "
                f"the plane widened beforehand; the library route it replaced, library_mm, "
                f"{t['route_ms']:.4f}) bound_ms {b:.4f} ({by}); {share(t, b)}")
            per_b[B] = dict(t, bound_ms=b, bound_by=by, max_abs_err=e)
        rows[key] = dict(per_b[40], by_rows={B: {k: v[k] for k in keep}
                                             for B, v in per_b.items()})
        del w, wl
    # gf4 from 32 rows: the wide path against K4 (model.mm_route's choice)
    for name, d, n in (("lm-head", V, D), ("w1", HID, D), ("w2", D, HID)):
        w = rand_w((2, d, n // 8), "gf4", dev)
        line = []
        for B in (32, 40, 48, 64):
            x = torch.randn(B, n, device=dev)
            b, _ = bound_ms(d * n / 2 + 4 * B * (n + d), 2 * B * d * n, gbps, PEAK_BF16)
            mv = timed(lambda i: hq.qmm_decode_gf4(x, w, i % 2), floor=b)[0]
            mm = timed(lambda i: hq.qmm_prefill(x, w, i % 2), floor=b)[0]
            line.append(f"B={B} wide {mv:.4f} K4 {mm:.4f}")
            rows.setdefault("gf4_boundary", {})[f"{name} B={B}"] = dict(wide=mv, k4=mm,
                                                                         bound=b)
        log(f"# gf4 {name} {d}x{n}, the wide path against K4 (ms, bound-checked CUPTI; "
            f"model.mm_route keeps 17-64 rows on the wide path): " + "; ".join(line))
        del w

    # the expert FFN on Mixtral 8x7B widths, 8 live slots of 8 experts, top-2
    L, E, A = 2, EXPERTS, MOE_SLOTS
    ids = torch.arange(A, dtype=torch.int32, device=dev)
    cnt = torch.tensor([A], dtype=torch.int32, device=dev)
    for fmt, key in (("fp8", "qmm_moe_ffn_wide"), ("gf4", "gf4_moe_ffn_wide")):
        gs, esz = (8, 0.5) if fmt == "gf4" else (1, 1)
        w1, w3 = (rand_w((L, E, HID, D // gs), fmt, dev) for _ in range(2))
        w2 = rand_w((L, E, D, HID // gs), fmt, dev)
        if fmt == "gf4":
            fn = lambda x, l: hq.gf4_moe_ffn(x, w1, w3, w2, ids, cnt, l, False)
            plain = lambda x, l: hq.gf4_moe_ffn_plain(x, w1, w3, w2, ids, cnt, l, False)
        else:
            fn = lambda x, l: hq.qmm_moe_ffn(x, w1, w3, w2, ids, cnt, fmt, l, False)
            plain = lambda x, l: hq.qmm_moe_ffn_plain(x, w1, w3, w2, ids, cnt, fmt, l, False)
        # each layer's live planes widened, (live, n, d) a weight
        wbs = [[widened(wt[l, :A], fmt).transpose(1, 2) for wt in (w1, w3, w2)]
               for l in range(L)]
        per_b = {}
        for B in WIDE_B:
            x = torch.randn(B, D, device=dev)
            e = check(f"moe_ffn_wide {fmt} Mixtral B={B}",
                      wide_took(hq, f"{fmt} expert FFN B={B}", lambda: fn(x, 1)),
                      plain(x, 1), 2 * TOL_WIDE)
            lib = grouped_library(w1, w3, w2, fmt, (None,) * 3, E, B, 2)
            nb = A * 3 * HID * D * esz
            b, by = bound_ms(nb + 4 * (B * D + A * B * D), 2 * B * A * 3 * HID * D, gbps,
                             PEAK_BF16)
            t = timings(lambda i: fn(x, i % L), lambda i: plain(x, i % L),
                        lambda i: moe_bmm(x, wbs[i % L]), bound=b)
            t["route_ms"] = timed(lambda i: lib(i, x), floor=b)[0]
            log(f"# {'K11 gf4_moe_ffn' if fmt == 'gf4' else 'K10 fp8 qmm_moe_ffn'} wide "
                f"D={D} H={HID}, {A} live slots, B={B}: max_abs_err {e:.3e} (tol "
                f"{2 * TOL_WIDE:g} x max|z|); {ms_line(t)} (a bf16 bmm a product over the live "
                f"planes widened beforehand; the library route, the grouped products through "
                f"library_mm, {-(-B * 2 // E)} rows an expert, {t['route_ms']:.4f}) bound_ms "
                f"{b:.4f} ({by}, {nb / 1e6:.1f} MB); {share(t, b)}")
            per_b[B] = dict(t, bound_ms=b, bound_by=by, max_abs_err=e)
            if B == 40:
                by_kernel(lambda i: fn(x, i % L), f"{fmt} expert FFN wide B=40")
        rows[key] = dict(per_b[40], by_rows={B: {k: v[k] for k in keep}
                                             for B, v in per_b.items()})
        del w1, w3, w2, wbs
        torch.cuda.empty_cache()

    # OLMoE widths: 64 experts, top-8 of random routing at 40 rows
    Do, Ho, Eo, k = OLMOE["dim"], OLMOE["hidden_dim"], OLMOE["experts"], OLMOE["topk"]
    B = 40
    w1, w3 = (rand_w((L, Eo, Ho, Do), "fp8", dev) for _ in range(2))
    w2 = rand_w((L, Eo, Do, Ho), "fp8", dev)
    x = torch.randn(B, Do, device=dev)
    idx = torch.randn(B, Eo, device=dev).topk(k, dim=-1).indices
    uniq, cnt_o = M.expert_slots(idx, Eo)
    live = int(cnt_o.item())
    fn = lambda l: hq.qmm_moe_ffn(x, w1, w3, w2, uniq, cnt_o, "fp8", l, False)
    plain = lambda l: hq.qmm_moe_ffn_plain(x, w1, w3, w2, uniq, cnt_o, "fp8", l, False)
    e = check(f"moe_ffn_wide fp8 OLMoE B={B}", wide_took(hq, "OLMoE sweep", lambda: fn(1)),
              plain(1), 2 * TOL_WIDE)
    lib = grouped_library(w1, w3, w2, "fp8", (None,) * 3, Eo, B, k)
    lids = uniq[:live].long()
    wbs = [[widened(wt[l].index_select(0, lids), "fp8").transpose(1, 2) for wt in (w1, w3, w2)]
           for l in range(L)]
    nb = live * 3 * Ho * Do
    b, by = bound_ms(nb + 4 * (B * Do + uniq.shape[0] * B * Do), 2 * B * live * 3 * Ho * Do,
                     gbps, PEAK_BF16)
    t = timings(lambda i: fn(i % L), lambda i: plain(i % L), lambda i: moe_bmm(x, wbs[i % L]),
                bound=b)
    t["route_ms"] = timed(lambda i: lib(i, x), floor=b)[0]
    log(f"# K10 fp8 qmm_moe_ffn wide, OLMoE widths D={Do} H={Ho}, {Eo} experts top-{k}, "
        f"B={B}: {live} live of {uniq.shape[0]} slots; max_abs_err {e:.3e} (tol "
        f"{2 * TOL_WIDE:g} x max|z|); {ms_line(t)} (a bf16 bmm a product over the live planes "
        f"widened beforehand; the library route, the grouped products through library_mm, "
        f"{t['route_ms']:.4f}) bound_ms {b:.4f} ({by}, {nb / 1e6:.1f} MB, "
        f"{2 * B} operations a weight byte); {share(t, b)}")
    by_kernel(lambda i: fn(i % L), "OLMoE sweep wide B=40")
    rows["qmm_moe_ffn_olmoe_wide"] = dict(t, bound_ms=b, bound_by=by, max_abs_err=e)
    del w1, w3, w2, wbs
    torch.cuda.empty_cache()
    return rows


def graph_call_ms(fn, n: int = 20, reps: int = 5) -> float:
    """ms a call of ``fn(i)`` as a captured CUDA graph of ``n`` calls
    (median of ``reps`` replays by CUDA events): the device's timeline with
    its gaps between kernels, without the host's pace."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(n):
            fn(i)
    g.replay()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b) / n)
    del g
    return statistics.median(ts)


def wide_verify_shapes(gbps, dev) -> dict:
    """Each product of the fp8 Mistral-7B verify (B = 8 x 5 = 40 rows) on
    the wide path: its plan, its bound, the device us of ``wide_kernel``
    and of its staging a call (CUPTI), and us a call as a captured graph
    of 20 calls (staging and the gaps between kernels included); planes
    cycled past the 50 MB L2, as a verify finds them."""
    from calm_tpu_torch.ops import hopper_qmm as hq

    B, out = 40, {}
    for name, (d, n) in (("k/v", (KV, D)), ("q/wo", (Q, D)), ("w1/w3", (HID, D)),
                         ("w2", (D, HID)), ("lm-head", (32000, D))):
        P = max(2, -(-100_000_000 // (d * n)))
        w = rand_w((P, d, n), "fp8", dev)
        x = torch.randn(B, n, device=dev)
        check(f"qmm_decode_wide fp8 {name} B={B}", hq.qmm_decode(x, w, "fp8", 0),
              hq.qmm_decode_plain(x, w, "fp8", 0), TOL_WIDE)
        b, _ = bound_ms(d * n + 4 * B * (n + d), 2 * B * d * n, gbps, PEAK_BF16)
        prof = {k: us / cnt for us, cnt, k in
                kernel_rows(lambda: [hq.qmm_decode(x, w, "fp8", i % P) for i in range(20)])}
        kern = next((v for k, v in prof.items() if k.startswith("wide_kernel")), None)
        stage = prof.get("stage_wide_kernel")
        g = 1e3 * graph_call_ms(lambda i: hq.qmm_decode(x, w, "fp8", i % P))
        p = hq.qmv_plan(B, (d,), n)
        out[name] = dict(bound_us=1e3 * b, kernel_us=kern, staging_us=stage, graph_us=g,
                         ks=p.ks, blocks=p.grid)
        dev_us = ("not measured (the profiler saw no device time)" if kern is None or stage is None
                  else f"wide_kernel {kern:.2f} us ({100 * 1e3 * b / kern:.1f}% of bound), its "
                  f"staging {stage:.2f} us")
        log(f"# wide path, fp8 mistral7b verify product {name} {d}x{n} B={B} (k parts {p.ks}, "
            f"{p.grid} blocks): bound {1e3 * b:.2f} us; {dev_us}; a call in a captured graph "
            f"of 20, gaps included, {g:.2f} us")
        del w
        torch.cuda.empty_cache()
    return out


# -- fp8e4 (e4m3 codes, a power-of-two scale per tensor / (layer, expert)) --

# products past 64 rows of fp16/fp8/fp8e4 (hopper_qmm.qmm_mm8, csrc/mm.cu)
MM8_R = (65, 128, 257, 1025, 2048)  # expert groups (65-300 rows) to whole dense prefills
MM8_SHAPES = (("q/o", Q, D), ("k/v", KV, D), ("w1/w3", HID, D), ("w2", D, HID),
              ("lm-head", 32000, D))  # Mistral-7B; Mixtral's experts have w1/w3's and w2's
MM8_FMTS = ("fp8", "fp8e4", "fp16")
TOL_MM8 = 1e-2  # against the f32 plain product, as TOL_MM: x rounded once to bf16
E5M2_FINITE = [b for b in range(256) if b & 0x7C != 0x7C]  # 0x7c-0x7f, 0xfc-0xff: inf, NaN


def library_mm(x, w, fmt, layer=None, scale=None):
    """The library route that ``qmm_mm8`` replaced (``dense_matmul``'s
    former bf16 branch), the smoke's yardstick (library_ms) and never the
    port's: the plane dequantized to a bf16 copy in device memory, x cast
    to bf16, one ``torch.mm`` with an f32 result, the fp8e4 scale after."""
    from calm_tpu_torch.ops.qmm import QTensor, dequant

    wl = w if layer is None else w[layer]
    out = torch.mm(x.to(torch.bfloat16), dequant(QTensor(wl, fmt), torch.bfloat16).T,
                   out_dtype=torch.float32)
    if scale is None:
        return out
    return out * (scale if layer is None else scale[layer])


def mm8_sum_bound(x, w, fmt, layer=None, scale=None):
    """How far two f32 sums of the same n bf16 products may lie apart in any
    order: each product of two bf16 values is exact in f32, each sum of n
    terms within (n - 1) 2^-24 sum |terms| of the exact one, so the two
    within 2 n 2^-24 sum |x w| (times the power-of-two scale). The kernel
    and the library differ only in that order."""
    from calm_tpu_torch.ops.qmm import QTensor, dequant

    wl = w if layer is None else w[layer]
    n = x.shape[1]
    ab = (x.to(torch.bfloat16).float().abs()
          @ dequant(QTensor(wl, fmt), torch.bfloat16).float().abs().T)
    b = 2.0 * n * 2.0 ** -24 * ab
    if scale is not None:
        b = b * (scale if layer is None else scale[layer]).abs()
    return b


def mm8_took(hq, what, run, R: int):
    """run() on ``qmm_mm8``: one launch, R rows on ``qmm.mm8_rows``."""
    from calm_tpu_torch.ops import cost

    n0, r0 = hq.qmm_mm8.launches, cost.counters().get("qmm.mm8_rows", 0)
    out = run()
    got = (hq.qmm_mm8.launches - n0, cost.counters().get("qmm.mm8_rows", 0) - r0)
    if got != (1, R):
        fail(f"{what}: {got[0]} qmm_mm8 launches and {got[1]} qmm.mm8_rows, not 1 and {R}")
    return out


MM8_WORST = {}  # fmt -> the largest |kernel - library| / mm8_sum_bound of the checks


def mm8_same_sums(what, fmt, got, lib, bound):
    """The kernel against the library's bf16 product: within mm8_sum_bound
    everywhere (the order of the f32 sums); the largest share logged."""
    err = (got - lib).abs()
    if not bool((err <= bound).all()):
        i = int((err - bound).argmax())
        fail(f"{what}: |kernel - library| {err.flatten()[i].item():.3e} > the sums' bound "
             f"{bound.flatten()[i].item():.3e}")
    share = (err / bound.clamp_min(1e-30)).max().item()
    MM8_WORST[fmt] = max(MM8_WORST.get(fmt, 0.0), share)
    return share


def mm8_planes(shape, fmt, dev, every: bool = False):
    """Weights for the checks: e5m2 of exponent <= 7 (``rand_w``; with
    ``every`` any finite byte, each plane's first ones all of them in
    order), e4m3 of any finite byte (``e4m3_rand``), fp16 small normals."""
    if fmt == "fp8e4":
        return e4m3_rand(shape, dev, every=True)
    if fmt == "fp8" and every:
        table = torch.tensor(E5M2_FINITE, dtype=torch.uint8, device=dev)
        b = table[torch.randint(0, len(E5M2_FINITE), shape, device=dev)]
        flat = b.reshape(-1, shape[-2] * shape[-1])
        flat[:, :len(E5M2_FINITE)] = table
        return b.view(torch.float8_e5m2)
    return rand_w(shape, fmt, dev)


def mm8_checks(dev):
    """``qmm_mm8`` (products past 64 rows, ``csrc/mm.cu``) at MM8_R rows on
    Mistral-7B's q/o, k/v, w1/w3, w2 and lm-head planes (Mixtral's experts
    have w1/w3's and w2's), e5m2, e4m3 with its power-of-two scales and
    fp16, layer 1 of a stack of 2: against the library's bf16 product
    (``library_mm``, the former route) within the f32 sums' bound
    (``mm8_sum_bound``) and the f32 plain product within TOL_MM8 x max|y|,
    each call counted on the wrapper and ``qmm.mm8_rows``, the k-split
    launches twice bit-equal; every finite e5m2 byte; Mixtral expert planes
    as ``model._moe_grouped`` passes them (``_mm`` on ``w1[layer, e]``),
    the shared bf16 operand; ragged d and n."""
    from calm_tpu_torch import model as M
    from calm_tpu_torch.ops import hopper_qmm as hq
    from calm_tpu_torch.ops.qmm import QTensor

    t0 = time.perf_counter()
    worst_plain, twice = 0.0, 0
    for fmt in MM8_FMTS:
        for name, d, n in MM8_SHAPES:
            w = mm8_planes((2, d, n), fmt, dev)
            sc = pow2_scales((2, 1), dev, 1) if fmt == "fp8e4" else None
            for R in MM8_R:
                x = torch.randn(R, n, device=dev)
                what = f"qmm_mm8 {fmt} {name} {d}x{n} R={R}"
                got = mm8_took(hq, what, lambda: hq.qmm_mm8(x, w, fmt, 1, sc), R)
                mm8_same_sums(what, fmt, got, library_mm(x, w, fmt, 1, sc),
                              mm8_sum_bound(x, w, fmt, 1, sc))
                e = check(what, got, hq.qmm_mm8_plain(x, w, fmt, 1, sc), TOL_MM8)
                worst_plain = max(worst_plain, e / scale_of(got))
                if hq.mm8_plan(R, d, n).ks > 1:
                    again = mm8_took(hq, what, lambda: hq.qmm_mm8(x, w, fmt, 1, sc), R)
                    if not torch.equal(got, again):
                        fail(f"{what}: two identical calls differ, by "
                             f"{(got - again).abs().max().item():.3e}")
                    twice += 1
            del w
    # every finite e5m2 byte, and ragged shapes (d off the 128-row tile, k
    # off the 64-value stage, R off the token tiles)
    for fmt, d, n, R in (("fp8", 1024, 4096, 128), ("fp8", 1003, 1040, 100),
                         ("fp16", 1003, 1040, 300), ("fp8e4", 1003, 1040, 777),
                         ("fp8", 8, 4096, 515)):
        w = mm8_planes((2, d, n), fmt, dev, every=True)
        sc = pow2_scales((2, 1), dev, 3) if fmt == "fp8e4" else None
        x = torch.randn(R, n, device=dev)
        what = f"qmm_mm8 {fmt} {d}x{n} R={R} (every finite byte, ragged)"
        got = mm8_took(hq, what, lambda: hq.qmm_mm8(x, w, fmt, 1, sc), R)
        mm8_same_sums(what, fmt, got, library_mm(x, w, fmt, 1, sc),
                      mm8_sum_bound(x, w, fmt, 1, sc))
        check(what, got, hq.qmm_mm8_plain(x, w, fmt, 1, sc), TOL_MM8)
    # Mixtral 8x7B's expert planes as the grouped MoE passes them: w1 and w2
    # of (layer, expert), one bf16 cast of x shared by w1/w3
    L, E = 2, EXPERTS
    for fmt in ("fp8", "fp8e4"):
        for name, d, n in (("w1", HID, D), ("w2", D, HID)):
            st = QTensor(mm8_planes((L, E, d, n), fmt, dev), fmt,
                         pow2_scales((L, E, 1), dev, 2) if fmt == "fp8e4" else None)
            for (layer, e), R in (((1, 5), 128), ((0, 7), 300)):
                pe = st[layer, e]
                x = torch.randn(R, n, device=dev)
                what = f"_mm {fmt} Mixtral expert {name} [{layer}, {e}] R={R}"
                xb = M._mm_operand(x, pe)
                if xb.dtype != torch.bfloat16:
                    fail(f"{what}: the shared operand is {xb.dtype}, not bf16")
                got = mm8_took(hq, what, lambda: M._mm(xb, pe), R)
                mm8_same_sums(what, fmt, got, library_mm(x, pe.data, fmt, None, pe.scale),
                              mm8_sum_bound(x, pe.data, fmt, None, pe.scale))
                check(what, got, hq.qmm_mm8_plain(x, pe.data, fmt, None, pe.scale), TOL_MM8)
            del st
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"# qmm_mm8 checks ({time.perf_counter() - t0:.1f} s): {len(MM8_FMTS)} formats x "
        f"{len(MM8_SHAPES)} planes x R = {MM8_R}, ragged and expert planes; |kernel - "
        f"library| at most " + ", ".join(f"{f} {v:.3f}" for f, v in MM8_WORST.items())
        + f" of the f32 sums' bound; against the f32 plain product at most {worst_plain:.3e} "
        f"x max|y| (tol {TOL_MM8:g}); {twice} k-split launches bit-equal to a second call")


def mm8_kernel_rows(gbps, dev):
    """``qmm_mm8`` timed beside its bound (the plane once, x in bf16, y in
    f32; 2 R d n operations at the bf16 peak), its plain version (f32) and
    the library route it replaced (``library_mm``: a bf16 copy of the plane,
    then ``torch.mm``), x already bf16 as the model's shared cast gives it:
    fp8 at every MM8_SHAPES plane and MM8_R, fp8e4 and fp16 at w1/w3 and w2
    at 128 and 2048 rows. Two planes cycled. The kernels line takes fp8
    w1/w3 at 2048 rows (a dense prefill, ``qmm_mm8``) and 128 (a Mixtral
    expert group, ``qmm_mm8_expert``), each checked against its plain
    version."""
    from calm_tpu_torch.ops import hopper_qmm as hq

    rows, table = {}, []
    for fmt in MM8_FMTS:
        esz = 2 if fmt == "fp16" else 1
        shapes = MM8_SHAPES if fmt == "fp8" else MM8_SHAPES[2:4]
        for name, d, n in shapes:
            w = mm8_planes((2, d, n), fmt, dev)
            sc = pow2_scales((2, 1), dev) if fmt == "fp8e4" else None
            for R in MM8_R if fmt == "fp8" else (128, 2048):
                x = torch.randn(R, n, device=dev)
                xb = x.to(torch.bfloat16)
                b, by = bound_ms(d * n * esz + 2 * R * n + 4 * R * d, 2 * R * d * n, gbps,
                                 PEAK_BF16)
                t = timings(lambda i: hq.qmm_mm8(xb, w, fmt, i % 2, sc),
                            lambda i: hq.qmm_mm8_plain(x, w, fmt, i % 2, sc),
                            lambda i: library_mm(xb, w, fmt, i % 2, sc), bound=b)
                p = hq.mm8_plan(R, d, n)
                log(f"# qmm_mm8 {fmt} {name} {d}x{n} R={R} (N {p.width} x {p.ttiles}, ks "
                    f"{p.ks}, {p.grid} blocks): {ms_line(t)} (library: a bf16 copy of the "
                    f"plane, then torch.mm) bound_ms {b:.4f} ({by}); {share(t, b)}")
                row = dict(t, bound_ms=b, bound_by=by, fmt=fmt, plane=name, R=R)
                table.append(row)
                if fmt == "fp8" and name == "w1/w3" and R in (128, 2048):
                    row["max_abs_err"] = check(f"qmm_mm8 {fmt} {name} R={R}",
                                               hq.qmm_mm8(x, w, fmt, 1, sc),
                                               hq.qmm_mm8_plain(x, w, fmt, 1, sc), TOL_MM8)
                    rows["qmm_mm8" if R == 2048 else "qmm_mm8_expert"] = row
            del w
            torch.cuda.empty_cache()
    log("# qmm_mm8 table (fmt plane R: kernel / bound / library ms, % of bound): " + "; ".join(
        f"{r['fmt']} {r['plane']} {r['R']}: {r['ms']:.4f} / {r['bound_ms']:.4f} / "
        f"{r['library_ms']:.4f}, {100 * r['bound_ms'] / r['ms']:.1f}%" for r in table))
    return rows


E4M3_FINITE = [b for b in range(256) if b not in (0x7F, 0xFF)]  # 0x7f / 0xff: NaN


def e4m3_rand(shape, dev, every: bool = False):
    """Random e4m3 codes of exponent 0-3 (|v| < 0.12, subnormals included),
    random sign; with ``every`` random finite codes of any exponent, and
    each plane's first 254 values all the finite bytes in order."""
    table = torch.tensor(E4M3_FINITE, dtype=torch.uint8, device=dev)
    if not every:
        b = torch.randint(0, 256, shape, device=dev, dtype=torch.int32) & 0x9F
        return b.to(torch.uint8).view(torch.float8_e4m3fn)
    b = table[torch.randint(0, len(E4M3_FINITE), shape, device=dev)]
    if every:
        flat = b.reshape(-1, shape[-2] * shape[-1])
        flat[:, :len(E4M3_FINITE)] = table
    return b.view(torch.float8_e4m3fn)


def pow2_scales(shape, dev, k0: int = 0):
    """fp8e4 scales 2^-3 .. 2^2, different from one plane (layer, expert) to
    the next and never 1, so a dropped or misindexed scale fails a check."""
    k = (torch.arange(math.prod(shape), device=dev) + k0) % 5
    return torch.pow(2.0, torch.where(k >= 3, k - 2, k - 3).float()).reshape(shape)


def fp8e4_kernel_rows(gbps, dev):
    """The fp8e4 routes, each checked against its plain version (scales
    2^-3 .. 2^2 that differ by layer and expert) and timed beside the e5m2
    row of the same shape in the same call, with that row's bound and
    library call: K2 at B=1 (Mistral-7B wq, 8 layers cycled, and the
    lm-head) and at B=8 (the lm-head, the multi-row path); K10 at one row
    (Mixtral 8x7B w1, 2 live of 8 experts, 2 layers cycled); the expert
    FFN (``qmm_moe_ffn``) at B=8 on Mixtral shapes, 8 of 8 slots live and
    3 of 8 (dead slots exactly zero). The kernels line takes the
    lm-head rows, K10 and the FFN with 8 live."""
    import torch.nn.functional as F

    from calm_tpu_torch.ops import hopper_qmm as hq
    from calm_tpu_torch.ops.qmm import QTensor, dequant

    rows, ratios = {}, []
    V, E = 32000, EXPERTS

    def both(what, key, make, run, plain, library, b, by, dead_zero=None):
        """The e5m2 row in full, then the fp8e4 row on the same shapes (its
        library call is the e5m2 row's: the same bf16 product)."""
        out = {}
        for fmt in ("fp8", "fp8e4"):
            args = make(fmt)
            got = run(args, 0)
            if dead_zero and fmt == "fp8e4":
                dead_zero(got)
            e = check(f"{key} {fmt} {what}", got, plain(args, 0), TOL_MV)
            t = timings(lambda i: run(args, i), lambda i: plain(args, i),
                        library if fmt == "fp8" else None, bound=b)
            if fmt == "fp8e4":
                t["library_ms"] = out["fp8"]["library_ms"]
                t["timed_by"] += "; library_ms: the e5m2 row's call"
            out[fmt] = dict(t, bound_ms=b, bound_by=by, max_abs_err=e)
            log(f"# {key} {fmt} {what}: max_abs_err {e:.3e} (tol {TOL_MV:g} x max|out|); "
                f"{ms_line(t)} bound_ms {b:.4f} ({by}); {share(t, b)}")
            del args
        r = out["fp8e4"]["ms"] / out["fp8"]["ms"]
        ratios.append(f"{key} {what} {r:.3f}")
        log(f"# {key} {what}: fp8e4 / e5m2 kernel ms {r:.3f} in the same call")
        return out["fp8e4"]

    # K2 at one row
    for name, d, L in (("wq", Q, 8), ("lm-head", V, 1)):
        x = torch.randn(1, D, device=dev)
        wb = dequant(QTensor(rand_w((1, d, D), "fp8", dev), "fp8"), torch.bfloat16)[0]

        def make(fmt, d=d, L=L):
            if fmt == "fp8":
                return rand_w((L, d, D), fmt, dev), None
            return e4m3_rand((L, d, D), dev), pow2_scales((L, 1), dev)
        fmt_of = lambda a: "fp8" if a[1] is None else "fp8e4"
        b, by = bound_ms(d * D + 4 * (D + d), 2 * d * D, gbps)
        r = both(f"{name} {d}x{D} B=1", "qmm_decode", make,
                 lambda a, i, L=L, x=x: hq.qmm_decode(x, a[0], fmt_of(a), i % L, a[1]),
                 lambda a, i, L=L, x=x: hq.qmm_decode_plain(x, a[0], fmt_of(a), i % L, a[1]),
                 lambda i, x=x, wb=wb: torch.matmul(x.bfloat16(), wb.T), b, by)
        if name == "lm-head":
            rows["qmm_decode_fp8e4"] = r
        del wb
    # K2 at 8 rows, the multi-row path: the lm-head
    x = torch.randn(8, D, device=dev)
    wb = dequant(QTensor(rand_w((1, V, D), "fp8", dev), "fp8"), torch.bfloat16)[0]
    b, by = bound_ms(V * D + 4 * 8 * (D + V), 2 * 8 * V * D, gbps, PEAK_BF16)
    rows["qmm_decode_fp8e4_multirow"] = both(
        f"lm-head {V}x{D} B=8", "qmm_decode",
        lambda fmt: ((rand_w((1, V, D), fmt, dev), None) if fmt == "fp8"
                     else (e4m3_rand((1, V, D), dev), pow2_scales((1, 1), dev, 4))),
        lambda a, i: hq.qmm_decode(x, a[0], "fp8" if a[1] is None else "fp8e4", 0, a[1]),
        lambda a, i: hq.qmm_decode_plain(x, a[0], "fp8" if a[1] is None else "fp8e4", 0, a[1]),
        lambda i: torch.matmul(x.bfloat16(), wb.T), b, by)
    del wb

    # K10 at one row: Mixtral w1, 2 live slots of 8 experts
    L = 2
    ids = torch.tensor([1, 5], dtype=torch.int32, device=dev)
    cnt = torch.tensor([2], dtype=torch.int32, device=dev)
    x = torch.randn(1, 1, D, device=dev)
    wb = dequant(QTensor(rand_w((L, 2, HID, D), "fp8", dev), "fp8"),
                 torch.bfloat16).transpose(2, 3)
    xb = x.bfloat16().expand(2, -1, -1)
    b, by = bound_ms(2 * HID * D + 4 * (D + 2 * HID), 2 * 2 * HID * D, gbps)

    def moe_args(fmt, shape):
        if fmt == "fp8":
            return rand_w(shape, fmt, dev), None
        return e4m3_rand(shape, dev), pow2_scales(shape[:2] + (1,), dev, 1)
    mfmt = lambda a: "fp8" if a[1] is None else "fp8e4"
    rows["qmm_moe_dense_fp8e4"] = both(
        f"w1 {HID}x{D}, 2 of {E} experts, B=1", "qmm_moe_dense",
        lambda fmt: moe_args(fmt, (L, E, HID, D)),
        lambda a, i: hq.qmm_moe_dense(x, a[0], ids, cnt, mfmt(a), i % L, a[1]),
        lambda a, i: hq.qmm_moe_dense_plain(x, a[0], ids, cnt, mfmt(a), i % L, a[1]),
        lambda i: torch.bmm(xb, wb[i % L]), b, by)
    del wb, xb
    torch.cuda.empty_cache()

    # the expert FFN at B=8, 8 slots: all live and 3 live
    ids = torch.arange(MOE_SLOTS, dtype=torch.int32, device=dev)
    x = torch.randn(8, D, device=dev)
    for live in (MOE_SLOTS, 3):
        cnt = torch.tensor([live], dtype=torch.int32, device=dev)
        wb = [dequant(QTensor(rand_w((L, live, *sh), "fp8", dev), "fp8"),
                      torch.bfloat16).transpose(2, 3) for sh in ((HID, D), (HID, D), (D, HID))]
        xb = x.bfloat16().expand(live, -1, -1)

        def bmm_chain(i, xb=xb, wb=wb):
            l = i % L
            h = F.silu(torch.bmm(xb, wb[0][l])) * torch.bmm(xb, wb[1][l])
            return torch.bmm(h, wb[2][l])

        def make(fmt):
            ws = [moe_args(fmt, (L, E) + sh) for sh in ((HID, D), (HID, D), (D, HID))]
            return [w for w, _ in ws], tuple(s for _, s in ws)

        def dead_zero(got, live=live):
            if live < MOE_SLOTS and got[live:].abs().max().item() != 0:
                fail(f"qmm_moe_ffn fp8e4 cnt={live}: a dead slot is not zero")
        ffmt = lambda a: "fp8" if a[1][0] is None else "fp8e4"
        nb = live * 3 * HID * D
        b, by = bound_ms(nb + 4 * (8 * D + MOE_SLOTS * 8 * D), 2 * 8 * nb, gbps, PEAK_BF16)
        r = both(f"D={D} H={HID}, {live} live of {MOE_SLOTS} slots, B=8", "qmm_moe_ffn",
                 make,
                 lambda a, i, cnt=cnt: hq.qmm_moe_ffn(x, *a[0], ids, cnt, ffmt(a), i % L, False,
                                                      a[1]),
                 lambda a, i, cnt=cnt: hq.qmm_moe_ffn_plain(x, *a[0], ids, cnt, ffmt(a), i % L,
                                                            False, a[1]),
                 bmm_chain, b, by, dead_zero)
        if live == MOE_SLOTS:
            rows["qmm_moe_ffn_fp8e4_multirow"] = r
        del wb, xb
        torch.cuda.empty_cache()
    log("# fp8e4 / e5m2 kernel ms, same shapes, same call: " + "; ".join(ratios))
    return rows


def precise_count(hq) -> int:
    """The launches so far of the path that the quality mode takes at 2-16
    rows in K2 and K3: the multi-row path's (``multirow_launches``), or an
    older tree's rows axis (``rows_launches``) when ``chip_compare.py
    --precise`` drives one."""
    attr = "rows_launches" if hasattr(hq.qmm_decode, "rows_launches") else "multirow_launches"
    return getattr(hq.qmm_decode, attr) + getattr(hq.qmm_decode_gf4, attr)


def precise_decode(x, w, fmt, layer, sc):
    """K2/K3 as the model calls them under ``--precise``: ``model._mv``
    with the quality mode on (on an older tree, whatever its quality mode
    takes)."""
    from calm_tpu_torch import model as M
    from calm_tpu_torch.ops import qmm as tqmm

    tqmm.enable_precise(True)
    try:
        return M._mv(x, tqmm.QTensor(w, fmt, sc), layer)
    finally:
        tqmm.enable_precise(False)


# --precise at 2-16 rows, its distance from the float64 product (each row to
# its max |y|) on the lm-head: ~1.5x the largest reading of the multi-row
# path on an H100 (3.4e-7, PERF.md §6), under the f32 matmul's; a lost lo
# term of x reads ~2.7e-4 (tests/test_torch_precise_multirow.py)
PRECISE_F64_LIMIT = 5e-7


def precise_kernel_rows(gbps, dev):
    """The quality mode's 2-16-row products (``--precise``): K2 (fp8,
    fp8e4) and K3 (gf4) at B=8 on the lm-head, as the model calls them
    under the mode (:func:`precise_decode`: the multi-row path, x in hi +
    lo), against their f32 plain versions (TOL_MV), and their distance
    from the float64 product (each row to its max |y|) held to
    PRECISE_F64_LIMIT, the plain f32 version's beside it; timed beside the
    default call (``qmm_decode`` without the mode) and an f32 matmul on
    the plane dequantized beforehand (the library call: JAX's precise XLA
    product); the bound is the bytes' (each input read and output written
    once), the f32-FMA bound that the one-row loops' rows axis had beside
    it; B = 2, 9 and 16 checked and held to the limit too. On an older
    tree (``chip_compare.py --precise``) the same calls time its quality
    mode."""
    from calm_tpu_torch.ops import hopper_qmm as hq
    from calm_tpu_torch.ops.qmm import QTensor, dequant

    rows = {}
    V, B = 32000, 8
    x = torch.randn(B, D, device=dev)

    def f64_dist(y, exact):
        return ((y.double() - exact).abs().amax(-1) / exact.abs().amax(-1)).max().item()

    for fmt, key in (("fp8", "qmm_decode_precise"), ("fp8e4", "qmm_decode_fp8e4_precise"),
                     ("gf4", "qmm_decode_gf4_precise")):
        gs, esz = (8, 0.5) if fmt == "gf4" else (1, 1)
        w = e4m3_rand((1, V, D), dev) if fmt == "fp8e4" else rand_w((1, V, D // gs), fmt, dev)
        sc = pow2_scales((1, 1), dev, 2) if fmt == "fp8e4" else None
        wf = dequant(QTensor(w[0], fmt), torch.float32)
        w64 = (wf.double() * (1.0 if sc is None else sc.double()[0])).T
        before = precise_count(hq)
        got = precise_decode(x, w, fmt, 0, sc)
        if precise_count(hq) != before + 1:
            fail(f"qmm_decode {fmt} precise B={B}: not on the quality mode's path")
        want = hq.qmm_decode_plain(x, w, fmt, 0, sc)
        default_y = hq.qmm_decode(x, w, fmt, 0, sc)
        e = check(f"qmm_decode {fmt} lm-head B={B} precise", got, want, TOL_MV)
        e2 = check(f"qmm_decode {fmt} lm-head B={B} default", default_y, want, TOL_MV)
        exact = x.double() @ w64
        f64 = [f64_dist(y, exact) for y in (got, default_y, want)]
        f64_more = []
        for Bc in (2, 9, 16):
            xc = torch.randn(Bc, D, device=dev)
            yc = precise_decode(xc, w, fmt, 0, sc)
            check_rows(f"qmm_decode {fmt} lm-head B={Bc} precise", yc,
                       hq.qmm_decode_plain(xc, w, fmt, 0, sc), TOL_MV)
            f64_more.append(f64_dist(yc, xc.double() @ w64))
        if max([f64[0]] + f64_more) > PRECISE_F64_LIMIT:
            fail(f"qmm_decode {fmt} lm-head precise: {f64[0]:.3e} at B={B}, {f64_more} at "
                 f"B = 2, 9, 16 from the float64 product > {PRECISE_F64_LIMIT:g}")
        nbytes, ops = V * D * esz + 4 * B * (D + V), 2 * B * V * D
        b, by = bound_ms(nbytes, ops, gbps, PEAK_BF16)
        b32, by32 = bound_ms(nbytes, ops, gbps)
        t = timings(lambda i: precise_decode(x, w, fmt, 0, sc),
                    lambda i: hq.qmm_decode_plain(x, w, fmt, 0, sc),
                    lambda i: torch.matmul(x, wf.T), bound=b)
        two = timed(lambda i: hq.qmm_decode(x, w, fmt, 0, sc), floor=b)[0]
        log(f"# {'K3 qmm_decode_gf4' if fmt == 'gf4' else 'K2 qmm_decode'} {fmt} lm-head "
            f"{V}x{D} B={B} --precise: max_abs_err {e:.3e} (default call {e2:.3e}; tol "
            f"{TOL_MV:g} x max|y| {scale_of(want):.3e}, against the f32 plain version); "
            f"from the float64 product, each row to its max: --precise {f64[0]:.3e} (B = 2, "
            f"9, 16: " + ", ".join(f"{v:.3e}" for v in f64_more) + f"; limit "
            f"{PRECISE_F64_LIMIT:g}), default call {f64[1]:.3e}, the plain f32 version "
            f"{f64[2]:.3e}; {ms_line(t)} (f32 matmul, TF32 off) bound_ms {b:.4f} ({by}; the "
            f"f32-FMA bound {b32:.4f}, {by32}); {share(t, b)}; the default call in the same "
            f"call {two:.4f} ms: the mode costs {t['ms'] / two:.2f}x, "
            f"{t['ms'] / t['library_ms']:.2f}x the f32 matmul")
        rows[key] = dict(t, bound_ms=b, bound_by=by, max_abs_err=e, default_ms=two,
                         default_err=e2, f32_fma_bound_ms=b32, f64_rel_err=f64,
                         f64_rel_err_b2_9_16=f64_more)
        del w, wf, w64, exact
    torch.cuda.empty_cache()
    return rows


def refused_without_a_plan(dev):
    """The entry points that ran 2-16 rows on the one-row loops (a grid
    axis over rows) refuse them: ``calm_qmm_decode`` at B >= 2 without a
    plan (the wide path's 40 rows too), every format, and
    ``calm_gf4_matvec`` at B >= 2 return
    cudaErrorInvalidValue (1) and write nothing."""
    from calm_tpu_torch.ops import build

    d, n, st = 64, 256, torch.cuda.current_stream().cuda_stream
    scale = torch.ones(1, device=dev)
    planes = {fmt: e4m3_rand((d, n), dev) if fmt == "fp8e4"
              else rand_w((d, n // (8 if fmt == "gf4" else 1)), fmt, dev)
              for fmt in ("fp16", "fp8", "gf4", "fp8e4")}
    for B in (2, 9, 16, 40):
        x = torch.randn(B, n, device=dev)
        y = torch.full((B, d), float("nan"), device=dev)
        for code, (fmt, w) in zip((0, 1, 2, 3), planes.items()):
            rc = build.lib("qmm").calm_qmm_decode(
                x.data_ptr(), w.data_ptr(), y.data_ptr(), B, d, n, code,
                scale.data_ptr() if fmt == "fp8e4" else None, None, None, None, 1, st)
            if rc != 1:
                fail(f"calm_qmm_decode {fmt} B={B} without a plan returned {rc}, not 1")
        rc = build.lib("gf4").calm_gf4_matvec(x.data_ptr(), planes["gf4"].data_ptr(),
                                              y.data_ptr(), B, d, n // 8, st)
        if rc != 1:
            fail(f"calm_gf4_matvec B={B} returned {rc}, not 1")
        torch.cuda.synchronize()
        if not torch.isnan(y).all():
            fail(f"a refused call at B={B} wrote its output")
    log("# refused without a plan: calm_qmm_decode (fp16, fp8, gf4, fp8e4) and "
        "calm_gf4_matvec at B = 2, 9, 16, 40 return cudaErrorInvalidValue, the output "
        "untouched")


def ragged_checks_fp8e4(dev):
    """fp8e4 on shapes the timed rows do not reach, scales 2^-3 .. 2^2 by
    layer and expert: K2 at d = 1003 (not a multiple of a warp's rows) and
    n = 1040 (16 x 65: whole 16-value steps, not whole 64-value chunks), B =
    1, 2, 3, 8, 9 and 16 (one and two n-tiles), on the multi-row path and
    as the model calls it under the quality mode; every plane holds all 254
    finite e4m3 bytes. K10 at B = 1 (``csrc/moe.cu``) and 2, 5, 16 (the
    multi-row sweep), x shared and per slot, four slots of eight experts
    with the last dead (exactly zero) or ids repeated; the FFN at B = 2, 3,
    5, 16, SiLU and GELU. The quality mode for fp8/fp16 at the same ragged
    shape and for gf4 at n = 1032 (an odd word count), B = 2, 3, 8, 9, 16;
    each of its calls counted on the multi-row path."""
    from calm_tpu_torch.ops import hopper_qmm as hq

    worst, n_checks = {}, 0

    def note(key, e):
        nonlocal n_checks
        worst[key] = max(worst.get(key, 0.0), e)
        n_checks += 1

    def counted(what, B, run):
        before = precise_count(hq)
        out = run()
        if precise_count(hq) - before != (B > 1):
            fail(f"{what}: not on the multi-row path")
        return out

    d, n = 1003, 1040
    w = e4m3_rand((3, d, n), dev, every=True)
    sc = pow2_scales((3, 1), dev)
    for B in (1, 2, 3, 8, 9, 16):
        x = torch.randn(B, n, device=dev)
        for precise in ((False, True) if B > 1 else (False,)):
            for layer in (0, 2):
                what = f"qmm_decode fp8e4 {d}x{n} B={B} layer {layer} precise={precise}"
                note("qmm_decode precise" if precise else "qmm_decode", check_rows(
                    what, counted(what, B, lambda: precise_decode(
                        x, w, "fp8e4", layer, sc) if precise else hq.qmm_decode(
                        x, w, "fp8e4", layer, sc)),
                    hq.qmm_decode_plain(x, w, "fp8e4", layer, sc), TOL_MV))
    for fmt in ("fp8", "fp16", "gf4"):
        nn = 1032 if fmt == "gf4" else n
        wg = rand_w((2, d, nn // (8 if fmt == "gf4" else 1)), fmt, dev)
        for B in (2, 3, 8, 9, 16):
            x = torch.randn(B, nn, device=dev)
            what = f"qmm_decode {fmt} {d}x{nn} B={B} precise"
            note("qmm_decode precise", check_rows(
                what, counted(what, B, lambda: precise_decode(x, wg, fmt, 1, None)),
                hq.qmm_decode_plain(x, wg, fmt, 1), TOL_MV))
    slot_sets = [(torch.tensor([0, 3, 6, 6], dtype=torch.int32, device=dev), 3),
                 (torch.tensor([5, 5, 2, 2], dtype=torch.int32, device=dev), 4)]

    def dead_zero(what, out, live):
        if live < out.shape[0] and out[live:].abs().max().item() != 0:
            fail(f"{what}: the dead slot is not zero")
    w = e4m3_rand((2, EXPERTS, d, n), dev, every=True)
    sc = pow2_scales((2, EXPERTS, 1), dev)
    for B in (1, 2, 5, 16):
        for Ax in (1, 4):
            for ids, live in slot_sets:
                cnt = torch.tensor([live], dtype=torch.int32, device=dev)
                x = torch.randn(Ax, B, n, device=dev)
                got = hq.qmm_moe_dense(x, w, ids, cnt, "fp8e4", 1, sc)
                dead_zero(f"qmm_moe_dense fp8e4 B={B}", got, live)
                note("qmm_moe_dense", check(
                    f"qmm_moe_dense fp8e4 {d}x{n} B={B} Ax={Ax} cnt={live}", got,
                    hq.qmm_moe_dense_plain(x, w, ids, cnt, "fp8e4", 1, sc), TOL_MV))
    Dm, Hm = 1040, 2064
    ws = [e4m3_rand((2, EXPERTS) + sh, dev, every=True) for sh in ((Hm, Dm), (Hm, Dm), (Dm, Hm))]
    scs = tuple(pow2_scales((2, EXPERTS, 1), dev, k) for k in (0, 1, 2))
    for B in (2, 3, 5, 16):
        for gelu in (False, True):
            for ids, live in slot_sets:
                cnt = torch.tensor([live], dtype=torch.int32, device=dev)
                x = torch.randn(B, Dm, device=dev)
                got = hq.qmm_moe_ffn(x, *ws, ids, cnt, "fp8e4", 0, gelu, scs)
                dead_zero(f"qmm_moe_ffn fp8e4 B={B}", got, live)
                note("qmm_moe_ffn", check(
                    f"qmm_moe_ffn fp8e4 D={Dm} H={Hm} B={B} gelu={gelu} cnt={live}", got,
                    hq.qmm_moe_ffn_plain(x, *ws, ids, cnt, "fp8e4", 0, gelu, scs), TOL_MV))
    del w, ws
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"# ragged shapes (fp8e4, and --precise): {n_checks} checks, all 254 "
        "finite e4m3 bytes in every plane, max_abs_err " + ", ".join(
            f"{k} {v:.3e}" for k, v in worst.items()) + f" (tol {TOL_MV:g} x max|out|)")


def by_launch(fn, what: str, products, norm_bytes: float, gbps: float, calls: int = 10):
    """The device ms of each launch of one call of ``fn(i)``, in launch
    order, over ``calls`` calls, each beside its byte bound: ``products``
    ((label, bytes), ...) are the chain's products in order, and any
    launch of ``norm_kernel`` between them moves ``norm_bytes``. Logs them
    with the chain's span on the device (its first launch's start to its
    last's end) and the gaps in it; returns [(label, kernel, ms, bound
    ms), ...] and the span in ms."""
    from torch.autograd import DeviceType

    for i in range(3):
        fn(i)
    prof = _profile(lambda: [fn(i) for i in range(calls)])
    evs = sorted((e.time_range.start, e.time_range.end, _short(e.name)) for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
    if not evs or len(evs) % calls:
        log(f"# {what} by launch: the profiler saw {len(evs)} launches in {calls} calls")
        return [], None
    n = len(evs) // calls
    out, prods = [], iter(products)
    for j in range(n):
        name = evs[j][2]
        label, nb = ("norm", norm_bytes) if "norm" in name else next(prods, ("?", 0.0))
        ms = statistics.mean(evs[c * n + j][1] - evs[c * n + j][0] for c in range(calls)) / 1e3
        out.append((label, name, ms, nb / (gbps * 1e9) * 1e3))
    span = statistics.mean(evs[c * n + n - 1][1] - evs[c * n][0] for c in range(calls)) / 1e3
    busy = sum(o[2] for o in out)
    log(f"# {what} by launch (device ms / bound ms, % of bound): " + "; ".join(
        f"{lab} {name} {ms:.4f} / {b:.4f} ({100 * b / ms:.1f}%)" for lab, name, ms, b in out)
        + f"; launches {busy:.4f}, span {span:.4f}, gaps {span - busy:.4f} ms a call")
    return out, span


def onerow_kernel_rows_gf4(gbps, dev):
    """The one-row gf4 epilogue (B = 1) at Mistral-7B widths (D 4096, H
    14336, Qd 4096, KVd 1024; RMSNorm as Mistral's): K8 (one layer), K7
    (one layer) and K6 (one Aya 23 8B / Mistral-7B FFN), each checked on
    both layers of 2-layer stacks (cycled when timed: one layer's 88 MB of
    FFN words is past the 50 MB L2), timed beside its bound, plain version
    and library call (bf16 matmuls on planes dequantized beforehand), and
    split by launch (``by_launch``); K6 also checked and timed at B = 8.
    Calls the wrappers only, so it also times an older tree's package in
    the same run (``chip_compare.py``)."""
    import torch.nn.functional as F

    from calm_tpu_torch.ops import hopper_qmm as hq
    from calm_tpu_torch.ops.qmm import QTensor, dequant

    rows, L, eps = {}, 2, 1e-5
    ws = [rand_w((L, d, n // 8), "gf4", dev)
          for d, n in ((D, Q), (HID, D), (HID, D), (D, HID), (Q, D), (KV, D), (KV, D))]
    wo, w1, w3, w2 = ws[:4]
    g = 1 + 0.1 * torch.randn(L, D, device=dev)
    anx = 1 + 0.1 * torch.randn(L, D, device=dev)
    wb = [dequant(QTensor(w, "gf4"), torch.bfloat16) for w in ws]
    a, r = torch.randn(1, Q, device=dev), torch.randn(1, D, device=dev)
    # each product's bytes at one row: words, x, out (and resid)
    p_wo = ("wo", D * Q / 2 + 4 * (Q + 2 * D))
    p_dual = ("w1/w3", HID * D + 4 * (D + HID))
    p_w2 = ("w2", D * HID / 2 + 4 * (HID + 2 * D))
    p_qkv = ("q/k/v", (Q + 2 * KV) * D / 2 + 4 * (D + Q + 2 * KV))
    norm_b = 4 * 3 * D

    # K8 gf4_offn_qkv
    errs = [check(f"gf4_offn_qkv B=1 layer {layer}",
                  hq.gf4_offn_qkv(a, r, g, anx, *ws, layer, False, eps, False),
                  hq.gf4_offn_qkv_plain(a, r, g, anx, *ws, layer, False, eps, False), TOL_MV)
            for layer in range(L)]
    n_w = D * Q + 3 * HID * D + (Q + 2 * KV) * D
    b, by = bound_ms(n_w // 2 + 4 * (3 * D + 2 * Q + 2 * KV), 2 * n_w, gbps)
    t = timings(lambda i: hq.gf4_offn_qkv(a, r, g, anx, *ws, i % L, False, eps, False),
                lambda i: hq.gf4_offn_qkv_plain(a, r, g, anx, *ws, i % L, False, eps, False),
                epilogue_chain(a, r, g, anx, wb, L), bound=b)
    log(f"# K8 gf4_offn_qkv one layer D={D} H={HID} Qd={Q} KVd={KV} B=1: "
        f"max_abs_err {max(errs):.3e} (tol {TOL_MV:g} x max|out|); {ms_line(t)} "
        f"(7 bf16 matmuls on pre-dequantized planes) bound_ms {b:.4f} ({by}, "
        f"{n_w / 2e6:.1f} MB); {share(t, b)}")
    rows["gf4_offn_qkv"] = dict(t, bound_ms=b, bound_by=by, max_abs_err=max(errs))
    by_launch(lambda i: hq.gf4_offn_qkv(a, r, g, anx, *ws, i % L, False, eps, False),
              "K8 gf4 one layer B=1", (p_wo, p_dual, p_w2, p_qkv), norm_b, gbps)

    # K7 gf4_offn
    errs = []
    for layer in range(L):
        args = (a, r, g, wo, w1, w3, w2, layer, False, eps, False)
        errs += check_offn(f"B=1 layer {layer}", hq.gf4_offn(*args), hq.gf4_offn_plain(*args))
    n_w = 3 * HID * D + D * Q
    b, by = bound_ms(n_w // 2 + 4 * (Q + 4 * D), 2 * n_w, gbps)
    t = timings(lambda i: hq.gf4_offn(a, r, g, wo, w1, w3, w2, i % L, False, eps, False),
                lambda i: hq.gf4_offn_plain(a, r, g, wo, w1, w3, w2, i % L, False, eps, False),
                offn_library(wb[:4], g, eps)(a, r), bound=b)
    log(f"# K7 gf4_offn D={D} H={HID} Qd={Q} B=1: max_abs_err {max(errs):.3e} (tol "
        f"{TOL_MV:g} x max|out|, ffn and r1 each); {ms_line(t)} (4 bf16 matmuls + "
        f"rms_norm) bound_ms {b:.4f} ({by}, {n_w / 2e6:.1f} MB); {share(t, b)}")
    rows["gf4_offn"] = dict(t, bound_ms=b, bound_by=by, max_abs_err=max(errs))
    by_launch(lambda i: hq.gf4_offn(a, r, g, wo, w1, w3, w2, i % L, False, eps, False),
              "K7 gf4 one layer B=1", (p_wo, p_dual, (p_w2[0], p_w2[1] - 4 * D)), norm_b, gbps)

    # K6 gf4_ffn; operations at the bf16 rate: the TPU kernel computes this
    # function on bf16 operands
    n_f = 3 * HID * D
    for B in (1, 8):
        x = torch.randn(B, D, device=dev)
        errs = [check(f"gf4_ffn B={B} layer {layer}", hq.gf4_ffn(x, w1, w3, w2, layer, False),
                      hq.gf4_ffn_plain(x, w1, w3, w2, layer, False), TOL_MV)
                for layer in range(L)]
        b, by = bound_ms(n_f // 2 + 4 * 2 * B * D, 2 * B * n_f, gbps, PEAK_BF16)
        xb = x.bfloat16()
        t = timings(lambda i: hq.gf4_ffn(x, w1, w3, w2, i % L, False),
                    lambda i: hq.gf4_ffn_plain(x, w1, w3, w2, i % L, False),
                    lambda i: torch.matmul(F.silu(torch.matmul(xb, wb[1][i % L].T))
                                           * torch.matmul(xb, wb[2][i % L].T), wb[3][i % L].T),
                    bound=b)
        log(f"# K6 gf4_ffn D={D} H={HID} B={B}: max_abs_err {max(errs):.3e} (tol "
            f"{TOL_MV:g} x max|y|); {ms_line(t)} (3 bf16 matmuls on pre-dequantized "
            f"planes) bound_ms {b:.4f} ({by}, {n_f / 2e6:.1f} MB); {share(t, b)}")
        if B == 1:
            rows["gf4_ffn"] = dict(t, bound_ms=b, bound_by=by, max_abs_err=max(errs))
            by_launch(lambda i: hq.gf4_ffn(x, w1, w3, w2, i % L, False), "K6 gf4 FFN B=1",
                      (p_dual, (p_w2[0], p_w2[1] - 4 * D)), norm_b, gbps)
    del ws, wo, w1, w3, w2, wb
    torch.cuda.empty_cache()
    return rows


def onerow_sweep(gbps, dev):
    """The one-row gf4 kernel's k split on K8 at B = 1 (one Mistral-7B
    layer, 2-layer stacks cycled): gf4_row_plan's (k split towards
    G1_TARGET_WARPS warps while a warp keeps G1_MIN_WORDS words) against k
    whole and k split 4x further; each checked against the plain version,
    timed, and split by launch. The rows a warp are the kernel's own."""
    from calm_tpu_torch.ops import hopper_qmm as hq

    L, eps = 2, 1e-5
    ws = [rand_w((L, d, n // 8), "gf4", dev)
          for d, n in ((D, Q), (HID, D), (HID, D), (D, HID), (Q, D), (KV, D), (KV, D))]
    g = 1 + 0.1 * torch.randn(L, D, device=dev)
    anx = 1 + 0.1 * torch.randn(L, D, device=dev)
    a, r = torch.randn(1, Q, device=dev), torch.randn(1, D, device=dev)
    want = hq.gf4_offn_qkv_plain(a, r, g, anx, *ws, 1, False, eps, False)
    n_w = D * Q + 3 * HID * D + (Q + 2 * KV) * D
    b, _ = bound_ms(n_w // 2 + 4 * (3 * D + 2 * Q + 2 * KV), 2 * n_w, gbps)
    names = ("G1_TARGET_WARPS", "G1_MIN_WORDS")
    base = tuple(getattr(hq, k) for k in names)
    T, M = base
    prods = (("wo", D * Q / 2 + 4 * (Q + 2 * D)), ("w1/w3", HID * D + 4 * (D + HID)),
             ("w2", D * HID / 2 + 4 * (HID + 2 * D)),
             ("q/k/v", (Q + 2 * KV) * D / 2 + 4 * (D + Q + 2 * KV)))
    out = []
    try:
        for cfg in (base, (0, M), (4 * T, M // 4)):
            for k, v in zip(names, cfg):
                setattr(hq, k, v)
            hq._gf4_row_plan.cache_clear()
            hq._row_plans.cache_clear()
            plans = [hq.gf4_row_plan(rows, n, dual) for rows, n, dual in
                     (((D,), Q, False), ((HID,), D, True), ((D,), HID, False),
                      ((Q, KV, KV), D, False))]
            what = ("ks " + "/".join(str(p.ks) for p in plans)
                    + (" (the plan)" if cfg == base else ""))
            check(f"gf4_offn_qkv B=1 {what}",
                  hq.gf4_offn_qkv(a, r, g, anx, *ws, 1, False, eps, False), want, TOL_MV)
            ms, how = timed(lambda i: hq.gf4_offn_qkv(a, r, g, anx, *ws, i % L, False, eps,
                                                      False), floor=b)
            out.append(f"{what} {ms:.4f} ms ({how}, {100 * b / ms:.1f}% of bound)")
            by_launch(lambda i: hq.gf4_offn_qkv(a, r, g, anx, *ws, i % L, False, eps, False),
                      f"K8 B=1 {what}", prods, 4 * 3 * D, gbps)
    finally:
        for k, v in zip(names, base):
            setattr(hq, k, v)
        hq._gf4_row_plan.cache_clear()
        hq._row_plans.cache_clear()
    log(f"# K8 one layer B=1 by k split (bound_ms {b:.4f}): " + "; ".join(out))
    del ws
    torch.cuda.empty_cache()


def ragged_checks_onerow(dev):
    """The one-row gf4 kernel (K6, K7 and K8 at B = 1) on shapes the
    Mistral-7B rows do not reach, SiLU and GELU, random and all-subnormal
    scale bytes: K6 at D 1032 / H 11032 (129 and 1379 words a row: odd
    word counts), D 8 / H 1000 (one word a row of w1 and w3, 8 rows of w2)
    and D 1000 / H 14336 (125 words a row of w1 and w3, w2 at n = 14336);
    K7 at D 1032 / H 11032 / Qd 512 and D 1000 / H 14336 / Qd 8 (one
    word a row of wo), LayerNorm with GELU; K8 at D 384 / H 640 / Qd 256
    with KVd 128 and KVd 6, whose k and v segments end inside a 4-row
    group (every other row count is whole words', a multiple of 8).
    Subnormal scales are held each output to its own max|out|."""
    from calm_tpu_torch.ops import hopper_qmm as hq

    L, eps, n = 2, 1e-5, 0
    worst = {"gf4_ffn": 0.0, "gf4_offn": 0.0, "gf4_offn_qkv": 0.0}

    def words(kind, shape):
        return rand_w(shape, "gf4", dev) if kind == "random" else subnormal_gf4(shape, dev)
    for kind in ("random", "subnormal"):
        chk = check if kind == "random" else check_rows
        for Dm, Hm, Qm in ((1032, 11032, 512), (8, 1000, 0), (1000, 14336, 8)):
            w1, w3 = (words(kind, (L, Hm, Dm // 8)) for _ in range(2))
            w2 = words(kind, (L, Dm, Hm // 8))
            g = 1 + 0.1 * torch.randn(L, Dm, device=dev)
            for gelu in (False, True):
                x = torch.randn(1, Dm, device=dev)
                e = chk(f"gf4_ffn D={Dm} H={Hm} B=1 gelu={gelu} {kind} scales",
                        hq.gf4_ffn(x, w1, w3, w2, 1, gelu),
                        hq.gf4_ffn_plain(x, w1, w3, w2, 1, gelu), TOL_MV)
                worst["gf4_ffn"], n = max(worst["gf4_ffn"], e), n + 1
                if Qm:
                    wo = words(kind, (L, Dm, Qm // 8))
                    args = (torch.randn(1, Qm, device=dev), torch.randn(1, Dm, device=dev), g,
                            wo, w1, w3, w2, 1, gelu, eps, gelu)  # LayerNorm with GELU
                    what = f"D={Dm} H={Hm} Qd={Qm} B=1 gelu={gelu} {kind} scales"
                    got, want = hq.gf4_offn(*args), hq.gf4_offn_plain(*args)
                    e = (max(check_offn(what, got, want)) if kind == "random"
                         else check_rows(f"gf4_offn {what}", got, want, TOL_MV))
                    worst["gf4_offn"], n = max(worst["gf4_offn"], e), n + 1
            del w1, w3, w2
        Dm, Hm, Qm = 384, 640, 256
        for KVm in (128, 6):
            ws = [words(kind, (L, d, k // 8)) for d, k in ((Dm, Qm), (Hm, Dm), (Hm, Dm),
                                                           (Dm, Hm), (Qm, Dm), (KVm, Dm),
                                                           (KVm, Dm))]
            g = 1 + 0.1 * torch.randn(L, Dm, device=dev)
            anx = 1 + 0.1 * torch.randn(L, Dm, device=dev)
            for gelu in (False, True):
                for layer in range(L):
                    args = (torch.randn(1, Qm, device=dev), torch.randn(1, Dm, device=dev), g,
                            anx, *ws, layer, gelu, eps, gelu)
                    e = chk(f"gf4_offn_qkv D={Dm} H={Hm} Qd={Qm} KVd={KVm} B=1 gelu={gelu} "
                            f"layer {layer} {kind} scales", hq.gf4_offn_qkv(*args),
                            hq.gf4_offn_qkv_plain(*args), TOL_MV)
                    worst["gf4_offn_qkv"], n = max(worst["gf4_offn_qkv"], e), n + 1
            del ws
    torch.cuda.synchronize()
    log(f"# one-row gf4 kernel, ragged shapes: {n} checks within {TOL_MV:g} of max|out| "
        "(subnormal scales: of each output's), max_abs_err " + ", ".join(
            f"{k} {v:.3e}" for k, v in worst.items()))


def check_offn(name, got, want) -> list[float]:
    """K7's (ffn, r1) against its plain version's, each to its own scale."""
    return [check(f"gf4_offn {part} {name}", g, w, TOL_MV)
            for part, g, w in zip(("ffn", "r1"), got, want)]


def check_sum(name, got, want, seed, abs_sum, span, terms=1):
    """A streaming sum against its float64 plain version, within the
    worst-case bound of its f32 sums (``hopper_stream.error_bound``). The
    words must make the check able to fail: the bound under a tenth of
    |sum - seed|, so that a kernel returning the seed alone, or missing a
    fifth of a sum of like-signed values, is caught."""
    from calm_tpu_torch.ops import hopper_stream as hs

    g, w = got.item(), want.item()
    err, tol = abs(g - w), hs.error_bound(abs_sum, span, terms)
    if not 10 * tol < abs(w - seed):
        fail(f"{name}: bound {tol:.3e} is not under a tenth of |sum - seed| = "
             f"{abs(w - seed):.3e}: the check could not tell a wrong sum")
    if not err <= tol:
        fail(f"{name}: |{g} - {w}| = {err:.3e} > bound {tol:.3e}")
    key = name.split()[0]
    WORST_REL[key] = max(WORST_REL.get(key, 0.0), err / abs_sum)
    return err, tol


def stream_kernel_rows(gbps, dev):
    """K1 (stream_sum) over a 3 GB buffer, as the tools' largest: word i
    is i plus a random value below 2^30, so every word is positive (the sum
    is its own magnitude, far above the error bound) and a word read from
    the wrong place, past 2^31 bytes included, moves the sum; K15's decode
    over 8 planes of the tool's 16384 x 4096 gf4 matrix (33.5 MB each),
    cycled so that a call finds its plane cold."""
    from calm_tpu_torch.ops import hopper_stream as hs

    rows = {}
    n = 3 * (1 << 30) // 4
    w = torch.randint(0, 2**30, (n,), device=dev, dtype=torch.int32)
    w += torch.arange(n, device=dev, dtype=torch.int32)
    span = hs.span_for(n, dev)
    seed = torch.tensor([0.5], device=dev)
    err, tol = check_sum("stream_sum 3 GB", hs.stream_sum(w, seed),
                         hs.stream_sum_plain(w, seed), 0.5, hs.abs_sum(w), span)
    b, by = bound_ms(4 * n + 8, n, gbps)
    t = timings(lambda i: hs.stream_sum(w, seed), lambda i: hs.stream_sum_plain(w, seed),
                lambda i: torch.sum(w, dtype=torch.float32), 3, bound=b)
    log(f"# K1 stream_sum {4 * n / 1e6:.0f} MB, {n} words, span {span}: |err| {err:.3e} "
        f"(bound {tol:.3e}, worst case of its f32 sums); {ms_line(t)} "
        f"(torch.sum(dtype=float32)) bound_ms {b:.4f} ({by}); {share(t, b)}, "
        f"{4 * n / t['ms'] / 1e6:.1f} GB/s")
    rows["stream_sum"] = dict(t, bound_ms=b, bound_by=by, max_abs_err=err)
    del w
    torch.cuda.empty_cache()

    P, d, g = 8, 16384, 512
    w = rand_w((P, d, g), "gf4", dev)
    span = hs.span_for(d * g, dev)
    errs = []
    for full in (False, True):
        for p in (0, P - 1):
            e, tol = check_sum(f"gf4_decode_sum full={full} plane {p}",
                               hs.gf4_decode_sum(w[p], seed, full),
                               hs.gf4_decode_sum_plain(w[p], seed, full), 0.5,
                               hs.abs_sum(w[p], gf4=True), span, 8)
            errs.append(e)
    b, by = bound_ms(4 * d * g + 8, 16 * d * g, gbps)
    t = timings(lambda i: hs.gf4_decode_sum(w[i % P], seed, False),
                lambda i: hs.gf4_decode_sum_plain(w[i % P], seed, False), None, 3, bound=b)
    log(f"# K15 gf4_decode_sum {d}x{8 * g} (no bf16 cast): |err| {max(errs):.3e} (bound "
        f"{tol:.3e}); {ms_line(t)} bound_ms {b:.4f} ({by}); {share(t, b)}, "
        f"{4 * d * g / t['ms'] / 1e6:.1f} GB/s")
    rows["gf4_decode_sum"] = dict(t, bound_ms=b, bound_by=by, max_abs_err=max(errs))
    del w
    torch.cuda.empty_cache()
    return rows


def ragged_checks_ffn_stream(dev):
    """K6 and K7 on shapes the 7B rows do not reach: 1, 3 and 16 rows, a
    model width of 1032 (129 words a row), a hidden width of 11032 (1379
    words: not a multiple of a warp's 32 lanes), SiLU and GELU, LayerNorm,
    and K7 with Qd = 512 != D; K1 and K15 on lengths that are not a
    multiple of a block's span or of 4 words: one block with a tail of 3
    words, and hundreds of blocks, the last one ragged."""
    from calm_tpu_torch.ops import hopper_qmm as hq
    from calm_tpu_torch.ops import hopper_stream as hs

    worst = {"gf4_ffn": 0.0, "gf4_offn": 0.0}
    Dm, Hm, Qm, L = 1032, 11032, 512, 2
    w1, w3 = (rand_w((L, Hm, Dm // 8), "gf4", dev) for _ in range(2))
    w2, wo = rand_w((L, Dm, Hm // 8), "gf4", dev), rand_w((L, Dm, Qm // 8), "gf4", dev)
    g = 1 + 0.1 * torch.randn(L, Dm, device=dev)
    for B in (1, 3, 16):
        for gelu in (False, True):
            x = torch.randn(B, Dm, device=dev)
            e = check(f"gf4_ffn D={Dm} H={Hm} B={B} gelu={gelu}",
                      hq.gf4_ffn(x, w1, w3, w2, 1, gelu),
                      hq.gf4_ffn_plain(x, w1, w3, w2, 1, gelu), TOL_MV)
            worst["gf4_ffn"] = max(worst["gf4_ffn"], e)
            a, r = torch.randn(B, Qm, device=dev), torch.randn(B, Dm, device=dev)
            args = (a, r, g, wo, w1, w3, w2, 1, gelu, 1e-5, gelu)  # LayerNorm with GELU
            e = check_offn(f"D={Dm} H={Hm} Qd={Qm} B={B} gelu={gelu}",
                           hq.gf4_offn(*args), hq.gf4_offn_plain(*args))
            worst["gf4_offn"] = max(worst["gf4_offn"], *e)
    n_sum = 0
    for n in (7, 4099, 1000003, 33554431):
        # random words with finite positive gf4 scales: codes averaging -0.5
        # keep the decoded sum far from 0; the sign bit cleared for K1
        w = rand_w((n,), "gf4", dev)
        wp = w & 0x7FFFFFFF
        sp = hs.span_for(n, dev)
        seed = torch.tensor([-3.25], device=dev)
        check_sum(f"stream_sum n={n} span={sp}", hs.stream_sum(wp, seed),
                  hs.stream_sum_plain(wp, seed), -3.25, hs.abs_sum(wp), sp)
        for full in (False, True):
            check_sum(f"gf4_decode_sum n={n} span={sp} full={full}",
                      hs.gf4_decode_sum(w, seed, full),
                      hs.gf4_decode_sum_plain(w, seed, full), -3.25,
                      hs.abs_sum(w, gf4=True), sp, 8)
        n_sum += 3
    torch.cuda.synchronize()
    log("# ragged shapes (K6, K7, K1, K15): max_abs_err " + ", ".join(
        f"{k} {v:.3e}" for k, v in worst.items()) + f"; {n_sum} streaming sums within "
        "their bounds")


# Tolerances, relative to max |out| unless said otherwise.
TOL_MV = 1e-5  # f32-FMA kernels (K2, K3, K8, K9): f32 sums in another order
TOL_DA = 1e-4  # K12, absolute (outputs are O(1)): f32, another order
# K4, K5, K13 and qmm_mm8 round their activations (and q, p) once to
# bf16 as the TPU kernels do: 2^-9 relative per operand, ~1e-3 of max |out|
# on random data; the JAX package's own tests hold its kernels at 3e-2.
TOL_MM = 1e-2
TOL_ATT = 1e-2


def causal_pairs(pos0: int, T: int, kv_len: int) -> int:
    """(query, cache row) pairs the causal mask leaves visible."""
    return sum(min(kv_len, pos0 + t + 1) for t in range(T))


def prefill_kernel_rows(gbps, dev):
    """K13 at Mistral-7B shapes (32 heads, 8 kv heads, hd 128): T=2048 from
    position 0 with bf16, fp8 and fp16 KV, and T=512 at position 1024."""
    import torch.nn.functional as F

    from calm_tpu_torch.ops import hopper_attn as ha

    B, KVH, M, S, hd, L = 1, 8, 4, 4096, 128, 2
    errs, best = [], None
    for kvd, kvname, T, pos0 in ((torch.bfloat16, "bf16", 2048, 0),
                                 (torch.float8_e5m2, "fp8", 2048, 0),
                                 (torch.float16, "fp16", 2048, 0),
                                 (torch.bfloat16, "bf16", 512, 1024)):
        kc = (torch.randn(L, B, KVH, S, hd, device=dev) * 0.5).to(kvd)
        vc = torch.randn(L, B, KVH, S, hd, device=dev).to(kvd)
        q = torch.randn(B, T, KVH, M, hd, device=dev)
        p0 = torch.full((B,), pos0, dtype=torch.int32, device=dev)
        kl = p0 + T
        got = ha.prefill_attention(q, kc, vc, p0, kl, L - 1)
        errs.append(check(f"prefill_attention {kvname} T={T} pos0={pos0}", got,
                          ha.prefill_attention_plain(q, kc, vc, p0, kl, L - 1), TOL_ATT))
        kv = pos0 + T
        lib = None
        if pos0 == 0:
            q4 = q.reshape(B, T, KVH * M, hd).transpose(1, 2).bfloat16()
            kb = kc.bfloat16()[:, :, :, :kv]
            vb = vc.bfloat16()[:, :, :, :kv]

            def lib(i):
                return F.scaled_dot_product_attention(
                    q4, kb[i % L], vb[i % L], is_causal=True, enable_gqa=True)
        nb = 2 * B * T * KVH * M * hd * 4 + 2 * B * KVH * kv * hd * kc.element_size()
        flops = 4 * B * KVH * M * hd * causal_pairs(pos0, T, kv)
        b, by = bound_ms(nb, flops, gbps, PEAK_BF16)
        # a profiled time below the bound missed part of the call (the
        # library's causal SDPA once read 0.0240 ms against 0.0348)
        t = timings(lambda i: ha.prefill_attention(q, kc, vc, p0, kl, i % L),
                    lambda i: ha.prefill_attention_plain(q, kc, vc, p0, kl, i % L),
                    lib, 3, bound=b)
        log(f"# K13 prefill_attention {kvname} KV T={T} pos0={pos0} (B=1, KVH=8, "
            f"M=4, hd=128): max_abs_err {errs[-1]:.3e} (tol {TOL_ATT:g} x max|out|); "
            f"{ms_line(t)} (bf16 causal SDPA) bound_ms {b:.4f} ({by}, "
            f"{flops / 1e9:.1f} GFLOP); {share(t, b)}")
        if kvname == "bf16" and T == 2048:
            best = dict(t, bound_ms=b, bound_by=by)
        del kc, vc, q
    return {"prefill_attention": dict(best, max_abs_err=max(errs))}


def prefill_corner_checks(dev):
    """K13 at the corners of its TMA + wgmma design, against its plain
    version within TOL_ATT of max |out|, at every head dim and cache dtype:
    T * M off the 128-row query tile, starts off a 128-row cache tile,
    kv_len below the causal end (and a sequence with nothing to see), M =
    1, 3, 4 and 8, a read from slot 3 of a 5-slot cache, and the sp prefill's
    one-layer gathered cache (model.py:874-877: S = the whole prompt, this
    rank's chunk at pos0 = T)."""
    from calm_tpu_torch.ops import hopper_attn as ha

    worst, n = 0.0, 0
    # (B, T, KVH, M, starts, kv_len below the causal end, L, S, Bc, batch_off)
    corners = (
        (2, 37, 2, 4, (0, 100), (0, 0), 2, 512, 2, 0),       # T * M off the tile
        (2, 100, 2, 3, (130, 7), (0, 0), 2, 512, 2, 0),      # M = 3, starts off a tile
        (1, 129, 3, 1, (5,), (0,), 2, 512, 1, 0),            # M = 1
        (2, 77, 2, 8, (0, 300), (20, 0), 2, 512, 2, 0),      # M = 8, kv_len short
        (2, 50, 2, 4, (100, 7), (60, 57), 2, 512, 5, 3),     # slot 3 of 5; nothing seen
        (1, 64, 2, 4, (64,), (0,), 1, 128, 1, 0),            # sp: gathered, pos0 = T
    )
    for hd in ha.HEAD_DIMS:
        for kvd in (torch.bfloat16, torch.float16, torch.float8_e5m2):
            for B, T, KVH, M, starts, short, L, S, Bc, boff in corners:
                kc = kv_rand((L, Bc, KVH, S, hd), kvd, dev, 0.5)
                vc = kv_rand((L, Bc, KVH, S, hd), kvd, dev)
                q = torch.randn(B, T, KVH, M, hd, device=dev)
                p0 = torch.tensor(starts, dtype=torch.int32, device=dev)
                kl = (p0 + T - torch.tensor(short, dtype=torch.int32, device=dev)).clamp_min(0)
                kl = kl.to(torch.int32)
                name = (f"prefill_attention hd={hd} {kvd} B={B} T={T} M={M} starts={starts} "
                        f"kv_len={kl.tolist()} L={L} S={S} batch_off={boff}")
                got = ha.prefill_attention(q, kc, vc, p0, kl, L - 1, boff)
                want = ha.prefill_attention_plain(q, kc, vc, p0, kl, L - 1, boff)
                if not bool(torch.isfinite(got).all()):
                    fail(f"{name}: non-finite output")
                worst = max(worst, check(name, got, want, TOL_ATT))
                n += 1
    torch.cuda.synchronize()
    log(f"# K13 corners: {n} checks (hd {ha.HEAD_DIMS} x bf16/fp16/e5m2 x T*M off the "
        f"query tile, starts off a cache tile, short kv_len, M 1/3/4/8, slot 3 of 5, the "
        f"sp gathered cache), max_abs_err {worst:.3e} (tol {TOL_ATT:g} x max|out|)")


def gf4_kernel_rows(gbps, dev):
    """K3 at the gf4 lm-head (32000 x 4096) and w2 (4096 x 14336), B=1; K4
    at T=2048 for w1 (14336 x 4096) and K5 for w2 (4096 x 14336)."""
    from calm_tpu_torch.ops import hopper_qmm as hq
    from calm_tpu_torch.ops.qmm import QTensor, dequant

    rows = {}
    errs, best = [], None
    for name, d, n, L in (("lm-head", 32000, 4096, 1), ("w2", 4096, 14336, 8)):
        w = rand_w((L, d, n // 8), "gf4", dev)  # w2: 8 planes, 235 MB > L2
        x = torch.randn(1, n, device=dev)
        errs.append(check(f"qmm_decode_gf4 {name}", hq.qmm_decode_gf4(x, w, L - 1),
                          hq.qmm_decode_gf4_plain(x, w, L - 1), TOL_MV))
        wb = dequant(QTensor(w, "gf4"), torch.bfloat16)
        b, by = bound_ms(d * n // 2 + 4 * (n + d), 2 * d * n, gbps)
        t = timings(lambda i: hq.qmm_decode_gf4(x, w, i % L),
                    lambda i: hq.qmm_decode_gf4_plain(x, w, i % L),
                    lambda i: torch.matmul(x.bfloat16(), wb[i % L].T), bound=b)
        log(f"# K3 qmm_decode_gf4 {name} {d}x{n} B=1: max_abs_err {errs[-1]:.3e} "
            f"(tol {TOL_MV:g} x max|y|); {ms_line(t)} (bf16 matmul, pre-dequantized) "
            f"bound_ms {b:.4f} ({by}, {d * n / 2e6:.1f} MB); {share(t, b)}")
        if name == "lm-head":
            best = dict(t, bound_ms=b, bound_by=by)
        del w, wb
    rows["qmm_decode_gf4"] = dict(best, max_abs_err=max(errs))

    R, L = 2048, 2
    for key, fn, name, d, n in (("qmm_prefill", hq.qmm_prefill, "K4 w1", 14336, 4096),
                                ("qmm_prefill_w2", hq.qmm_prefill_w2, "K5 w2", 4096, 14336)):
        w = rand_w((L, d, n // 8), "gf4", dev)
        x = torch.randn(R, n, device=dev)
        err = check(f"{key} {name}", fn(x, w, L - 1), hq.qmm_prefill_plain(x, w, L - 1),
                    TOL_MM)
        wb = dequant(QTensor(w, "gf4"), torch.bfloat16)
        xb = x.bfloat16()
        flops = 2 * R * d * n
        b, by = bound_ms(4 * R * n + d * n // 2 + 4 * R * d, flops, gbps, PEAK_BF16)
        t = timings(lambda i: fn(x, w, i % L),
                    lambda i: hq.qmm_prefill_plain(x, w, i % L),
                    lambda i: torch.matmul(xb, wb[i % L].T), 3, bound=b)
        # the model rounds x once for several products: the kernel alone
        # (a profiled time below the bound missed part of the call)
        ms_b, how_b = timed(lambda i: fn(xb, w, i % L), floor=b)
        log(f"# {name} {key} {d}x{n} R={R}: max_abs_err {err:.3e} "
            f"(tol {TOL_MM:g} x max|y|); {ms_line(t)} (bf16 matmul, pre-dequantized; "
            f"kernel_ms from an f32 x, its cast included) bound_ms {b:.4f} ({by}, "
            f"{flops / 1e9:.1f} GFLOP); {share(t, b)}, {flops / t['ms'] / 1e9:.1f} "
            f"TFLOP/s; from a bf16 x {ms_b:.4f} ms ({how_b}), "
            f"{flops / ms_b / 1e9:.1f} TFLOP/s, kernel/library "
            f"{ms_b / t['library_ms']:.2f}x")
        rows[key] = dict(t, bound_ms=b, bound_by=by, max_abs_err=err, bf16_x_ms=ms_b)
        del w, wb, x, xb
    return rows


def ragged_checks_prefill_gf4(dev):
    """K3/K4/K5/K13 on shapes the Mistral-7B rows do not reach: ragged rows
    (33, 100, 2047), a hidden width of 11008 (1376 words a row), a width
    whose words per row are not a multiple of 4, d off the tile; K13 with T
    off the 16-query tile, two sequences at other starts, head_dim 64 with
    8 query heads per kv head, fp16 and fp8 caches. Also the products no
    kernel takes under --precise (``dense_matmul``'s f32 product) against
    the f32 product."""
    from calm_tpu_torch.ops import hopper_attn as ha
    from calm_tpu_torch.ops import hopper_qmm as hq
    from calm_tpu_torch.ops.qmm import QTensor, dense_matmul, qmatmul

    worst = {"qmm_decode_gf4": 0.0, "qmm_prefill": 0.0, "prefill_attention": 0.0,
             "dense_matmul": 0.0}
    for fmt, R in (("fp8", 100), ("fp16", 100), ("gf4", 20)):
        qt = QTensor(rand_w((2, 1003, 1040 // (8 if fmt == "gf4" else 1)), fmt, dev), fmt)
        x = torch.randn(R, 1040, device=dev)
        e = check(f"dense_matmul {fmt} R={R}", dense_matmul(x, qt, 1),
                  qmatmul(x, qt, 1), TOL_MM)
        worst["dense_matmul"] = max(worst["dense_matmul"], e)
    for d, n in ((1003, 1040), (4096, 11008)):
        w = rand_w((2, d, n // 8), "gf4", dev)
        for B in (1, 3, 16):
            x = torch.randn(B, n, device=dev)
            e = check(f"qmm_decode_gf4 {d}x{n} B={B}", hq.qmm_decode_gf4(x, w, 1),
                      hq.qmm_decode_gf4_plain(x, w, 1), TOL_MV)
            worst["qmm_decode_gf4"] = max(worst["qmm_decode_gf4"], e)
        for R in (33, 100, 2047):
            x = torch.randn(R, n, device=dev)
            for fn in (hq.qmm_prefill, hq.qmm_prefill_w2):
                e = check(f"{fn.__name__} {d}x{n} R={R}", fn(x, w, 1),
                          hq.qmm_prefill_plain(x, w, 1), TOL_MM)
                worst["qmm_prefill"] = max(worst["qmm_prefill"], e)
    L, S = 2, 512
    for kvd in (torch.float16, torch.bfloat16, torch.float8_e5m2):
        for hd, KVH, M, T, starts in ((64, 2, 8, 100, (0, 37)),
                                      (128, 2, 4, 33, (300, 5))):
            B = len(starts)
            kc = torch.randn(L, B, KVH, S, hd, device=dev).to(kvd)
            vc = torch.randn(L, B, KVH, S, hd, device=dev).to(kvd)
            q = torch.randn(B, T, KVH, M, hd, device=dev)
            p0 = torch.tensor(starts, dtype=torch.int32, device=dev)
            kl = p0 + T
            e = check(f"prefill_attention {kvd} hd={hd} M={M} T={T} starts={starts}",
                      ha.prefill_attention(q, kc, vc, p0, kl, 1),
                      ha.prefill_attention_plain(q, kc, vc, p0, kl, 1), TOL_ATT)
            worst["prefill_attention"] = max(worst["prefill_attention"], e)
    torch.cuda.synchronize()
    log("# ragged shapes (prefill, gf4): max_abs_err " + ", ".join(
        f"{k} {v:.3e}" for k, v in worst.items()))


def ragged_checks(dev):
    """The kernels' other template paths, which the B=1 Mistral-7B path
    does not reach, against their plain versions at small shapes: 3 and 16
    activation rows with a ragged last block of rows; the fused epilogues
    (fp8, fp16, gf4) at B=2 and 5 with GELU and LayerNorm over a 3-layer
    stack; attention in plain and fresh mode at B=2 with per-row kv_len,
    head_dim 64 and 128, 8 and 16 query rows per kv head, every cache
    dtype."""
    from calm_tpu_torch.ops import hopper_attn as ha
    from calm_tpu_torch.ops import hopper_qmm as hq

    worst = {"qmm_decode": 0.0, "qx_offn_qkv": 0.0, "gf4_offn_qkv": 0.0,
             "decode_attention": 0.0}
    for fmt in ("fp8", "fp16"):
        w = rand_w((2, 1003, 1040), fmt, dev)  # 1003 rows: a ragged last block
        for B in (3, 16):
            x = torch.randn(B, 1040, device=dev)
            e = check(f"qmm_decode {fmt} B={B}", hq.qmm_decode(x, w, fmt, 1),
                      hq.qmm_decode_plain(x, w, fmt, 1), TOL_MV)
            worst["qmm_decode"] = max(worst["qmm_decode"], e)
    L, D, H, Qd, KVd = 3, 512, 768, 512, 128
    g = 1 + 0.1 * torch.randn(L, D, device=dev)
    anx = 1 + 0.1 * torch.randn(L, D, device=dev)
    for fmt in ("fp8", "fp16", "gf4"):
        gs = 8 if fmt == "gf4" else 1
        ws = [rand_w((L, d, n // gs), fmt, dev)
              for d, n in ((D, Qd), (H, D), (H, D), (D, H), (Qd, D), (KVd, D), (KVd, D))]
        key = "gf4_offn_qkv" if fmt == "gf4" else "qx_offn_qkv"
        for B in (2, 5):
            a, r = torch.randn(B, Qd, device=dev), torch.randn(B, D, device=dev)
            for layer in range(L):
                if fmt == "gf4":
                    args = (a, r, g, anx, *ws, layer, True, 1e-5, True)
                    got, want = hq.gf4_offn_qkv(*args), hq.gf4_offn_qkv_plain(*args)
                else:
                    args = (a, r, g, anx, *ws, layer, fmt, True, 1e-5, True)
                    got, want = hq.qx_offn_qkv(*args), hq.qx_offn_qkv_plain(*args)
                e = check(f"{key} {fmt} B={B} layer {layer}", got, want, TOL_MV)
                worst[key] = max(worst[key], e)
    B, KVH, S, L = 2, 2, 1000, 2
    kl = torch.tensor([700, 1000], dtype=torch.int32, device=dev)
    kp = torch.tensor([3, 999], dtype=torch.int32, device=dev)
    for kvd in (torch.float16, torch.bfloat16, torch.float8_e5m2):
        for hd, M in ((64, 16), (128, 8)):
            kc = torch.randn(L, B, KVH, S, hd, device=dev).to(kvd)
            vc = torch.randn(L, B, KVH, S, hd, device=dev).to(kvd)
            q = torch.randn(B, KVH * M, hd, device=dev)
            fr = (torch.randn(B, KVH, hd, device=dev).to(kvd),
                  torch.randn(B, KVH, hd, device=dev).to(kvd), kp)
            for fresh in (None, fr):
                e = max_err(ha.decode_attention(q, kc, vc, kl, 1, fresh),
                            ha.decode_attention_plain(q, kc, vc, kl, 1, fresh))
                if not e <= TOL_DA:
                    fail(f"decode_attention {kvd} hd={hd} M={M} "
                         f"fresh={fresh is not None}: {e:.3e} > {TOL_DA}")
                worst["decode_attention"] = max(worst["decode_attention"], e)
    torch.cuda.synchronize()
    log("# ragged shapes: max_abs_err " + ", ".join(
        f"{k} {v:.3e}" for k, v in worst.items()))


# a prompt of more than 100 byte tokens: its prefill takes the gf4 matmul
PROMPT_LONG = ("Batched prefill runs every prompt token through each layer at "
               "once: the projections as matrix products, then causal flash "
               "attention over the cache.")
TOL_STEP = 1e-3     # decode logits, rel. to max |logit|: f32 sums in another
                    # order, bf16 KV
TOL_PREFILL = 1e-2  # logits after a prefill, rel. to max |logit|: activations,
                    # q and p rounded once to bf16 as on the TPU (PERF.md)


def counters():
    """kernel name -> (wrapper, the attribute that counts its launches);
    a wrapper or counter that an older tree lacks (``chip_compare.py``
    drives one) is left out."""
    from calm_tpu_torch.ops import hopper_attn as ha
    from calm_tpu_torch.ops import hopper_collectives as hc
    from calm_tpu_torch.ops import hopper_qmm as hq
    from calm_tpu_torch.ops import hopper_stream as hs
    fns = {"qmm_decode": hq.qmm_decode, "qx_offn_qkv": hq.qx_offn_qkv,
           "decode_attention": ha.decode_attention,
           "prefill_attention": ha.prefill_attention,
           "qmm_decode_gf4": hq.qmm_decode_gf4, "qmm_prefill": hq.qmm_prefill,
           "qmm_prefill_w2": hq.qmm_prefill_w2, "gf4_offn_qkv": hq.gf4_offn_qkv,
           "qmm_moe_dense": hq.qmm_moe_dense, "gf4_moe_ffn": hq.gf4_moe_ffn,
           "qmm_moe_ffn": getattr(hq, "qmm_moe_ffn", None),
           "qmm_mm8": getattr(hq, "qmm_mm8", None),
           "gf4_ffn": hq.gf4_ffn, "gf4_offn": hq.gf4_offn,
           "stream_sum": hs.stream_sum, "gf4_decode_sum": hs.gf4_decode_sum,
           "ring_all_reduce": hc.ring_all_reduce}
    out = {k: (f, "launches") for k, f in fns.items()}
    out["decode_attention_paged"] = (ha.decode_attention, "paged_launches")
    out["qmm_decode_multirow"] = (hq.qmm_decode, "multirow_launches")
    out["qx_offn_qkv_multirow"] = (hq.qx_offn_qkv, "multirow_launches")
    out["gf4_offn_qkv_multirow"] = (hq.gf4_offn_qkv, "multirow_launches")
    out["gf4_ffn_multirow"] = (hq.gf4_ffn, "multirow_launches")
    out["qmm_decode_gf4_multirow"] = (hq.qmm_decode_gf4, "multirow_launches")
    out["gf4_offn_multirow"] = (hq.gf4_offn, "multirow_launches")
    out["qmm_moe_dense_multirow"] = (hq.qmm_moe_dense, "multirow_launches")
    out["qmm_moe_ffn_multirow"] = (fns["qmm_moe_ffn"], "multirow_launches")
    out["gf4_moe_ffn_multirow"] = (hq.gf4_moe_ffn, "multirow_launches")
    # the wide path: 17-64 rows (a verify's 8 x 5, ticks of 17-64 slots)
    out["qmm_decode_wide"] = (hq.qmm_decode, "wide_launches")
    out["qmm_decode_gf4_wide"] = (hq.qmm_decode_gf4, "wide_launches")
    out["qmm_moe_dense_wide"] = (hq.qmm_moe_dense, "wide_launches")
    out["qmm_moe_ffn_wide"] = (fns["qmm_moe_ffn"], "wide_launches")
    out["gf4_moe_ffn_wide"] = (hq.gf4_moe_ffn, "wide_launches")
    out["decode_attention_partials"] = (ha.decode_attention, "partials_launches")
    out["prefill_attention_split"] = (ha.prefill_attention, "split_launches")
    out["tree_attention"] = (getattr(ha, "tree_attention", None), "launches")
    from calm_tpu_torch.graphs import StepGraph, VerifyGraph
    count_replays()
    if hasattr(StepGraph, "replays"):  # an older tree counts its replays itself
        out["graph_replays"] = (StepGraph, "replays")
        out["verify_replays"] = (VerifyGraph, "replays")
    else:
        out["graph_replays"] = (REPLAYS, "step")  # replays of captured steps
        out["verify_replays"] = (REPLAYS, "verify")  # replays of captured verifies
    return {k: (f, a) for k, (f, a) in out.items() if hasattr(f, a)}


class _Replays:
    step = 0
    verify = 0


REPLAYS = _Replays()  # the replays count_replays() has counted


def count_replays():
    """Count a replay's launches on the kernel wrappers' counters, as the
    eager step counts them, and the replays in ``REPLAYS``: the package's
    wrappers count in Python, which a replay does not run, and its graphs
    count a replay only in ``ops.cost``'s ``graph.replays``. A capture runs
    its body twice (the eager warm-up, then the capture), so half of what
    a capture counted is taken back and added again on each replay. Once a
    process; an older tree whose graphs count their replays themselves
    (``StepGraph.replays``) is left as it is."""
    from calm_tpu_torch.graphs import StepGraph, VerifyGraph
    if hasattr(StepGraph, "replays") or getattr(StepGraph, "smoke_counted", False):
        return
    StepGraph.smoke_counted = True

    def launch_attrs():
        return list({(id(f), a): (f, a) for f, a in counters().values()
                     if f is not REPLAYS}.values())

    def counting(cls, kind):
        real_capture, real_replay = cls.capture, cls.replay

        def capture(self):
            attrs = launch_attrs()
            before = [getattr(f, a) for f, a in attrs]
            real_capture(self)
            made = [(f, a, getattr(f, a) - n) for (f, a), n in zip(attrs, before)]
            if any(n % 2 for _, _, n in made):
                fail(f"a {kind} capture counted an odd number of launches: "
                     f"{[(a, n) for _, a, n in made if n % 2]}")
            self.smoke_launches = [(f, a, n // 2) for f, a, n in made if n]
            for f, a, n in self.smoke_launches:
                setattr(f, a, getattr(f, a) - n)

        def replay(self, *args):
            real_replay(self, *args)
            for f, a, n in self.smoke_launches:
                setattr(f, a, getattr(f, a) + n)
            setattr(REPLAYS, kind, getattr(REPLAYS, kind) + 1)
        cls.capture, cls.replay = capture, replay
    counting(StepGraph, "step")
    counting(VerifyGraph, "verify")


def drive(run):
    """``run()`` with every launch count set to 0 just before it; returns
    its result and the counts read just after."""
    fns = counters()
    for f, attr in fns.values():
        setattr(f, attr, 0)
    out = run()
    torch.cuda.synchronize()
    return out, {k: getattr(f, attr) for k, (f, attr) in fns.items()}


def cli(path, args, stdin_path=os.devnull):
    """The CLI in its own process on the card, started now, read later."""
    with open(stdin_path) as stdin:
        return subprocess.Popen([sys.executable, "-m", "calm_tpu_torch.cli", path]
                                + args, cwd=ROOT, stdin=stdin, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)


def margin(logits) -> float:
    """The gap between the two largest logits, relative to max |logit|."""
    top = np.sort(logits)[-2:]
    return float((top[1] - top[0]) / np.abs(logits).max())


def greedy_agrees(what, got: int, logits_cpu, tol: float) -> bool:
    """The card's greedy id against the CPU's at one position: equal, or
    else the CPU's top two logits lie within ``tol`` of the scale, a
    near-tie that the operands' rounding may decide either way (then
    False). A clear disagreement fails the run."""
    want = int(logits_cpu.argmax())
    if got == want:
        return True
    if margin(logits_cpu) > tol:
        fail(f"{what}: greedy id {got} != CPU {want}, top-2 margin "
             f"{margin(logits_cpu):.3e} of scale > {tol}")
    return False


def same_generation(what, cpu, prompt_toks, got, want, tol) -> str:
    """Greedy ids generated on the card against the CPU's: equal, or equal
    up to a position where the CPU's next-token logits are a near-tie."""
    n = next((i for i, (g, c) in enumerate(zip(got, want)) if g != c), None)
    if n is None:
        if len(got) != len(want) or len(got) < 8:
            fail(f"{what}: greedy ids {got} != CPU {want}")
        return f"ids equal ({got})"
    cpu.reset()
    greedy_agrees(f"{what}, id {n}", got[n], cpu.prefill_tokens(prompt_toks + want[:n]),
                  tol)
    return f"ids equal up to {n}, then a near-tie ({got[:n + 1]}...)"


def unrotated_steps(eng, steps, what):
    """``steps`` [(token, CPU logits)] decoded again on the card with
    ROTATED_DECODE off (CALM_ROT=0: each layer's own q/k/v, then gf4_offn,
    K7), held to the CPU's logits. Returns the launch counts of that run."""
    from calm_tpu_torch import model as M

    was, M.ROTATED_DECODE = M.ROTATED_DECODE, False
    try:
        eng.step(steps[0][0], 0)  # captures this step's graph, its warm-up outside the count
        eng.reset()
        lgs, counts = drive(lambda: [eng.step(tok, pos) for pos, (tok, _) in enumerate(steps)])
    finally:
        M.ROTATED_DECODE = was
    worst, ties = 0.0, 0
    for pos, (lg, (_, lc)) in enumerate(zip(lgs, steps)):
        worst = max(worst, float(np.abs(lg - lc).max() / np.abs(lc).max()))
        ties += not greedy_agrees(f"{what} CALM_ROT=0 step {pos}", int(lg.argmax()), lc,
                                  TOL_STEP)
    n_l = eng.cfg.n_layers * len(steps)
    if worst > TOL_STEP or counts["gf4_offn"] != n_l or counts["gf4_offn_qkv"]:
        fail(f"{what} CALM_ROT=0: logits {worst:.3e} from the CPU (tol {TOL_STEP}), "
             f"launches {counts}")
    log(f"# {what} CALM_ROT=0 vs cpu: {len(steps)} steps, max logit diff {worst:.3e} of "
        f"scale (tol {TOL_STEP:g}), {ties} near-ties; gf4_offn {counts['gf4_offn']} "
        f"launches, gf4_offn_qkv 0")
    return counts


# Aya 23 8B (CohereForAI/aya-23-8B, CohereForCausalLM, its public
# config.json): Mistral-7B's widths with a vocab of 256000, parallel
# LayerNorm (layernorm_par, eps 1e-5), SiLU, rope_theta 10000, tied
# embeddings; logit_scale is folded into model.norm.weight by the converter
AYA = dict(MISTRAL, vocab_size=256000)
AYA_VOCAB_CUT = 32000  # the 2-layer container's: the CPU's plain lm-head


def fp16_twin(w):
    """The weights with every gf4 tensor decoded once to fp16: exact (a
    gf4 value is a 3-bit code less 4 times an e5m2 scale / 4, at most 5
    significant bits, and e5m2's exponent range lies inside f16's), so the
    CPU's plain products see the same f32 values."""
    import dataclasses

    from calm_tpu_torch import model as M
    from calm_tpu_torch.ops.qmm import QTensor, gf4_decode_words

    def twin(v):
        if isinstance(v, QTensor) and v.fmt == "gf4":
            return QTensor(gf4_decode_words(v.data, torch.float16), "fp16")
        return v
    lw = w.layers
    layers = dataclasses.replace(lw, **{f.name: twin(getattr(lw, f.name))
                                        for f in dataclasses.fields(lw)})
    embed = twin(w.embed)
    return M.Weights(embed=embed, layers=layers, final_norm=w.final_norm,
                     output=embed if w.output is w.embed else twin(w.output))


def cpu_reference(path, what, context: int = 0):
    """The CPU plain path on a container (at ``context``, 0: the
    container's), the reference of the card's checks: (engine, a note for
    the log or None). A gf4 container's CPU
    engine runs on ``fp16_twin`` weights: its products widen fp16 instead
    of decoding words, the same f32 values into the same f32 products,
    several times faster (held bit for bit to the gf4 engine on one step
    here)."""
    from calm_tpu_torch.engine import Engine

    cpu = Engine(path, context=context, device="cpu")
    if cpu.cfg.dtype != "gf4":
        return cpu, None
    t0 = time.perf_counter()
    twin = Engine.from_weights(cpu.cfg, fp16_twin(cpu.weights), cpu.tokenizer,
                               n_bytes=cpu.n_bytes, n_params=cpu.n_params,
                               n_bandwidth=cpu.n_bandwidth, device="cpu")
    a, b = cpu.step(3, 0), twin.step(3, 0)
    if not np.array_equal(a, b):
        fail(f"{what}: the fp16 twin's CPU logits differ from the gf4 CPU path's by "
             f"{np.abs(a - b).max():.3e}")
    twin.reset()
    return twin, (f"# {what}: CPU reference on the exact fp16 decode of the gf4 words, its "
                  f"first step bit-equal to the gf4 CPU path's "
                  f"({time.perf_counter() - t0:.1f} s)")


class LazyCPU:
    """A container's CPU reference engine, built at first use: the rare
    near-tie checks (``same_generation``) that ask the CPU for one more
    prefill than the worker computed (``cpu_side``)."""

    def __init__(self, path, what):
        self._args, self._eng = (path, what), None

    def __getattr__(self, name):
        if self._eng is None:
            self._eng, note = cpu_reference(*self._args)
            if note:
                log(note)
        return getattr(self._eng, name)


# The container phases' CPU side runs in a worker process while the card runs
# the phases before them (``cpu_side``): the CPU plain path is most of those
# phases' time, and the card's checks need its results only at the end.
CPU_THREADS = 6  # the worker's threads: two of the host's cores stay the card's
# (fmt, experts, cohere) of the 2-layer containers, in the order of their phases
CONTAINERS = (("fp8", 0, False), ("gf4", 0, False), ("gf4", 0, True), ("fp8", 0, True),
              ("fp8", 4, False), ("gf4", 4, False), ("fp8e4", 0, False),
              ("fp8e4", 4, False))


def container_kind(fmt, experts: int = 0, cohere: bool = False) -> dict:
    """A 2-layer container's config, names and the checks its phase runs
    (``container_phase``'s docstring)."""
    from calm_tpu_torch.config import ModelConfig

    moe = dict(n_experts=experts, n_experts_ac=2, rope_theta=1e6) if experts else {}
    arch = (dict(norm_ln=True, norm_par=True, vocab_size=AYA_VOCAB_CUT) if cohere
            else dict(norm_ln=False))
    cfg = ModelConfig(**{**MISTRAL, "n_layers": 2, "rope_theta": 10000.0, **moe, **arch},
                      seq_len=4096, rotary_dim=128, dtype=fmt, bos_token_id=1,
                      eos_token_id=2)
    name = "aya23-8b" if cohere else f"mixtral{experts}x7b" if experts else "mistral7b"
    return dict(cfg=cfg, name=name, what=f"{fmt} {name}-width",
                # generate and prefill against the CPU only
                light=(cohere and fmt == "fp8") or (fmt == "fp8e4" and experts > 0),
                served=fmt != "fp8e4",
                precise=fmt in ("fp8", "gf4") and not (experts or cohere),
                speculative=fmt == "fp8" and not (experts or cohere),
                full=not (experts or cohere),  # the whole serving check
                # fp8 with a short prompt (decode kernels), gf4 with a long
                # one (its prefill takes the gf4 matmul)
                prompt="The quick brown fox" if fmt != "gf4" else PROMPT_LONG)


def write_containers(tmp, dev) -> dict:
    """Every container of ``CONTAINERS`` written into ``tmp`` on the card,
    from seeded random bits (not the bit pattern: its rows are all alike;
    fp8e4: seeded floats quantized tensor by tensor, as the converter
    does). Returns {(fmt, experts, cohere): path}."""
    from calm_tpu_torch.utils.synth import synth_container

    out = {}
    for key in CONTAINERS:
        k = container_kind(*key)
        path = os.path.join(tmp, f"{k['name']}-width-2l-{key[0]}.calm")
        t0 = time.perf_counter()
        synth_container(path, k["cfg"], seed=1, device=dev, random=True, tied=key[2])
        log(f"# {k['what']} engine: wrote {os.path.getsize(path) / 1e9:.2f} GB container "
            f"in {time.perf_counter() - t0:.1f} s")
        out[key] = path
    return out


def native_checks(paths, what: str) -> None:
    """The native host library (``calm_tpu_torch.native``, built from
    native/*.cc with g++): it builds here, its parser accepts each
    container of ``paths``, and each one's tokenizer encodes through it,
    with the Python encoder's ids on the container phases' prompts. No
    fallback: a missing library fails the run."""
    from calm_tpu_torch import native
    from calm_tpu_torch.container import TensorFile
    from calm_tpu_torch.tokenizer import Tokenizer

    t0 = time.perf_counter()
    if not native.available():
        fail(f"the native host library did not build: {native.last_error()}")
    texts = ([PROMPT_LONG, "The quick brown fox", "hello", "hello there\n", PRECISE_PROMPT,
              "Hi", PROMPT_LONG * 3] + [r[0] for r in SERVE_REQUESTS])
    n_bytes = 0
    for p in paths:
        data = bytearray(os.path.getsize(p))
        with open(p, "rb") as f:
            f.readinto(data)
        n_bytes += len(data)
        if not native.parse_bytes(data):
            fail(f"native: the parser refused {p}: {native.last_error()}")
        del data
        tf = TensorFile(p)
        tok = Tokenizer.from_container(tf)
        os.environ["CALM_TPU_NO_NATIVE"] = "1"
        try:
            py = Tokenizer.from_container(tf)
        finally:
            del os.environ["CALM_TPU_NO_NATIVE"]
        if tok._native is None or py._native is not None:
            fail(f"native: the tokenizer of {p} does not encode through the library")
        for text in texts:
            for bos in (True, False):
                if tok.encode(text, bos=bos) != py.encode(text, bos=bos):
                    fail(f"native: ids of {text[:40]!r} differ from the Python encoder's")
    log(f"# native host library {os.path.basename(native.library_path())}: built, parsed "
        f"{len(paths)} {what} containers ({n_bytes / 1e9:.2f} GB) from memory, each "
        f"tokenizer encodes natively with the Python encoder's ids on {len(texts)} "
        f"prompts; {time.perf_counter() - t0:.1f} s")


def cpu_side(path, fmt, experts, cohere) -> dict:
    """The CPU plain path's side of ``container_phase``'s checks on one
    container, for a worker process (CPU only, ``CPU_THREADS`` threads):
    the same calls in the same order as the phase made them on its CPU
    engine. Returns their results: 8 greedy steps from token 1 (each fed
    the CPU's id), the greedy generate of the phase's prompt, a prefill of
    ``PROMPT_LONG`` and 8 steps after it, and where the phase runs them
    the perplexity, the ``--precise`` generate's and the speculative
    generate's reference ids, and the CPU server's requests and logits;
    ``notes``: lines for the log."""
    try:
        torch.set_num_threads(CPU_THREADS)
        k = container_kind(fmt, experts, cohere)
        t0 = time.perf_counter()
        cpu, note = cpu_reference(path, k["what"])
        with dequant_once(cpu.weights):
            return _cpu_checks(cpu, k, note, t0)
    except SystemExit:  # fail() logged why; a pool's worker passes on exceptions only
        raise RuntimeError(f"the CPU side of {fmt} experts={experts} cohere={cohere} failed")


@contextlib.contextmanager
def dequant_once(weights):
    """The CPU plain path with each plane of ``weights`` dequantized once:
    ``dequant`` of a view of those weights' own storage keeps its result
    (the same values; every caller only reads them), so a CPU step reads
    f32 planes instead of decoding every plane again. Anything else (a
    gathered expert stack) is decoded as before. For the worker process
    that runs nothing but the CPU side."""
    import dataclasses

    from calm_tpu_torch.ops import hopper_qmm, qmm
    from calm_tpu_torch.ops.qmm import QTensor

    stores = set()

    def collect(v):
        if isinstance(v, QTensor):
            v = v.data
        if isinstance(v, torch.Tensor):
            stores.add(v.untyped_storage().data_ptr())
        elif dataclasses.is_dataclass(v):
            for f in dataclasses.fields(v):
                collect(getattr(v, f.name))
    collect(weights)
    real, kept = qmm.dequant, {}

    def dequant(qt, dtype=torch.float32):
        d = qt.data
        if qt.scale is not None or d.untyped_storage().data_ptr() not in stores:
            return real(qt, dtype)
        key = (d.untyped_storage().data_ptr(), d.storage_offset(), tuple(d.shape),
               tuple(d.stride()), qt.fmt, dtype)
        if key not in kept:
            kept[key] = real(qt, dtype)
        return kept[key]
    qmm.dequant = hopper_qmm.dequant = dequant
    try:
        yield
    finally:
        qmm.dequant = hopper_qmm.dequant = real


def _cpu_checks(cpu, k, note, t0) -> dict:
    out = dict(notes=[note] if note else [])
    tok, steps = 1, []
    for pos in range(8):
        lc = cpu.step(tok, pos)
        steps.append((tok, lc))
        tok = int(lc.argmax())
    out["steps"] = steps
    cpu.reset()
    n = len(cpu.tokenizer.encode(k["prompt"], bos=True)) + 8
    out["gen_ids"] = cpu.generate(k["prompt"], n, temperature=0).ids
    toks = cpu.tokenizer.encode(PROMPT_LONG, bos=True)
    cpu.reset()
    lcs, ids = [cpu.prefill_tokens(toks)], []
    for i in range(8):
        ids.append(int(lcs[-1].argmax()))
        lcs.append(cpu.step(ids[-1], len(toks) + i))
    out["prefill"] = (lcs, ids)
    if not k["light"]:
        out["ppl"] = cpu.perplexity(PROMPT_LONG * 3)
    if k["precise"]:
        cpu.reset()
        n = len(cpu.tokenizer.encode(PRECISE_PROMPT, bos=True)) + 8
        out["precise_ids"] = cpu.generate(PRECISE_PROMPT, n, temperature=0).ids
    if k["served"]:
        out["serve"] = cpu_server(cpu, k["what"], k["full"], out["notes"])
    if k["speculative"]:
        cpu.reset()
        out["hello_ids"] = cpu.generate("hello", 16, temperature=0).ids
    out["notes"].append(f"# {k['what']}: the CPU side in a worker process, "
                        f"{time.perf_counter() - t0:.1f} s on {CPU_THREADS} threads")
    return out


PRECISE_COUNTS = {}  # fmt -> the launch counts of a full-width 17-token --precise prefill


PRECISE_PROMPT = "Hi there"  # 9 tokens of the byte vocabulary: a 2-16-row prefill


def precise_checks(path, what, cpu, toks, lc_prefill, err_prefill, steps_cpu, err_steps,
                   want_ids):
    """``Engine(path, precise=True)`` on the card against the same CPU
    logits as the default engine's checks: the prefill of ``toks`` (f32
    products in place of bf16), 8 decode steps (per op, no fused
    epilogue), and a greedy generate whose 9-token prompt's 8-row prefill
    takes the multi-row path as by default, against the CPU's ids
    ``want_ids`` (``cpu`` answers a near-tie). Logs both errors."""
    from calm_tpu_torch.engine import Engine
    from calm_tpu_torch.ops import qmm as tqmm

    eng = Engine(path, precise=True)
    try:
        lg = eng.prefill_tokens(toks)
        e_pre = float(np.abs(lg - lc_prefill).max() / np.abs(lc_prefill).max())
        eng.reset()
        e_steps = 0.0
        for pos, (tok, lc) in enumerate(steps_cpu):
            lg = eng.step(tok, pos)
            e_steps = max(e_steps, float(np.abs(lg - lc).max() / np.abs(lc).max()))
        eng.reset()
        prompt = PRECISE_PROMPT
        n = len(eng.tokenizer.encode(prompt, bos=True))
        eng.generate(prompt, n + 2, temperature=0)  # captures the step
        eng.reset()
        st, counts = drive(lambda: eng.generate(prompt, n + 8, temperature=0))
        gen = same_generation(f"{what} --precise generate", cpu,
                              eng.tokenizer.encode(prompt, bos=True), st.ids, want_ids,
                              TOL_PREFILL)
    finally:
        tqmm.enable_precise(False)
    rows = counts["qmm_decode_multirow"] + counts["qmm_decode_gf4_multirow"]
    if e_pre > TOL_PREFILL or e_steps > TOL_STEP or rows == 0 or counts["qx_offn_qkv"]:
        fail(f"{what} --precise: prefill logits {e_pre:.3e}, steps {e_steps:.3e} from the "
             f"CPU, launches {counts}")
    log(f"# {what} --precise vs cpu: logits after the {len(toks)}-token prefill {e_pre:.3e} "
        f"of scale (default {err_prefill:.3e}), 8 steps {e_steps:.3e} (default "
        f"{err_steps:.3e}); generate {gen}, its {n - 1}-row prefill on the multi-row path "
        f"({rows} launches), qx_offn_qkv 0")
    del eng


def container_phase(path, ref, fmt, dev, experts: int = 0, cohere: bool = False):
    """Engine, prefill, perplexity and CLI on a 2-layer Mistral-7B-width
    container, or with ``experts`` a 2-layer Mixtral-width MoE one (top-2,
    bench.py's mixtral4x7b proxy at 4), or with ``cohere`` a 2-layer Aya 23
    8B-width parallel-norm one (tied, its vocab cut to 32000), of seeded
    random bits (fp8e4: seeded floats quantized tensor by tensor, as the
    converter does, so the scales are real and differ by layer and
    expert), written by ``write_containers`` to ``path``, held against
    the CPU plain path (``cpu_reference``), whose side ``ref`` (the
    worker process's pending ``cpu_side``) computes; then served. The fp8 Aya-width and the fp8e4 MoE containers run generate
    and prefill against the CPU only; the fp8e4 Mistral-width one is not
    served; the gf4 Mistral-width one also decodes with ROTATED_DECODE
    off; the fp8 and gf4 Mistral-width ones run under ``--precise`` too
    (``precise_checks``, and the CLI's ``-x``). Returns (launch counts of
    the main path, tokens, launch counts of the CALM_ROT=0 decode or
    None)."""
    from calm_tpu_torch import model as M
    from calm_tpu_torch.engine import Engine

    k = container_kind(fmt, experts, cohere)
    cfg, name, what = k["cfg"], k["name"], k["what"]
    light, served, precise, speculative = (k["light"], k["served"], k["precise"],
                                           k["speculative"])
    rot0 = None
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        twin, spec_procs = None, None
        if speculative:  # the draft of the same weights in gf4; the CLI's --draft runs
            twin = os.path.join(tmp, f"{name}-width-2l-gf4-twin.calm")
            gf4_twin(twin, cfg, 1, dev)
            spec_procs = {kind: cli(path, SPEC_CLI + ["--draft", d])
                          for kind, d in (("self", path), ("gf4 twin", twin))}
        text_path = os.path.join(tmp, "ppl.txt")
        with open(text_path, "w") as f:
            f.write(PROMPT_LONG * 3)
        user_path = os.path.join(tmp, "user.txt")  # one user line, then EOF
        with open(user_path, "w") as f:
            f.write("hello there\n")
        # the CLI and the HTTP server run on the card beside the checks below
        procs = [] if light else [
            cli(path, ["-t", "0", "-n", "16", "-r", "2", "-i", "hello"]),
            cli(path, ["-x", text_path]),
            cli(path, ["-y", "be brief", "-n", "24", "-s", "7"], user_path)]
        if precise:
            # the whole text in one window, as the engines' perplexity below
            procs.append(cli(path, ["--precise", "-x", text_path, "-n", "0"]))
        http_args = (["--page-rows", "16"] if fmt == "gf4"
                     else ["--draft", path, "--gamma", "3"] if speculative else [])
        httpd = httpd_proc(path, http_args) if served and not light else None
        # the front end over a group of paged decoders: as many as cards
        httpd_dp = (httpd_proc(path, ["--dp", str(torch.cuda.device_count()),
                                      "--page-rows", "16", "--prefix-cache-tokens", "4096"])
                    if speculative else None)
        eng = Engine(path)
        log(eng.banner())
        if experts:  # routing builds the expert slots on the device
            tok = torch.ones(1, dtype=torch.int64, device=dev)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")  # raises at a host sync
            try:
                M.decode_step(eng.cfg, eng.weights, tok, 0, eng.cache)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            eng.reset()
            log(f"# {what}: a decode step ran with no host sync")

        # the main path: fp8 with a short prompt (decode kernels), gf4 with
        # a long one (its prefill takes the gf4 matmul), counts from 0
        prompt = k["prompt"]
        steps = len(eng.tokenizer.encode(prompt, bos=True)) + 8
        s1, counts = drive(lambda: eng.generate(prompt, steps, temperature=0))
        tokens = s1.tokens
        eng.reset()
        s2 = eng.generate(prompt, steps, temperature=0)
        log(s1.perf_line())
        log(s2.perf_line())
        if s1.logits_hash != s2.logits_hash or s1.ids != s2.ids:
            fail(f"{what}: two greedy generations differ")
        if len(s1.ids) < 8 or len(set(s1.ids)) < 2:
            fail(f"{what}: degenerate generation: {tokens} tokens, ids {s1.ids}")
        log(f"# {what} engine: {tokens} positions, ids {s1.ids[:12]}..., launches "
            f"{counts}")

        # decode on the card against the plain path on the CPU, each side
        # fed the CPU's greedy id
        t_wait = time.perf_counter()
        ref = ref.get()
        log(f"# {what}: waited {time.perf_counter() - t_wait:.1f} s for the CPU side")
        for note in ref["notes"]:
            log(note)
        cpu = LazyCPU(path, what)  # a near-tie's one more prefill
        worst, ties, steps_cpu = 0.0, 0, ref["steps"]
        eng.reset()
        for pos, (tok, lc) in enumerate(steps_cpu):
            lg = eng.step(tok, pos)
            worst = max(worst, float(np.abs(lg - lc).max() / np.abs(lc).max()))
            ties += not greedy_agrees(f"{what} step {pos}", int(lg.argmax()), lc, TOL_STEP)
        if worst > TOL_STEP:
            fail(f"{what}: logits differ from the CPU by {worst:.3e} > {TOL_STEP}")
        worst_steps = worst
        if fmt == "gf4" and not experts and not cohere:
            rot0 = unrotated_steps(eng, steps_cpu, what)
        if fmt == "fp8" and not experts and not cohere:
            device_sampling_check(eng, what)
        eng.reset()
        p_toks = eng.tokenizer.encode(prompt, bos=True)
        gen = same_generation(f"{what} generate", cpu, p_toks,
                              eng.generate(prompt, steps, temperature=0).ids,
                              ref["gen_ids"], TOL_PREFILL)
        log(f"# {what} engine vs cpu: 8 steps, max logit diff {worst:.3e} of scale "
            f"(tol {TOL_STEP:g}), {ties} near-ties; generate {gen}")

        # batched prefill of > 100 tokens, then 8 greedy steps on each side
        toks = eng.tokenizer.encode(PROMPT_LONG, bos=True)
        eng.reset()
        lcs, ids = ref["prefill"]
        lg, lc = eng.prefill_tokens(toks), lcs[0]
        lc_prefill = lc
        err_prefill = float(np.abs(lg - lc).max() / np.abs(lc).max())
        worst, ties = 0.0, 0
        for i in range(9):
            worst = max(worst, float(np.abs(lg - lc).max() / np.abs(lc).max()))
            if i == 8:
                break
            ties += not greedy_agrees(f"{what} greedy id {i} after prefill",
                                      int(lg.argmax()), lc, TOL_PREFILL)
            lg, lc = eng.step(ids[i], len(toks) + i), lcs[i + 1]
        if not worst <= TOL_PREFILL:
            fail(f"{what}: logits after prefill differ from the CPU by {worst:.3e} "
                 f"> {TOL_PREFILL}")
        if light:
            log(f"# {what} prefill vs cpu: {len(toks)} tokens, then 8 steps: logits diff "
                f"{worst:.3e} of scale (tol {TOL_PREFILL:g}); next 8 greedy ids {ids}, "
                f"{ties} near-ties; container phase {time.perf_counter() - t0:.1f} s")
            del eng, cpu
            return counts, tokens, rot0
        pg, pc = eng.perplexity(PROMPT_LONG * 3), ref["ppl"]
        if not abs(pg[0] - pc[0]) <= 1e-2 * pc[0] or pg[2] != pc[2]:
            fail(f"{what}: perplexity {pg} != CPU {pc}")
        log(f"# {what} prefill vs cpu: {len(toks)} tokens, then 8 steps: logits diff "
            f"{worst:.3e} of scale (tol {TOL_PREFILL:g}); next 8 greedy ids {ids}, "
            f"{ties} near-ties; perplexity {pg[0]:.4f} ± {pg[1]:.4f} vs CPU "
            f"{pc[0]:.4f} ± {pc[1]:.4f} over {pg[2]} tokens (tol 1e-2 rel.)")
        if precise:
            precise_checks(path, what, cpu, toks, lc_prefill, err_prefill, steps_cpu,
                           worst_steps, ref["precise_ids"])

        for p, mode in zip(procs, ("generate", "-x", "-y", "--precise -x -n 0")):
            out, errs = p.communicate(timeout=600)
            if p.returncode != 0:
                fail(f"{what} cli {mode} exited {p.returncode}: {errs[-2000:]}")
            if mode == "generate":  # -r 2: the second sequence replays what the first captured
                perf = errs.strip().splitlines()[-2:]
                if len(perf) != 2 or perf[0].split("#")[-1] != perf[1].split("#")[-1]:
                    fail(f"{what} cli -r 2: perf lines {perf}")
                log(f"# {what} cli -r 2: {out.splitlines()[0]} | {perf[0]} | {perf[1]}")
            elif "-x" in mode.split():
                line = [l for l in out.splitlines() if l.startswith("# perplexity:")]
                if not line:
                    fail(f"{what} cli {mode} printed no perplexity line: {out[-1000:]}")
                extra = ""
                if mode.startswith("--precise"):  # the same window as pg and pc
                    ppl = float(line[0].split()[2])
                    if not abs(ppl - pc[0]) <= 1e-2 * pc[0]:
                        fail(f"{what} cli {mode}: perplexity {ppl} != CPU {pc[0]}")
                    extra = (f" (relative to the CPU engine's {pc[0]:.4f}: "
                             f"{abs(ppl - pc[0]) / pc[0]:.2e}; the card's default engine "
                             f"{abs(pg[0] - pc[0]) / pc[0]:.2e})")
                log(f"# {what} cli {mode}: {line[0]}{extra}")
            elif "Assistant: " not in out:
                fail(f"{what} cli -y printed no reply: {out[-1000:]}")
            else:
                log(f"# {what} cli -y: {len(out)} characters, exit 0")
        t_serve = time.perf_counter()
        if served:
            want_srv, lcs_srv = ref["serve"]
            want_srv = [Served(*w) for w in want_srv]
            card_ids = serving_checks(path, what, (want_srv, lcs_srv), full=k["full"])
            if speculative:
                speculative_container_checks(path, twin, what, eng, cpu, dev, ref["hello_ids"],
                                             want_srv, lcs_srv, spec_procs)
            http_check(httpd, what + (" paged" if fmt == "gf4" else " --draft --gamma 3"
                                      if speculative else ""), speculative)
            if httpd_dp is not None:
                # "The quick brown fox" is SERVE_REQUESTS[3]: the CPU server's
                # ids, and the card's paged Server's (held to them at near-ties)
                http_check(httpd_dp, what + f" --dp {torch.cuda.device_count()} --page-rows 16",
                           dp=(served_text(eng.tokenizer, want_srv[3].ids),
                               served_text(eng.tokenizer, card_ids["paged"][3])))
        log(f"# {what}: container phase {time.perf_counter() - t0:.1f} s, of it serving "
            f"{time.perf_counter() - t_serve:.1f} s")
        del eng, cpu
    return counts, tokens, rot0

# Serving: requests of 5-150 tokens, greedy and host-sampled (the
# per-request xorshift stream makes card and CPU draws comparable); two of
# them share a 64-token prefix, the second admitted after the first
SHARED = "A system prompt that several requests share, sixty-three bytes."
SERVE_REQUESTS = [  # (prompt, max_tokens, temperature, seed)
    (SHARED + " Q1", 8, 0.0, 1),
    ("Hi all", 10, 0.8, 5),
    (PROMPT_LONG, 12, 0.0, 1),
    ("The quick brown fox", 9, 0.0, 1),
    (SHARED + " And a second question", 11, 0.0, 1),
    ("Pack my box with five dozen liquor jugs", 8, 1.0, 9),
]


def serve_recorded(srv, reqs):
    """Submit ``reqs`` at once and drain; returns the requests and the
    logits each one sampled from, step by step (requests are admitted in
    submission order, so the k-th sampler made serves request k)."""
    from calm_tpu_torch import serve as S

    made = []

    class Recording(S.Sampler):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.seen = []
            made.append(self)

        def sample(self, logits):
            self.seen.append(np.array(logits, np.float32))
            return super().sample(logits)

    real, S.Sampler = S.Sampler, Recording
    try:
        out = [srv.submit(p, max_tokens=n, temperature=t, seed=sd)
               for p, n, t, sd in reqs]
        srv.run_until_drained(max_ticks=2000)
    finally:
        S.Sampler = real
    if not all(r.done for r in out) or len(made) != len(out):
        fail("a served request did not finish")
    return out, [m.seen for m in made]


def same_served(what, got, want, temperature, lg, lc, tol) -> str:
    """A request's ids ``got`` against the reference server's ``want``:
    equal, or equal up to a step where both servers' logits (``lg``,
    ``lc``, one array a step) agree within ``tol`` of their scale, so the
    draw (or greedy pick) fell on a near-tie that the operands' rounding
    may decide either way."""
    n = next((i for i, (g, c) in enumerate(zip(got, want)) if g != c), None)
    if n is None:
        if len(got) != len(want):
            fail(f"{what}: ids {got} != reference {want}")
        return "equal"
    err = float(np.abs(lg[n] - lc[n]).max() / np.abs(lc[n]).max())
    if err > tol:
        fail(f"{what}: ids differ at {n} where the logits differ by {err:.3e} > {tol}")
    if temperature == 0 and margin(lc[n]) > tol:
        fail(f"{what}: greedy id {got[n]} != reference {want[n]}, top-2 margin "
             f"{margin(lc[n]):.3e} of scale > {tol}")
    return f"differ from id {n} (logits {err:.1e} apart: a near-tie)"


def serve_requests(full: bool):
    """The requests a container is served: ``SERVE_REQUESTS``, or with
    ``full`` False the first two, greedy, 5 tokens each (each CPU tick of a
    MoE model decodes every expert's planes, the script's slowest CPU
    work)."""
    return SERVE_REQUESTS if full else [(p, 5, 0.0, s) for p, _, _, s in SERVE_REQUESTS[:2]]


def cpu_server(cpu, what, full, notes):
    """The CPU server on ``cpu``'s weights with a slot for each request of
    ``serve_requests(full)`` (a request's ids do not depend on the slot
    count, and the CPU's ticks, each a pass over all weights, are fewest
    so). Returns (each request's (ids, temperature, tokens), the logits
    each sampled from); a line for ``notes``."""
    from calm_tpu_torch.engine import Engine
    from calm_tpu_torch.serve import Server

    reqs = serve_requests(full)
    t0 = time.perf_counter()
    ref = Engine.from_weights(cpu.cfg, cpu.weights, cpu.tokenizer, n_bytes=cpu.n_bytes,
                              n_params=cpu.n_params, n_bandwidth=cpu.n_bandwidth,
                              batch=len(reqs), device="cpu")
    want, lcs = serve_recorded(Server(batch=len(reqs), engine=ref), reqs)
    notes.append(f"# {what} serve: CPU server ({len(reqs)} slots) "
                 f"{time.perf_counter() - t0:.1f} s, {sum(r.n_generated for r in want)} tokens")
    # plain tuples: a class of this script does not unpickle in the parent
    return [(list(r.ids), r.temperature, r.n_generated) for r in want], lcs


class Served(NamedTuple):
    """A request the CPU server served."""
    ids: list
    temperature: float
    n_generated: int


def serving_checks(path, what, served, full=True):
    """``Server`` on the card, dense, paged (16-row pages, a pool of half
    the dense rows) and dense with the prefix cache (``full``; else dense
    and paged on ``serve_requests(False)``), each held to the CPU server's
    ``served`` (``cpu_server``: requests, logits) on the same requests.
    Returns each mode's ids of the requests."""
    from calm_tpu_torch import model as M
    from calm_tpu_torch.serve import Server

    reqs = serve_requests(full)
    want, lcs = served
    card_ids = {}
    rows = 4 * 4096 // 2 // 16
    modes = {"dense": {}, "paged": dict(page_rows=16, pool_pages=rows)}
    if full:
        modes["prefix"] = dict(prefix_cache_tokens=4096)
    for mode, kw in modes.items():
        srv = Server(path, batch=4, **kw)
        if mode == "paged":  # one replayed tick: K12 in paged mode on every layer
            srv.submit("Hi", max_tokens=2)
            srv.tick()  # admits and captures the step, its warm-up outside the count
            _, one = drive(srv.tick)
            if one["decode_attention_paged"] != srv.engine.cfg.n_layers:
                fail(f"{what}: a paged tick launched K12 paged "
                     f"{one['decode_attention_paged']} times")
            (got, lgs), counts = drive(lambda: serve_recorded(srv, reqs))
        else:
            got, lgs = serve_recorded(srv, reqs)
        res = [same_served(f"{what} serve {mode} request {i}", g.ids, w.ids,
                           w.temperature, lg, lc, TOL_PREFILL)
               for i, (g, w, lg, lc) in enumerate(zip(got, want, lgs, lcs))]
        extra = ""
        if mode == "prefix":
            hit = got[4].cached_prefix
            if hit != 64 or srv.prefix_cache.hits != 1:
                fail(f"{what}: the shared prefix was not served from the cache "
                     f"({hit} rows, {srv.prefix_cache.hits} hits)")
            extra = f", request 4 took {hit} prefix rows from the cache"
        if mode == "paged":
            extra = (f", pages in use after {srv._paged.pages_in_use()}, "
                     f"K12 paged launches {counts['decode_attention_paged']}")
        card_ids[mode] = [list(g.ids) for g in got]
        log(f"# {what} serve {mode} vs CPU: " + "; ".join(
            f"{i} {r}" for i, r in enumerate(res)) + extra)
        if mode == "paged":  # a step makes no host sync before its logits
            dec, cfg = srv._paged, srv.engine.cfg
            pt = dec.page_table()
            toks = [s.token for s in dec.slots]
            pos = [5, 900, 4095 + 7, 30]  # one slot past the window
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                M.paged_decode_step(cfg, srv.engine.weights, toks, pos, dec.pool, pt)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            log(f"# {what}: a paged decode step of 4 slots at positions {pos} ran "
                "with no host sync")
        del srv
    return card_ids


def httpd_proc(path, args):
    """``python -m calm_tpu_torch.httpd`` on the card, on a free port."""
    return subprocess.Popen(
        [sys.executable, "-m", "calm_tpu_torch.httpd", path, "--port", "0",
         "--batch", "4", "--access-log"] + args, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def same_stream(streamed: str, text: str) -> bool:
    """A streamed text against the whole one: pieces are decoded one at a
    time, so a character split over two byte tokens streams as U+FFFD;
    every other streamed character appears in the text, in order."""
    it = iter(text)
    return bool(streamed) and all(c in it for c in streamed if c != "\ufffd")


def served_text(tok, ids, prompt="The quick brown fox", max_tokens=8) -> str:
    """The text a Server returns for greedy ``ids`` of ``prompt`` at
    ``max_tokens``: the pieces up to a stop id or the last token, which
    ends the request unprinted."""
    prev, out = tok.encode(prompt, bos=True)[-1], bytearray()
    for n, t in enumerate(ids[:max_tokens], 1):
        if t in (tok.bos_id, tok.eos_id, tok.eot_id) or n >= max_tokens:
            break
        out += tok.decode_piece(prev, t)
        prev = t
    return out.decode("utf-8", errors="replace")


def http_check(proc, what, speculative: bool = False, dp=None):
    """Health, a streamed and a plain greedy generate (the same text),
    stats (with ``speculative``, a ``speculative`` block of JAX's keys
    that counts rounds), then SIGTERM: the server drains and exits 0.
    With ``dp`` = (the CPU server's text, the card's paged Server's) the
    plain generate's text equals the CPU's, or the card's where that one
    parts from the CPU at a near-tie, and the stats show the group's pool
    empty and its prefix caches' pinned prompt."""
    banner = proc.stdout.readline()
    line = proc.stdout.readline()
    m = re.search(r"http://[\d.]+:(\d+)", line)
    if not m:
        proc.kill()
        fail(f"{what} httpd did not start: {banner!r} {line!r} {proc.stderr.read()[-2000:]}")
    base = f"http://127.0.0.1:{m.group(1)}"

    def post(obj):
        r = urllib.request.Request(f"{base}/v1/generate", data=json.dumps(obj).encode(),
                                   headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(r, timeout=300) as f:
            return f.read().decode()

    with urllib.request.urlopen(f"{base}/v1/health", timeout=60) as f:
        health = json.load(f)
    body = {"prompt": "The quick brown fox", "max_tokens": 8, "temperature": 0.0}
    plain = json.loads(post(body))
    streamed = post(dict(body, stream=True))
    with urllib.request.urlopen(f"{base}/v1/stats", timeout=60) as f:
        stats = json.load(f)
    proc.send_signal(signal.SIGTERM)
    try:
        out, errs = proc.communicate(timeout=120)
    except subprocess.TimeoutExpired:
        proc.kill()
        fail(f"{what} httpd did not drain on SIGTERM")
    spec = stats.get("speculative")
    if speculative and (not spec or set(spec) != {"rounds", "emitted", "acceptance"}
                        or spec["rounds"] < 1):
        fail(f"{what} httpd --draft: stats {stats}")
    if dp is not None:
        pc = stats.get("prefix_cache") or {}
        if (plain["text"] not in dp or stats.get("pages_in_use") != 0
                or pc.get("entries", 0) < 1 or stats.get("slots") != 4):
            fail(f"{what} httpd: text {plain['text']!r}, the CPU server's {dp[0]!r}, the "
                 f"card's paged Server's {dp[1]!r}; stats {stats}")
        log(f"# {what} httpd: the generate's text equals the "
            + ("CPU server's" if plain["text"] == dp[0] else
               "card's paged Server's (which parts from the CPU at a near-tie)"))
    if (health.get("status") != "ok" or not same_stream(streamed, plain["text"])
            or proc.returncode != 0
            or "# drained" not in errs or plain["tokens"] < 1):
        fail(f"{what} httpd: health {health}, plain {plain}, streamed {streamed!r}, "
             f"exit {proc.returncode}, stderr {errs[-2000:]}")
    log(f"# {what} httpd on port {m.group(1)}: health ok, generate {plain['tokens']} "
        f"tokens (streamed the same text), ttft {plain['ttft_ms']} ms; stats "
        f"{json.dumps(stats)}; SIGTERM drained, exit 0")


# -- the compiled decode step: CUDA graphs against the eager step -----------


def eager_decode_once(cfg, w, token, pos, cache, rolling, pt=None, sampling=None):
    """``model.decode_once``'s work without its graph: the eager step and
    the next token, for the eager drains and the by-wrapper profiles (a
    replay calls no wrapper)."""
    from calm_tpu_torch import model as M
    from calm_tpu_torch.sampler import device_sample

    if pt is None:
        out, _ = M.decode_step(cfg, w, token, pos, cache, rolling=rolling)
    else:
        out, _ = M.paged_decode_step(cfg, w, token, pos, cache, pt, rolling)
    return out, out.argmax(-1) if sampling is None else device_sample(out, *sampling)


@contextlib.contextmanager
def eager_steps():
    """Within the block the serving tick and ``Engine.step`` run the eager
    step, as the port did before its steps were captured."""
    from calm_tpu_torch import model as M

    real, M.decode_once = M.decode_once, eager_decode_once
    try:
        yield
    finally:
        M.decode_once = real


def eager_loop(cfg, w, token, pos0, cache, n, sampling=None):
    """``model.decode_loop``'s chunk eagerly: ``decode_step`` n times with
    the chunk's ``rolling``, each token the argmax or ``device_sample``'s
    draw. Returns (tokens (B, n), cache, logits (n, B, V))."""
    from calm_tpu_torch import model as M
    from calm_tpu_torch.sampler import device_sample

    rolling = pos0 + n >= cfg.seq_len
    toks, lgs = [], []
    for i in range(n):
        out, cache = M.decode_step(cfg, w, token, pos0 + i, cache, rolling=rolling)
        token = out.argmax(-1) if sampling is None else device_sample(out, *sampling)
        toks.append(token)
        lgs.append(out)
    return torch.stack(toks, 1), cache, torch.stack(lgs)


def log_captures():
    """Log every capture of a decode step or a verify with its time, and
    keep it in CAPTURES (after :func:`count_replays`)."""
    from calm_tpu_torch.graphs import StepGraph, VerifyGraph

    count_replays()
    real, real_v = StepGraph.capture, VerifyGraph.capture

    def capture(self):
        real(self)
        CAPTURES.append(("step", self.token.shape[0], None, self.capture_s))
        log(f"# graph capture: B={self.token.shape[0]}, "
            f"{'sampled' if self.sampled else 'greedy'}, "
            f"{'paged' if self.pt is not None else 'dense'}, "
            f"{replay_launches(self)} wrapper launches a replay: "
            f"{1e3 * self.capture_s:.1f} ms (eager warm-up included)")

    def capture_v(self):
        real_v(self)
        B, T = self.tokens.shape
        CAPTURES.append(("verify", B, T, self.capture_s))
        log(f"# graph capture: verify B={B} T={T}{' tree' if self.tree is not None else ''}, "
            f"{replay_launches(self)} wrapper launches a replay: "
            f"{1e3 * self.capture_s:.1f} ms (eager warm-up included)")
    StepGraph.capture, VerifyGraph.capture = capture, capture_v


def replay_launches(g) -> int:
    """The wrapper launches one replay of ``g`` makes (an older tree keeps
    them in ``g.launches``)."""
    return sum(n for _, _, n in getattr(g, "smoke_launches", getattr(g, "launches", ())))


def same_bits(what, got, want):
    """Replayed ids or logits against the eager step's: bit for bit (the
    same kernels in the same order, no float atomics)."""
    if got.shape != want.shape or not torch.equal(got, want):
        diff = (got.float() - want.float()).abs().max().item() if got.shape == want.shape else None
        fail(f"{what}: replayed and eager differ (shapes {tuple(got.shape)} / "
             f"{tuple(want.shape)}, max diff {diff})")


GRAPH_SEQ, GRAPH_STEPS = 64, 80  # the wrap check: a window of 64, 80 steps


def graph_wrap_check(dev):
    """The captured step across the sink wrap, on 2-layer Mistral-7B-width
    fp8 and gf4 weights (seeded random) at seq_len 64. Dense: 80 greedy
    steps of ``decode_loop`` (replayed) against 80 eager ``decode_step``
    calls: ids, logits and the caches after, bit for bit, and the two runs'
    launch counts equal. A sampled step captured at a wrapped position
    leaves the cache's bytes as they were, and its 40 replays at -t 0.8
    draw the eager run's ids for the same seed. Paged: 2 slots at
    positions 0 and 30 on scrambled 16-row pages, 80 replayed
    ``decode_once`` ticks against 80 eager ``paged_decode_step`` calls,
    logits and pools bit for bit. Returns the launch counts of the first
    dense run replayed."""
    from calm_tpu_torch import model as M
    from calm_tpu_torch.config import ModelConfig
    from calm_tpu_torch.paged import create_pool
    from calm_tpu_torch.utils.synth import synth_weights

    S, n = GRAPH_SEQ, GRAPH_STEPS
    out = None
    for fmt in ("fp8", "gf4"):
        t0 = time.perf_counter()
        cfg = ModelConfig(**{**MISTRAL, "n_layers": 2}, rope_theta=10000.0, seq_len=S,
                          rotary_dim=128, dtype=fmt, norm_ln=False)
        w = synth_weights(cfg, seed=3, device=dev, random=True)
        what = f"graphs {fmt} 2-layer mistral7b-width, seq_len {S}"
        tok0 = torch.tensor([5], device=dev)
        ce_, cr_ = (M.KVCache.create(cfg, 1, torch.bfloat16, dev) for _ in range(2))
        (te, _, le), ce = drive(lambda: eager_loop(cfg, w, tok0, 0, ce_, n))
        tr, _, lr = M.decode_loop(cfg, w, tok0, 0, cr_, n)  # captures, then replays
        same_bits(f"{what} dense ids", tr, te)
        same_bits(f"{what} dense logits", lr, le)
        same_bits(f"{what} dense cache k", cr_.k, ce_.k)
        same_bits(f"{what} dense cache v", cr_.v, ce_.v)
        cr_.k.zero_()
        cr_.v.zero_()
        (tr2, _, lr2), cr = drive(lambda: M.decode_loop(cfg, w, tok0, 0, cr_, n))
        same_bits(f"{what} dense ids, second run", tr2, te)
        same_bits(f"{what} dense logits, second run", lr2, le)
        replays = cr.pop("graph_replays")
        ce.pop("graph_replays")
        if cr != ce or replays != n:
            fail(f"{what}: launches replayed {cr} ({replays} replays) != eager {ce}")
        out = out or dict(cr, graph_replays=replays)

        # a sampled step captured past the wrap: the cache unchanged by the
        # capture, the replayed draws the eager draws
        def sampling():
            g = torch.Generator(device=dev)
            g.manual_seed(7)
            return (g, torch.full((1,), 0.8, device=dev), torch.full((1,), 0.1, device=dev))
        tok, k = te[:, -1], 40
        xe = M.KVCache(ce_.k.clone(), ce_.v.clone())
        xr = M.KVCache(ce_.k.clone(), ce_.v.clone())
        ts, _, ls = eager_loop(cfg, w, tok, n, xe, k, sampling())
        smp = sampling()
        g = M.step_graph(cfg, w, xr, 1, True, sampled=True)
        g.load(tok, n, smp)
        before = (xr.k.clone(), xr.v.clone())
        g.capture()
        same_bits(f"{what}: cache k across the capture of a rolling step", xr.k, before[0])
        same_bits(f"{what}: cache v across the capture of a rolling step", xr.v, before[1])
        trs, _, lrs = M.decode_loop(cfg, w, tok, n, xr, k, smp)
        same_bits(f"{what} sampled ids (seed 7, -t 0.8)", trs, ts)
        same_bits(f"{what} sampled logits", lrs, ls)
        if len(set(ts[0].tolist())) < 2:
            fail(f"{what}: the sampled run drew one id: {ts[0].tolist()}")
        del xe, xr, before, g

        # paged: two slots, one wrapping 30 steps before the other
        PR, P = 16, 12
        pt = torch.tensor([[3, 7, 1, 9], [10, 2, 5, 0]], dtype=torch.int32, device=dev)
        pe, pr = (create_pool(cfg, P, PR, torch.bfloat16, dev) for _ in range(2))
        pos0 = [0, 30]
        ke = kr = torch.tensor([5, 9], device=dev)
        ids_e, ids_r = [], []
        for i in range(n):
            pos = [p + i for p in pos0]
            le_, _ = M.paged_decode_step(cfg, w, ke, pos, pe, pt, True)
            lr_, nxt = M.decode_once(cfg, w, kr, pos, pr, max(pos) + 1 >= S, pt)
            same_bits(f"{what} paged logits, step {i}", lr_, le_)
            ke, kr = le_.argmax(-1), nxt.clone()
            ids_e.append(ke)
            ids_r.append(kr)
        same_bits(f"{what} paged ids", torch.stack(ids_r), torch.stack(ids_e))
        same_bits(f"{what} paged pool k", pr.k, pe.k)
        same_bits(f"{what} paged pool v", pr.v, pe.v)
        log(f"# {what}: dense {n} greedy steps replayed = eager bit for bit (ids "
            f"{te[0, :6].tolist()}... {te[0, -4:].tolist()}, logits, cache), launches equal "
            f"({sum(ce.values())} either way, {replays} replays); a sampled step captured "
            f"at pos {n}: cache bytes unchanged, {k} replayed draws at -t 0.8 = eager "
            f"({len(set(ts[0].tolist()))} distinct ids); paged 2 slots from pos {pos0}, "
            f"{n} ticks: logits, ids and pool bit for bit; {time.perf_counter() - t0:.1f} s")
        del w, ce_, cr_, pe, pr
        torch.cuda.empty_cache()
    return out


# -- speculative decoding: the replayed verify, K13 at a verify's T ----------

GAMMA = 4          # the speculative depth of every speculative path here
VERIFY_T = (4, 5)  # a verify's query rows at GAMMA: the linear chain (g), a served round (g+1)
CAPTURES = []      # (kind, B, T or None, seconds) of every capture, in order
SPEC_COUNTS = {}   # the launch counts of the full-width speculative drain
TREE_COUNTS = {}   # the launch counts of the full-width tree rounds
SPEC_MOE_COUNTS = {}    # the launch counts of the full-width Mixtral speculative drain
VERIFY_MOE_COUNTS = {}  # fmt -> the launch counts of the MoE verify graph check


VERIFY_B = (1, 2, 8)  # the split-S route's checked sequences: one stream, two, a tick's 8
VERIFY_CHECK_T = (1, 2, 3, 4, 5)  # a verify's query rows at gamma 0-4
TREES = ((3, 4), (3, 5))  # (k, m): 10 nodes (the tree timed at full width), 13 (the CLI's)
# (hd, KVH, M) of the split-S corner checks: Mistral-7B, Phi-3-mini, Gemma-7B,
# Gemma-2B, and 8 query rows a kv head at hd 64
SPLIT_HEADS = ((128, 8, 4), (96, 32, 1), (256, 16, 1), (256, 1, 8), (64, 4, 8))
SPLIT_CORNER_S = 1000  # not a whole number of tiles
SWEEP_T = (4, 8, 12, 16, 24, 32)  # the route crossover's T at M = 4: 16-128 rows a kv head
# every (B, T, KVH, M, S, hd) chip_smoke.py gives the split-S route's plan
# (tests/test_torch_verify_attention.py holds the plan over them)
SPLIT_SHAPES = sorted(
    {(B, T, 8, 4, 4096, 128) for B in VERIFY_B for T in VERIFY_CHECK_T}
    | {(1, 1 + k * (m - 1), 8, 4, 4096, 128) for k, m in TREES}
    | {(B, T, KVH, M, SPLIT_CORNER_S, hd) for hd, KVH, M in SPLIT_HEADS
       for B, T in ((2, 1), (2, 3), (2, 5), (1, 10), (2, 13))}
    | {(B, T, 8, 4, 4096, 128) for B in (1, 8) for T in SWEEP_T})


def verify_kernel_rows(gbps, dev):
    """K13 at a speculative verify's shapes: Mistral-7B's heads (32 query,
    8 kv, hd 128), bf16 KV, T = 1-5 query rows from the window's last rows
    (pos0 = 4096 - T... 4091), B = 1, 2 and 8, against its plain version;
    T = 4 and 5 at B = 1 and 8 timed beside causal SDPA on the same rows
    (the library row), T launches of K12 (one a query row at its own
    kv_len, the same function, also checked against K13's output) and, on
    a tree that has it, the persistent kernel on the same inputs (the
    parent commit's route). Then the draft tree's attention (k=3, m=4 and
    k=3, m=5) at the window's end and near position 16: ``tree_attention``
    against its plain version, timed beside that plain version over the
    whole window (the parent's route) and SDPA with the tree's mask. On a
    tree without the split-S route (``chip_compare.py``) the same calls
    time its routes. Returns the kernels line's rows: T=5, B=8 (a served
    round's verify) and the tree at the window's end."""
    import torch.nn.functional as F

    from calm_tpu_torch.ops import hopper_attn as ha
    from calm_tpu_torch.speculative import _tree_mask

    persistent = getattr(ha, "_persistent_launch", None)
    tree_fn = getattr(ha, "tree_attention", None)
    KVH, M, S, hd, L = 8, 4, 4096, 128, 2
    rows = {}
    for B in VERIFY_B:
        kc = (torch.randn(L, B, KVH, S, hd, device=dev) * 0.5).bfloat16()
        vc = torch.randn(L, B, KVH, S, hd, device=dev).bfloat16()
        for T in VERIFY_CHECK_T:
            pos0 = S - 5  # a verify of T rows at the window's end: 4091
            q = torch.randn(B, T, KVH, M, hd, device=dev)
            p0 = torch.full((B,), pos0, dtype=torch.int32, device=dev)
            kl, kv = p0 + T, pos0 + T
            got = ha.prefill_attention(q, kc, vc, p0, kl, L - 1)
            err = check(f"prefill_attention verify T={T} B={B}", got,
                        ha.prefill_attention_plain(q, kc, vc, p0, kl, L - 1), TOL_ATT)
            if T not in VERIFY_T or B == 2:
                continue
            qs = [q[:, t].reshape(B, KVH * M, hd).contiguous() for t in range(T)]
            kls = [p0 + t + 1 for t in range(T)]
            k12_out = torch.stack([ha.decode_attention(qs[t], kc, vc, kls[t], L - 1)
                                   for t in range(T)], 1).reshape(got.shape)
            check(f"decode_attention as a verify T={T} B={B}", k12_out, got, TOL_ATT)

            def k12(i):
                for t in range(T):
                    ha.decode_attention(qs[t], kc, vc, kls[t], i % L)
            q4 = q.reshape(B, T, KVH * M, hd).transpose(1, 2).bfloat16()
            kb, vb = kc[:, :, :, :kv], vc[:, :, :, :kv]
            mask = (torch.arange(kv, device=dev)[None, :]
                    <= pos0 + torch.arange(T, device=dev)[:, None])

            def lib(i):
                return F.scaled_dot_product_attention(q4, kb[i % L], vb[i % L],
                                                      attn_mask=mask, enable_gqa=True)
            nb = 2 * B * T * KVH * M * hd * 4 + 2 * B * KVH * kv * hd * kc.element_size()
            flops = 4 * B * KVH * M * hd * causal_pairs(pos0, T, kv)
            b, by = bound_ms(nb, flops, gbps, PEAK_BF16)
            t = timings(lambda i: ha.prefill_attention(q, kc, vc, p0, kl, i % L),
                        lambda i: ha.prefill_attention_plain(q, kc, vc, p0, kl, i % L),
                        lib, 3, bound=b)
            k12_ms, k12_by = timed(k12, floor=b)
            route = "persistent"
            if hasattr(ha, "verify_plan") and ha.split_route(T, M):
                p = ha.verify_plan(B, T, KVH, M, S, hd)
                route = (f"split-S, {p.blocks} blocks of {p.threads} threads, chunks of "
                         f"{p.chunk_rows} rows")
            else:
                route += f", {ha.prefill_grid(B, T, KVH, M)} blocks"
            old = ""
            if persistent is not None:
                o_ms, o_by = timed(lambda i: persistent(q, kc, vc, p0, kl, i % L, 0), floor=b)
                check(f"prefill_attention persistent as a verify T={T} B={B}",
                      persistent(q, kc, vc, p0, kl, L - 1, 0), got, TOL_ATT)
                old = (f"; the persistent kernel (the parent's route) {o_ms:.4f} ms ({o_by}), "
                       f"{o_ms / t['ms']:.2f}x the route's")
                t["persistent_ms"] = o_ms
            log(f"# K13 prefill_attention at a verify's T={T}, B={B}, pos0={pos0}, bf16 KV "
                f"(KVH=8, M=4, hd=128; {route}): max_abs_err {err:.3e} (tol {TOL_ATT:g} x "
                f"max|out|); {ms_line(t)} (bf16 SDPA, bottom-right causal mask) bound_ms "
                f"{b:.4f} ({by}); {share(t, b)}; {T} launches of K12 {k12_ms:.4f} ms "
                f"({k12_by}), K13/K12 {t['ms'] / k12_ms:.2f}x{old}")
            rows[f"verify T={T} B={B}"] = dict(t, bound_ms=b, bound_by=by, max_abs_err=err,
                                                k12_ms=k12_ms)
        if B == 1:
            for k, m in TREES:
                mask = torch.from_numpy(_tree_mask(k, m)).to(dev)
                N = mask.shape[0]
                q = torch.randn(1, N, KVH, M, hd, device=dev)
                for where, kv in (("the window's end", S), ("position 16", 16 + N)):
                    p0 = torch.full((1,), kv - N, dtype=torch.int32, device=dev)
                    kl = p0 + N

                    def plain(i):
                        return ha.prefill_attention_plain(q, kc, vc, p0, kl, i % L, tree=mask,
                                                          rows=S)
                    fn = plain if tree_fn is None else (
                        lambda i: tree_fn(q, kc, vc, p0, kl, i % L, mask))
                    got = fn(L - 1)
                    err = check(f"tree_attention k={k} m={m} at {where}", got, plain(L - 1),
                                TOL_ATT)
                    seen = torch.cat([torch.ones(N, kv - N, dtype=torch.bool, device=dev),
                                      mask], 1)
                    q4 = q.reshape(1, N, KVH * M, hd).transpose(1, 2).bfloat16()

                    def lib(i):
                        return F.scaled_dot_product_attention(
                            q4, kc[i % L][:, :, :kv], vc[i % L][:, :, :kv], attn_mask=seen,
                            enable_gqa=True)
                    sd = lib(L - 1).transpose(1, 2).reshape(got.shape)
                    check(f"tree_attention k={k} m={m} at {where} against SDPA with its mask",
                          got, sd, TOL_ATT)
                    nb = 2 * N * KVH * M * hd * 4 + 2 * KVH * kv * hd * kc.element_size()
                    pairs = N * (kv - N) + int(mask.sum())
                    b, by = bound_ms(nb, 4 * KVH * M * hd * pairs, gbps, PEAK_BF16)
                    t = timings(fn, plain, lib, 3, bound=b)
                    log(f"# the tree's attention, k={k} m={m} ({N} nodes) at {where} (kv_len "
                        f"{kv}), B=1, bf16 KV "
                        + ("(the split-S route with the tree's mask)" if tree_fn else
                           "(plain PyTorch over the whole window: no kernel on this tree)")
                        + f": max_abs_err {err:.3e} (tol {TOL_ATT:g} x max|out|); {ms_line(t)}"
                        f" (SDPA with the tree's mask over kv_len rows); the plain version "
                        f"reads all {S} rows in f32; bound_ms {b:.4f} ({by}); {share(t, b)}")
                    rows[f"tree k={k} m={m} at {where}"] = dict(t, bound_ms=b, bound_by=by,
                                                                max_abs_err=err)
        del kc, vc
        torch.cuda.empty_cache()
    return {"prefill_attention_verify": rows["verify T=5 B=8"],
            "tree_attention": rows["tree k=3 m=4 at the window's end"], "verify_rows": rows}


def nan_rows(t: torch.Tensor) -> None:
    """Fill a view of a cache with NaN (e5m2: its NaN byte 0x7f)."""
    if t.dtype == torch.float8_e5m2:
        t.view(torch.uint8).fill_(0x7F)
    else:
        t.fill_(float("nan"))


def split_corner_checks(dev):
    """The split-S route against its plain version at every head dim and
    cache dtype (``SPLIT_HEADS`` x bf16, fp16, e5m2) on a window of
    ``SPLIT_CORNER_S`` rows (not whole tiles), two sequences from cache
    slot 1 of 4: T = 1, 3 and 5 with kv_len under one tile, ragged, and at
    the window's end; the tree at 10 nodes (one sequence) and 13 (two,
    ragged; 104 rows a kv head at M = 8: two row groups); cache rows at and
    past kv_len set to NaN in one sequence (nothing of them may reach the
    output)."""
    from calm_tpu_torch.ops import hopper_attn as ha
    from calm_tpu_torch.speculative import _tree_mask

    S, L, Bc, boff = SPLIT_CORNER_S, 2, 4, 1
    worst, n = 0.0, 0
    for hd, KVH, M in SPLIT_HEADS:
        for kvd in (torch.bfloat16, torch.float16, torch.float8_e5m2):
            kc = kv_rand((L, Bc, KVH, S, hd), kvd, dev, 0.5)
            vc = kv_rand((L, Bc, KVH, S, hd), kvd, dev)
            for B, T, starts, tree in ((2, 1, [0, S - 1], None), (2, 3, [2, 517], None),
                                       (2, 5, [S - 5, 61], None),
                                       (1, 10, [S - 10], (3, 4)), (2, 13, [40, 700], (3, 5))):
                q = torch.randn(B, T, KVH, M, hd, device=dev)
                p0 = torch.tensor(starts, dtype=torch.int32, device=dev)
                kl = p0 + T
                k2, v2 = kc.clone(), vc.clone()
                if B == 2:  # sequence 1: NaN at and past its kv_len
                    for t in (k2, v2):
                        nan_rows(t[:, boff + 1, :, starts[1] + T:])
                if tree is None:
                    got = ha.prefill_attention(q, k2, v2, p0, kl, 1, boff)
                    want = ha.prefill_attention_plain(q, kc, vc, p0, kl, 1, boff)
                else:
                    mask = torch.from_numpy(_tree_mask(*tree)).to(dev)
                    got = ha.tree_attention(q, k2, v2, p0, kl, 1, mask, boff)
                    want = ha.prefill_attention_plain(q, kc, vc, p0, kl, 1, boff, tree=mask,
                                                      rows=S)
                name = (f"split-S hd={hd} KVH={KVH} M={M} {str(kvd)[6:]} B={B} T={T} "
                        f"starts={starts}{' tree ' + str(tree) if tree else ''}")
                e = check(name, got, want, TOL_ATT)
                worst = max(worst, e / max(scale_of(want), 1e-30))
                n += 1
            del kc, vc
    torch.cuda.synchronize()
    log(f"# split-S route corners (head dims {sorted({h[0] for h in SPLIT_HEADS})} x bf16/fp16/"
        f"e5m2, S={S}, slots from {boff}, kv_len under a tile, ragged and at the window's end, "
        f"trees of 10 and 13 nodes, NaN past kv_len): {n} checks, worst max_abs_err "
        f"{worst:.3e} of max|out| (tol {TOL_ATT:g})")


def split_route_sweep(gbps, dev):
    """The route crossover: the split-S route and the persistent kernel on
    the same inputs, Mistral-7B heads, bf16 KV, T in ``SWEEP_T`` (16-128
    rows a kv head) at the window's end and from position 0, B = 1 and 8;
    ``hopper_attn.SPLIT_MAX_ROWS`` is set from it. Returns {(B, T, pos0):
    (split ms, persistent ms)}."""
    from calm_tpu_torch.ops import hopper_attn as ha

    KVH, M, S, hd, L = 8, 4, 4096, 128, 2
    out = {}
    for B in (1, 8):
        kc = (torch.randn(L, B, KVH, S, hd, device=dev) * 0.5).bfloat16()
        vc = torch.randn(L, B, KVH, S, hd, device=dev).bfloat16()
        for T in SWEEP_T:
            for pos0 in (S - T, 0):
                q = torch.randn(B, T, KVH, M, hd, device=dev)
                p0 = torch.full((B,), pos0, dtype=torch.int32, device=dev)
                kl = p0 + T
                sp = ha._split_launch(q, kc, vc, p0, kl, L - 1, 0, None)
                check(f"split-S sweep B={B} T={T} pos0={pos0}", sp,
                      ha._persistent_launch(q, kc, vc, p0, kl, L - 1, 0), TOL_ATT)
                s_ms, _ = timed(lambda i: ha._split_launch(q, kc, vc, p0, kl, i % L, 0, None))
                p_ms, _ = timed(lambda i: ha._persistent_launch(q, kc, vc, p0, kl, i % L, 0))
                out[(B, T, pos0)] = (s_ms, p_ms)
        del kc, vc
    log("# route crossover (Mistral-7B heads, bf16 KV; ms split-S / persistent, cupti): "
        + "; ".join(f"B={B} T={T} ({T * M} rows) pos0={p}: {a:.4f} / {b:.4f}"
                    for (B, T, p), (a, b) in out.items())
        + f"; SPLIT_MAX_ROWS {ha.SPLIT_MAX_ROWS}")
    return out


def wall_ms(fn, reps: int = 5) -> tuple[float, float]:
    """(median ms, spread %) of ``fn()`` by the host's clock, the card
    synchronised around each call."""
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(1e3 * (time.perf_counter() - t))
    med = statistics.median(ts)
    return med, 100 * (max(ts) - min(ts)) / med


def verify_bits(what, cfg, w, cache, tokens, starts, depth=None, tree=None):
    """The cache's replayed verify (``model.verify_once``) against the eager
    forward on the same inputs (``prefill`` with every row's logits, or
    ``tree_verify``): logits and written rows bit for bit. Returns
    (replayed ms, eager ms), medians of 5 and 3."""
    from calm_tpu_torch import model as M

    tok = torch.as_tensor(np.asarray(tokens), dtype=torch.int64).to(cache.k.device)
    B, T = tok.shape

    def replayed():
        return M.verify_once(cfg, w, tok, starts, cache, depth, tree)

    def eager():
        if tree is None:
            return M.prefill(cfg, w, tok, starts, cache, "all")[0]
        return M.tree_verify(cfg, w, tok, starts, torch.as_tensor(depth),
                             torch.as_tensor(tree), cache)[0]

    def rows():
        return [buf[:, b, :, s:s + T].clone() for b, s in enumerate(starts)
                for buf in (cache.k, cache.v)]
    r = replayed().clone()  # captures at first use
    r_rows = rows()
    e = eager()
    same_bits(f"{what}: verify logits", r, e)
    for a, b in zip(r_rows, rows()):
        same_bits(f"{what}: verify cache rows", a, b)
    return wall_ms(replayed)[0], wall_ms(eager, 3)[0]


@contextlib.contextmanager
def spec_rounds():
    """Record every speculative round of the block: (the draft's tokens
    (B, n), the target's verify logits (B, T, V)) on the host."""
    from calm_tpu_torch import model as M

    seen, last = [], {}
    real_loop, real_verify = M.decode_loop, M.verify_once

    def loop(*a, **k):
        out = real_loop(*a, **k)
        last["toks"] = out[0].cpu()
        return out

    def verify(*a, **k):
        out = real_verify(*a, **k)
        seen.append((last.get("toks"), out.float().cpu()))
        return out
    M.decode_loop, M.verify_once = loop, verify
    try:
        yield seen
    finally:
        M.decode_loop, M.verify_once = real_loop, real_verify


def self_draft_rejections(what, rounds, tol) -> tuple[int, float]:
    """A linear round of a draft that is the target: each rejection must sit
    at a near-tie, the proposed token's verify logit within ``tol`` of the
    row's maximum (relative to max |logit|): the draft's one-row step and
    the verify's multi-row forward round differently, nothing else.
    Returns (rejections, the largest such gap)."""
    n, worst = 0, 0.0
    for toks, lg in rounds:
        lg, prop = lg[0].numpy(), toks[0].tolist()
        for i, x in enumerate(prop[:lg.shape[0]]):
            top = int(lg[i].argmax())
            if top == x:
                continue
            gap = float((lg[i, top] - lg[i, x]) / np.abs(lg[i]).max())
            if gap > tol:
                fail(f"{what}: the self draft's token {x} was rejected for {top}, "
                     f"{gap:.3e} of scale apart (> {tol}): not a near-tie")
            n, worst = n + 1, max(worst, gap)
            break
    return n, worst


def same_ids_near_ties(what, got, want, logits, tol) -> str:
    """Ids against the plain replayed greedy run's: equal, or equal up to a
    step where the plain run's top two logits lie within ``tol`` of scale."""
    n = next((i for i, (g, c) in enumerate(zip(got, want)) if g != c), None)
    if n is None:
        if len(got) != len(want):
            fail(f"{what}: ids {got} != plain greedy {want}")
        return "ids equal"
    if margin(logits[n]) > tol:
        fail(f"{what}: id {n} is {got[n]}, plain greedy {want[n]}, top-2 margin "
             f"{margin(logits[n]):.3e} of scale > {tol}")
    return f"ids equal up to {n}, then a near-tie"


def gf4_words(t: torch.Tensor) -> torch.Tensor:
    """f32 (..., n) -> gf4 words (..., n/8) int32 on the card, by
    ``quant.gf4_quantize``'s rule: each group of 8 scaled by its largest
    magnitude rounded to e5m2, codes round(x / max * -4 + 4) in [0, 7]."""
    g = t.float().reshape(*t.shape[:-1], -1, 8)
    gmax = g.gather(-1, g.abs().argmax(-1, keepdim=True))
    gb = gmax.to(torch.float8_e5m2)
    gn = torch.nan_to_num(g / gb.float(), nan=0.0, posinf=0.0, neginf=0.0)
    q = torch.clamp(torch.round(gn.half() * -4 + 4), 0, 7).to(torch.int64)
    shifts = 8 + 3 * torch.arange(8, device=t.device)
    words = (q << shifts).sum(-1) + gb.view(torch.uint8).squeeze(-1).to(torch.int64)
    return (words - (words >= 2**31).to(torch.int64) * 2**32).to(torch.int32)


def gf4_twin(path, cfg, seed, dev):
    """The gf4 twin of ``synth_container(..., cfg, seed, random=True)``'s fp8
    container: the same weights, every matrix decoded and quantized to gf4
    on the card, written to ``path``; a correlated draft by construction."""
    import dataclasses

    from calm_tpu_torch import model as M
    from calm_tpu_torch.ops.qmm import QTensor, dequant
    from calm_tpu_torch.utils.synth import synth_weights, write_weights

    w = synth_weights(cfg, seed, dev, random=True)

    def twin(v):
        if not isinstance(v, QTensor):
            return v
        f = dequant(v, torch.float32)
        step = max(1, (1 << 26) // f[0].numel())  # slabs of at most 64M values
        return QTensor(torch.cat([gf4_words(f[i:i + step])
                                  for i in range(0, f.shape[0], step)]), "gf4")
    lw = w.layers
    layers = dataclasses.replace(lw, **{f.name: twin(getattr(lw, f.name))
                                        for f in dataclasses.fields(lw)})
    gcfg = dataclasses.replace(cfg, dtype="gf4")
    write_weights(path, gcfg, M.Weights(embed=twin(w.embed), layers=layers,
                                        final_norm=w.final_norm, output=twin(w.output)))
    del w, layers
    torch.cuda.empty_cache()


def cli_text(out: str, banners: int = 3) -> str:
    """The CLI's generated text: its stdout past the banner lines (the
    model's, the device's and the draft's), less the closing newline."""
    parts = out.split("\n", banners)
    if len(parts) <= banners or not all(p.startswith("# ") for p in parts[:banners]):
        fail(f"cli: no banners before the text: {out[:500]!r}")
    return parts[banners][:-1]


SPEC_CLI = ["-t", "0", "-n", "16", "-i", "hello", "--gamma", str(GAMMA)]


def speculative_container_checks(path, twin, what, eng, cpu, dev, want, want_srv, lcs_srv,
                                 procs):
    """Speculation on the 2-layer Mistral-7B-width fp8 container: the CLI's
    ``--draft`` with the target itself and with its gf4 twin (``gf4_twin``),
    its text that of ``speculative_generate`` in this process, whose ids
    are the CPU's plain greedy ids (near-ties aside) and whose self draft
    is rejected at near-ties only; then ``Server`` with the target as
    draft against the CPU server's requests (``serving_checks``): the
    greedy ids the CPU's, a sampled request served by plain ticks as the
    CPU's. ``want``: the CPU's greedy ids of "hello" (``cpu`` answers a
    near-tie); ``procs``: the CLI's runs (``SPEC_CLI`` with ``--draft``),
    by draft, started with the container phase's other CLI runs."""
    from calm_tpu_torch.engine import Engine
    from calm_tpu_torch.serve import Server
    from calm_tpu_torch.speculative import speculative_generate

    t0 = time.perf_counter()
    drafts = {"self": path, "gf4 twin": twin}
    p_toks = eng.tokenizer.encode("hello", bos=True)
    texts = {}
    for name, d in drafts.items():
        draft = Engine(d)
        eng.reset()
        with spec_rounds() as rounds:
            st, counts = drive(lambda: speculative_generate(eng, draft, "hello", 16,
                                                            gamma=GAMMA, echo=True))
        gen = same_generation(f"{what} speculative, {name} draft", cpu, p_toks, st.ids,
                              want, TOL_PREFILL)
        rej = ""
        if name == "self":
            n, gap = self_draft_rejections(f"{what} speculative", rounds, TOL_PREFILL)
            rej = f"; {n} rejections, each at a near-tie (largest gap {gap:.2e} of scale)"
        texts[name] = st.text
        log(f"# {what} speculative_generate, {name} draft, gamma {GAMMA}: {gen}; acceptance "
            f"{st.acceptance:.3f} over {st.rounds} rounds{rej}; verify replays "
            f"{counts['verify_replays']}, K13 launches {counts['prefill_attention']} "
            f"persistent, {counts['prefill_attention_split']} split-S")
        del draft
    for name, p in procs.items():
        out, errs = p.communicate(timeout=600)
        spec = [l for l in errs.splitlines() if l.startswith("# speculative:")]
        if p.returncode != 0 or not spec:
            fail(f"{what} cli --draft ({name}) exited {p.returncode}: {errs[-2000:]}")
        if cli_text(out) != texts[name]:
            fail(f"{what} cli --draft ({name}): text {cli_text(out)!r} != "
                 f"speculative_generate's {texts[name]!r}")
        log(f"# {what} cli --draft ({name}) --gamma {GAMMA}: the text of speculative_generate "
            f"in this process; {spec[0]}")

    # the server: the sampled request first, so that rounds start after it
    order = [1, 0, 2, 3, 4]
    reqs = [SERVE_REQUESTS[i] for i in order]
    srv = Server(path, batch=4, draft_path=path, gamma=GAMMA)
    (got, lgs), counts = drive(lambda: serve_recorded(srv, reqs))
    res = []
    for r, i, lg in zip(got, order, lgs):
        w = want_srv[i]
        if w.temperature > 0:
            res.append(f"{i} {same_served(f'{what} spec serve request {i}', r.ids, w.ids, w.temperature, lg, lcs_srv[i], TOL_PREFILL)}")
            continue
        n = next((j for j, (a, b) in enumerate(zip(r.ids, w.ids)) if a != b), None)
        if n is None and len(r.ids) != len(w.ids):
            fail(f"{what} spec serve request {i}: ids {r.ids} != CPU {w.ids}")
        if n is not None and margin(lcs_srv[i][n]) > TOL_PREFILL:
            fail(f"{what} spec serve request {i}: id {n} {r.ids[n]} != CPU {w.ids[n]}, "
                 f"top-2 margin {margin(lcs_srv[i][n]):.3e} of scale")
        res.append(f"{i} " + ("equal" if n is None else f"equal up to {n}, then a near-tie"))
    if srv.spec_rounds == 0 or counts["verify_replays"] != srv.spec_rounds:
        fail(f"{what} spec serve: {srv.spec_rounds} rounds, {counts['verify_replays']} "
             "verify replays")
    log(f"# {what} spec serve (4 slots, the target as draft, gamma {GAMMA}) vs the CPU server: "
        + "; ".join(res) + f"; {srv.spec_rounds} rounds, acceptance "
        f"{srv.spec_accepted / max(srv.spec_emitted, 1):.3f}, depth now {srv._gamma_now}; "
        f"speculative checks {time.perf_counter() - t0:.1f} s")
    del srv


TINYLLAMA = dict(dim=2048, hidden_dim=5632, head_dim=64, n_layers=22, n_heads=32,
                 n_kv_heads=4, vocab_size=32000)  # TinyLlama-1.1B's published shape


def speculative_full_width(cfg, dev, gbps, smi, default):
    """Speculation on ``full_width_phase``'s 32-layer fp8 Mistral-7B with
    seeded random weights (the phase's bit pattern gives every logit one
    value, a tie that no draft can match), bf16 KV, ctx 4096, 32 tokens
    from position 0 as first32: the linear
    loop at gamma 4 with the target as its own draft and with a draft of
    TinyLlama-1.1B's published shape (seeded random fp8 weights: its
    acceptance measures nothing of real text), and the tree at k=3, m=4
    with the target as draft. Each path: ids against plain replayed
    greedy's (near-ties aside), the self draft's rejections at near-ties
    only, the draft's ms a step, the verify's ms replayed and eager (bit
    for bit the same), ms a round, tok/s beside plain first32 in this run,
    acceptance and the device's busy share. Then 8 greedy requests of 32
    tokens served with the target as draft against the plain server on
    the same requests. Returns the numbers."""
    import dataclasses

    from calm_tpu_torch import model as M
    from calm_tpu_torch.config import ModelConfig
    from calm_tpu_torch.engine import Engine
    from calm_tpu_torch.serve import Server
    from calm_tpu_torch.speculative import (_tree_mask, speculative_generate,
                                            tree_speculative_generate)
    from calm_tpu_torch.tokenizer import Tokenizer
    from calm_tpu_torch.utils.synth import byte_vocab, synth_weights, weight_bytes

    t_phase = time.perf_counter()
    N, V = 32, cfg.vocab_size
    cfg = dataclasses.replace(cfg, bos_token_id=1, eos_token_id=2)
    w = synth_weights(cfg, seed=0, device=dev, random=True)
    total, bw = weight_bytes(cfg)
    tok = Tokenizer.from_tensors(*byte_vocab(V), 1, 2, V)

    def engine(c, weights, nbytes, B=1):
        return Engine.from_weights(c, weights, tok, n_bytes=nbytes[0], n_params=0,
                                   n_bandwidth=nbytes[1], batch=B, device=dev)
    target, selfd = engine(cfg, w, (total, bw)), engine(cfg, w, (total, bw))
    tcfg = ModelConfig(**TINYLLAMA, rope_theta=10000.0, seq_len=cfg.seq_len, rotary_dim=64,
                       dtype="fp8", norm_ln=False, bos_token_id=1, eos_token_id=2)
    tiny = engine(tcfg, synth_weights(tcfg, seed=5, device=dev, random=True),
                  weight_bytes(tcfg))
    out = {}

    # plain replayed greedy from position 0: the reference ids and logits, and
    # Engine.generate's time in this run
    bos = torch.tensor([1], device=dev)
    ref_t, _, ref_l = M.decode_loop(cfg, w, bos, 0, target.cache, N)
    ref_ids, ref_l = ref_t[0].tolist(), ref_l[:, 0].float().cpu().numpy()

    def plain():
        target.reset()
        return target.generate("", N, temperature=0)
    plain()
    p_ms, p_spread = wall_ms(plain, 3)
    out["plain"] = dict(ms_tok=p_ms / N, tok_s=1e3 * N / p_ms, spread_pct=p_spread)
    log(f"# speculative fp8 mistral7b: plain replayed greedy Engine.generate, {N} tokens "
        f"from pos 0: {p_ms / N:.3f} ms/tok, {1e3 * N / p_ms:.2f} tok/s (median of 3, spread "
        f"{p_spread:.2f}%; first32 by decode_loop in this run "
        f"{default['first32']['ms_tok']:.3f} ms/tok) on {smi}")

    k, m = 3, 4
    n_tree = 1 + k * (m - 1)
    tree = _tree_mask(k, m)
    depth = np.asarray([0] + [d for _ in range(k) for d in range(1, m)], np.int32)
    rng = np.random.default_rng(3)
    paths = (("linear, self draft", selfd, dict(gamma=GAMMA)),
             ("linear, TinyLlama-1.1B-shaped draft", tiny, dict(gamma=GAMMA)),
             (f"tree k={k} m={m}, self draft", selfd, dict(k=k, m=m)))
    for name, draft, kw in paths:
        t_path = time.perf_counter()
        fn = tree_speculative_generate if "k" in kw else speculative_generate

        def run(n=N):
            target.reset()
            draft.reset()
            return fn(target, draft, "", n, **kw)
        n_cap = len(CAPTURES)
        with spec_rounds() as rounds:
            st = run()  # captures the graphs of the path
        ids = same_ids_near_ties(f"speculative {name}", st.ids, ref_ids[:len(st.ids)], ref_l,
                                 TOL_PREFILL)
        rej = ""
        if draft is selfd and "gamma" in kw:
            n, gap = self_draft_rejections(f"speculative {name}", rounds, TOL_PREFILL)
            rej = f", {n} rejections, each at a near-tie (largest gap {gap:.2e} of scale)"
        cap_s = sum(c[3] for c in CAPTURES[n_cap:])
        if "k" in kw:  # the tree rounds' launches: the kernels line's tree_attention
            st2, tc = drive(run)
            if tc["tree_attention"] != cfg.n_layers * st2.rounds:
                fail(f"speculative {name}: {st2.rounds} rounds launched tree_attention "
                     f"{tc['tree_attention']} times")
            TREE_COUNTS.update(tc)
        ms, spread = wall_ms(run, 3)
        # the busy share over a run of 8 tokens (a profile of 32 costs seconds)
        short_ms = wall_ms(lambda: run(8), 3)[0]
        rows = kernel_rows(lambda: run(8))
        dev_ms = sum(r[0] for r in rows) / 1e3 if rows else None
        # the pieces: the draft's step (its batch: k lanes for the tree)
        lanes = kw.get("k", 1)
        dcache = M.KVCache.create(draft.cfg, lanes, torch.bfloat16, dev)
        t1 = torch.ones(lanes, dtype=torch.int64, device=dev)
        M.decode_loop(draft.cfg, draft.weights, t1, 0, dcache, 2, rolling=False)
        d_ms = wall_ms(lambda: M.decode_loop(draft.cfg, draft.weights, t1, 0, dcache, 8,
                                             rolling=False))[0] / 8
        del dcache
        T = n_tree if "k" in kw else GAMMA
        toks = rng.integers(3, V, (1, T))
        v_ms, e_ms = verify_bits(f"speculative {name}", cfg, w, target.cache, toks, [16],
                                 depth if "k" in kw else None, tree if "k" in kw else None)
        busy = ("not measured" if dev_ms is None
                else f"{100 * dev_ms / short_ms:.1f}% (an 8-token run)")
        out[name] = dict(ms_tok=ms / st.tokens, tok_s=1e3 * st.tokens / ms, spread_pct=spread,
                         round_ms=ms / max(st.rounds, 1), rounds=st.rounds,
                         acceptance=st.acceptance, draft_step_ms=d_ms, verify_ms=v_ms,
                         verify_eager_ms=e_ms, busy_pct=None if dev_ms is None
                         else 100 * dev_ms / short_ms, capture_s=cap_s)
        log(f"# speculative fp8 mistral7b, {name}: {N} tokens from pos 0 in {st.rounds} rounds, "
            f"acceptance {st.acceptance:.3f}{rej}; {ids}; {ms / st.tokens:.3f} ms/tok, "
            f"{1e3 * st.tokens / ms:.2f} tok/s (median of 3, spread {spread:.2f}%; plain "
            f"{p_ms / N:.3f} ms/tok: {p_ms / N / (ms / st.tokens):.3f}x); round "
            f"{ms / max(st.rounds, 1):.3f} ms; draft step {d_ms:.3f} ms (B={lanes}, "
            f"replayed); verify T={T} replayed {v_ms:.3f} ms, eager {e_ms:.3f} ms, bit-equal; "
            f"device busy {busy}; first run's captures {cap_s:.3f} s; "
            f"{time.perf_counter() - t_path:.1f} s on {smi}")

    # the verify's attention against the parent commit's routes in this call:
    # a B=1 linear verify at the window's end, the tree near position 16 and
    # at the window's end, each replayed (bit-equal to eager on both routes)
    t_path = time.perf_counter()
    cmp = {}
    for label, start, T, dep, tr in (
            ("linear B=1 T=4 at the window's end", cfg.seq_len - GAMMA, GAMMA, None, None),
            (f"tree k={k} m={m} near position 16", 16, n_tree, depth, tree),
            (f"tree k={k} m={m} at the window's end", cfg.seq_len - n_tree, n_tree, depth,
             tree)):
        toks = rng.integers(3, V, (1, T))
        new = verify_bits(f"verify {label}", cfg, w, target.cache, toks, [start], dep, tr)[0]
        with parent_verify_routes(target.cache):
            old = verify_bits(f"verify {label}, the parent's route", cfg, w, target.cache,
                              toks, [start], dep, tr)[0]
        cmp[label] = dict(replayed_ms=new, parent_route_ms=old)
    out["verify_routes"] = cmp
    log("# verify attention routes, fp8 mistral7b replayed (ms: this route / the parent's "
        "route, K13 persistent for a linear verify, plain PyTorch over the window for the "
        "tree): " + "; ".join(f"{k} {v['replayed_ms']:.3f} / {v['parent_route_ms']:.3f} "
                               f"({v['parent_route_ms'] - v['replayed_ms']:+.3f})"
                               for k, v in cmp.items())
        + f"; {time.perf_counter() - t_path:.1f} s on {smi}")

    # serving: 8 greedy requests of 32 tokens, plain and with the target as draft
    t_path = time.perf_counter()
    B = 8
    prng = np.random.default_rng(1)
    prompts = ["".join(chr(c) for c in prng.integers(97, 123, n))
               for n in prng.integers(128, 1025, B)]
    reqs = [(p, N, 0.0, 1) for p in prompts]
    plain_srv = Server(batch=B, engine=engine(cfg, w, (total, bw), B))
    want, lgs = serve_recorded(plain_srv, reqs)
    pw, _ = wall_ms(lambda: serve_recorded(plain_srv, reqs), 2)
    del plain_srv
    spec = Server(batch=B, engine=engine(cfg, w, (total, bw), B),
                  draft_engine=engine(cfg, w, (total, bw), B), gamma=GAMMA)
    serve_recorded(spec, reqs)  # captures
    r0 = (spec.spec_rounds, spec.spec_accepted, spec.spec_emitted)
    (got, _), counts = drive(lambda: serve_recorded(spec, reqs))
    n_rounds = spec.spec_rounds - r0[0]
    acc = (spec.spec_accepted - r0[1]) / max(spec.spec_emitted - r0[2], 1)
    sw, _ = wall_ms(lambda: serve_recorded(spec, reqs), 2)

    def rounds(profiled: bool, n: int = 2):
        """n rounds of all eight slots, past their admission: (ms a round,
        profiler rows or None)."""
        for p in prompts:
            spec.submit(p, max_tokens=N, temperature=0.0)
        spec.tick()  # admits all eight and runs a round
        out_rows = None
        if profiled:
            out_rows = kernel_rows(lambda: [spec.tick() for _ in range(n)])
            t = None
        else:
            t = wall_ms(lambda: [spec.tick() for _ in range(n)], 1)[0] / n
        spec.run_until_drained()
        return t, out_rows
    tick_ms = rounds(False)[0]
    rows = rounds(True)[1]
    dev_ms = sum(r[0] for r in rows) / 1e3 / 2 if rows else None
    res = [same_ids_near_ties(f"spec serve request {i}", g.ids, r.ids, np.stack(lg),
                              TOL_PREFILL) for i, (g, r, lg) in enumerate(zip(got, want, lgs))]
    if counts["prefill_attention_split"] <= 0 or counts["verify_replays"] != n_rounds:
        fail(f"spec serve: {n_rounds} rounds, launches {counts}")
    SPEC_COUNTS.update(counts)
    toks = rng.integers(3, V, (B, GAMMA + 1))
    starts = [300 + 400 * b for b in range(B)]
    v_ms, e_ms = verify_bits("spec serve", cfg, w, spec.engine.cache, toks, starts)
    vt = torch.as_tensor(toks, device=dev)
    by_kernel(lambda i: M.verify_once(cfg, w, vt, starts, spec.engine.cache),
              f"spec serve verify B={B} T={GAMMA + 1}, replayed,", calls=5)
    with parent_product_routes(spec.engine.cache):  # the products through library_mm
        old_ms = verify_bits("spec serve, the parent's route", cfg, w, spec.engine.cache,
                             toks, starts)[0]
    n_tok = sum(r.n_generated for r in got)
    busy = "not measured" if dev_ms is None else f"{100 * dev_ms / tick_ms:.1f}%"
    out["serve"] = dict(plain_drain_ms=pw, spec_drain_ms=sw, plain_tok_s=1e3 * n_tok / pw,
                        spec_tok_s=1e3 * n_tok / sw, rounds=n_rounds, acceptance=acc,
                        round_ms=tick_ms, verify_ms=v_ms, verify_eager_ms=e_ms,
                        verify_parent_route_ms=old_ms,
                        busy_pct=None if dev_ms is None else 100 * dev_ms / tick_ms)
    log(f"# spec serve fp8 mistral7b, {B} slots, {B} greedy requests of {N} tokens "
        f"({min(map(len, prompts)) + 1}-{max(map(len, prompts)) + 1}-token prompts), the target "
        f"as draft, gamma {GAMMA}: drain {sw:.1f} ms ({1e3 * n_tok / sw:.1f} tok/s) against the "
        f"plain drain's {pw:.1f} ms ({1e3 * n_tok / pw:.1f} tok/s), medians of 2; {n_rounds} "
        f"rounds; a round of all eight slots past admission {tick_ms:.3f} ms, acceptance "
        f"{acc:.3f}; verify B={B} T={GAMMA + 1} replayed {v_ms:.3f} ms, eager {e_ms:.3f} ms, "
        f"bit-equal, the route before the wide path (library_mm) replayed {old_ms:.3f} ms; "
        f"{counts['qmm_decode_wide']} wide products; "
        f"K13 {counts['prefill_attention_split']} split-S launches (verifies), "
        f"{counts['prefill_attention']} persistent (admissions), {counts['verify_replays']} "
        f"verify replays; device busy {busy} (2 rounds); ids against the plain drain: "
        + "; ".join(f"{i} {r}" for i, r in enumerate(res))
        + f"; {time.perf_counter() - t_path:.1f} s on {smi}")
    del spec, target, selfd, tiny
    torch.cuda.empty_cache()
    out["tick32"] = tick_wide(cfg, w, dev, smi)
    del w
    torch.cuda.empty_cache()
    log(f"# speculative fp8 mistral7b: {time.perf_counter() - t_phase:.1f} s; "
        + json.dumps(out))
    return out


@contextlib.contextmanager
def parent_verify_routes(cache):
    """The verify's attention as the parent commit ran it: the persistent
    K13 at every T (``SPLIT_MAX_ROWS`` 0) and the tree's plain version over
    the whole window in place of ``tree_attention``. The cache's captured
    verifies are dropped on entry and on exit, so each route captures its
    own."""
    from calm_tpu_torch import model as M
    from calm_tpu_torch.ops import hopper_attn as ha

    def drop():
        for key in [key for key in cache.graphs if key[0] == "verify"]:
            del cache.graphs[key]

    def plain_tree(q, kc, vc, p0, kl, layer, tree, batch_off=0):
        return ha.prefill_attention_plain(q, kc, vc, p0, kl, layer, batch_off, tree=tree,
                                          rows=kc.shape[3])
    saved = ha.SPLIT_MAX_ROWS, M.tree_attention
    drop()
    ha.SPLIT_MAX_ROWS, M.tree_attention = 0, plain_tree
    try:
        yield
    finally:
        ha.SPLIT_MAX_ROWS, M.tree_attention = saved
        drop()


@contextlib.contextmanager
def parent_product_routes(cache):
    """The products of 17-64 rows as they ran before the wide path:
    fp8/fp16/fp8e4 through the library (``library_mm``: a bf16 copy of the
    plane, ``torch.mm``; gf4 at 32-64 on K4), the MoE FFN past 16 rows
    through the grouped products (so a MoE verify runs eagerly), by the
    16-row limit in place of 64. The cache's captured graphs are dropped on
    entry and on exit, so each route captures its own."""
    from calm_tpu_torch import model as M
    from calm_tpu_torch.ops import hopper_qmm as hq

    def drop():
        cache.graphs.clear()
    saved = M.MAX_MV_ROWS, hq.MAX_MV_ROWS, M.qmm_mm8
    drop()
    M.MAX_MV_ROWS = hq.MAX_MV_ROWS = hq.MAX_ROWS
    M.qmm_mm8 = library_mm
    try:
        yield
    finally:
        M.MAX_MV_ROWS, hq.MAX_MV_ROWS, M.qmm_mm8 = saved
        drop()


def tick_wide(cfg, w, dev, smi, slots: int = 32, steps: int = 8, pos: int = 512) -> dict:
    """One tick of ``slots`` slots on full-width weights: the captured
    decode step of a batch of 32 (``decode_loop``, replayed) from position
    ``pos``, its ms a step against the route before the wide path
    (``library_mm`` per op) in this call, each route's ids the other's but at near-ties;
    the wide path's launches a step counted (7 products a layer and the
    lm-head)."""
    from calm_tpu_torch import model as M

    V = cfg.vocab_size
    cache = M.KVCache.create(cfg, slots, torch.bfloat16, dev)
    tok = torch.randint(3, V, (slots,), device=dev)

    def run(n=steps):
        return M.decode_loop(cfg, w, tok, pos, cache, n)
    out = {}
    ids = {}
    for route in ("wide", "parent"):
        ctx = parent_product_routes(cache) if route == "parent" else contextlib.nullcontext()
        with ctx:
            t, _, lg = run()  # captures
            ids[route] = (t.cpu().numpy(), lg.float().cpu().numpy())
            _, counts = drive(run)
            ms, spread = wall_ms(run, 5)
        out[route] = dict(ms_step=ms / steps, spread_pct=spread)
        if route == "wide":
            want = steps * (7 * cfg.n_layers + 1)
            if counts["qmm_decode_wide"] != want:
                fail(f"tick of {slots} slots: {counts['qmm_decode_wide']} wide launches, "
                     f"not {want}")
            out["wide_launches"] = counts["qmm_decode_wide"]
    # the routes' ids agree but at near-ties (their x operands differ: f16
    # with a row's scale, bf16); a slot's first mismatch decides, its later
    # steps read other tokens
    tw, lw = ids["wide"]  # (B, N), (N, B, V)
    tp = ids["parent"][0]
    ties = 0
    for b in range(slots):
        diff = np.nonzero(tw[b] != tp[b])[0]
        if diff.size:
            s0 = diff[0]
            top = np.sort(lw[s0, b])[-2:]
            if top[1] - top[0] > TOL_PREFILL * np.abs(lw[s0, b]).max():
                fail(f"tick of {slots} slots: step {s0} slot {b} ids {tw[b, s0]} / "
                     f"{tp[b, s0]} apart by more than a near-tie")
            ties += 1
    del cache
    torch.cuda.empty_cache()
    log(f"# a tick of {slots} slots, fp8 mistral7b from position {pos}, replayed: "
        f"{out['wide']['ms_step']:.3f} ms a step (spread {out['wide']['spread_pct']:.2f}%) on "
        f"the wide path ({out['wide_launches'] // steps} launches a step) against the parent's "
        f"route {out['parent']['ms_step']:.3f} ms (spread {out['parent']['spread_pct']:.2f}%) "
        f"in this call; the routes' ids equal in {slots - ties} slots, a near-tie first in "
        f"{ties} on {smi}")
    return out


def spec_serve_moe(cfg, w, total, bw, dev, smi) -> dict:
    """8 greedy requests of 32 tokens served on the 16-layer Mixtral 8x7B
    with the target as its own draft, gamma 4, against the plain server on
    the same requests (ids equal but at near-ties): drain times, rounds,
    the verify of 8 x 5 rows replayed (the expert sweep on the wide path)
    against the eager forward bit for bit and against the route before the
    wide path (eager grouped products through ``library_mm``) in this call, and the
    launches of the drain's verifies."""
    from calm_tpu_torch.engine import Engine
    from calm_tpu_torch.serve import Server
    from calm_tpu_torch.tokenizer import Tokenizer
    from calm_tpu_torch.utils.synth import byte_vocab

    import dataclasses

    t0 = time.perf_counter()
    N, B, V = 32, 8, cfg.vocab_size
    cfg = dataclasses.replace(cfg, bos_token_id=1, eos_token_id=2)
    tok = Tokenizer.from_tensors(*byte_vocab(V), 1, 2, V)

    def engine():
        return Engine.from_weights(cfg, w, tok, n_bytes=total, n_params=0, n_bandwidth=bw,
                                   batch=B, device=dev)
    prng = np.random.default_rng(1)
    prompts = ["".join(chr(c) for c in prng.integers(97, 123, n))
               for n in prng.integers(128, 1025, B)]
    reqs = [(p, N, 0.0, 1) for p in prompts]
    plain_srv = Server(batch=B, engine=engine())
    want, lgs = serve_recorded(plain_srv, reqs)
    pw, _ = wall_ms(lambda: serve_recorded(plain_srv, reqs), 2)
    del plain_srv
    spec = Server(batch=B, engine=engine(), draft_engine=engine(), gamma=GAMMA)
    serve_recorded(spec, reqs)  # captures
    r0 = spec.spec_rounds
    (got, _), counts = drive(lambda: serve_recorded(spec, reqs))
    n_rounds = spec.spec_rounds - r0
    sw, _ = wall_ms(lambda: serve_recorded(spec, reqs), 2)
    res = [same_ids_near_ties(f"mixtral spec serve request {i}", g.ids, r.ids, np.stack(lg),
                              TOL_PREFILL) for i, (g, r, lg) in enumerate(zip(got, want, lgs))]
    if counts["verify_replays"] != n_rounds or counts["qmm_moe_ffn_wide"] <= 0:
        fail(f"mixtral spec serve: {n_rounds} rounds, launches {counts}")
    SPEC_MOE_COUNTS.update(counts)
    rng = np.random.default_rng(7)
    toks = rng.integers(3, V, (B, GAMMA + 1))
    starts = [300 + 400 * b for b in range(B)]
    v_ms, e_ms = verify_bits("mixtral spec serve", cfg, w, spec.engine.cache, toks, starts)
    with parent_product_routes(spec.engine.cache):
        from calm_tpu_torch import model as M
        tk = torch.as_tensor(toks, device=dev)
        M.verify_once(cfg, w, tk, starts, spec.engine.cache)
        old_ms = wall_ms(lambda: M.verify_once(cfg, w, tk, starts, spec.engine.cache), 3)[0]
    n_tok = sum(r.n_generated for r in got)
    out = dict(plain_drain_ms=pw, spec_drain_ms=sw, rounds=n_rounds, verify_ms=v_ms,
               verify_eager_ms=e_ms, verify_parent_route_ms=old_ms,
               plain_tok_s=1e3 * n_tok / pw, spec_tok_s=1e3 * n_tok / sw)
    log(f"# spec serve fp8 mixtral8x7b (16 layers), {B} slots, {B} greedy requests of {N} "
        f"tokens, the target as draft, gamma {GAMMA}: drain {sw:.1f} ms ({1e3 * n_tok / sw:.1f} "
        f"tok/s) against the plain drain's {pw:.1f} ms ({1e3 * n_tok / pw:.1f} tok/s), medians "
        f"of 2; {n_rounds} rounds, {counts['verify_replays']} verify replays, "
        f"{counts['qmm_moe_ffn_wide']} expert FFNs and {counts['qmm_decode_wide']} products on "
        f"the wide path; verify B={B} T={GAMMA + 1} replayed {v_ms:.3f} ms, eager {e_ms:.3f} ms, "
        f"bit-equal; the route before the wide path (eager, grouped products through "
        f"library_mm) "
        f"{old_ms:.3f} ms; ids against the plain drain: "
        + "; ".join(f"{i} {r}" for i, r in enumerate(res))
        + f"; {time.perf_counter() - t0:.1f} s on {smi}")
    del spec
    torch.cuda.empty_cache()
    return out


def verify_graph_check_moe(dev):
    """The captured verify of a MoE target (2-layer Mixtral 8x7B widths, 8
    experts, top-2, fp8, fp8e4 and gf4, seq_len 64): B=8 at T=5 (40 rows:
    the expert sweep on the wide path; gf4's products on K4), gf4 also B=4
    at T=5 (20 rows: K3 on the wide path), and the k=3, m=4 tree, each replayed
    against the eager forward bit for bit (logits and written rows), the
    cache across the capture unchanged, the replays seen on
    verify replays and the wide launches counted."""
    from calm_tpu_torch import model as M
    from calm_tpu_torch.config import ModelConfig
    from calm_tpu_torch.speculative import _tree_mask
    from calm_tpu_torch.utils.synth import synth_weights

    rng = np.random.default_rng(5)
    tree = _tree_mask(3, 4)
    depth = np.asarray([0] + [d for _ in range(3) for d in range(1, 4)], np.int32)
    for fmt in ("fp8", "fp8e4", "gf4"):
        cfg = ModelConfig(**{**MISTRAL, "n_layers": 2}, rope_theta=1e6, seq_len=64,
                          rotary_dim=128, dtype=fmt, norm_ln=False, n_experts=EXPERTS,
                          n_experts_ac=2)
        w = synth_weights(cfg, seed=3, device=dev, random=True)
        cases = ((8, 5, [0, 7, 14, 21, 30, 38, 50, 59], None), (1, 10, [20], tree))
        for B, T, starts, tr in cases + (((4, 5, [3, 17, 40, 59], None),) if fmt == "gf4"
                                         else ()):
            cache = M.KVCache(*(torch.randn(cfg.n_layers, B, cfg.n_kv_heads, 64, cfg.head_dim,
                                            device=dev).bfloat16() for _ in range(2)))
            if not M.moe_sweeps(w.layers, B * T):
                fail(f"verify moe {fmt} B={B} T={T}: not on the expert sweep")
            before = (cache.k.clone(), cache.v.clone())
            g = M.verify_graph(cfg, w, cache, B, T, tr is not None)
            g.load(rng.integers(3, cfg.vocab_size, (B, T)), starts,
                   None if tr is None else depth, tr)
            g.capture()
            what = f"verify moe {fmt} B={B} T={T}"
            same_bits(f"{what}: cache k across the capture", cache.k, before[0])
            same_bits(f"{what}: cache v across the capture", cache.v, before[1])
            (_, counts) = drive(lambda: verify_bits(
                f"{what}{' tree' if tr is not None else ''}", cfg, w, cache,
                rng.integers(3, cfg.vocab_size, (B, T)), starts,
                None if tr is None else depth, tr))
            if counts["verify_replays"] <= 0 or (B * T > 16 and counts[
                    "gf4_moe_ffn_wide" if fmt == "gf4" else "qmm_moe_ffn_wide"] <= 0):
                fail(f"{what}: not replayed on the wide sweep ({counts})")
            VERIFY_MOE_COUNTS.setdefault(fmt, {k: 0 for k in counts})
            for k, v in counts.items():
                VERIFY_MOE_COUNTS[fmt][k] += v
        del w
        torch.cuda.empty_cache()
    log("# verify graphs of a MoE target, 2-layer mixtral8x7b-width fp8, fp8e4 and gf4 at "
        "seq_len 64: B=8 T=5 (the expert sweep on the wide path), gf4 B=4 T=5, the k=3 m=4 "
        "tree: cache unchanged across each capture, replayed logits and rows = eager bit for "
        "bit; launches " + json.dumps(VERIFY_MOE_COUNTS))


def verify_graph_check(dev):
    """The captured verify on 2-layer Mistral-7B-width fp8 and gf4 weights
    at seq_len 64: B=1 at T=4, B=3 at T=5 from ragged starts, and the k=3,
    m=4 tree, each replayed against the eager forward bit for bit (logits
    and written rows), the cache across the capture unchanged."""
    from calm_tpu_torch import model as M
    from calm_tpu_torch.config import ModelConfig
    from calm_tpu_torch.speculative import _tree_mask
    from calm_tpu_torch.utils.synth import synth_weights

    rng = np.random.default_rng(4)
    tree = _tree_mask(3, 4)
    depth = np.asarray([0] + [d for _ in range(3) for d in range(1, 4)], np.int32)
    for fmt in ("fp8", "gf4"):
        cfg = ModelConfig(**{**MISTRAL, "n_layers": 2}, rope_theta=10000.0, seq_len=64,
                          rotary_dim=128, dtype=fmt, norm_ln=False)
        w = synth_weights(cfg, seed=3, device=dev, random=True)
        for B, T, starts, tr in ((1, 4, [9], None), (3, 5, [0, 30, 59], None),
                                 (1, 10, [20], tree)):
            cache = M.KVCache(*(torch.randn(cfg.n_layers, B, cfg.n_kv_heads, 64, cfg.head_dim,
                                            device=dev).bfloat16() for _ in range(2)))
            before = (cache.k.clone(), cache.v.clone())
            g = M.verify_graph(cfg, w, cache, B, T, tr is not None)
            g.load(rng.integers(3, cfg.vocab_size, (B, T)), starts,
                   None if tr is None else depth, tr)
            g.capture()
            same_bits(f"verify {fmt} B={B} T={T}: cache k across the capture", cache.k, before[0])
            same_bits(f"verify {fmt} B={B} T={T}: cache v across the capture", cache.v, before[1])
            verify_bits(f"verify {fmt} 2-layer B={B} T={T}{' tree' if tr is not None else ''}",
                        cfg, w, cache, rng.integers(3, cfg.vocab_size, (B, T)), starts,
                        None if tr is None else depth, tr)
        del w
        torch.cuda.empty_cache()
    log("# verify graphs, 2-layer mistral7b-width fp8 and gf4 at seq_len 64: B=1 T=4, B=3 "
        "T=5 from starts 0/30/59, the k=3 m=4 tree: cache unchanged across each capture, "
        "replayed logits and rows = eager bit for bit")


def profile_tokens(run, n_tok: int, ms_tok: float, label: str):
    """Device time per token by kernel, and the busy share against the
    unprofiled ms/tok. Where the profiler sees no kernel (inside a graph's
    replay, CUPTI may not), it says so and gives the tokens' time by CUDA
    events instead: no busy share then."""
    rows = kernel_rows(run)
    if not rows:
        log(f"# profile {label}: the profiler saw no device time (busy share not "
            f"measured); CUDA events: {timed_events(lambda i: run(), 3, 1) / n_tok:.3f} "
            f"ms/tok")
        return
    dev_ms = sum(r[0] for r in rows) / 1e3 / n_tok
    top = "; ".join(f"{name} {us / 1e3 / n_tok:.3f} ms x{cnt / n_tok:g}"
                    for us, cnt, name in rows[:8])
    n_launch = sum(r[1] for r in rows) / n_tok
    log(f"# profile {label}: device {dev_ms:.3f} ms/tok of {ms_tok:.3f} ms/tok "
        f"= busy {100 * dev_ms / ms_tok:.1f}%, {n_launch:g} device ops/tok; per "
        f"token: {top}")


def rate_share(gb_s: float) -> str:
    """A rate's share of the card's nominal HBM rate and, once the tools
    phase has measured it, of the attainable read rate (K1, 3 GB)."""
    out = f"{gb_s:.1f} GB/s = {100 * gb_s / RATES['nominal']:.2f}% of nominal " \
          f"{RATES['nominal']:.0f} GB/s"
    if RATES["attainable"]:
        out += (f", {100 * gb_s / RATES['attainable']:.2f}% of attainable "
                f"{RATES['attainable']:.1f} GB/s")
    return out


RATES = {"nominal": 3350.0, "attainable": None}
PREFILL_COUNTS = {}  # what -> the launch counts of one full-width 2048-token prefill
FIRST32 = {}  # full-width model -> its replayed first32 ms/tok in this run
LAST32 = {}   # full-width model -> its replayed last32 ms/tok in this run


def full_width_phase(fmt, dev, gbps, smi, experts: int = 0, cohere: bool = False):
    """32-layer Mistral-7B pattern weights, or with ``experts`` Mixtral
    8x7B (rope_theta 1e6) cut to 16 of its 32 layers (the serving phases
    need the script's time) with seeded random weights, so that tokens
    spread over the experts as a real prompt's do (the pattern would send
    every token to experts 0 and 1), or with ``cohere`` Aya 23 8B at all
    32 layers, vocab 256000, tied, seeded random weights: a 2048-token
    prefill (median of 3), then bench.py's decode protocol (first32 /
    last32 at ctx 4096). gf4 Mistral-7B decodes first32 once more with
    ROTATED_DECODE off (K7 and each layer's own q/k/v), held to the
    rotated path (K8) on the same weights. Mixtral is then served on the
    same weights (``full_width_serving_phase`` with ``built``): returns
    that phase's launch counts by mode, or None for the other models."""
    from calm_tpu_torch import model as M
    from calm_tpu_torch.config import ModelConfig
    from calm_tpu_torch.engine import kv_cache_bytes
    from calm_tpu_torch.utils.synth import synth_weights, weight_bytes

    ctx, steps, T = 4096, 32, 2048
    moe = (dict(n_experts=experts, n_experts_ac=2, rope_theta=1e6, n_layers=16)
           if experts else {})
    arch = dict(norm_ln=True, norm_par=True) if cohere else dict(norm_ln=False)
    cfg = ModelConfig(**{**(AYA if cohere else MISTRAL), "rope_theta": 10000.0, **moe,
                         **arch}, seq_len=ctx, rotary_dim=128, dtype=fmt)
    what = (f"{fmt} aya23-8b" if cohere else f"{fmt} mixtral{experts}x7b" if experts
            else f"{fmt} mistral7b")
    # fp8e4: seeded floats quantized plane by plane, real scales by layer and expert
    random = bool(experts) or cohere or fmt == "fp8e4"
    t0 = time.perf_counter()
    w = synth_weights(cfg, seed=0, device=dev, random=random)
    total, bw = weight_bytes(cfg)
    if cohere:  # tied: the lm-head is the embedding
        total -= w.output.data.numel() * w.output.data.element_size()
        w.output = w.embed
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    log(f"# {what}: {cfg.n_layers} layers, vocab {cfg.vocab_size}, {total / 2**30:.2f} GiB "
        f"{'random' if random else 'pattern'} weights in "
        f"{time.perf_counter() - t0:.1f} s; bf16 KV, ctx {ctx}")
    cache = M.KVCache.create(cfg, 1, torch.bfloat16, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    prompt = torch.randint(3, cfg.vocab_size, (1, T), generator=gen, device=dev)

    def prefill():
        return M.prefill(cfg, w, prompt, [0], cache, "last")[0]

    if experts:  # warm, counting layer 0's rows per expert
        routed, real = [], M.route

        def spy(c, gate):
            out = real(c, gate)
            if not routed:
                routed.append(torch.bincount(out[1].reshape(-1), minlength=experts).tolist())
            return out
        M.route = spy
        try:
            PREFILL_COUNTS[what] = drive(prefill)[1]
        finally:
            M.route = real
        log(f"# prefill {what} T={T}: layer 0 routes its {T} tokens x 2 to the "
            f"{experts} experts as {routed[0]}")
    else:
        PREFILL_COUNTS[what] = drive(prefill)[1]  # warm
    secs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits = prefill()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
    if not torch.isfinite(logits).all():
        fail(f"prefill {what}: non-finite logits")
    med = statistics.median(secs)
    spread = 100 * (max(secs) - min(secs)) / med
    out = {"prefill": dict(ms=1e3 * med, tok_s=T / med, spread_pct=spread)}
    log(f"# prefill {what} T={T}: {1e3 * med:.3f} ms, {T / med:.1f} tok/s "
        f"(median of 3, spread {spread:.2f}%) on {smi}")
    rows = kernel_rows(prefill)
    if rows:
        dev_ms = sum(r[0] for r in rows) / 1e3
        top = "; ".join(f"{name} {us / 1e3:.3f} ms x{cnt}" for us, cnt, name in rows[:8])
        log(f"# profile prefill {what} T={T}: device {dev_ms:.3f} ms of {1e3 * med:.3f} "
            f"ms = busy {100 * dev_ms / (1e3 * med):.1f}%; {top}")
    else:
        log(f"# profile prefill {what}: the profiler saw no device time (not measured)")

    if fmt == "gf4" and not (experts or cohere):  # fp8's: in precise_full_width
        out["prefill 17-token --precise"] = precise_short_prefill(cfg, w, cache, prompt, smi)
        PRECISE_COUNTS[fmt] = {"qmm_decode_gf4_precise": out[
            "prefill 17-token --precise"]["precise"]["launches"]}
    token = torch.zeros(1, dtype=torch.int64, device=dev)
    runs = [("first32", 0), ("last32", ctx - 2 * steps)]
    if fmt == "gf4" and not (experts or cohere):
        runs.append(("first32 CALM_ROT=0", 0))
    first, rot0, was = None, None, M.ROTATED_DECODE
    for name, pos0 in runs:
        unrotated = name.endswith("CALM_ROT=0")
        M.ROTATED_DECODE = not unrotated
        eager_timed = name == "first32" and not (experts or cohere)
        try:
            M.decode_loop(cfg, w, token, pos0, cache, 2)  # warm: captures the step
            secs = []
            for _ in range(3):
                torch.cuda.synchronize()
                t = time.perf_counter()
                toks, cache, logits = M.decode_loop(cfg, w, token, pos0, cache, steps)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t)
            # the eager step on the same inputs: the same ids and logits, bit
            # for bit, and on Mistral-7B first32 its time beside the replay's
            e_secs = []
            for _ in range(3 if eager_timed else 1):
                torch.cuda.synchronize()
                t = time.perf_counter()
                te, cache, le = eager_loop(cfg, w, token, pos0, cache, steps)
                torch.cuda.synchronize()
                e_secs.append(time.perf_counter() - t)
            same_bits(f"decode {what} {name} ids", toks, te)
            same_bits(f"decode {what} {name} logits", logits, le)
            if unrotated:
                (toks, _, logits), rot0 = drive(
                    lambda: M.decode_loop(cfg, w, token, pos0, cache, steps))
            med = statistics.median(secs)
            profile_tokens(lambda: M.decode_loop(cfg, w, token, pos0, cache, 4), 4,
                           1e3 * med / steps, f"{what} {name} (pos {pos0}), replayed")
            if eager_timed:
                e_med = statistics.median(e_secs)
                profile_tokens(lambda: eager_loop(cfg, w, token, pos0, cache, 4), 4,
                               1e3 * e_med / steps, f"{what} {name} (pos {pos0}), eager")
        finally:
            M.ROTATED_DECODE = was
        if not torch.isfinite(logits).all():
            fail(f"decode {what} {name}: non-finite logits")
        if name == "first32":
            first = (toks[0].tolist(), logits[:, 0].float().cpu().numpy())
            FIRST32[what] = 1e3 * med / steps
        if name == "last32":
            LAST32[what] = 1e3 * med / steps
        spread = 100 * (max(secs) - min(secs)) / med
        read = sum(bw + kv_cache_bytes(cfg, 16, pos0 + i) for i in range(steps))
        gb_s = read / 1e9 / med
        out[name] = dict(tok_s=steps / med, ms_tok=1e3 * med / steps, gb_s=gb_s,
                         pct_hbm=100 * gb_s / gbps, spread_pct=spread)
        if RATES["attainable"]:
            out[name]["pct_attainable"] = 100 * gb_s / RATES["attainable"]
        log(f"# decode {what} {name} (pos {pos0}), replayed: {steps / med:.2f} tok/s, "
            f"{1e3 * med / steps:.3f} ms/tok, {rate_share(gb_s)} "
            f"(median of 3, spread {spread:.2f}%); ids and logits = the eager step's "
            f"bit for bit, on {smi}")
        if eager_timed:
            e_med = statistics.median(e_secs)
            e_gb = read / 1e9 / e_med
            out[name + " eager"] = dict(tok_s=steps / e_med, ms_tok=1e3 * e_med / steps,
                                        gb_s=e_gb, pct_hbm=100 * e_gb / gbps,
                                        spread_pct=100 * (max(e_secs) - min(e_secs)) / e_med)
            log(f"# decode {what} {name} (pos {pos0}), eager in the same run: "
                f"{steps / e_med:.2f} tok/s, {1e3 * e_med / steps:.3f} ms/tok, "
                f"{rate_share(e_gb)} (median of 3, spread "
                f"{out[name + ' eager']['spread_pct']:.2f}%); replayed / eager "
                f"{med / e_med:.3f}")
        if unrotated:  # against the rotated first32 on the same inputs
            ids, lg = toks[0].tolist(), logits[:, 0].float().cpu().numpy()
            n = next((i for i, (a, b) in enumerate(zip(ids, first[0])) if a != b), steps)
            worst = max(float(np.abs(lg[i] - first[1][i]).max() / np.abs(first[1][i]).max())
                        for i in range(min(n + 1, steps)))
            if worst > TOL_STEP or rot0["gf4_offn"] != cfg.n_layers * steps:
                fail(f"decode {what} CALM_ROT=0: logits {worst:.3e} from the rotated "
                     f"path's (tol {TOL_STEP}), launches {rot0}")
            if n < steps:
                greedy_agrees(f"{what} CALM_ROT=0 id {n}", ids[n], first[1][n], TOL_STEP)
            log(f"# decode {what} CALM_ROT=0 vs rotated: ids equal for {n} of {steps} "
                f"steps, logits within {worst:.3e} of scale (tol {TOL_STEP:g}); "
                f"gf4_offn {rot0['gf4_offn']} launches")
    if fmt == "fp8" and not (experts or cohere):
        out.update(precise_full_width(cfg, w, cache, prompt, token, steps, bw, gbps, smi,
                                      first, out))
        PRECISE_COUNTS[fmt] = {"qmm_decode_precise": out[
            "prefill 17-token --precise"]["precise"]["launches"]}
        del cache
        torch.cuda.empty_cache()
        cache = None
        out["speculative"] = speculative_full_width(cfg, dev, gbps, smi, out)
    del cache
    torch.cuda.empty_cache()
    if experts and fmt == "fp8":  # served speculatively: the verify's sweep of 40 rows
        out["speculative serve"] = spec_serve_moe(cfg, w, total, bw, dev, smi)
    log(f"# {what}: " + json.dumps(out))
    served = None
    if experts:  # the serving tick on these weights: the expert sweep at 8 rows
        served = full_width_serving_phase(dev, gbps, smi, fmt, built=(cfg, w, total, bw))
    del w
    torch.cuda.empty_cache()
    return served


def precise_full_width(cfg, w, cache, prompt, token, steps, bw, gbps, smi, first, default):
    """What ``--precise`` costs on the full-width model (``full_width_phase``'s
    fp8 Mistral-7B weights, cache and prompt): the 2048-token prefill
    (every product an f32 ``torch.mm`` on planes dequantized to f32, TF32
    off, in place of the bf16 product) and first32 replayed (per op: the
    fused epilogue declines, one row keeps the f32 loop), each timed in the
    same way as the default rows beside it, and the logits' distance from
    the default run's; then a 17-token prompt's prefill
    (:func:`precise_short_prefill`). Returns the rows for the phase's
    JSON."""
    from calm_tpu_torch import model as M
    from calm_tpu_torch.engine import kv_cache_bytes
    from calm_tpu_torch.ops import qmm as tqmm

    out = {"prefill 17-token --precise": precise_short_prefill(cfg, w, cache, prompt, smi)}
    tqmm.enable_precise(True)
    try:
        M.prefill(cfg, w, prompt, [0], cache, "last")  # warm
        secs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            lg = M.prefill(cfg, w, prompt, [0], cache, "last")[0]
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
        med = statistics.median(secs)
        if not torch.isfinite(lg).all():
            fail("prefill --precise: non-finite logits")
        out["prefill --precise"] = dict(ms=1e3 * med, tok_s=prompt.shape[1] / med,
                                        spread_pct=100 * (max(secs) - min(secs)) / med)
        log(f"# prefill {cfg.dtype} mistral7b T={prompt.shape[1]} --precise: {1e3 * med:.3f} ms "
            f"(default {default['prefill']['ms']:.3f} ms in this run: "
            f"{1e3 * med / default['prefill']['ms']:.2f}x; median of 3, spread "
            f"{out['prefill --precise']['spread_pct']:.2f}%) on {smi}")
        M.decode_loop(cfg, w, token, 0, cache, 2)  # warm: captures the precise step
        secs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            toks, cache, logits = M.decode_loop(cfg, w, token, 0, cache, steps)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
        med = statistics.median(secs)
        _, counts = drive(lambda: M.decode_loop(cfg, w, token, 0, cache, 2))
        profile_tokens(lambda: M.decode_loop(cfg, w, token, 0, cache, 4), 4,
                       1e3 * med / steps, f"{cfg.dtype} mistral7b first32 --precise, replayed")
    finally:
        tqmm.enable_precise(False)
    if not torch.isfinite(logits).all() or counts["qx_offn_qkv"]:
        fail(f"decode --precise: non-finite logits or the fused epilogue ran ({counts})")
    lg = logits[:, 0].float().cpu().numpy()
    ids = toks[0].tolist()
    n = next((i for i, (a, b) in enumerate(zip(ids, first[0])) if a != b), steps)
    diff = max(float(np.abs(lg[i] - first[1][i]).max() / np.abs(first[1][i]).max())
               for i in range(min(n + 1, steps)))
    read = sum(bw + kv_cache_bytes(cfg, 16, i) for i in range(steps))
    gb_s = read / 1e9 / med
    out["first32 --precise"] = dict(tok_s=steps / med, ms_tok=1e3 * med / steps, gb_s=gb_s,
                                    pct_hbm=100 * gb_s / gbps,
                                    spread_pct=100 * (max(secs) - min(secs)) / med)
    log(f"# decode {cfg.dtype} mistral7b first32 --precise, replayed: {steps / med:.2f} tok/s, "
        f"{1e3 * med / steps:.3f} ms/tok (default {default['first32']['ms_tok']:.3f} in this "
        f"run: {1e3 * med / steps / default['first32']['ms_tok']:.3f}x), {rate_share(gb_s)}; "
        f"ids equal to the default run's for {n} of {steps} steps, logits within {diff:.3e} "
        f"of scale; per op: qmm_decode {counts['qmm_decode']} launches a 2-step loop, "
        f"qx_offn_qkv 0, on {smi}")
    return out


SHORT_ROWS = 16  # a 17-token prompt: the Engine prefills all but its last token


def precise_short_prefill(cfg, w, cache, prompt, smi, reps: int = 10) -> dict:
    """A 17-token prompt's prefill under ``--precise`` on the full-width
    model: its first SHORT_ROWS tokens through ``M.prefill`` (the Engine
    prefills all but the last; logits of the last row), so every product
    takes the quality mode's 2-16-row path, 7 a layer (q, k, v, wo, w1, w3,
    w2), beside the default mode's prefill of the same rows in the same
    call: device ms (CUPTI, the sum of a call's kernels, mean of 5), wall
    ms by the host clock (median of ``reps``, the card synchronised around
    each), the launches, and the logits' distance from the default's. On
    an older tree (``chip_compare.py --precise``) the launches are those
    of its quality mode. Returns the phase's row and logs it."""
    from calm_tpu_torch import model as M
    from calm_tpu_torch.ops import hopper_qmm as hq
    from calm_tpu_torch.ops import qmm as tqmm

    toks = prompt[:, :SHORT_ROWS]

    def run():
        return M.prefill(cfg, w, toks, [0], cache, "last")[0]

    out, logits = {}, {}
    for mode, precise in (("default", False), ("precise", True)):
        tqmm.enable_precise(precise)
        try:
            run()  # warm
            before = precise_count(hq)
            logits[mode] = run().float()
            torch.cuda.synchronize()
            n = precise_count(hq) - before
            dev_ms, how = timed(lambda i: run(), iters=5, warmup=1)
            secs = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t = time.perf_counter()
                run()
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t)
        finally:
            tqmm.enable_precise(False)
        if not torch.isfinite(logits[mode]).all() or (precise and n != 7 * cfg.n_layers):
            fail(f"prefill {cfg.dtype} {SHORT_ROWS} rows {mode}: non-finite logits or "
                 f"{n} launches on the quality mode's path")
        med = statistics.median(secs)
        out[mode] = dict(device_ms=dev_ms, timed_by=how, ms=1e3 * med,
                         spread_pct=100 * (max(secs) - min(secs)) / med, launches=n)
    ref = logits["default"]
    out["distance"] = float((logits["precise"] - ref).abs().max() / ref.abs().max())
    p, d = out["precise"], out["default"]
    log(f"# prefill {cfg.dtype} {cfg.n_layers} layers, a 17-token prompt ({SHORT_ROWS} rows) "
        f"--precise: device {p['device_ms']:.3f} ms ({p['timed_by']}), wall {p['ms']:.3f} ms "
        f"(median of {reps}, spread {p['spread_pct']:.2f}%), {p['launches']} launches on the "
        f"quality mode's path; default in the same call: device {d['device_ms']:.3f} ms, wall "
        f"{d['ms']:.3f} ms: the mode costs {p['device_ms'] / d['device_ms']:.2f}x device; "
        f"logits {out['distance']:.3e} of scale from the default's, on {smi}")
    return out


def full_width_serving_phase(dev, gbps, smi, fmt: str = "fp8", cohere: bool = False,
                             built=None):
    """32-layer Mistral-7B (or with ``cohere`` Aya 23 8B: parallel norm,
    vocab 256000, tied) in ``fmt`` with seeded random weights built in
    memory, or the model ``built`` = (cfg, weights, total bytes, bandwidth
    bytes) that ``full_width_phase`` built (Mixtral 8x7B at 16 layers),
    bf16 KV, ctx 4096, 8 slots: 16 requests of seeded random bytes
    (one token a byte) of 128-1024 tokens, 64 greedy tokens each, submitted
    at once and drained, dense and, for fp8 Mistral-7B, then paged (512-row
    pages, a pool of half the dense rows), for gf4 Mistral-7B then dense with
    ROTATED_DECODE off (CALM_ROT=0: each layer's own q/k/v on K3, then K7,
    every tick at 8 rows); 3 drains each. The device time of 10 ticks is
    split by kernel and by wrapper (K3, K6, K7, K8; K2, K9; K10, K11). On a
    MoE model the eager drain also counts the live experts of each layer's
    sweep, and a tick's GB/s counts those experts' bytes. Returns each
    mode's launch counts of its first timed drain."""
    import dataclasses

    from calm_tpu_torch import model as M
    from calm_tpu_torch.config import ModelConfig
    from calm_tpu_torch.engine import Engine, kv_cache_bytes
    from calm_tpu_torch.ops import hopper_qmm as hq
    from calm_tpu_torch.serve import Server
    from calm_tpu_torch.tokenizer import Tokenizer
    from calm_tpu_torch.utils.synth import byte_vocab, synth_weights, weight_bytes

    ctx, B, n_req, n_gen = 4096, 8, 16, 64
    t0 = time.perf_counter()
    if built is None:
        arch = dict(norm_ln=True, norm_par=True) if cohere else dict(norm_ln=False)
        cfg = ModelConfig(**{**(AYA if cohere else MISTRAL), **arch}, rope_theta=10000.0,
                          seq_len=ctx, rotary_dim=128, dtype=fmt, bos_token_id=1,
                          eos_token_id=2)
        what = f"{fmt} {'aya23-8b' if cohere else 'mistral7b'}"
        w = synth_weights(cfg, seed=0, device=dev, random=True)
        total, bw = weight_bytes(cfg)
        if cohere:  # tied: the lm-head is the embedding
            total -= w.output.data.numel() * w.output.data.element_size()
            w.output = w.embed
            torch.cuda.empty_cache()
    else:
        cfg, w, total, bw = built
        cfg = dataclasses.replace(cfg, bos_token_id=1, eos_token_id=2)
        what = f"{fmt} mixtral{cfg.n_experts}x7b"
    tokenizer = Tokenizer.from_tensors(*byte_vocab(cfg.vocab_size), 1, 2, cfg.vocab_size)
    rng = np.random.default_rng(0)
    prompts = ["".join(chr(c) for c in rng.integers(97, 123, n))
               for n in rng.integers(128, 1025, n_req)]
    log(f"# serve {what}: {cfg.n_layers} layers, vocab {cfg.vocab_size}, "
        f"{total / 2**30:.2f} GiB random weights "
        f"{'reused' if built else f'in {time.perf_counter() - t0:.1f} s'}; bf16 KV, ctx "
        f"{ctx}, {B} slots, {n_req} requests of {min(map(len, prompts)) + 1}-"
        f"{max(map(len, prompts)) + 1} tokens, {n_gen} greedy tokens each")

    def engine():
        return Engine.from_weights(cfg, w, tokenizer, n_bytes=total, n_params=0,
                                   n_bandwidth=bw, batch=B, device=dev)

    def drain(srv):
        ticks = []
        real = srv.tick

        def tick():
            free = sum(not s.active for s in srv.slots)
            admits = min(free, len(srv.pending))
            kv = sum(kv_cache_bytes(cfg, 16, s.pos) for s in srv.slots if s.active)
            stepped = free < B or admits > 0  # a slot is live: the tick decodes
            t = time.perf_counter()
            real()
            ticks.append((time.perf_counter() - t, admits, kv, stepped))
        srv.tick = tick
        reqs = [srv.submit(p, max_tokens=n_gen, temperature=0.0) for p in prompts]
        torch.cuda.synchronize()
        t = time.perf_counter()
        srv.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        srv.tick = real
        if not all(r.done for r in reqs):
            fail("serve: a request did not finish")
        return reqs, wall, ticks

    out, ids, seen, counts = {}, {}, {}, {}
    modes = [("dense", {}, True)]
    if fmt == "fp8" and not cfg.n_experts:
        modes.append(("paged", dict(page_rows=512, pool_pages=32), True))
    elif fmt == "gf4" and not (cohere or cfg.n_experts):
        modes.append(("dense CALM_ROT=0", {}, False))
    if cfg.n_experts:
        wrappers = (("qmm_decode", "qmm_moe_dense", "qmm_moe_ffn") if fmt != "gf4"
                    else ("qmm_decode_gf4", "gf4_moe_ffn"))
    else:
        wrappers = (("qmm_decode", "qx_offn_qkv") if fmt == "fp8" else ("qmm_decode",)
                    if fmt == "fp8e4"
                    else ("qmm_decode_gf4", "gf4_offn_qkv", "gf4_ffn", "gf4_offn"))
    wrappers = tuple(n for n in wrappers if hasattr(hq, n))  # an older tree may lack one
    expert_bytes = 3 * cfg.hidden_dim * cfg.dim * {"fp8": 1, "fp8e4": 1, "fp16": 2,
                                                   "gf4": 0.5}[fmt]
    was = M.ROTATED_DECODE
    for mode, kw, rotated in modes:
        M.ROTATED_DECODE = rotated
        try:
            srv = Server(batch=B, engine=engine(), **kw)
            # a first drain, warm, keeps each request's ids (and, to hold
            # paged to dense, their logits)
            if any(m == "paged" for m, _, _ in modes):
                reqs, seen[mode] = serve_recorded(srv, [(p, n_gen, 0.0, 1) for p in prompts])
            else:
                reqs = drain(srv)[0]
            ids[mode] = [r.ids for r in reqs]
            runs = []
            for k in range(3):
                if k == 0:
                    (reqs, wall, ticks), counts[mode] = drive(lambda: drain(srv))
                    stepped = sum(t[3] for t in ticks)
                else:
                    reqs, wall, ticks = drain(srv)
                runs.append((wall, reqs, ticks))
            walls = [r[0] for r in runs]
            n_tok = sum(r.n_generated for r in runs[0][1])
            dec = [t for r in runs for t in r[2] if t[1] == 0]  # decode-only ticks
            tick_ms = [1e3 * statistics.median(t[0] for t in r[2] if t[1] == 0) for r in runs]
            med = statistics.median(tick_ms)
            ttft = sorted(1e3 * (r.first_token_at - r.submitted_at) for r in runs[0][1])
            eager, live = None, []
            if mode == "dense" and rotated and not cohere:  # the eager tick, same run
                real_slots = M.expert_slots

                def slots_seen(idx, n):  # each sweep's live experts, kept on the card
                    u, c = real_slots(idx, n)
                    live.append(c)
                    return u, c
                M.expert_slots = slots_seen
                try:
                    with eager_steps():
                        (e_reqs, e_wall, e_ticks), e_counts = drive(lambda: drain(srv))
                finally:
                    M.expert_slots = real_slots
                if [r.ids for r in e_reqs] != ids[mode]:
                    fail(f"serve {what} {mode}: the eager drain's ids differ from the "
                         "replayed drains'")
                # the same requests, so the same ticks: every wrapper's launches
                # equal, and one replay a decode tick
                replays = counts[mode]["graph_replays"]
                if ({k: v for k, v in e_counts.items() if k != "graph_replays"}
                        != {k: v for k, v in counts[mode].items() if k != "graph_replays"}
                        or replays != stepped or e_counts["graph_replays"]):
                    fail(f"serve {what} {mode}: launches replayed {counts[mode]} ({stepped} "
                         f"decode ticks) != eager {e_counts}")
                eager = (e_wall, 1e3 * statistics.median(t[0] for t in e_ticks if t[1] == 0),
                         sorted(1e3 * (r.first_token_at - r.submitted_at) for r in e_reqs))
            # a tick reads its live experts' weights: on a MoE model the mean
            # live count a sweep (the eager drain's) in place of top-k
            live_mean = torch.cat(live).float().mean().item() if live else None
            bw_tick = bw + (cfg.n_layers * (live_mean - cfg.n_experts_ac) * expert_bytes
                            if live_mean is not None else 0)
            gbs = statistics.median((bw_tick + kv) / dt / 1e9 for dt, _, kv, _ in dec)
            # busy share: device time of 10 replayed decode ticks against
            # their unprofiled time, split by kernel; then 10 eager ticks
            # split by kernel wrapper (a replay calls no wrapper)
            for p in prompts[:B]:
                srv.submit(p, max_tokens=n_gen, temperature=0.0)
            srv.tick()  # admits all eight
            rows = kernel_rows(lambda: [srv.tick() for _ in range(10)])
            with eager_steps():
                e_rows, per = profile_wrappers(lambda: [srv.tick() for _ in range(10)],
                                               wrappers)
            srv.run_until_drained()
        finally:
            M.ROTATED_DECODE = was
        dev_ms = sum(r[0] for r in rows) / 1e3 / 10 if rows else None
        busy = "not measured" if dev_ms is None else (
            f"device {dev_ms:.3f} ms/tick = busy {100 * dev_ms / med:.1f}%; " + "; ".join(
                f"{name} {us / 1e4:.3f} ms x{cnt / 10:g}" for us, cnt, name in rows[:6]))
        e_dev = sum(r[0] for r in e_rows) / 1e3 / 10 if e_rows else None
        if e_dev is not None:
            busy += (f"; eager ticks (the by-wrapper split): device {e_dev:.3f} ms/tick; by "
                     "wrapper (device ms a tick, share of the eager tick's device time): " + (
                         "; ".join(f"{w} {sum(k.values()) / 1e4:.3f} "
                                   f"({sum(k.values()) / 1e4 / e_dev:.1%}: " + ", ".join(
                                       f"{n} {us / 1e4:.3f}" for n, us in
                                       sorted(k.items(), key=lambda kv: -kv[1])) + ")"
                                   for w, k in per.items()) or "not measured"))
        wall = statistics.median(walls)
        out[mode] = dict(wall_s=wall, tok_s=n_tok / wall, tick_ms=med,
                         tick_spread_pct=100 * (max(tick_ms) - min(tick_ms)) / med,
                         ttft_p50_ms=statistics.median(ttft), ttft_max_ms=ttft[-1],
                         gb_s=gbs, busy_pct=None if dev_ms is None else 100 * dev_ms / med,
                         device_ms_tick=dev_ms)
        if live_mean is not None:
            out[mode]["live_experts_per_layer"] = live_mean
            log(f"# serve {what} {mode}: {live_mean:.3f} live experts a layer's sweep (mean "
                f"of {len(live)} sweeps of the eager drain; {cfg.n_experts_ac} of "
                f"{cfg.n_experts} a row), {bw_tick / 1e9:.3f} GB of weights a tick")
        if eager is not None:
            out[mode + " eager"] = dict(wall_s=eager[0], tok_s=n_tok / eager[0],
                                        tick_ms=eager[1], ttft_p50_ms=statistics.median(eager[2]),
                                        ttft_max_ms=eager[2][-1])
            log(f"# serve {what} {mode}, one eager drain in the same run: {eager[0]:.3f} s, "
                f"{n_tok / eager[0]:.1f} tok/s, decode tick {eager[1]:.3f} ms (replayed "
                f"{med:.3f}: {med / eager[1]:.3f} of eager), TTFT p50 "
                f"{statistics.median(eager[2]):.1f} ms, max {eager[2][-1]:.1f} ms; the same ids, "
                f"and the same launches as the replayed drain "
                f"({sum(v for k, v in counts[mode].items() if k != 'graph_replays')}, "
                f"{counts[mode]['graph_replays']} replays for {stepped} decode ticks)")
        log(f"# serve {what} {mode}: drain {wall:.3f} s (median of 3, "
            f"{min(walls):.3f}-{max(walls):.3f}), {n_tok} tokens, {n_tok / wall:.1f} tok/s "
            f"over {B} slots; decode tick {med:.3f} ms (median of each run's median: "
            f"{', '.join(f'{x:.3f}' for x in tick_ms)}; spread "
            f"{out[mode]['tick_spread_pct']:.2f}%); TTFT p50 {statistics.median(ttft):.1f} ms, "
            f"max {ttft[-1]:.1f} ms; {rate_share(gbs)} per decode tick (weights + live "
            f"KV); {busy} on {smi}")
        key = "gf4_moe_ffn" if fmt == "gf4" else "qmm_moe_ffn"
        if cfg.n_experts and key + "_multirow" in counts[mode]:
            # every decode tick's sweep: one multi-row FFN a layer
            c = counts[mode]
            if (c[key + "_multirow"] != cfg.n_layers * stepped or c[key] != c[key + "_multirow"]
                    or c["qmm_moe_dense"]):
                fail(f"serve {what} {mode}: {stepped} decode ticks, launches {c}")
            log(f"# serve {what} {mode}: {stepped} decode ticks, {key} {c[key + '_multirow']} "
                f"launches at 8 rows ({cfg.n_layers} a tick, four kernels each), "
                f"qmm_moe_dense 0")
        if not rotated:  # every tick's layers on K7 at 8 rows, none on K8
            c = counts[mode]
            if (c["gf4_offn_multirow"] != cfg.n_layers * stepped
                    or c["gf4_offn"] != c["gf4_offn_multirow"] or c["gf4_offn_qkv"]
                    or c["qmm_decode_gf4_multirow"] != (3 * cfg.n_layers + 1) * stepped):
                fail(f"serve {what} {mode}: {stepped} decode ticks, launches {c}")
            log(f"# serve {what} {mode}: {stepped} decode ticks, gf4_offn "
                f"{c['gf4_offn_multirow']} launches at 8 rows ({cfg.n_layers} a tick), "
                f"gf4_offn_qkv 0, qmm_decode_gf4 {c['qmm_decode_gf4_multirow']} at 8 rows "
                f"(q, k, v of each layer and the lm-head)")
        del srv
        torch.cuda.empty_cache()

    if "paged" in ids:
        out.update(group_drains(Server, engine, drain, prompts, n_gen, ids["paged"],
                                seen["paged"], out["paged"], w, dev, smi))

    # paged against dense: the same ids, and logits the same kernels give
    split, worst = [], 0.0
    for i, (a, b) in enumerate(zip(ids.get("paged", []), ids["dense"])):
        n = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), len(a))
        for lg, lc in zip(seen["paged"][i][:n], seen["dense"][i][:n]):
            worst = max(worst, float(np.abs(lg - lc).max() / np.abs(lc).max()))
        if n < len(a) or len(a) != len(b):
            split.append(f"{i}: " + same_served(f"serve paged request {i}", a, b, 0.0,
                                                seen["paged"][i], seen["dense"][i], TOL_STEP))
    if worst > TOL_STEP:
        fail(f"serve {what}: paged logits differ from dense by {worst:.3e} > {TOL_STEP}")
    for i in (0, 7):  # and two requests of each dense drain against a single stream
        toks = tokenizer.encode(prompts[i], bos=True)
        cache = M.KVCache.create(cfg, 1, torch.bfloat16, dev)
        M.prefill(cfg, w, torch.tensor([toks[:-1]], device=dev), [0], cache, "none")
        dense = [m for m in ids if m != "paged"]
        st, _, lg = M.decode_loop(cfg, w, torch.tensor([toks[-1]], device=dev),
                                  len(toks) - 1, cache, max(len(ids[m][i]) for m in dense))
        want = st[0].tolist()
        for mode in dense:
            got = ids[mode][i]
            n = next((j for j, (x, y) in enumerate(zip(got, want)) if x != y), None)
            if n is not None:
                greedy_agrees(f"serve {what} {mode} request {i} vs single stream, id {n}",
                              got[n], lg[n, 0].float().cpu().numpy(), TOL_PREFILL)
            log(f"# serve {what} {mode} request {i} ({len(toks)} tokens) against prefill + "
                "decode_loop: " + ("ids equal" if n is None else f"equal up to {n}, then a "
                                   "near-tie") + f" ({len(set(got))} distinct of {len(got)}: "
                f"{got[:8]}...)")
        del cache
    distinct = len({t for r in ids["dense"] for t in r})
    if distinct < 2:
        fail(f"serve {what}: every request generated one id")
    if "paged" in ids:
        log(f"# serve {what} paged vs dense: {n_req - len(split)} of {n_req} requests "
            f"with equal ids ({distinct} distinct ids in all), their logits within "
            f"{worst:.3e} of scale (tol {TOL_STEP:g}); split: {split or 'none'}; "
            + json.dumps(out))
    else:
        log(f"# serve {what}: {distinct} distinct ids in all; " + json.dumps(out))
    if built is None:
        del w
    torch.cuda.empty_cache()
    return counts


GROUP_PAGES = 16  # a group decoder's pool: 4 slots x 4 pages of 512 rows (half dense)


def group_drains(Server, engine, drain, prompts, n_gen, want, lcs, single, w, dev, smi):
    """The 16 requests on ``Server(page_rows=512, dp_devices=[dev, dev])``:
    two paged decoders of 4 slots on this one card sharing one copy of the
    weights, each with its own pool and captured step; drained with host
    sampling, then with ``device_sampling`` (each decoder its own
    generator seeded from the server's). Each mode: a warm drain whose ids
    are held to the single pool's (``want``, ``lcs``: its ids and logits;
    equal but at near-ties), 3 timed drains, 10 profiled ticks, the pool
    empty at the end. Returns each mode's drain, tick and busy figures,
    logged beside the single pool's (``single``), a finding, not a target."""
    out = {}
    for mode, kw in (("paged group", {}), ("paged group device sampling",
                                            dict(device_sampling=True))):
        srv = Server(batch=8, engine=engine(), page_rows=512, pool_pages=GROUP_PAGES,
                     dp_devices=[dev, dev], **kw)
        decs = srv._paged.decs
        if len(decs) != 2 or not decs[0].weights is decs[1].weights is w:
            fail(f"serve {mode}: the two decoders do not share the one copy of the weights")
        if kw:
            reqs = drain(srv)[0]  # warm: captures each decoder's sampled step
            seen = [lc for lc in lcs]  # no logits reach the host: the single pool's
        else:
            reqs, seen = serve_recorded(srv, [(p, n_gen, 0.0, 1) for p in prompts])
        split = [f"{i}: " + same_served(f"serve {mode} request {i}", r.ids, want[i], 0.0,
                                        seen[i], lcs[i], TOL_STEP)
                 for i, r in enumerate(reqs) if r.ids != want[i]]
        runs = [drain(srv) for _ in range(3)]
        walls = [r[1] for r in runs]
        tick_ms = [1e3 * statistics.median(t[0] for t in r[2] if t[1] == 0) for r in runs]
        med = statistics.median(tick_ms)
        n_tok = sum(r.n_generated for r in runs[0][0])
        for p in prompts[:8]:
            srv.submit(p, max_tokens=n_gen, temperature=0.0)
        srv.tick()  # admits all eight
        rows = kernel_rows(lambda: [srv.tick() for _ in range(10)])
        srv.run_until_drained()
        if srv._paged.pages_in_use() != 0:
            fail(f"serve {mode}: {srv._paged.pages_in_use()} pages in use after the drains")
        dev_ms = sum(r[0] for r in rows) / 1e3 / 10 if rows else None
        wall = statistics.median(walls)
        out[mode] = dict(wall_s=wall, tok_s=n_tok / wall, tick_ms=med,
                         tick_spread_pct=100 * (max(tick_ms) - min(tick_ms)) / med,
                         device_ms_tick=dev_ms,
                         busy_pct=None if dev_ms is None else 100 * dev_ms / med)
        log(f"# serve fp8 mistral7b {mode}, 2 decoders x 4 slots on one card, one copy of "
            f"the weights: ids of the 16 requests " + (
                "equal to the single pool's" if not split else f"split: {split}")
            + f"; drain {wall:.3f} s (median of 3, {min(walls):.3f}-{max(walls):.3f}), "
            f"{n_tok / wall:.1f} tok/s; decode tick {med:.3f} ms ({', '.join(f'{x:.3f}' for x in tick_ms)}) "
            f"against the single pool's {single['tick_ms']:.3f} ms in this run; "
            + ("device not measured" if dev_ms is None else
               f"device {dev_ms:.3f} ms/tick = busy {100 * dev_ms / med:.1f}% (the single "
               f"pool's {single['busy_pct'] or float('nan'):.1f}%)")
            + f"; pages in use after 0 on {smi}")
        del srv
        torch.cuda.empty_cache()
    return out


def tools_phase(smi):
    """``main()`` of both port tools, in-process; returns their launch
    counts and sets the attainable HBM read rate from dma_ceiling's 3 GB
    rows."""
    from calm_tpu_torch.tools import dma_ceiling, gf4_bound

    (dma, g4), counts = drive(lambda: (dma_ceiling.main(), gf4_bound.main()))
    RATES["attainable"] = max(r["gb_s"] for r in dma if r["mb"] > 1e3)
    log(f"# attainable HBM read rate: {RATES['attainable']:.1f} GB/s (K1, best 3 GB row "
        f"of dma_ceiling) = {100 * RATES['attainable'] / RATES['nominal']:.2f}% of "
        f"nominal {RATES['nominal']:.0f} GB/s on {smi}; gf4_bound: " + ", ".join(
            f"{r['what']} {r['gb_s']:.0f} GB/s" for r in g4 if r["td"] in (2048, None)))
    return counts


# ---------------------------------------------------------------------------
# The profiler and its tools (calm_tpu_torch.profiler, tools.perf, tools.sol)
# ---------------------------------------------------------------------------

PERF_TOL = 0.05       # perf's ms/tok against the full-width phase's first32
PERF_MAX_HBM = 105.0  # the most % of the nominal HBM rate a table row may read
PERF_COVER = 70.0     # the least % of the traced device time in rows with bytes


def tool(name, *args, timeout=600) -> str:
    """``python -m calm_tpu_torch.tools.<name>`` on the card; its standard
    output (fails on a non-zero exit)."""
    r = subprocess.run([sys.executable, "-m", f"calm_tpu_torch.tools.{name}", *args],
                       cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    if r.returncode:
        fail(f"tools.{name} {' '.join(args)} exited {r.returncode}: {r.stderr[-2000:]}")
    return r.stdout


def in_process(main, argv) -> str:
    """A tool's ``main(argv)`` in this process (no interpreter to start);
    its standard output."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def table_rows(out: str) -> tuple[list[dict], float]:
    """The rows of a printed trace_table with their columns, and its share
    of the device time in rows with recorded bytes."""
    rows, cover, inside = [], None, False
    for line in out.splitlines():
        m = re.match(r"# rows with recorded bytes: ([\d.]+)% of the device time", line)
        if m:
            cover, inside = float(m.group(1)), False
        inside = inside or line.startswith("# op ")
        parts = line[2:].split()
        share = next((i for i, p in enumerate(parts) if re.fullmatch(r"[\d.]+%", p)), None)
        if not inside or share is None or share < 5:
            continue
        row = dict(name=" ".join(parts[:share - 4]), calls=int(parts[share - 4]),
                   mean_us=float(parts[share - 3]), total_ms=float(parts[share - 1]),
                   share=float(parts[share][:-1]))
        if len(parts) > share + 4:
            row.update(gb_s=float(parts[share + 1]), hbm=float(parts[share + 2]),
                       tc=float(parts[share + 3]), alu=float(parts[share + 4]),
                       bound=" ".join(parts[share + 5:]))
        rows.append(row)
    if cover is None:
        fail("tools.perf printed no trace table")
    return rows, cover


def profiler_phase(smi, container: str) -> dict:
    """``tools.perf`` at full width in its own process: fp8 Mistral-7B
    (pattern weights, bf16 KV, ctx 4096) first32 replayed, min of 3, with
    the roofline report against this run's attainable rate, and the trace
    table of one eager run; held to ``profiler.step_bytes``, the full-width
    phase's first32 (within PERF_TOL), the nominal HBM rate (no row over
    PERF_MAX_HBM %) and the recorded bytes' cover of the traced device time
    (at least PERF_COVER %). Then, in this process, a 2048-token prefill of
    the 2-layer Mistral-width fp8 container with its table, and
    ``tools.sol`` beside the measured first32. Returns the numbers it
    read."""
    from calm_tpu_torch import profiler
    from calm_tpu_torch.config import ModelConfig
    from calm_tpu_torch.tools import perf, sol

    t0 = time.perf_counter()
    cfg = ModelConfig(**perf.SHAPES["mistral7b"], seq_len=4096, rope_theta=10000.0,
                      norm_ln=False, dtype="fp8", rotary_dim=128)
    with tempfile.TemporaryDirectory(prefix="calm_perf_") as tr:
        out = tool("perf", "--synthetic", "mistral7b", "--dtype", "fp8", "-n", "32",
                   "--pos", "0", "--trace", tr, "--attainable", f"{RATES['attainable']:.1f}")
    t_perf = time.perf_counter() - t0
    lines = out.splitlines()
    roof = [l for l in lines if l.startswith("# roofline:")]
    ach = [l for l in lines if l.startswith("# achieved:")]
    if not (roof and ach and "# measured per-op table" in out):
        fail(f"tools.perf: no roofline report or table in\n{out[-3000:]}")
    want_gb = profiler.step_bytes(cfg, 16, 0)
    ms_tok = float(re.search(r"# achieved: ([\d.]+) ms/tok", ach[0]).group(1))
    gb_s = float(re.search(r", (\d+) GB/s = ", ach[0]).group(1))
    if f"({want_gb / 1e9:.2f} GB/tok" not in roof[0] or abs(
            gb_s - want_gb / 1e9 / (ms_tok / 1e3)) > 0.01 * gb_s + 1:
        fail(f"tools.perf: the roofline's bytes a token are not step_bytes = {want_gb}: "
             f"{roof[0]} / {ach[0]}")
    first = FIRST32["fp8 mistral7b"]
    if abs(ms_tok - first) > PERF_TOL * first:
        fail(f"tools.perf: {ms_tok:.3f} ms/tok, more than {100 * PERF_TOL:.0f}% from the "
             f"full-width phase's first32 {first:.3f}")
    rows, cover = table_rows(out)
    over = [r for r in rows if r.get("hbm", 0.0) > PERF_MAX_HBM]
    if over or cover < PERF_COVER:
        fail(f"tools.perf table: rows over {PERF_MAX_HBM}% of nominal HBM {over}, "
             f"recorded bytes cover {cover}% of the device time (least {PERF_COVER})")
    log(f"# tools.perf fp8 mistral7b first32 in {t_perf:.1f} s: {ms_tok} ms/tok against the "
        f"phase's {first:.3f} ({100 * (ms_tok / first - 1):+.2f}%) on {smi}")
    for l in roof + ach + [l for l in lines if l.startswith(("# measured", "# rows with",
                                                             "# recorded"))]:
        log(l)
    for r in rows[:12]:
        log(f"#   table: {r}")
    res = dict(ms_tok=ms_tok, gb_s=gb_s, cover=cover, top=rows[:12], perf_s=t_perf)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="calm_perf_") as tr:
        out = in_process(perf.main, [container, "--prefill", "2048", "--ctx", "4096",
                                     "--trace", tr])
    pf = [l for l in out.splitlines() if l.startswith("# prefill T=2048")]
    rows, cover = table_rows(out)
    if not pf or any(r.get("hbm", 0.0) > PERF_MAX_HBM for r in rows):
        fail(f"tools.perf --prefill 2048: {out[-3000:]}")
    log(f"# tools.perf --prefill 2048, 2-layer Mistral-width fp8 container, in "
        f"{time.perf_counter() - t0:.1f} s: {pf[0]}; recorded bytes cover {cover}% of the "
        f"traced device time on {smi}")
    for r in rows[:6]:
        log(f"#   table: {r}")
    res["prefill"] = dict(line=pf[0], cover=cover, top=rows[:6])

    card = max((k for k in sol.CARDS if k in torch.cuda.get_device_name(0)), key=len)
    out = in_process(sol.main, ["--model", "mistral7b", "--dtype", "fp8", "--ctx", "4096",
                                "--pos", "0", "--chip", card, "-v"])
    sol_tok = float(re.search(r"SoL +([\d.]+) tok/s", out).group(1))
    log(f"# tools.sol mistral7b fp8 pos 0 on the {card} entry: {out.splitlines()[0].strip()}; "
        f"measured first32 {1e3 / first:.1f} tok/s = {100 * 1e3 / first / sol_tok:.1f}% of "
        f"its SoL on {smi}")
    res["sol_tok_s"] = sol_tok
    return res


# ---------------------------------------------------------------------------
# The repo's tools on the port: tools.convert, accept, quality, bench and
# serve_bench, each run as a user runs it (``python -m``, its own process)
# ---------------------------------------------------------------------------

# mistralai/Mistral-7B-v0.1's config.json, cut to 2 of its 32 layers
HF_MISTRAL = {"architectures": ["MistralForCausalLM"], "hidden_size": 4096,
              "intermediate_size": 14336, "num_hidden_layers": 2,
              "num_attention_heads": 32, "num_key_value_heads": 8, "vocab_size": 32000,
              "max_position_embeddings": 32768, "sliding_window": 4096,
              "bos_token_id": 1, "eos_token_id": 2, "rope_theta": 10000.0,
              "rms_norm_eps": 1e-5, "hidden_act": "silu", "tie_word_embeddings": False}
CONVERTED = ("fp8", "gf4")  # the converter's formats checked on the card
CONVERT_CTX = 4096  # both sides load the converted containers at this context (bf16 KV)
# the gate's checkpoints: tools/accept.py's --selftest configs (:143-162) at
# widths the card's kernels take (head dim 64, rows of 128-aligned widths)
ACCEPT_DENSE = {"architectures": ["LlamaForCausalLM"], "hidden_size": 256,
                "intermediate_size": 512, "num_hidden_layers": 2, "num_attention_heads": 4,
                "num_key_value_heads": 2, "vocab_size": 272, "max_position_embeddings": 128,
                "bos_token_id": 1, "eos_token_id": 2, "rope_theta": 10000.0,
                "rms_norm_eps": 1e-5, "hidden_act": "silu", "tie_word_embeddings": False}
ACCEPT_MOE = dict(ACCEPT_DENSE, architectures=["MixtralForCausalLM"], num_local_experts=4,
                  num_experts_per_tok=2)
ACCEPT_DIRS = (("tinyllama-1.1b", ACCEPT_DENSE, 11), ("mistral-7b", ACCEPT_DENSE, 12),
               ("llama-3-8b", ACCEPT_DENSE, 13), ("mixtral-8x7b", ACCEPT_MOE, 14))
ACCEPT_ROWS = {1: ("convert[fp16]", "hash[fp16]", "cpu-crosscheck", "ppl[fp16]", "bench[fp16]"),
               2: tuple(f"{s}[{d}]" for d in ("fp16", "fp8")
                        for s in ("convert", "hash", "ppl", "bench")) + ("delta[fp8]",),
               3: tuple(f"{s}[{d}]" for d in ("fp16", "gf4")
                        for s in ("convert", "hash", "ppl", "bench")) + ("delta[gf4]",),
               4: ("convert[gf4]", "hash[gf4]", "ppl[gf4]", "bench[gf4]")}
SERVE_BENCH = ["--batch", "8", "--requests", "16", "--prompt-len", "128", "--max-tokens",
               "32", "--prefix-share", "0.5", "--prefix-cache-tokens", "8192"]


def write_hf_inputs(tmp, dev) -> dict:
    """The tools' inputs written with torch alone, as downloads hold them:
    a BF16 ``MistralForCausalLM`` checkpoint of Mistral-7B's widths at 2
    layers, and the gate's tiny BF16 checkpoints (``ACCEPT_DIRS``), each
    ``config.json``, ``model.safetensors`` and a byte-fallback
    ``tokenizer.json``, from seeded normal weights drawn on the card."""
    from calm_tpu_torch.utils.modelgen import write_hf_checkpoint

    t0 = time.perf_counter()
    mistral = os.path.join(tmp, "hf-mistral-7b-2l")
    write_hf_checkpoint(mistral, HF_MISTRAL, seed=7, device=dev)
    root = os.path.join(tmp, "hf-accept")
    for name, cfg, seed in ACCEPT_DIRS:
        write_hf_checkpoint(os.path.join(root, name), cfg, seed=seed, device=dev)
    log(f"# HF checkpoints written with torch: Mistral-7B widths at 2 layers, BF16, "
        f"{os.path.getsize(os.path.join(mistral, 'model.safetensors')) / 1e9:.2f} GB; "
        f"{len(ACCEPT_DIRS)} tiny ones for the gate; {time.perf_counter() - t0:.1f} s")
    return dict(mistral=mistral, accept=root,
                out={fmt: os.path.join(tmp, f"converted-mistral7b-2l-{fmt}.calm")
                     for fmt in CONVERTED})


def convert_side(hf_dir, out, fmt) -> dict:
    """For the worker process: ``python -m calm_tpu_torch.tools.convert``
    of the BF16 checkpoint at ``fmt`` (its seconds), then the CPU plain
    path on the container (``cpu_reference`` at ``CONVERT_CTX``): 8 greedy
    steps from token 1, and ``PROMPT_LONG``'s prefill with 8 steps after
    it, as ``_cpu_checks`` computes them."""
    try:
        torch.set_num_threads(CPU_THREADS)
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "calm_tpu_torch.tools.convert", out,
                            hf_dir, "--dtype", fmt], cwd=ROOT, capture_output=True,
                           text=True, timeout=900,
                           env=dict(os.environ, OMP_NUM_THREADS=str(CPU_THREADS)))
        secs = time.perf_counter() - t0
        if r.returncode:
            raise RuntimeError(f"tools.convert --dtype {fmt} exited {r.returncode}: "
                               f"{r.stderr[-2000:]}")
        what = f"converted {fmt} mistral7b-width"
        t0 = time.perf_counter()
        cpu, note = cpu_reference(out, what, CONVERT_CTX)
        res = dict(seconds=secs, last=r.stdout.strip().splitlines()[-1].strip(),
                   notes=[note] if note else [])
        with dequant_once(cpu.weights):
            tok, steps = 1, []
            for pos in range(8):
                lc = cpu.step(tok, pos)
                steps.append((tok, lc))
                tok = int(lc.argmax())
            res["steps"] = steps
            toks = cpu.tokenizer.encode(PROMPT_LONG, bos=True)
            cpu.reset()
            lcs, ids = [cpu.prefill_tokens(toks)], []
            for i in range(8):
                ids.append(int(lcs[-1].argmax()))
                lcs.append(cpu.step(ids[-1], len(toks) + i))
            res["prefill"] = (lcs, ids)
        res["notes"].append(f"# {what}: the CPU side in a worker process, "
                            f"{time.perf_counter() - t0:.1f} s on {CPU_THREADS} threads")
        return res
    except SystemExit:  # fail() logged why; a pool's worker passes on exceptions only
        raise RuntimeError(f"the CPU side of the converted {fmt} container failed")


def converted_checks(hf, refs, smi) -> dict:
    """(a) Each converted container on the card against the CPU plain
    path on the same container (``convert_side``): 8 decode steps within
    TOL_STEP of scale, the prefill and 8 steps after it within
    TOL_PREFILL, greedy ids equal but at near-ties."""
    from calm_tpu_torch.engine import Engine

    out = {}
    for fmt in CONVERTED:
        what = f"converted {fmt} mistral7b-width"
        t0 = time.perf_counter()
        ref = refs[fmt].get()
        log(f"# {what}: tools.convert --dtype {fmt} of the BF16 checkpoint in "
            f"{ref['seconds']:.1f} s ({ref['last']}; {os.path.getsize(hf['out'][fmt]) / 1e9:.2f} "
            f"GB), waited {time.perf_counter() - t0:.1f} s for it and the CPU side")
        for note in ref["notes"]:
            log(note)
        eng = Engine(hf["out"][fmt], context=CONVERT_CTX)
        worst, ties = 0.0, 0
        for pos, (tok, lc) in enumerate(ref["steps"]):
            lg = eng.step(tok, pos)
            worst = max(worst, float(np.abs(lg - lc).max() / np.abs(lc).max()))
            ties += not greedy_agrees(f"{what} step {pos}", int(lg.argmax()), lc, TOL_STEP)
        if worst > TOL_STEP:
            fail(f"{what}: decode logits differ from the CPU by {worst:.3e} > {TOL_STEP}")
        toks = eng.tokenizer.encode(PROMPT_LONG, bos=True)
        eng.reset()
        lcs, ids = ref["prefill"]
        lg, lc = eng.prefill_tokens(toks), lcs[0]
        worst_p, ties_p = 0.0, 0
        for i in range(9):
            worst_p = max(worst_p, float(np.abs(lg - lc).max() / np.abs(lc).max()))
            if i == 8:
                break
            ties_p += not greedy_agrees(f"{what} greedy id {i} after prefill",
                                        int(lg.argmax()), lc, TOL_PREFILL)
            lg, lc = eng.step(ids[i], len(toks) + i), lcs[i + 1]
        if not worst_p <= TOL_PREFILL:
            fail(f"{what}: logits after prefill differ from the CPU by {worst_p:.3e} "
                 f"> {TOL_PREFILL}")
        log(f"# {what} on the card vs cpu: 8 steps within {worst:.3e} of scale (tol "
            f"{TOL_STEP:g}), {ties} near-ties; a {len(toks)}-token prefill and 8 steps "
            f"within {worst_p:.3e} (tol {TOL_PREFILL:g}), {ties_p} near-ties; on {smi}")
        out[fmt] = dict(convert_s=ref["seconds"], step_err=worst, prefill_err=worst_p)
        del eng
    return out


def json_line(out: str, what: str) -> dict:
    """The last JSON object a tool printed on its standard output."""
    for line in reversed(out.strip().splitlines()):
        if line.startswith("{"):
            return json.loads(line)
    fail(f"{what}: no JSON line in\n{out[-2000:]}")


def tool_run(name, *args, timeout=900) -> tuple[str, str, float]:
    """``python -m calm_tpu_torch.tools.<name>`` on the card: (standard
    output, standard error, seconds); fails on a non-zero exit."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", f"calm_tpu_torch.tools.{name}", *args],
                       cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    if r.returncode:
        fail(f"tools.{name} {' '.join(args)} exited {r.returncode}: {r.stderr[-3000:]}")
    return r.stdout, r.stderr, time.perf_counter() - t0


def accept_check(hf, smi) -> dict:
    """(b) The acceptance gate on the tiny BF16 checkpoints, configs 1-4,
    on the card: PASS, the rows of ``ACCEPT_ROWS`` each ok, the
    cpu-crosscheck on the card's rule (greedy ids of the CPU's CLI, equal
    but at a near-tie)."""
    jpath = os.path.join(hf["accept"], "accept.json")
    out, _, secs = tool_run("accept", hf["accept"], "--configs", "1,2,3,4",
                            "--ppl-chars", "2000", "--json", jpath)
    with open(jpath) as f:
        res = json.load(f)
    rows = {(r["config"], r["stage"]): r for r in res["rows"]}
    want = {(c, s) for c, stages in ACCEPT_ROWS.items() for s in stages}
    if (res["verdict"] != "PASS" or set(rows) != want or not all(r["ok"] for r in rows.values())
            or res["backend"] != "cuda"):
        fail(f"tools.accept: {json.dumps(res)[-3000:]}")
    cross = rows[(1, "cpu-crosscheck")]["detail"]
    if "greedy ids equal" not in cross:
        fail(f"tools.accept: the cpu-crosscheck row is not on the card's rule: {cross}")
    log(f"# tools.accept configs 1-4 on the card in {secs:.1f} s: {res['verdict']}, "
        f"{len(rows)} rows ok; cpu-crosscheck: {cross}; on {smi}")
    for (c, s), r in sorted(rows.items()):
        if s.startswith(("ppl", "delta", "bench")):
            log(f"#   accept cfg{c} {s}: {r['detail']}")
    return dict(seconds=secs, ppl=res["ppl"], decode=res["decode"], crosscheck=cross)


def quality_check(smi) -> dict:
    """(c) The quality tool on the card's kernels: every format's SNR line,
    and each format's logit drift with argmax agreement 6/6."""
    out, _, secs = tool_run("quality")
    snr = re.findall(r"^ +(\w+) \( ?\d+ bpw\): SNR +([\d.]+) dB", out, re.M)
    drift = re.findall(r"^ +(\w+): max rel logit drift +([\d.]+)%, argmax agreement (\d)/6",
                       out, re.M)
    if len(snr) != 4 or len(drift) != 4 or any(a != "6" for _, _, a in drift):
        fail(f"tools.quality: {out[-3000:]}")
    log(f"# tools.quality on the card in {secs:.1f} s: SNR dB " + ", ".join(
        f"{f} {v}" for f, v in snr) + "; logit drift against the f32 oracle " + ", ".join(
        f"{f} {d}% (6/6)" for f, d, _ in drift) + f" on {smi}")
    return dict(snr=dict(snr), drift={f: float(d) for f, d, _ in drift})


def bench_check(smi) -> dict:
    """(d) The bench tool at full width (32-layer Mistral-7B, ctx 4096):
    the fp8 default, whose first32 (positions 2000-2031) must lie between
    this run's full-width first32 (from position 0) and last32; ``--dtype
    fp16`` and ``--kv fp8``, neither timed at full width before; and
    ``--prefill 2048`` with its share of the bf16 tensor-core peak. Each
    run's captured steps fall in the dropped first runs (two a window),
    none in a timed run."""
    res = {}
    first, last = FIRST32["fp8 mistral7b"], LAST32["fp8 mistral7b"]
    for what, args in (("fp8", []), ("fp16", ["--dtype", "fp16"]),
                       ("fp8 --kv fp8", ["--kv", "fp8"]), ("fp8 --prefill 2048",
                                                          ["--prefill", "2048"])):
        out, err, secs = tool_run("bench", *args)
        j = json_line(out, f"tools.bench {what}")
        if "--prefill" in args:
            if not (j["metric"] == "prefill_tok_s_mistral7b_fp8" and "pct_mxu_peak" in j):
                fail(f"tools.bench {what}: {j}")
            line = [l for l in err.splitlines() if l.startswith("# prefill T=2048")]
            log(f"# tools.bench {what} in {secs:.1f} s: {json.dumps(j)}; {line[0][2:]} on {smi}")
            res[what] = dict(j, seconds=secs)
            continue
        caps = re.findall(r"# captured steps at pos0 \d+: (\d+) in the dropped first runs "
                          r"of (\d+) lengths, (\d+) in timed runs", err)
        wins = dict(re.findall(r"^# (first32|last32): ([\d.]+) tok/s", err, re.M))
        keys = {"metric", "value", "unit", "vs_baseline", "spread_pct", "gb_s",
                "attainable_ceiling_gbps", "pct_of_attainable_ceiling"}
        if (set(j) != keys or len(caps) != 2 or any(c != ("2", "2", "0") for c in caps)
                or set(wins) != {"first32", "last32"}):
            fail(f"tools.bench {what}: {j}, captures {caps}, windows {wins}\n{err[-2000:]}")
        ms = {k: 1e3 / float(v) for k, v in wins.items()}
        if what == "fp8" and not first <= ms["first32"] <= last:
            fail(f"tools.bench fp8: first32 {ms['first32']:.4f} ms/tok (positions 2000-2031) "
                 f"outside the full-width phase's first32 {first:.4f} (from 0) .. last32 "
                 f"{last:.4f}")
        warn = [l for l in err.splitlines() if "WARNING" in l]
        log(f"# tools.bench {what} in {secs:.1f} s: first32 {ms['first32']:.4f} ms/tok, "
            f"last32 {ms['last32']:.4f} ms/tok; {json.dumps(j)}"
            + (f" (full-width phase: first32 {first:.4f}, last32 {last:.4f})"
               if what == "fp8" else "") + f"{'; ' + warn[0] if warn else ''} on {smi}")
        res[what] = dict(j, first32_ms=ms["first32"], last32_ms=ms["last32"], seconds=secs)
    return res


def serve_bench_check(path, smi) -> dict:
    """(e) serve_bench on the 2-layer Mistral-width fp8 container: 16
    requests of 128 tokens, half of each shared, 32 tokens each, 8 slots,
    a prefix cache: every request's 32 tokens generated, the JSON keys of
    ``tools/serve_bench.py`` with both TTFT percentiles."""
    out, err, secs = tool_run("serve_bench", path, *SERVE_BENCH)
    j = json_line(out, "tools.serve_bench")
    m = re.search(r": (\d+) tokens in ([\d.]+)s = ", err)
    warm = [l for l in err.splitlines() if l.startswith("# prefix cache:")]
    keys = {"metric", "value", "unit", "ttft_p50_ms", "ttft_p95_ms", "requests", "slots"}
    if set(j) != keys or not m or int(m.group(1)) != 16 * 32 or not warm:
        fail(f"tools.serve_bench: {j}\n{err[-2000:]}")
    log(f"# tools.serve_bench in {secs:.1f} s: {m.group(1)} tokens (16 x 32), "
        f"{json.dumps(j)}; {warm[0][2:]} on {smi}")
    return dict(j, seconds=secs)


def repo_tools_phase(hf, refs, container_fp8, smi) -> dict:
    """(a)-(e): the converter, the acceptance gate, the quality tool, the
    bench tool at full width and serve_bench, each as a user runs it."""
    t0 = time.perf_counter()
    out = dict(convert=converted_checks(hf, refs, smi), accept=accept_check(hf, smi),
               quality=quality_check(smi), bench=bench_check(smi),
               serve_bench=serve_bench_check(container_fp8, smi))
    log(f"# repo tools phase {time.perf_counter() - t0:.1f} s: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# The parallel slice: K12's other head dims and partials mode, K14, and the
# sharded phases (ranks spawned on one card over gloo)
# ---------------------------------------------------------------------------

TOL_PARTIALS = 1e-5  # K12 partials: acc, m and l, each rel. to its max |.|: f32
# the head shapes the converter writes beside Mistral's: (name, H, KVH, hd)
HEAD_SHAPES = (("Phi-3-mini", 32, 32, 96), ("Gemma-7B", 16, 16, 256),
               ("Gemma-2B", 8, 1, 256), ("32 query rows a kv head", 64, 2, 128))


def check_partials(name, got, want, tol=TOL_PARTIALS) -> float:
    """K12 partials (acc, m, l) against the plain version: rows with nothing
    visible give m = -inf, l = 0, acc = 0 on both sides; the rest within
    ``tol`` of each output's largest magnitude."""
    (a, m, l), (wa, wm, wl) = got, want
    dead = torch.isneginf(wm)
    if (not torch.equal(torch.isneginf(m), dead) or l[dead].any()
            or a[dead.expand_as(a)].any()):
        fail(f"{name}: empty rows are not m = -inf, l = 0, acc = 0")
    if dead.all():
        return 0.0
    return max(check(name, g, w, tol) for g, w in (
        (a, wa), (m.masked_fill(dead, 0.0), wm.masked_fill(dead, 0.0)), (l, wl)))


def merge_partials(parts):
    """The exact softmax from the S-shards' (acc, m, l): one max and two
    sums, as sp decode closes it across ranks (calm_tpu/model.py:569-576)."""
    mg = torch.stack([p[1] for p in parts]).amax(0)
    num = sum(p[0] * torch.exp(p[1] - mg) for p in parts)
    return num / sum(p[2] * torch.exp(p[1] - mg) for p in parts)


def ragged_checks_heads(dev):
    """K12 in plain, fresh, paged and partials mode and K13 at the head
    shapes of the converter's Phi-3-mini and Gemma containers and at 32
    query rows a kv head, bf16 and e5m2 caches, ragged kv_len, an empty
    partials slot, against their plain versions."""
    from calm_tpu_torch.ops import hopper_attn as ha

    worst = {"decode_attention": 0.0, "partials": 0.0, "prefill_attention": 0.0}
    n = 0
    gen = torch.Generator().manual_seed(11)
    B, S, L, PR, T = 2, 640, 2, 64, 37
    for name, H, KVH, hd in HEAD_SHAPES:
        M = H // KVH
        for kvd in (torch.bfloat16, torch.float8_e5m2):
            kc, vc = kv_rand((L, B, KVH, S, hd), kvd, dev), kv_rand((L, B, KVH, S, hd), kvd, dev)
            q = torch.randn(B, H, hd, device=dev)
            kl = torch.tensor([S, 333], dtype=torch.int32, device=dev)
            fr = (kv_rand((B, KVH, hd), kvd, dev), kv_rand((B, KVH, hd), kvd, dev),
                  torch.tensor([17, 200], dtype=torch.int32, device=dev))
            order = torch.randperm(B * (S // PR), generator=gen).reshape(B, -1)
            pt = order.to(torch.int32).to(dev)
            kp, vp = to_pages(kc, PR, pt), to_pages(vc, PR, pt)
            for fresh in (None, fr):
                for paged in (False, True):
                    k_, v_, p_ = (kp, vp, pt) if paged else (kc, vc, None)
                    e = max_err(ha.decode_attention(q, k_, v_, kl, 1, fresh, pt=p_),
                                ha.decode_attention_plain(q, k_, v_, kl, 1, fresh, pt=p_))
                    if not e <= TOL_DA:
                        fail(f"decode_attention {name} hd={hd} {kvd} fresh="
                             f"{fresh is not None} paged={paged}: {e:.3e} > {TOL_DA}")
                    worst["decode_attention"] = max(worst["decode_attention"], e)
                    n += 1
            kl0 = torch.tensor([S - 7, 0], dtype=torch.int32, device=dev)  # slot 1 empty
            worst["partials"] = max(worst["partials"], check_partials(
                f"decode_attention_partials {name} {kvd}",
                ha.decode_attention(q, kc, vc, kl0, 1, partials=True),
                ha.decode_attention_partials_plain(q, kc, vc, kl0, 1)))
            qp = torch.randn(B, T, KVH, M, hd, device=dev)
            p0 = torch.tensor([0, 100], dtype=torch.int32, device=dev)
            worst["prefill_attention"] = max(worst["prefill_attention"], check(
                f"prefill_attention {name} {kvd}",
                ha.prefill_attention(qp, kc, vc, p0, p0 + T, 1),
                ha.prefill_attention_plain(qp, kc, vc, p0, p0 + T, 1), TOL_ATT))
            n += 2
            del kc, vc, kp, vp
    torch.cuda.synchronize()
    log(f"# ragged shapes (head dims 96/256, 32 rows a kv head): {n} checks; "
        f"max_abs_err K12 {worst['decode_attention']:.3e} (tol {TOL_DA:g}), K12 partials "
        f"{worst['partials']:.3e} (tol {TOL_PARTIALS:g} x max|.|), K13 "
        f"{worst['prefill_attention']:.3e} (tol {TOL_ATT:g} x max|out|)")


def flash_lse(q4, k, v):
    """One PyTorch flash-attention call that returns the output and the
    log-sum-exp, the same state as K12 partials (out = acc / l, lse = m +
    log l): the yardstick of the partials row, used nowhere in the port."""
    return torch.ops.aten._scaled_dot_product_flash_attention(q4, k, v)[:2]


def partials_kernel_rows(gbps, dev):
    """K12 partials at Mistral-7B's decode shape (B=1, 8 kv heads, M=4, hd
    128, bf16 cache), kv_len 4096 split into sp = 2 and 4 S-shards, and at 8
    slots: each shard against the plain version, the merge of the shards'
    partials against plain mode over the whole cache; ragged: an empty
    shard, kv_len ending mid-chunk, e5m2 and fp16 caches. The sp = 2 shard
    is timed beside its bound: the shard's K/V bytes."""
    from calm_tpu_torch.ops import hopper_attn as ha

    KVH, M, hd, S, L = 8, 4, 128, 4096, 8
    errs, row = [], None
    for B, kvd, kv_len in ((1, torch.bfloat16, 4096), (8, torch.bfloat16, 4096),
                           (1, torch.bfloat16, 1000), (1, torch.bfloat16, 1500),
                           (1, torch.float8_e5m2, 2500), (1, torch.float16, 3000)):
        Lb = L if B == 1 else 2
        kc = kv_rand((Lb, B, KVH, S, hd), kvd, dev, 0.5)
        vc = kv_rand((Lb, B, KVH, S, hd), kvd, dev)
        q = torch.randn(B, KVH * M, hd, device=dev)
        kl = torch.full((B,), kv_len, dtype=torch.int32, device=dev)
        whole = ha.decode_attention(q, kc, vc, kl, Lb - 1)
        e = max_err(whole, ha.decode_attention_plain(q, kc, vc, kl, Lb - 1))
        if not e <= TOL_DA:
            fail(f"decode_attention plain mode B={B} kv_len {kv_len}: {e:.3e} > {TOL_DA}")
        for sp in (2, 4):
            s_loc = S // sp
            ks = [kc[:, :, :, i * s_loc:(i + 1) * s_loc].contiguous() for i in range(sp)]
            vs = [vc[:, :, :, i * s_loc:(i + 1) * s_loc].contiguous() for i in range(sp)]
            locs = [(kl - i * s_loc).clamp(0, s_loc).to(torch.int32) for i in range(sp)]
            parts = []
            for i in range(sp):
                got = ha.decode_attention(q, ks[i], vs[i], locs[i], Lb - 1, partials=True)
                errs.append(check_partials(
                    f"decode_attention_partials B={B} {kvd} kv_len {kv_len} shard {i}/{sp}",
                    got, ha.decode_attention_partials_plain(q, ks[i], vs[i], locs[i], Lb - 1)))
                parts.append(got)
            e = max_err(merge_partials(parts), whole)
            if not e <= TOL_DA:
                fail(f"K12 partials merged over {sp} shards B={B} kv_len {kv_len}: "
                     f"{e:.3e} from plain mode > {TOL_DA}")
            empty = sum(int(x.max()) == 0 for x in locs)
            log(f"# K12 partials B={B} {str(kvd)[6:]} kv_len {kv_len}, sp={sp} ({empty} "
                f"empty shards): each shard within {TOL_PARTIALS:g} of the plain version, "
                f"the merge {e:.3e} from plain mode over the cache (tol {TOL_DA:g})")
            if sp == 2 and kvd == torch.bfloat16 and kv_len == S:
                k0, v0, l0 = ks[0], vs[0], locs[0]
                q4 = q.reshape(B, KVH, M, hd).bfloat16()
                nb = 2 * B * KVH * s_loc * hd * 2 + 4 * B * KVH * M * (2 * hd + 2)
                b, by = bound_ms(nb, 4 * B * KVH * M * s_loc * hd, gbps)
                t = timings(lambda i: ha.decode_attention(q, k0, v0, l0, i % Lb, partials=True),
                            lambda i: ha.decode_attention_partials_plain(q, k0, v0, l0, i % Lb),
                            lambda i: flash_lse(q4, k0[i % Lb], v0[i % Lb]), bound=b)
                att = nb / (RATES["attainable"] * 1e6) if RATES["attainable"] else None
                log(f"# K12 partials bf16 B={B} shard 0 of 2 ({s_loc} rows, KVH=8, M=4, "
                    f"hd=128): {ms_line(t)} (flash attention with log-sum-exp) bound_ms "
                    f"{b:.4f} ({by}, {nb / 1e6:.2f} MB at {gbps:.0f} GB/s); at the "
                    f"attainable {RATES['attainable'] or 0:.1f} GB/s "
                    f"{att or float('nan'):.4f} ms; {share(t, b)}")
                if B == 1:
                    row = dict(t, bound_ms=b, bound_by=by, attainable_bound_ms=att)
        del kc, vc, ks, vs
    torch.cuda.empty_cache()
    return {"decode_attention_partials": dict(row, max_abs_err=max(errs))}


RING_SIZES = (4096, 8 * 32 * 128, 1, 127)  # a tp close of Mistral-7B (its residual),
# the sp merge at 8 slots (B * H * hd), and ragged ones (plus n * 128 + 1, and
# n * 128 * 37, a multiple of n * 128 that the kernel reads in place)


def ring_flags_blocks(dev, n) -> int:
    """The blocks a rank (G) of K14's last call at n ranks, read from its
    flags, or 0 when they break the protocol: entry flags of segments < G
    hold exactly this call's tag (epoch << 32), done flags the tag | 1, and
    every flag past G (left by a call of more blocks) an earlier epoch's
    value."""
    from calm_tpu_torch.ops import hopper_collectives as hc

    flags, epoch, gmax = hc.ring_flags(dev, n)
    f = flags.cpu()
    e = epoch << 32
    entry, done = f[:, :gmax], f[:, gmax:]
    g = int((entry[0] == e).sum())
    ok = (g >= 1 and bool((entry[:, :g] == e).all()) and bool((done[:, :g] == e | 1).all())
          and all(bool((x < e).all()) for x in (entry[:, g:], done[:, g:])))
    return g if ok else 0


def ring_checks(dev) -> tuple[int, int, int, int]:
    """200 calls of K14 at each n in (2, 3, 4, 8) on fresh random data, f32
    and bf16 in turn, cycling through the sizes (aligned to n * 128, read
    in place, and ragged, padded; the blocks a rank change from call to
    call), each against the ring-order plain version bit for bit (torch.
    equal), with the inputs compared to copies taken before the call and
    the flags read back (``ring_flags_blocks``): (calls, mismatches,
    calls that changed an input, calls whose flags break the protocol)."""
    from calm_tpu_torch.ops import hopper_collectives as hc

    calls = bad = touched = bad_flags = 0
    gen = torch.Generator(device=dev).manual_seed(12)
    for n in (2, 3, 4, 8):
        sizes = RING_SIZES + (n * 128 + 1, n * 128 * 37)
        blocks = set()
        for i in range(200):
            dt = torch.float32 if i % 2 == 0 else torch.bfloat16
            xs = [(torch.randn(sizes[i % len(sizes)], generator=gen, device=dev)
                   * 10.0 ** (r - n // 2)).to(dt) for r in range(n)]
            keep = [x.clone() for x in xs]
            got, want = hc.ring_all_reduce(xs), hc.ring_all_reduce_plain(xs)
            bad += sum(not torch.equal(a, b) for a, b in zip(got, want))
            touched += not all(torch.equal(a, b) for a, b in zip(xs, keep))
            g = ring_flags_blocks(dev, n)
            bad_flags += g == 0
            blocks.add(g)
            calls += 1
        if len(blocks - {0}) < 2:
            fail(f"ring_all_reduce n={n}: the sizes gave blocks a rank {sorted(blocks)}; "
                 "the check needs calls of different block counts")
    torch.cuda.synchronize()
    return calls, bad, touched, bad_flags


def ring_kernel_rows(gbps, dev):
    """K14: the 200-call bit-equality runs (its main path, counted), then
    64 MB a rank timed at n = 2, 4, 8 beside the plain version and one
    library call of the same function on one device (``torch.stack(xs)
    .sum(0)`` copied into n outputs). Bound: each rank's input read once
    and output written once, at the nominal rate and at the attainable
    one; the two-shot moves exactly those bytes."""
    from calm_tpu_torch.ops import hopper_collectives as hc

    (calls, bad, touched, bad_flags), counts = drive(lambda: ring_checks(dev))
    if bad:
        fail(f"ring_all_reduce: {bad} of {calls} x n results differ from the ring-order "
             "plain version")
    if touched:
        fail(f"ring_all_reduce: {touched} of {calls} calls changed an input")
    if bad_flags:
        fail(f"ring_all_reduce: after {bad_flags} of {calls} calls the flags do not hold "
             "that call's epoch where its blocks ran (or a later one elsewhere)")
    log(f"# K14 ring_all_reduce: {calls} calls at n = 2, 3, 4, 8 (f32 and bf16; sizes "
        f"{RING_SIZES}, n*128+1 and n*128*37), every rank's result bit-equal to the "
        f"ring-order plain version, the inputs unchanged, every call's entry/done flags "
        f"tagged with its own epoch as its block count changed; "
        f"{counts['ring_all_reduce']} launches")
    row = None
    for n in (2, 4, 8):
        elems = 16 << 20  # 64 MB of f32 a rank
        xs = [torch.randn(elems, device=dev) for _ in range(n)]
        outs = [torch.empty_like(x) for x in xs]

        def library(i):
            s = torch.stack(xs).sum(0)
            for o in outs:
                o.copy_(s)
        got, want = hc.ring_all_reduce(xs), hc.ring_all_reduce_plain(xs)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            fail(f"ring_all_reduce n={n} 64 MB: not bit-equal to the plain version")
        del got, want
        nbytes = 2 * n * elems * 4
        b, by = bound_ms(nbytes, (n - 1) * elems, gbps)
        t = timings(lambda i: hc.ring_all_reduce(xs), lambda i: hc.ring_all_reduce_plain(xs),
                    library, plain_iters=3, bound=b)
        att = nbytes / (RATES["attainable"] or gbps) / 1e6
        log(f"# K14 ring_all_reduce n={n} x 64 MB f32 on one card: bit-equal; "
            f"{ms_line(t)} (stack + sum + n copies) bound_ms {b:.4f} ({by}: n inputs read, "
            f"n outputs written; {att:.4f} at the attainable rate); {share(t, b)}")
        if n == 4:
            row = dict(t, bound_ms=b, bound_by=by, attainable_bound_ms=att, max_abs_err=0.0)
        del xs, outs
    torch.cuda.empty_cache()
    return {"ring_all_reduce": row}, counts


# Sharded phases: (a) Mistral-7B fp8 at 8 of 32 layers, tp=2 x sp=2; (b)
# Mixtral 8x7B fp8 at 4 of 32 layers, ep=2; (c) 2 layers of Mistral-7B
# width, ctx 64, sp=2, across the window wrap
CTX_A, STEPS_A, LAYERS_A = 1024, 32, 8
PROMPT_B, STEPS_B, LAYERS_B = 64, 16, 4
CTX_C, STEPS_C = 64, 96
STEPS_D = 32                    # (d) pp=4 decode steps
B_E, MICRO_E, STEPS_E = 4, 2, 8  # (e) GPipe slots, microbatches, steps
STEPS_F = 8                     # (f) pp=2 x ep=2 Mixtral steps
CTX_G, STEPS_G = 2048, 8        # (g) the ring's window (= prompt) and decode steps
STEPS_H = 32                    # (h) sharded_decode_scan steps after (a)'s prefill
PHASES = "abcdefgh"


def sharded_cfg(phase):
    """(a), (d), (e), (h): Mistral-7B fp8 at 8 layers, ctx 1024; (b), (f):
    Mixtral 8x7B fp8 at 4 layers; (c): 2 layers at ctx 64; (g): 8 layers at
    ctx 2048, the ring prefill's whole window."""
    from calm_tpu_torch.config import ModelConfig

    if phase in "adeh":
        kw = dict(n_layers=LAYERS_A, rope_theta=10000.0, seq_len=CTX_A)
    elif phase in "bf":
        kw = dict(n_layers=LAYERS_B, rope_theta=1e6, n_experts=EXPERTS, n_experts_ac=2,
                  seq_len=1024)
    elif phase == "g":
        kw = dict(n_layers=LAYERS_A, rope_theta=10000.0, seq_len=CTX_G)
    else:
        kw = dict(n_layers=2, rope_theta=10000.0, seq_len=CTX_C)
    return ModelConfig(**{**MISTRAL, **kw}, rotary_dim=128, dtype="fp8", norm_ln=False)


def sharded_rank(rank, dev, prompts, toks):
    """One rank of the sharded phases, on ``dev`` with three other ranks
    over gloo: (a), (d)-(h) on all four, (b) and (c) on ranks 0 and 1. The
    same seeded random weights as the parent's, cut to this rank's shards
    (a pipeline stage's layers under pp); each phase teacher-forces the
    parent's greedy ids (``toks[phase]``, (N, B) for (e)). Returns the
    logits (rank 0; (g)'s ring prefill row from the rank that holds it),
    the launch counts of each run, seconds, and ms per step."""
    from calm_tpu_torch import model as M
    from calm_tpu_torch.parallel import (ShardingPlan, make_grid, make_mesh, make_pp_mesh,
                                         shard_cache, shard_weights, sharded_decode_scan,
                                         sharded_decode_step, sharded_decode_step_gpipe,
                                         sharded_decode_step_pp, sharded_prefill,
                                         sharded_prefill_sp)
    from calm_tpu_torch.utils.synth import synth_weights

    out = {}

    def weights(phase, mesh, plan, batch=1, sp=False):
        cfg = sharded_cfg(phase)
        w = synth_weights(cfg, seed=0, device=dev, random=True)
        ws = shard_weights(w, cfg, mesh, plan)
        del w
        torch.cuda.empty_cache()
        return cfg, ws, shard_cache(M.KVCache.create(cfg, batch, torch.bfloat16, dev), mesh,
                                    plan, sp=sp)

    def run(phase, mesh, plan, prefill, pos0, sp, step=None, batch=1):
        t0 = time.perf_counter()
        cfg, ws, cache = weights(phase, mesh, plan, batch, sp)
        pf = prefill(cfg, ws, cache) if prefill else None
        step = (step or sharded_decode_step)(cfg, mesh, plan)
        ids = np.asarray(toks[phase]).reshape(len(toks[phase]), batch)

        def decode():
            lg = []
            for i in range(len(ids)):
                x, _ = step(ws, torch.tensor(ids[i]), pos0 + i, cache)
                lg.append(x)
            return torch.stack(lg)
        decode_out, counts = drive(decode)  # the counts of this rank's run
        t1 = time.perf_counter()
        decode()  # again on the rolled cache: only the pace is kept
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t1) / len(ids)
        keep = rank == 0
        out[phase] = dict(counts=counts, ms_step=ms, secs=time.perf_counter() - t0,
                          prefill=pf.cpu().numpy() if keep and pf is not None else None,
                          steps=decode_out[:, 0].cpu().numpy() if keep and batch == 1
                          else decode_out.cpu().numpy() if keep else None)
        return cfg, ws, cache

    prompt_a = prompts["a"]
    mesh = make_mesh(tp=2, sp=2, device=dev)
    plan = ShardingPlan(tp="tp", sp="sp")
    run("a", mesh, plan, lambda cfg, ws, cache: sharded_prefill_sp(cfg, mesh, plan)(
        ws, torch.tensor([prompt_a]), cache)[0][0, -1], CTX_A, sp=True)
    mesh_b = make_mesh(ep=2, device=dev)
    if mesh_b is not None:
        plan_b = ShardingPlan(ep="ep")
        run("b", mesh_b, plan_b, lambda cfg, ws, cache: sharded_prefill(cfg, mesh_b, plan_b)(
            ws, torch.tensor([prompts["b"]]), [0], cache)[0][0], PROMPT_B, sp=False)
    mesh_c = make_mesh(sp=2, device=dev)
    if mesh_c is not None:
        run("c", mesh_c, ShardingPlan(sp="sp"), None, 0, sp=True)
    # (d) four pipeline stages of two layers; (e) GPipe, 2 stages x tp=2,
    # B_E slots in MICRO_E microbatches; (f) two stages x ep=2 of Mixtral
    run("d", make_pp_mesh(4, 1, device=dev), ShardingPlan(pp="pp"), None, 0, sp=False,
        step=sharded_decode_step_pp)
    run("e", make_pp_mesh(2, 2, device=dev), ShardingPlan(tp="tp", pp="pp"), None, 0,
        sp=False, batch=B_E,
        step=lambda cfg, mesh, plan: sharded_decode_step_gpipe(cfg, mesh, plan, MICRO_E))
    run("f", make_grid(dict(pp=2, ep=2, tp=1), device=dev), ShardingPlan(ep="ep", pp="pp"),
        None, 0, sp=False, step=sharded_decode_step_pp)
    # (g) the ring sp prefill over sp=4 of a CTX_G-token window, then sp
    # decode; the all-gather path on the same weights and prompt beside it
    t0 = time.perf_counter()
    mesh = make_mesh(sp=4, device=dev)
    plan = ShardingPlan(sp="sp", ring=True)
    T = CTX_G // 4
    i = mesh.axis_index("sp")
    chunk = torch.tensor([prompts["g"][i * T:(i + 1) * T]], device=dev)
    last = {}
    cfg, ws, cache = weights("g", mesh, plan, sp=True)
    for ring in (True, False):
        pl = dataclasses.replace(plan, ring=ring)
        if not ring:
            cache = shard_cache(M.KVCache.create(cfg, 1, torch.bfloat16, dev), mesh, pl,
                                sp=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        (lg, cache), counts = drive(lambda: M.prefill_sp(cfg, ws, chunk, cache, pl, mesh))
        last["ring" if ring else "gather"] = dict(
            row=lg[0, -1].float().cpu().numpy() if i == 3 else None, counts=counts,
            ms=1e3 * (time.perf_counter() - t1))
        if ring:
            step = sharded_decode_step(cfg, mesh, pl)
            steps = []
            for j, tok in enumerate(toks["g"]):
                x, cache = step(ws, torch.tensor([tok]), CTX_G + j, cache)
                steps.append(x[0].float().cpu().numpy())
    del ws, cache
    torch.cuda.empty_cache()
    out["g"] = dict(last, steps=np.stack(steps) if rank == 0 else None,
                    secs=time.perf_counter() - t0)
    # (h) sharded_decode_scan on (a)'s mesh after (a)'s prefill
    t0 = time.perf_counter()
    mesh = make_mesh(tp=2, sp=2, device=dev)
    plan = ShardingPlan(tp="tp", sp="sp")
    cfg, ws, cache = weights("h", mesh, plan, sp=True)
    lg, cache = sharded_prefill_sp(cfg, mesh, plan)(ws, torch.tensor([prompt_a]), cache)
    first = int(lg[0, -1].argmax())
    (ids, cache, lg), counts = drive(lambda: sharded_decode_scan(cfg, mesh, plan, STEPS_H)(
        ws, [first], CTX_A, cache))
    out["h"] = dict(ids=[first] + ids[0].tolist(), counts=counts,
                    secs=time.perf_counter() - t0)
    del ws, cache
    torch.cuda.empty_cache()
    out.update(serving_rank(rank, dev, prompts["serve"]))
    return out


def sharded_reference(phase, dev, prompt, n_steps, first=(1,)):
    """The unsharded run in this process on the same weights: (logits after
    the prompt or None, per-step logits (N, V), or (N, B, V) for several
    first tokens, on the host, the greedy ids fed to each step)."""
    from calm_tpu_torch import model as M
    from calm_tpu_torch.utils.synth import synth_weights

    cfg = sharded_cfg(phase)
    w = synth_weights(cfg, seed=0, device=dev, random=True)
    B = len(first)
    cache = M.KVCache.create(cfg, B, torch.bfloat16, dev)
    pf, tok = None, torch.tensor(first, device=dev)
    if prompt:
        pf = M.prefill(cfg, w, torch.tensor([prompt], device=dev), [0], cache, "last")[0][0]
        tok = pf.argmax()[None]
    toks, lgs = [], []
    for i in range(n_steps):
        lg, cache = M.decode_step(cfg, w, tok, len(prompt) + i, cache)
        toks.append(tok.tolist())
        lgs.append(lg.float().cpu().numpy())
        tok = lg.argmax(-1)
    del w, cache
    torch.cuda.empty_cache()
    lgs = np.stack(lgs)
    return ((None if pf is None else pf.float().cpu().numpy()),
            lgs[:, 0] if B == 1 else lgs, [t[0] for t in toks] if B == 1 else toks)


# Sharded serving, in the same world of 4 ranks: (i) Server(mesh, plan)
# tp=2 x dp=2 dense, (j) the mesh-paged pool at tp=4 with a prefix cache,
# (k) two hosts of tp=2, each host submitting its own requests; all on an
# 8-layer Mistral-7B-width fp8 container, each held to the unsharded
# Server in the parent on the same container
CTX_SERVE, SERVE_TOKENS, SERVE_MID = 1024, 16, 4  # window, greedy tokens, ticks
                                                  # before (i)'s last admission


def serve_cfg():
    from calm_tpu_torch.config import ModelConfig

    return ModelConfig(**{**MISTRAL, "n_layers": LAYERS_A, "rope_theta": 10000.0},
                       seq_len=CTX_SERVE, rotary_dim=128, dtype="fp8", bos_token_id=1,
                       eos_token_id=2, norm_ln=False)


def serve_plan(tmp) -> dict:
    """The serving cases' container (written here) and requests: (i) 4
    prompts of 64-256 tokens, the last admitted after SERVE_MID ticks; (j)
    two prompts that share the 64-token page-aligned ``SHARED``; (k) two
    prompts a host."""
    from calm_tpu_torch.utils.synth import synth_container

    path = os.path.join(tmp, "mistral7b-width-8l-fp8.calm")
    t0 = time.perf_counter()
    synth_container(path, serve_cfg(), seed=3, device="cuda", random=True)
    log(f"# sharded serving: wrote the {LAYERS_A}-layer Mistral-7B-width fp8 container "
        f"({os.path.getsize(path) / 1e9:.2f} GB) in {time.perf_counter() - t0:.1f} s")
    native_checks([path], f"{LAYERS_A}-layer")
    rng = np.random.default_rng(20)
    words = ["".join(chr(c) for c in rng.integers(97, 123, n)) for n in
             rng.integers(63, 256, 8)]
    return {"path": path, "i": words[:4], "k": {0: words[4:6], 1: words[6:8]},
            "j": [SHARED + " Q1", SHARED + " And a second question"]}


def param_bytes(w) -> int:
    """The bytes of every tensor of Weights ``w`` (a tied lm-head once)."""
    seen, n = set(), 0
    lw = w.layers
    for x in [w.embed, w.output, w.final_norm] + [getattr(lw, f) for f in
                                                   lw.__dataclass_fields__]:
        for t in (getattr(x, "data", x), getattr(x, "scale", None)):
            if isinstance(t, torch.Tensor) and t.data_ptr() not in seen:
                seen.add(t.data_ptr())
                n += t.numel() * t.element_size()
    return n


def kv_bytes(srv) -> int:
    """The bytes of a Server's KV: its dense cache, or its pool(s) with
    their scratch and page table."""
    if srv._paged is None:
        return 2 * srv.engine.cache.k.numel() * srv.engine.cache.k.element_size()
    decs = getattr(srv._paged, "decs", [srv._paged])
    return sum(2 * (d.pool.k.numel() * d.pool.k.element_size() + d.scratch.k.numel()
                    * d.scratch.k.element_size()) + d._pt_dev.numel() * 4 for d in decs)


def served_case(make, reqs, dev, keep: bool, mid: int = 0, one_by_one: bool = False):
    """A Server built by ``make()`` on ``dev`` serving greedy ``reqs``: all
    submitted at once (with ``mid``: the last one after ``mid`` ticks; with
    ``one_by_one``: each drained before the next). Returns its ids, the
    logits each request sampled from (when ``keep``), its ticks, wall
    seconds, the weight bytes allocated by the load (memory_allocated
    across the build less the KV) and counted, the cached prefixes and the
    prefix cache's hits."""
    import gc

    from calm_tpu_torch import serve as S

    gc.collect()  # what an earlier case left in cycles is freed before, not during
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    srv = make()
    torch.cuda.synchronize()
    alloc = torch.cuda.memory_allocated(dev) - base - kv_bytes(srv)
    made, ticks, real = [], [0], srv.tick

    class Recording(S.Sampler):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.seen = []
            made.append(self)

        def sample(self, logits):
            if keep:
                self.seen.append(np.array(logits, np.float32))
            return super().sample(logits)

    def tick():
        ticks[0] += 1
        real()
    srv.tick = tick
    sampler, S.Sampler = S.Sampler, Recording
    t0 = time.perf_counter()
    try:
        out = []
        for i, p in enumerate(reqs):
            if mid and i == len(reqs) - 1:
                for _ in range(mid):
                    srv.tick()
            out.append(srv.submit(p, max_tokens=SERVE_TOKENS, temperature=0.0))
            if one_by_one:
                srv.run_until_drained(max_ticks=500)
        srv.run_until_drained(max_ticks=500)
        torch.cuda.synchronize()
    finally:
        S.Sampler = sampler
        del srv.tick  # the wrapper holds the server: no cycle outlives the case
    wall = time.perf_counter() - t0
    if not all(r.done for r in out) or len(made) != len(out):
        fail(f"a served request did not finish ({[r.done for r in out]})")
    res = dict(ids=[list(r.ids) for r in out], seen=[m.seen for m in made] if keep else None,
               ticks=ticks[0], wall=wall, alloc=alloc, counted=param_bytes(srv.engine.weights),
               cached=[r.cached_prefix for r in out],
               hits=None if srv.prefix_cache is None else srv.prefix_cache.hits,
               pages=None if srv._paged is None else srv._paged.pages_in_use())
    del srv
    torch.cuda.empty_cache()
    return res


def serving_rank(rank, dev, sv) -> dict:
    """One rank of the sharded serving cases (i)-(k) (``serve_plan``):
    every rank of a case's mesh constructs the Server and makes the same
    submit() calls, ticking in lockstep. Returns {case: served_case's
    result} (the logits from the first rank of each mesh or host)."""
    from calm_tpu_torch.parallel import ShardingPlan, make_mesh, make_multihost_mesh
    from calm_tpu_torch.serve import Server

    out = {}
    mesh = make_mesh(tp=2, dp=2, device=dev)
    out["i"] = served_case(lambda: Server(sv["path"], batch=4, mesh=mesh,
                                          plan=ShardingPlan(tp="tp", dp="dp")),
                           sv["i"], dev, rank == 0, mid=SERVE_MID)
    mesh = make_mesh(tp=4, device=dev)
    out["j"] = served_case(lambda: Server(sv["path"], batch=2, mesh=mesh,
                                          plan=ShardingPlan(tp="tp"), page_rows=16,
                                          prefix_cache_tokens=4096),
                           sv["j"], dev, rank == 0, one_by_one=True)
    os.environ["LOCAL_WORLD_SIZE"] = "2"  # two hosts of two ranks
    try:
        mesh = make_multihost_mesh(tp=2, dp_dcn=2, device=dev)
        host = rank // 2
        out["k"] = dict(served_case(lambda: Server(sv["path"], batch=4, mesh=mesh,
                                                   plan=ShardingPlan(tp="tp", dp="dp")),
                                    sv["k"][host], dev, rank % 2 == 0), host=host)
    finally:
        del os.environ["LOCAL_WORLD_SIZE"]
    return out


def sharded_serving_checks(res, sv, dev, smi):
    """(i)-(k) against the unsharded Server on the same container in this
    process: greedy ids equal but at near-ties (``same_served``), every
    request done, (j)'s second request served from the cache, the ranks of
    a mesh (or a host) with the same ids, and each rank's weight bytes
    about 1/tp of the unsharded model's."""
    import gc

    from calm_tpu_torch.engine import Engine
    from calm_tpu_torch.serve import Server

    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    eng = Engine(sv["path"], batch=4, device=dev)
    torch.cuda.synchronize()
    whole = torch.cuda.memory_allocated(dev) - base - 2 * eng.cache.k.numel() * \
        eng.cache.k.element_size()
    ref = {"i": served_case(lambda: Server(batch=4, engine=eng), sv["i"], dev, True,
                            mid=SERVE_MID),
           "k": served_case(lambda: Server(batch=4, engine=eng),
                            sv["k"][0] + sv["k"][1], dev, True)}
    del eng
    torch.cuda.empty_cache()
    ref["j"] = served_case(lambda: Server(sv["path"], batch=2, page_rows=16,
                                          prefix_cache_tokens=4096, device=dev),
                           sv["j"], dev, True, one_by_one=True)
    what = {"i": "(i) Server(mesh, plan) tp=2 x dp=2, 4 requests of 64-256 tokens (the "
                 f"last admitted after {SERVE_MID} ticks)",
            "j": "(j) mesh-paged tp=4, 16-row pages, a prefix cache, two requests sharing "
                 "a 64-token prompt",
            "k": "(k) two hosts of tp=2 (dp across hosts), two requests a host"}
    tp = {"i": 2, "j": 4, "k": 2}
    for case in "ijk":
        got = [r[case] for r in res]
        if case == "k":
            want = {h: [ids for ids in ref["k"]["ids"][2 * h:2 * h + 2]] for h in (0, 1)}
            lcs = {h: ref["k"]["seen"][2 * h:2 * h + 2] for h in (0, 1)}
            keep = {g["host"]: g for g, r in zip(got, range(4)) if r % 2 == 0}
            pairs = [(f"host {h} request {n}", keep[h]["ids"][n], want[h][n],
                      keep[h]["seen"][n], lcs[h][n]) for h in (0, 1) for n in range(2)]
            if any(g["ids"] != keep[g["host"]]["ids"] for g in got):
                fail(f"sharded serving {what[case]}: the ranks of a host disagree")
        else:
            if any(g["ids"] != got[0]["ids"] for g in got):
                fail(f"sharded serving {what[case]}: the ranks disagree")
            pairs = [(f"request {n}", got[0]["ids"][n], ref[case]["ids"][n],
                      got[0]["seen"][n], ref[case]["seen"][n])
                     for n in range(len(ref[case]["ids"]))]
        res_ = [f"{name} " + same_served(f"sharded serving {what[case]} {name}", g, w, 0.0,
                                         lg, lc, TOL_PREFILL)
                for name, g, w, lg, lc in pairs]
        extra = ""
        if case == "j":
            if (got[0]["cached"] != ref["j"]["cached"] or got[0]["cached"][1] != 64
                    or got[0]["hits"] != 1 or got[0]["pages"] != 0):
                fail(f"sharded serving {what[case]}: cached prefixes {got[0]['cached']} "
                     f"(unsharded {ref['j']['cached']}), hits {got[0]['hits']}, pages in "
                     f"use {got[0]['pages']}")
            extra = (f"; the second request took {got[0]['cached'][1]} prefix rows from the "
                     f"cache (1 hit), pages in use after 0")
        share = [g["alloc"] / whole for g in got]
        if any(not 0.9 / tp[case] <= x <= 1.1 / tp[case] for x in share):
            fail(f"sharded serving {what[case]}: weight bytes a rank {[g['alloc'] for g in got]}"
                 f" against {whole} unsharded, not about 1/{tp[case]}")
        log(f"# sharded serving {what[case]}: " + "; ".join(res_) + extra
            + f"; {got[0]['ticks']} ticks, {max(g['wall'] for g in got):.2f} s (unsharded "
            f"{ref[case]['ticks']} ticks, {ref[case]['wall']:.2f} s; ranks share one card, no "
            f"speed result); weight bytes a rank by torch.cuda.memory_allocated after the "
            f"load {[g['alloc'] for g in got]} ({', '.join(f'{x:.4f}' for x in share)} of "
            f"the unsharded {whole}; counted {[g['counted'] for g in got]}) on {smi}")


def near_ties(what, got, want, tol) -> tuple[float, int]:
    """Per-step logits (N, V) against the reference's: the largest error
    relative to each step's max |logit|, and the near-ties among the
    greedy ids (a clear disagreement fails)."""
    worst, ties = 0.0, 0
    for i, (g, w) in enumerate(zip(got, want)):
        worst = max(worst, float(np.abs(g - w).max() / np.abs(w).max()))
        ties += not greedy_agrees(f"{what} step {i}", int(g.argmax()), w, tol)
    return worst, ties


def sharded_phases(dev, smi):
    """(a)-(h) in one spawned world of 4 ranks on cuda:0 (gloo: NCCL refuses
    two ranks on one device), each held to the unsharded run in this
    process: logits within the tolerance, greedy ids equal except at
    near-ties. In (a) each rank's K12 partials launches are layers x steps;
    in (d) each stage launches its layers' K9 chain and K12, stage 0 the K2
    lm-head; in (e) K12 runs once a (local layer, microbatch, step) from its
    slot offset; in (g) the ring prefill launches no K13 (the all-gather
    path one a layer) and its last row and decode match the unsharded run
    and the all-gather path; (h)'s scan ids equal (a)'s step loop's.
    Returns the launch counts of (a), summed over its ranks."""
    from calm_tpu_torch.parallel import spawn

    gen = torch.Generator().manual_seed(21)
    prompts = {"a": torch.randint(3, MISTRAL["vocab_size"], (CTX_A,), generator=gen).tolist(),
               "b": torch.randint(3, MISTRAL["vocab_size"], (PROMPT_B,), generator=gen).tolist()}
    prompts["g"] = torch.randint(3, MISTRAL["vocab_size"], (CTX_G,), generator=gen).tolist()
    first_e = torch.randint(3, MISTRAL["vocab_size"], (B_E,), generator=gen).tolist()
    stmp = tempfile.TemporaryDirectory()
    prompts["serve"] = serve_plan(stmp.name)
    t0 = time.perf_counter()
    ref = {"a": sharded_reference("a", dev, prompts["a"], STEPS_A),
           "b": sharded_reference("b", dev, prompts["b"], STEPS_B),
           "c": sharded_reference("c", dev, [], STEPS_C),
           "d": sharded_reference("d", dev, [], STEPS_D),
           "e": sharded_reference("e", dev, [], STEPS_E, first_e),
           "f": sharded_reference("f", dev, [], STEPS_F),
           "g": sharded_reference("g", dev, prompts["g"], STEPS_G)}
    t_ref = time.perf_counter() - t0
    dev = torch.device(dev.type, dev.index or 0)
    res = spawn(sharded_rank, 4, dev, prompts, {k: v[2] for k, v in ref.items()},
                device=dev, timeout_s=900)
    log(f"# sharded phases: unsharded references {t_ref:.1f} s, 4 ranks spawned on one "
        f"card {time.perf_counter() - t0 - t_ref:.1f} s")
    t1 = time.perf_counter()
    sharded_serving_checks(res, prompts["serve"], dev, smi)
    stmp.cleanup()
    log(f"# sharded serving (i)-(k): the unsharded references and checks "
        f"{time.perf_counter() - t1:.1f} s")
    what = {"a": f"(a) Mistral-7B fp8 {LAYERS_A} layers, tp=2 x sp=2, sp prefill of "
                 f"{CTX_A} then {STEPS_A} steps",
            "b": f"(b) Mixtral 8x7B fp8 {LAYERS_B} layers, ep=2, prefill of {PROMPT_B} "
                 f"then {STEPS_B} steps",
            "c": f"(c) Mistral-7B width fp8 2 layers, ctx {CTX_C}, sp=2, {STEPS_C} steps "
                 "across the wrap",
            "d": f"(d) Mistral-7B fp8 {LAYERS_A} layers, pp=4 (2 a stage), {STEPS_D} greedy "
                 "steps",
            "e": f"(e) Mistral-7B fp8 {LAYERS_A} layers, GPipe pp=2 x tp=2, B={B_E} in "
                 f"{MICRO_E} microbatches, {STEPS_E} steps",
            "f": f"(f) Mixtral 8x7B fp8 {LAYERS_B} layers, pp=2 x ep=2, {STEPS_F} steps"}
    total_a = {}
    for phase, tol in (("a", TOL_PREFILL), ("b", TOL_PREFILL), ("c", TOL_STEP),
                       ("d", TOL_STEP), ("e", TOL_STEP), ("f", TOL_STEP)):
        pf_ref, lg_ref, _ = ref[phase]
        got = res[0][phase]
        worst, ties = 0.0, 0
        if pf_ref is not None:
            worst = float(np.abs(got["prefill"] - pf_ref).max() / np.abs(pf_ref).max())
        if phase == "e":  # (N, B, V): slot for slot
            for b in range(B_E):
                w_b, t_b = near_ties(f"sharded {what[phase]} slot {b}", got["steps"][:, b],
                                     lg_ref[:, b], tol)
                worst, ties = max(worst, w_b), ties + t_b
        else:
            w_s, ties = near_ties(f"sharded {what[phase]}", got["steps"], lg_ref, tol)
            worst = max(worst, w_s)
        if not worst <= tol:
            fail(f"sharded {what[phase]}: logits {worst:.3e} of scale from the unsharded "
                 f"run > {tol}")
        ranks = [r[phase] for r in res if phase in r]
        counts = [r["counts"] for r in ranks]
        cfg = sharded_cfg(phase)
        n_steps = len(ref[phase][2])
        local = cfg.n_layers // {"d": 4, "e": 2, "f": 2}.get(phase, 1)
        if phase == "a":
            want = cfg.n_layers * n_steps
            if any(c["decode_attention_partials"] != want for c in counts):
                fail(f"sharded (a): K12 partials launches "
                     f"{[c['decode_attention_partials'] for c in counts]} per rank, not "
                     f"layers x steps = {want} each")
            total_a = {k: sum(c[k] for c in counts) for k in counts[0]}
        if phase in "bf" and any(c["qmm_moe_dense"] != 3 * local * n_steps for c in counts):
            fail(f"sharded ({phase}): K10 launches {[c['qmm_moe_dense'] for c in counts]} per "
                 f"rank, not 3 x local layers x steps")
        if phase == "c" and any(c["decode_attention_partials"] != cfg.n_layers * n_steps
                                for c in counts):
            fail(f"sharded (c): K12 partials launches per rank "
                 f"{[c['decode_attention_partials'] for c in counts]}")
        if phase == "d" and any(
                c["qx_offn_qkv"] != local * n_steps or c["decode_attention"] != local * n_steps
                or c["qmm_decode"] != (3 + (r == 0)) * n_steps for r, c in enumerate(counts)):
            fail(f"sharded (d): each stage's K9 and K12 launches are not its layers x steps, "
                 f"or K2 not its q/k/v priming (+ the lm-head on stage 0): {counts}")
        if phase == "e" and any(c["decode_attention"] != local * MICRO_E * n_steps
                                for c in counts):
            fail(f"sharded (e): K12 launches {[c['decode_attention'] for c in counts]} per "
                 f"rank, not local layers x microbatches x steps")
        launched = {k: v for k, v in counts[0].items() if v}
        log(f"# sharded {what[phase]}: logits within {worst:.3e} of scale of the unsharded "
            f"run (tol {tol:g}), {ties} near-ties in {n_steps} greedy ids; rank 0 launches "
            f"{launched}; wall ms per step by rank (ranks share one card, no speed result): "
            + ", ".join(f"{r['ms_step']:.1f}" for r in ranks)
            + (f"; {max(r['secs'] for r in ranks):.1f} s" if phase in "def" else "")
            + f" on {smi}")

    g = [r["g"] for r in res]
    pf_ref, lg_ref, _ = ref["g"]
    ring = next(x["ring"]["row"] for x in g if x["ring"]["row"] is not None)
    gather = next(x["gather"]["row"] for x in g if x["gather"]["row"] is not None)
    scale = np.abs(pf_ref).max()
    errs = [float(np.abs(ring - pf_ref).max() / scale),
            float(np.abs(gather - pf_ref).max() / scale),
            float(np.abs(ring - gather).max() / scale)]
    worst, ties = near_ties("sharded (g) sp=4 decode after the ring prefill", g[0]["steps"],
                            lg_ref, TOL_PREFILL)
    k13 = [(x["ring"]["counts"]["prefill_attention"], x["gather"]["counts"][
        "prefill_attention"]) for x in g]
    if max(errs + [worst]) > TOL_PREFILL or any(r != 0 or a != LAYERS_A for r, a in k13):
        fail(f"sharded (g): the ring prefill's last row {errs[0]:.3e} of scale from the "
             f"unsharded run, the all-gather's {errs[1]:.3e}, ring to all-gather "
             f"{errs[2]:.3e}, decode {worst:.3e} (tol {TOL_PREFILL}); K13 launches (ring, "
             f"all-gather) per rank {k13}, want (0, {LAYERS_A})")
    log(f"# sharded (g) Mistral-7B fp8 {LAYERS_A} layers, sp=4 ring prefill of {CTX_G} "
        f"then {STEPS_G} sp decode steps: last row within {errs[0]:.3e} of scale of the "
        f"unsharded prefill (all-gather path {errs[1]:.3e}, ring to all-gather "
        f"{errs[2]:.3e}; tol {TOL_PREFILL:g}), decode {worst:.3e}, {ties} near-ties; K13 "
        f"launches per rank (ring, all-gather) {k13}; prefill wall ms by rank, ring / "
        f"all-gather (ranks share one card, no speed result): " + ", ".join(
            f"{x['ring']['ms']:.0f}/{x['gather']['ms']:.0f}" for x in g)
        + f"; {max(x['secs'] for x in g):.1f} s on {smi}")

    h = res[0]["h"]
    a_ids = [int(res[0]["a"]["prefill"].argmax())] + [int(x.argmax())
                                                       for x in res[0]["a"]["steps"]]
    # (a) is fed the reference's ids, the scan its own: their histories are
    # one up to the first id where (a) and the reference part (a near-tie)
    fed = ref["a"][2]
    m = next((i for i, (x, y) in enumerate(zip(a_ids, fed)) if x != y), len(fed))
    n = next((i for i, (x, y) in enumerate(zip(h["ids"][:m + 1], a_ids)) if x != y), None)
    if n is not None:
        # the histories part at a near-tie of (a)'s step: (a) is fed the
        # reference's ids, the scan its own
        greedy_agrees(f"sharded (h) scan id {n}", h["ids"][n],
                      res[0]["a"]["steps"][n - 1] if n else res[0]["a"]["prefill"],
                      TOL_PREFILL)
    if len(h["ids"]) != STEPS_H + 1 or any(
            c["decode_attention_partials"] != LAYERS_A * STEPS_H for c in
            (r["h"]["counts"] for r in res)):
        fail(f"sharded (h): {len(h['ids'])} ids, K12 partials launches "
             f"{[r['h']['counts']['decode_attention_partials'] for r in res]}")
    log(f"# sharded (h) sharded_decode_scan, tp=2 x sp=2 after (a)'s sp prefill, {STEPS_H} "
        f"steps: ids equal to (a)'s step loop for the {min(m + 1, len(a_ids))} steps of one "
        f"history" + ("" if n is None else f" up to {n}, then a near-tie")
        + f" ({h['ids'][:8]}...); "
        f"{max(r['h']['secs'] for r in res):.1f} s on {smi}")
    return total_a


def device_sampling_check(eng, what):
    """Engine.generate at -t 1 on the card samples on the device by
    default: each id lies in the min-p support set of its step's logits,
    replayed step by step on the card. min-p is set from the first step's
    logits so that its set holds the top 1% of the vocab, so the check can
    fail (random weights give flat logits: -p 0.1 would keep them all)."""
    prompt = "The quick brown fox"
    p = eng.tokenizer.encode(prompt, bos=True)
    eng.reset()
    eng.prefill_tokens(p[:-1])
    lg = eng.step(p[-1], len(p) - 1)
    minp = float(np.exp(-(lg.max() - np.quantile(lg, 0.99))))
    eng.reset()
    st = eng.generate(prompt, 40, temperature=1.0, minp=minp, seed=7)
    eng.reset()
    eng.prefill_tokens(p[:-1])
    tok, sizes = p[-1], []
    for pos, nxt in enumerate(st.ids, start=len(p) - 1):
        lg = eng.step(tok, pos)
        keep = np.nonzero(lg >= lg.max() + math.log(minp) * 1.0)[0]
        sizes.append(len(keep))
        if nxt not in keep:
            fail(f"{what}: device-sampled id {nxt} at {pos} outside the min-p set "
                 f"({len(keep)} ids)")
        tok = nxt
    eng.reset()
    if not 1 < max(sizes) < len(lg):
        fail(f"{what}: device sampling check cannot discriminate: min-p sets {sizes}")
    log(f"# {what} device sampling (-t 1 -p {minp:.4f}, the default path): {len(st.ids)} "
        f"ids, {len(set(st.ids))} distinct, each in its step's min-p set ({min(sizes)}-"
        f"{max(sizes)} of {len(lg)} ids)")


HEAD_CONTAINERS = (  # 2-layer containers of the converter's other head dims
    ("phi3-mini", dict(dim=3072, hidden_dim=8192, head_dim=96, n_heads=32, n_kv_heads=32,
                       vocab_size=32064, rotary_dim=96, rope_theta=10000.0)),
    ("gemma-2b", dict(dim=2048, hidden_dim=16384, head_dim=256, n_heads=8, n_kv_heads=1,
                      vocab_size=32000, rotary_dim=256, rope_theta=10000.0, act_gelu=True)))


def head_dim_containers(dev):
    """A 2-layer fp8 container of Phi-3-mini's widths (head_dim 96) and one
    of Gemma-2B's (head_dim 256, 8 query heads on 1 kv head; vocab cut to
    32000 for the CPU's plain lm-head): generate on the card (prefill, then
    decode) without raising, and 8 steps held to the CPU plain path."""
    from calm_tpu_torch.config import ModelConfig
    from calm_tpu_torch.engine import Engine
    from calm_tpu_torch.utils.synth import synth_container

    for name, kw in HEAD_CONTAINERS:
        cfg = ModelConfig(**{**kw, "n_layers": 2}, seq_len=512, dtype="fp8", norm_ln=False,
                          bos_token_id=1, eos_token_id=2)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, f"{name}-2l.calm")
            synth_container(path, cfg, seed=3, device=dev, random=True)
            eng, cpu = Engine(path), Engine(path, device="cpu")
            st = eng.generate(PROMPT_LONG, len(eng.tokenizer.encode(PROMPT_LONG, bos=True))
                              + 16, temperature=0)
            tok, worst, ties = 1, 0.0, 0
            eng.reset()
            for pos in range(8):
                lg, lc = eng.step(tok, pos), cpu.step(tok, pos)
                worst = max(worst, float(np.abs(lg - lc).max() / np.abs(lc).max()))
                ties += not greedy_agrees(f"{name} step {pos}", int(lg.argmax()), lc, TOL_STEP)
                tok = int(lc.argmax())
            if worst > TOL_STEP:
                fail(f"{name}-width: logits {worst:.3e} from the CPU > {TOL_STEP}")
            log(f"# {name}-width fp8 2 layers (head_dim {cfg.head_dim}, {cfg.n_heads} q / "
                f"{cfg.n_kv_heads} kv heads): generate {st.tokens} positions on the card "
                f"(prefill + decode), 8 steps within {worst:.3e} of the CPU (tol "
                f"{TOL_STEP:g}), {ties} near-ties")
            del eng, cpu
    torch.cuda.empty_cache()


def ptxas_summary(build) -> str:
    """Registers and spills of each library's kernels, from nvcc -Xptxas -v."""
    out = []
    for name in build.SOURCES:
        path = os.path.join(build.BUILD_DIR, name + ".log")
        if not os.path.exists(path):
            continue
        text = open(path).read()
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(s) for s in re.findall(r"(\d+) bytes spill stores", text))
        if regs:
            out.append(f"{name}.cu {len(regs)} kernels, {min(regs)}-{max(regs)} "
                       f"registers, {spills} B spill stores")
    return "; ".join(out) or "no ptxas report"


def ptxas_each(build, lib: str, kernel: str) -> str:
    """-Xptxas -v of each instantiation of a kernel template: its template
    arguments, registers and spill stores."""
    path = os.path.join(build.BUILD_DIR, lib + ".log")
    if not os.path.exists(path):
        return f"{kernel}: no ptxas report"
    out = []
    for blk in open(path).read().split("Compiling entry function '")[1:]:
        name = blk.split("'")[0]
        if kernel not in name:
            continue
        targs = ",".join(re.findall(r"L[ib](\d+)E", name.split(kernel, 1)[1]))
        regs = re.findall(r"Used (\d+) registers", blk)
        spill = sum(int(x) for x in re.findall(r"(\d+) bytes spill stores", blk))
        out.append(f"<{targs}> {regs[0] if regs else '?'}r/{spill}B")
    return f"{kernel} (registers / spill stores): " + " ".join(out)


def ptxas_kernels(build, lib: str, kernel: str) -> str:
    """-Xptxas -v of one kernel's instantiations: registers, spills and
    static shared memory, from the build log; the dynamic shared memory a
    launch asks for comes from the library."""
    path = os.path.join(build.BUILD_DIR, lib + ".log")
    if not os.path.exists(path):
        return f"{kernel}: no ptxas report"
    blocks = open(path).read().split("Compiling entry function '")[1:]
    regs, spills, smem = [], 0, 0
    for blk in blocks:
        if kernel not in blk.split("'")[0]:
            continue
        regs += [int(r) for r in re.findall(r"Used (\d+) registers", blk)]
        spills += sum(int(x) for x in re.findall(r"(\d+) bytes spill stores", blk))
        smem = max([smem] + [int(x) for x in re.findall(r"(\d+) bytes smem", blk)])
    if not regs:
        return f"{kernel}: not in the ptxas report"
    return (f"{kernel}: {len(regs)} instantiations, {min(regs)}-{max(regs)} registers, "
            f"{spills} B spill stores, {smem} B static shared memory")


def main():
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA GPU available")
        sys.exit(1)
    from calm_tpu_torch import device
    from calm_tpu_torch.ops import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = device.smi_name_power()
    info = device.probe()
    dev = torch.device("cuda")
    # the 2-layer containers first: the CPU side of their checks runs in a
    # worker process (CPU_THREADS threads) from here on, beside the build
    # and the card's phases up to theirs
    import multiprocessing

    ctmp = tempfile.TemporaryDirectory()
    paths = write_containers(ctmp.name, dev)
    hf = write_hf_inputs(ctmp.name, dev)
    pool = multiprocessing.get_context("spawn").Pool(1)
    WORKERS.append(pool)
    # first the converter on the BF16 checkpoint and the CPU side of its
    # containers (the repo tools phase reads them at the end), then the
    # containers' CPU sides, each done before its phase needs it
    conv_refs = {fmt: pool.apply_async(convert_side, (hf["mistral"], hf["out"][fmt], fmt))
                 for fmt in CONVERTED}
    refs = {key: pool.apply_async(cpu_side, (paths[key],) + key) for key in CONTAINERS}
    pool.close()

    def container(fmt, experts=0, cohere=False):
        key = (fmt, experts, cohere)
        return container_phase(paths[key], refs[key], fmt, dev, experts, cohere)
    log(f"# containers written, their CPU side started at {time.perf_counter() - t_start:.1f} s")
    native_checks(list(paths.values()), "2-layer")
    build_s = build.build_all()
    gbps = info.hbm_gbps or 3350.0
    log(f"# probe: {smi}; torch {info.torch_version} cuda {info.cuda_version} "
        f"{info.sm} HBM {info.hbm_bytes} B, nominal {gbps:.0f} GB/s; nvcc "
        f"{info.nvcc}; kernel build {build_s:.2f} s; {ptxas_summary(build)}")
    if info.sm != "sm_90":
        fail(f"the kernels are built for sm_90a, this card is {info.sm}")
    attn_lib, gf4_lib = build.lib("attn"), build.lib("gf4")
    log(f"# ptxas -v: {ptxas_kernels(build, 'attn', 'attn_decode_kernel')}, dynamic "
        f"{attn_lib.calm_decode_smem(128, 1, 4)} B at hd 128 bf16 (4 query rows), "
        f"{attn_lib.calm_decode_smem(256, 1, 8)} B at hd 256 (8 query rows); "
        f"{ptxas_kernels(build, 'gf4', 'gf4_mm_kernel')}, dynamic "
        f"{gf4_lib.calm_gf4_mm_smem()} B; "
        f"{ptxas_kernels(build, 'attn', 'prefill_kernel')}, dynamic " + ", ".join(
            f"{attn_lib.calm_prefill_smem(hd, kvt)}" for hd in (64, 96, 128, 256)
            for kvt in (1, 0, 2)) + " B (hd 64/96/128/256 x bf16/fp16/e5m2); "
        f"{ptxas_kernels(build, 'ring', 'allreduce_kernel')}; "
        f"{ptxas_each(build, 'attn', 'verify_kernel')} <hd, kvt>, dynamic " + ", ".join(
            f"{attn_lib.calm_verify_smem(hd, kvt)}" for hd in (64, 96, 128, 256)
            for kvt in (1, 0, 2)) + " B")
    log(f"# ptxas -v, the multi-row path <fmt, act, m-tiles, n-tiles, odd gf4 rows>: "
        f"{ptxas_each(build, 'qmm', 'mmv_kernel')}; the one-row loops <fmt, act>: "
        f"{ptxas_each(build, 'qmm', 'qmv_kernel')}; <act>: "
        f"{ptxas_each(build, 'qmm', 'gf4_row_kernel')}; {ptxas_each(build, 'gf4', 'gf4_mv_kernel')}; "
        f"<fmt, rows> (fmt 3: e4m3): {ptxas_each(build, 'moe', 'moe_qmv_kernel')}; the wide "
        f"path <fmt, width>: {ptxas_each(build, 'qmm', 'wide_kernel')}, dynamic " + ", ".join(
            f"{build.lib('qmm').calm_wide_smem(f, n)}" for f in range(4) for n in (32, 40, 64))
        + f" B (fmt 0-3 x width 32/40/64); its --precise and gf4 rows of n % 32 != 0 "
        f"<fmt, act, m-tiles, odd, moe, precise>: {ptxas_each(build, 'qmm', 'mmw_kernel')}; "
        f"past 64 rows <fmt, width>: {ptxas_each(build, 'mm', 'mm8_kernel')}, dynamic " + ", ".join(
            f"{build.lib('mm').calm_mm8_smem(f, n)}" for f in (0, 1, 3) for n in (128, 192, 256))
        + " B (fmt 0/1/3 x width 128/192/256)")
    log_captures()

    RATES["nominal"] = gbps
    rows = kernel_phase(gbps, dev)
    # K13 at a speculative verify's T (the split-S route) and the draft
    # tree's attention, beside SDPA, T launches of K12 and the parent's
    # routes; its corners; the crossover that sets the route
    rows.update(verify_kernel_rows(gbps, dev))
    split_corner_checks(dev)
    split_route_sweep(gbps, dev)
    # the wide path: products and the expert sweep of 17-64 rows
    wide_checks(dev)
    rows.update(wide_kernel_rows(gbps, dev))
    wide_verify_shapes(gbps, dev)
    # products past 64 rows: fp16/fp8/fp8e4 on mm8_kernel
    mm8_checks(dev)
    rows.update(mm8_kernel_rows(gbps, dev))
    log(f"# kernel phase done at {time.perf_counter() - t_start:.1f} s")
    # the tools' chains are K1's and K15's main path; the 3 GB rows give the
    # attainable read rate every later GB/s is also read against
    counts_tools = tools_phase(smi)
    log(f"# tools done at {time.perf_counter() - t_start:.1f} s")
    # the parallel slice: K12 partials and K14 rows (read against the
    # attainable rate too), the sharded phases (K12 partials' main path),
    # and the converter's other head dims end to end
    rows.update(partials_kernel_rows(gbps, dev))
    ring_rows, counts_ring = ring_kernel_rows(gbps, dev)
    rows.update(ring_rows)
    t0 = time.perf_counter()
    counts_sp = sharded_phases(dev, smi)
    log(f"# sharded phases {time.perf_counter() - t0:.1f} s, done at "
        f"{time.perf_counter() - t_start:.1f} s")
    head_dim_containers(dev)
    # each kernel's launches come from the main path that uses it: the fp8
    # decode path (K2, K9, K12), the gf4 prefill + decode path (K3, K4, K5,
    # K8, K13) and its CALM_ROT=0 decode (K7); each container is then served
    # (Server, httpd)
    counts8, tok8, _ = container("fp8")
    counts4, tok4, counts_rot0 = container("gf4")
    # the parallel-norm (Cohere) paths: gf4 prefill + decode (K6)
    counts4c, tok4c, _ = container("gf4", cohere=True)
    container("fp8", cohere=True)
    # and the MoE paths: fp8 decode (K10), gf4 decode (K11)
    counts8m, tok8m, _ = container("fp8", experts=4)
    counts4m, tok4m, _ = container("gf4", experts=4)
    # fp8e4: the dense decode path (K2's e4m3 body, per op) and the MoE
    # one (K10's e4m3 body at one row)
    counts8e4, tok8e4, _ = container("fp8e4")
    counts8e4m, tok8e4m, _ = container("fp8e4", experts=4)
    log(f"# container phases done at {time.perf_counter() - t_start:.1f} s")
    # the captured step against the eager one across the sink wrap
    graph_wrap_check(dev)
    verify_graph_check(dev)
    verify_graph_check_moe(dev)
    log(f"# graph wrap and verify checks done at {time.perf_counter() - t_start:.1f} s")
    # Mixtral 8x7B is also served on its full-width weights: the sweep at 8
    # rows, K10's multi-row FFN (fp8) and K11's (gf4)
    served = {}
    for experts, cohere in ((0, False), (0, True), (EXPERTS, False)):
        for fmt in ("fp8", "gf4") if cohere else ("fp8", "gf4", "fp8e4"):
            counts = full_width_phase(fmt, dev, gbps, smi, experts, cohere)
            if counts:
                served[fmt] = counts["dense"]
            log(f"# full-width {fmt} {experts} experts{' aya23-8b' if cohere else ''} "
                f"done at {time.perf_counter() - t_start:.1f} s")
    # the profiler and its tools: tools.perf at full width against fp8
    # Mistral-7B's first32 above, its prefill on the 2-layer container, sol
    t0 = time.perf_counter()
    profiler_phase(smi, paths[("fp8", 0, False)])
    log(f"# profiler phase {time.perf_counter() - t0:.1f} s, done at "
        f"{time.perf_counter() - t_start:.1f} s")
    # the repo's tools on the port: convert (its containers against the CPU
    # side computed in the worker), accept, quality, bench at full width
    # (against the full-width phase's first32 and last32), serve_bench
    repo_tools_phase(hf, conv_refs, paths[("fp8", 0, False)], smi)
    pool.join()
    WORKERS.remove(pool)
    ctmp.cleanup()
    log(f"# repo tools phase done at {time.perf_counter() - t_start:.1f} s")
    # the paged serving path: K12 in paged mode
    counts_pg = full_width_serving_phase(dev, gbps, smi)["paged"]
    log(f"# full-width serving done at {time.perf_counter() - t_start:.1f} s")
    # the gf4 serving ticks at 8 rows: K8 (Mistral-7B), K7 (Mistral-7B under
    # CALM_ROT=0), K6 and K3 (Aya 23 8B)
    g4 = full_width_serving_phase(dev, gbps, smi, "gf4")
    counts_g4, counts_g4r0 = g4["dense"], g4["dense CALM_ROT=0"]
    counts_g4c = full_width_serving_phase(dev, gbps, smi, "gf4", cohere=True)["dense"]
    log(f"# full-width gf4 serving done at {time.perf_counter() - t_start:.1f} s")
    # the fp8e4 serving tick at 8 rows: K2's e4m3 body on the multi-row path
    counts_e4 = full_width_serving_phase(dev, gbps, smi, "fp8e4")["dense"]
    log(f"# full-width fp8e4 serving done at {time.perf_counter() - t_start:.1f} s")

    sources = {"qmm_decode": ("calm_tpu_torch/csrc/qmm.cu",
                              "calm_tpu/ops/pallas_qmm.py:92", counts8),
               "qx_offn_qkv": ("calm_tpu_torch/csrc/qmm.cu",
                               "calm_tpu/ops/pallas_qmm.py:942", counts8),
               # the multi-row path: the serving tick's 8 slots (a paged drain)
               "qmm_decode_multirow": ("calm_tpu_torch/csrc/qmm.cu",
                                       "calm_tpu/ops/pallas_qmm.py:92", counts_pg),
               "qx_offn_qkv_multirow": ("calm_tpu_torch/csrc/qmm.cu",
                                        "calm_tpu/ops/pallas_qmm.py:942", counts_pg),
               "decode_attention": ("calm_tpu_torch/csrc/attn.cu",
                                    "calm_tpu/ops/pallas_attn.py:77", counts8),
               "decode_attention_paged": ("calm_tpu_torch/csrc/attn.cu",
                                          "calm_tpu/ops/pallas_attn.py:77", counts_pg),
               "prefill_attention": ("calm_tpu_torch/csrc/attn.cu",
                                     "calm_tpu/ops/pallas_attn.py:326", counts4),
               # K13's split-S route at a served speculative round's T=5 (B=8,
               # the window's last rows): launches from the full-width
               # speculative drain's verifies
               "prefill_attention_verify": ("calm_tpu_torch/csrc/attn.cu",
                                            "calm_tpu/ops/pallas_attn.py:326", SPEC_COUNTS,
                                            "prefill_attention_split"),
               # the same kernel with the draft tree's mask (jnp in JAX, no
               # Pallas kernel): launches from the full-width tree rounds
               "tree_attention": ("calm_tpu_torch/csrc/attn.cu", "calm_tpu/model.py:613",
                                  TREE_COUNTS),
               "qmm_decode_gf4": ("calm_tpu_torch/csrc/gf4.cu",
                                  "calm_tpu/ops/pallas_qmm.py:100", counts4),
               "qmm_prefill": ("calm_tpu_torch/csrc/gf4.cu",
                               "calm_tpu/ops/pallas_qmm.py:238", counts4),
               "qmm_prefill_w2": ("calm_tpu_torch/csrc/gf4.cu",
                                  "calm_tpu/ops/pallas_qmm.py:346", counts4),
               "gf4_offn_qkv": ("calm_tpu_torch/csrc/qmm.cu",
                                "calm_tpu/ops/pallas_qmm.py:737", counts4),
               # the gf4 multi-row path: the gf4 serving ticks' 8 slots
               "gf4_offn_qkv_multirow": ("calm_tpu_torch/csrc/qmm.cu",
                                         "calm_tpu/ops/pallas_qmm.py:737", counts_g4),
               "gf4_ffn_multirow": ("calm_tpu_torch/csrc/qmm.cu",
                                    "calm_tpu/ops/pallas_qmm.py:464", counts_g4c),
               "qmm_decode_gf4_multirow": ("calm_tpu_torch/csrc/qmm.cu",
                                           "calm_tpu/ops/pallas_qmm.py:100", counts_g4c),
               "gf4_offn_multirow": ("calm_tpu_torch/csrc/qmm.cu",
                                     "calm_tpu/ops/pallas_qmm.py:601", counts_g4r0),
               "qmm_moe_dense": ("calm_tpu_torch/csrc/moe.cu",
                                 "calm_tpu/ops/pallas_qmm.py:1248", counts8m),
               "gf4_moe_ffn": ("calm_tpu_torch/csrc/moe.cu",
                               "calm_tpu/ops/pallas_qmm.py:1361", counts4m),
               # the MoE sweep at 8 rows: the Mixtral 8x7B serving drains
               "qmm_moe_ffn_multirow": ("calm_tpu_torch/csrc/qmm.cu",
                                        "calm_tpu/ops/pallas_qmm.py:1248", served["fp8"]),
               "gf4_moe_ffn_multirow": ("calm_tpu_torch/csrc/qmm.cu",
                                        "calm_tpu/ops/pallas_qmm.py:1361", served["gf4"]),
               "gf4_ffn": ("calm_tpu_torch/csrc/qmm.cu",
                           "calm_tpu/ops/pallas_qmm.py:464", counts4c),
               "gf4_offn": ("calm_tpu_torch/csrc/qmm.cu",
                            "calm_tpu/ops/pallas_qmm.py:601", counts_rot0),
               "stream_sum": ("calm_tpu_torch/csrc/stream.cu",
                              "tools/dma_ceiling.py:26", counts_tools),
               "gf4_decode_sum": ("calm_tpu_torch/csrc/stream.cu",
                                  "tools/gf4_bound.py:55", counts_tools),
               "decode_attention_partials": ("calm_tpu_torch/csrc/attn.cu",
                                             "calm_tpu/ops/pallas_attn.py:57", counts_sp),
               "ring_all_reduce": ("calm_tpu_torch/csrc/ring.cu",
                                   "calm_tpu/ops/pallas_collectives.py:42", counts_ring),
               # fp8e4: no Pallas kernel; JAX runs it through XLA with the scale
               # on the output. Launches from the fp8e4 paths: the Mistral-width
               # container (one row), its 8-slot serving drain, the MoE
               # container (one row) and the Mixtral drain (8 rows)
               "qmm_decode_fp8e4": ("calm_tpu_torch/csrc/qmm.cu", "calm_tpu/ops/qmm.py:179",
                                    counts8e4, "qmm_decode"),
               "qmm_decode_fp8e4_multirow": ("calm_tpu_torch/csrc/qmm.cu",
                                             "calm_tpu/ops/qmm.py:179", counts_e4,
                                             "qmm_decode_multirow"),
               "qmm_moe_dense_fp8e4": ("calm_tpu_torch/csrc/moe.cu", "calm_tpu/ops/qmm.py:179",
                                       counts8e4m, "qmm_moe_dense"),
               "qmm_moe_ffn_fp8e4_multirow": ("calm_tpu_torch/csrc/qmm.cu",
                                              "calm_tpu/ops/qmm.py:179", served["fp8e4"],
                                              "qmm_moe_ffn_multirow"),
               # --precise at 2-16 rows (JAX's precise XLA product), the
               # multi-row path: launches from the full-width fp8 and gf4
               # Mistral-7B 17-token prompts' prefills
               "qmm_decode_precise": ("calm_tpu_torch/csrc/qmm.cu", "calm_tpu/ops/qmm.py:190",
                                      PRECISE_COUNTS["fp8"]),
               "qmm_decode_gf4_precise": ("calm_tpu_torch/csrc/qmm.cu",
                                          "calm_tpu/ops/qmm.py:190", PRECISE_COUNTS["gf4"]),
               # the wide path (17-64 rows; JAX runs these in XLA): the served
               # speculative drains' verifies of 8 x 5 rows (fp8 Mistral-7B,
               # Mixtral 8x7B) and the MoE verify graphs (fp8e4, gf4)
               "qmm_decode_wide": ("calm_tpu_torch/csrc/qmm.cu",
                                   "calm_tpu/ops/pallas_qmm.py:92", SPEC_COUNTS),
               "qmm_decode_fp8e4_wide": ("calm_tpu_torch/csrc/qmm.cu",
                                         "calm_tpu/ops/qmm.py:179", VERIFY_MOE_COUNTS["fp8e4"],
                                         "qmm_decode_wide"),
               "qmm_decode_gf4_wide": ("calm_tpu_torch/csrc/qmm.cu",
                                       "calm_tpu/ops/pallas_qmm.py:100",
                                       VERIFY_MOE_COUNTS["gf4"]),
               "qmm_moe_ffn_wide": ("calm_tpu_torch/csrc/qmm.cu",
                                    "calm_tpu/ops/pallas_qmm.py:1248", SPEC_MOE_COUNTS),
               # past 64 rows (JAX runs these in XLA): one full-width fp8
               # 2048-token prefill, Mistral-7B and Mixtral 8x7B (the grouped
               # experts)
               "qmm_mm8": ("calm_tpu_torch/csrc/mm.cu", "calm_tpu/ops/qmm.py:189",
                           PREFILL_COUNTS["fp8 mistral7b"]),
               "qmm_mm8_expert": ("calm_tpu_torch/csrc/mm.cu", "calm_tpu/ops/qmm.py:189",
                                  PREFILL_COUNTS[f"fp8 mixtral{EXPERTS}x7b"], "qmm_mm8"),
               "gf4_moe_ffn_wide": ("calm_tpu_torch/csrc/qmm.cu",
                                    "calm_tpu/ops/pallas_qmm.py:1361", VERIFY_MOE_COUNTS["gf4"])}
    kernels = []
    for name, (src, rep, counts, *key) in sources.items():
        n = counts[key[0] if key else name]
        if n <= 0:
            fail(f"{name} was not launched on its main path")
        r = rows[name]
        kernels.append(dict(name=name, route="cuda", source=src, replaces=rep,
                            launches=n, max_abs_err=r["max_abs_err"],
                            ms=r["ms"], plain_ms=r["plain_ms"],
                            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                            library_ms=r["library_ms"], timed_by=r["timed_by"],
                            **{k: r[k] for k in ("attainable_bound_ms",) if k in r}))
    log(f"# main paths: fp8 {tok8} positions, gf4 {tok4}, gf4 Aya-width {tok4c}, fp8 "
        f"MoE {tok8m}, gf4 MoE {tok4m}, fp8e4 {tok8e4}, fp8e4 MoE {tok8e4m}; total "
        f"{time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
