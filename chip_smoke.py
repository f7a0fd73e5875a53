"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from ``calm_tpu_torch/csrc``, holds each
against its plain PyTorch version at Mistral-7B, Mixtral 8x7B and the
tools' shapes and ragged ones and times it beside its bound; runs both
bandwidth tools (``calm_tpu_torch.tools.dma_ceiling``, ``gf4_bound``),
whose 3 GB rows give the card's attainable HBM read rate; drives
``Engine.generate`` (batched prefill, then decode), ``prefill_tokens``,
``perplexity`` and the CLI (generate, ``-x``, ``-y``) on 2-layer
Mistral-7B-width fp8 and gf4 containers (gf4 also with ROTATED_DECODE
off, as CALM_ROT=0), 2-layer Aya 23 8B-width parallel-norm (Cohere) gf4
and fp8 containers and 2-layer Mixtral-width (4 experts, top-2) fp8 and
gf4 MoE containers, each checked against the CPU plain path; runs a
2048-token prefill and the ``bench.py`` decode protocol on 32-layer
Mistral-7B, Aya 23 8B and Mixtral 8x7B, fp8 and gf4; serves the
containers through ``Server`` (dense, paged, prefix cache) against the
CPU's server and through ``python -m calm_tpu_torch.httpd``; serves 16
requests on a 32-layer Mistral-7B with 8 slots, dense and paged; and ends
with a ``kernels`` JSON line and ``{"ok": true, "device": ...}``. Any
failure exits non-zero before the last line; without a GPU it exits 1 at
once.
"""

from __future__ import annotations

import json
import os
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request

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


def fail(msg: str):
    log(f"FAIL: {msg}")
    sys.exit(1)


def _short(kernel: str) -> str:
    """'void (anonymous namespace)::qmv_kernel<1, 0, 1>(Args)' ->
    'qmv_kernel<1, 0, 1>'."""
    k = kernel.replace("(anonymous namespace)::", "").removeprefix("void ")
    return k.split("(")[0][:60]


def kernel_rows(run) -> list[tuple[float, int, str]]:
    """(device us, launches, short name) of every kernel ``run`` launches,
    by torch.profiler (CUPTI), largest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sorted(((e.self_device_time_total, e.count, _short(e.key))
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  reverse=True)


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
    return (f"kernel_ms {t['ms']:.4f} plain_ms {t['plain_ms']:.4f} library_ms {lib} "
            f"({t['timed_by']})")


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
            t = timings(lambda i: hq.qmm_decode(x, w, fmt, i % L),
                        lambda i: hq.qmm_decode_plain(x, w, fmt, i % L),
                        lambda i: torch.matmul(x.bfloat16(), wb[i % L].T))
            b, by = bound_ms(d * D * esz + 4 * (D + d), 2 * d * D, gbps)
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
        t = timings(lambda i: hq.qx_offn_qkv(a, r, g, anx, *ws, i % L, fmt,
                                             False, 1e-5, False),
                    lambda i: hq.qx_offn_qkv_plain(a, r, g, anx, *ws, i % L, fmt,
                                                   False, 1e-5, False),
                    epilogue_chain(a, r, g, anx, wb, L))
        n_w = D * Qd + 3 * H * D + (Qd + 2 * KVd) * D
        b, by = bound_ms(n_w * esz + 4 * (3 * D + 2 * Qd + 2 * KVd), 2 * n_w, gbps)
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
            t = timings(lambda i: ha.decode_attention(q, kc, vc, kl, i % L, fr),
                        lambda i: ha.decode_attention_plain(q, kc, vc, kl, i % L, fr),
                        lambda i: F.scaled_dot_product_attention(
                            q4, kb[i % L, :, :, :kv_len], vb[i % L, :, :, :kv_len],
                            enable_gqa=True))
            nb = 2 * KVH * kv_len * hd * esz + 2 * KVH * hd * esz + 8 * B * KVH * M * hd
            b, by = bound_ms(nb, 4 * KVH * M * kv_len * hd, gbps)
            log(f"# K12 decode_attention fresh {kvname} KV kv_len {kv_len} "
                f"(B=1, KVH=8, M=4, hd=128, S=4096): max_abs_err {e:.3e} "
                f"(tol {TOL_DA:g}); {ms_line(t)} (bf16 SDPA) bound_ms {b:.4f} "
                f"({by}); {share(t, b)}")
            if kvname == "bf16" and kv_len == 4096:
                best = dict(t, bound_ms=b, bound_by=by)
        del kc, vc
    rows["decode_attention"] = dict(best, max_abs_err=max(errs))
    ragged_checks(dev)
    rows.update(prefill_kernel_rows(gbps, dev))
    rows.update(gf4_kernel_rows(gbps, dev))
    ragged_checks_prefill_gf4(dev)
    rows.update(moe_kernel_rows(gbps, dev))
    ragged_checks_moe(dev)
    rows.update(paged_kernel_rows(gbps, dev))
    ragged_checks_paged(dev)
    rows.update(ffn_kernel_rows(gbps, dev))
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
    pages beside dense fresh mode; K9 and K2 (lm-head) at 8 rows."""
    import torch.nn.functional as F

    from calm_tpu_torch.ops import hopper_attn as ha
    from calm_tpu_torch.ops import hopper_qmm as hq
    from calm_tpu_torch.ops.qmm import QTensor, dequant

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
                lambda i: ha.decode_attention_plain(q, kc, vc, kl, i % L, fr), sdpa)
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
                    sdpa)
        log(f"# K12 decode_attention paged+fresh bf16 KV B=8 kv_len {S} PR={PR} "
            f"(scrambled table): max_abs_err {e:.3e} (tol {TOL_DA:g}), equal to dense "
            f"mode; {ms_line(t)} (bf16 SDPA on the rows held densely, gather excluded) "
            f"bound_ms {b:.4f} ({by}); {share(t, b)}")
        if PR == 512:
            rows["decode_attention_paged"] = dict(t, bound_ms=b, bound_by=by, max_abs_err=e)
        del kp, vp
    del kc, vc

    # K9 one layer and K2 at the lm-head, fp8, 8 rows
    H, V = HID, 32000
    ws = [rand_w(sh, "fp8", dev) for sh in ((2, D, Q), (2, H, D), (2, H, D), (2, D, H),
                                            (2, Q, D), (2, KV, D), (2, KV, D))]
    g = 1 + 0.1 * torch.randn(2, D, device=dev)
    anx = 1 + 0.1 * torch.randn(2, D, device=dev)
    a, r = torch.randn(B, Q, device=dev), torch.randn(B, D, device=dev)
    e = check("qx_offn_qkv fp8 B=8", hq.qx_offn_qkv(a, r, g, anx, *ws, 1, "fp8", False,
                                                    1e-5, False),
              hq.qx_offn_qkv_plain(a, r, g, anx, *ws, 1, "fp8", False, 1e-5, False), TOL_MV)
    wb = [dequant(QTensor(w, "fp8"), torch.bfloat16) for w in ws]
    t = timings(lambda i: hq.qx_offn_qkv(a, r, g, anx, *ws, i % 2, "fp8", False, 1e-5, False),
                lambda i: hq.qx_offn_qkv_plain(a, r, g, anx, *ws, i % 2, "fp8", False, 1e-5,
                                               False),
                epilogue_chain(a, r, g, anx, wb, 2))
    n_w = D * Q + 3 * H * D + (Q + 2 * KV) * D
    # at 8 rows, operations at the bf16 rate: the TPU kernels compute these
    # products on bf16 operands
    b, by = bound_ms(n_w + 4 * B * (3 * D + 2 * Q + 2 * KV), 2 * B * n_w, gbps, PEAK_BF16)
    log(f"# K9 qx_offn_qkv fp8 one layer B=8: max_abs_err {e:.3e} (tol {TOL_MV:g} x "
        f"max|out|); {ms_line(t)} (7 bf16 matmuls) bound_ms {b:.4f} ({by}); {share(t, b)}")
    del ws, wb
    w = rand_w((1, V, D), "fp8", dev)
    x = torch.randn(B, D, device=dev)
    e = check("qmm_decode fp8 lm-head B=8", hq.qmm_decode(x, w, "fp8", 0),
              hq.qmm_decode_plain(x, w, "fp8", 0), TOL_MV)
    wb = dequant(QTensor(w, "fp8"), torch.bfloat16)
    t = timings(lambda i: hq.qmm_decode(x, w, "fp8", 0),
                lambda i: hq.qmm_decode_plain(x, w, "fp8", 0),
                lambda i: torch.matmul(x.bfloat16(), wb[0].T))
    b, by = bound_ms(V * D + 4 * B * (D + V), 2 * B * V * D, gbps, PEAK_BF16)
    log(f"# K2 qmm_decode fp8 lm-head {V}x{D} B=8: max_abs_err {e:.3e} (tol {TOL_MV:g} x "
        f"max|y|); {ms_line(t)} (bf16 matmul) bound_ms {b:.4f} ({by}); {share(t, b)}")
    del w, wb
    torch.cuda.empty_cache()
    return rows


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
        t = timings(lambda i: hq.qmm_moe_dense(x, w, ids, cnt, fmt, i % L),
                    lambda i: hq.qmm_moe_dense_plain(x, w, ids, cnt, fmt, i % L),
                    lambda i: torch.bmm(xb, wb[i % L]))
        b, by = bound_ms(A * d * n * esz + 4 * (x.numel() + A * B * d),
                         2 * A * B * d * n, gbps)
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
    t = timings(lambda i: hq.gf4_moe_ffn(x, w1, w3, w2, ids, cnt, i % L, False),
                lambda i: hq.gf4_moe_ffn_plain(x, w1, w3, w2, ids, cnt, i % L, False),
                bmm_chain)
    n_w = A * 3 * HID * D
    b, by = bound_ms(n_w // 2 + 4 * (B * D + A * B * D), 2 * B * n_w, gbps)
    log(f"# K11 gf4_moe_ffn D={D} H={HID}, 2 of {E} experts, B=1: max_abs_err "
        f"{err:.3e} (tol {TOL_MV:g} x max|z|); {ms_line(t)} (3 bf16 bmm, "
        f"pre-dequantized live planes) bound_ms {b:.4f} ({by}, {n_w / 2e6:.1f} MB); "
        f"{share(t, b)}")
    rows["gf4_moe_ffn"] = dict(t, bound_ms=b, bound_by=by, max_abs_err=err)
    del w1, w3, w2, wb
    torch.cuda.empty_cache()
    return rows


def ragged_checks_moe(dev):
    """K10 and K11 on shapes the Mixtral rows do not reach: B = 1, 3, 5
    and 16, eight experts in four slots of which the last is dead (cnt 3,
    padded by repeating an id: its output must be exactly 0), d = 1003, a
    hidden width of 11008 (1376 words), a model width of 1040 (130 words),
    x shared and per slot, SiLU and GELU."""
    from calm_tpu_torch.ops import hopper_qmm as hq

    ids = torch.tensor([0, 3, 6, 6], dtype=torch.int32, device=dev)
    cnt = torch.tensor([3], dtype=torch.int32, device=dev)
    worst = {"qmm_moe_dense": 0.0, "gf4_moe_ffn": 0.0}

    def dead_zero(what, out):
        if out[3].abs().max().item() != 0:
            fail(f"{what}: the dead slot is not zero")

    for fmt, d, n in (("fp8", 1003, 1040), ("fp16", 1003, 1040), ("gf4", 1003, 11008)):
        w = rand_w((2, EXPERTS, d, n // (8 if fmt == "gf4" else 1)), fmt, dev)
        for B in (1, 3, 5, 16):
            for Ax in (1, 4):
                x = torch.randn(Ax, B, n, device=dev)
                got = hq.qmm_moe_dense(x, w, ids, cnt, fmt, 1)
                dead_zero(f"qmm_moe_dense {fmt} B={B}", got)
                e = check(f"qmm_moe_dense {fmt} {d}x{n} B={B} Ax={Ax}", got,
                          hq.qmm_moe_dense_plain(x, w, ids, cnt, fmt, 1), TOL_MV)
                worst["qmm_moe_dense"] = max(worst["qmm_moe_dense"], e)
    Dm, Hm = 1040, 11008
    w1, w3 = (rand_w((2, EXPERTS, Hm, Dm // 8), "gf4", dev) for _ in range(2))
    w2 = rand_w((2, EXPERTS, Dm, Hm // 8), "gf4", dev)
    for B in (1, 5, 16):
        for gelu in (False, True):
            x = torch.randn(B, Dm, device=dev)
            got = hq.gf4_moe_ffn(x, w1, w3, w2, ids, cnt, 1, gelu)
            dead_zero(f"gf4_moe_ffn B={B}", got)
            e = check(f"gf4_moe_ffn D={Dm} H={Hm} B={B} gelu={gelu}", got,
                      hq.gf4_moe_ffn_plain(x, w1, w3, w2, ids, cnt, 1, gelu), TOL_MV)
            worst["gf4_moe_ffn"] = max(worst["gf4_moe_ffn"], e)
    torch.cuda.synchronize()
    log("# ragged shapes (MoE): max_abs_err " + ", ".join(
        f"{k} {v:.3e}" for k, v in worst.items()))


def ffn_kernel_rows(gbps, dev):
    """K6 at one Aya 23 8B / Mistral-7B layer's FFN (dim 4096, hidden
    14336), B=1 and B=8; K7 at one Mistral-7B layer (wo 4096 x 4096), B=1,
    RMSNorm as Mistral's. Two-layer stacks cycled: one layer's 88 MB of
    FFN words is past the 50 MB L2."""
    import torch.nn.functional as F

    from calm_tpu_torch.ops import hopper_qmm as hq
    from calm_tpu_torch.ops.qmm import QTensor, dequant

    rows, L, eps = {}, 2, 1e-5
    w1, w3 = (rand_w((L, HID, D // 8), "gf4", dev) for _ in range(2))
    w2 = rand_w((L, D, HID // 8), "gf4", dev)
    wo = rand_w((L, D, Q // 8), "gf4", dev)
    wb = [dequant(QTensor(w, "gf4"), torch.bfloat16) for w in (w1, w3, w2, wo)]
    n_ffn = 3 * HID * D

    def ffn_lib(xb, l):
        return torch.matmul(F.silu(torch.matmul(xb, wb[0][l].T))
                            * torch.matmul(xb, wb[1][l].T), wb[2][l].T)
    errs, best = [], None
    for B in (1, 8):
        x = torch.randn(B, D, device=dev)
        for layer in range(L):
            errs.append(check(f"gf4_ffn B={B} layer {layer}",
                              hq.gf4_ffn(x, w1, w3, w2, layer, False),
                              hq.gf4_ffn_plain(x, w1, w3, w2, layer, False), TOL_MV))
        # operations at the bf16 rate: the TPU kernel computes this function
        # on bf16 operands
        b, by = bound_ms(n_ffn // 2 + 4 * 2 * B * D, 2 * B * n_ffn, gbps, PEAK_BF16)
        xb = x.bfloat16()
        t = timings(lambda i: hq.gf4_ffn(x, w1, w3, w2, i % L, False),
                    lambda i: hq.gf4_ffn_plain(x, w1, w3, w2, i % L, False),
                    lambda i: ffn_lib(xb, i % L), bound=b)
        log(f"# K6 gf4_ffn D={D} H={HID} B={B}: max_abs_err {max(errs):.3e} (tol "
            f"{TOL_MV:g} x max|y|); {ms_line(t)} (3 bf16 matmuls on pre-dequantized "
            f"planes) bound_ms {b:.4f} ({by}, {n_ffn / 2e6:.1f} MB); {share(t, b)}")
        if B == 1:
            best = dict(t, bound_ms=b, bound_by=by)
    rows["gf4_ffn"] = dict(best, max_abs_err=max(errs))

    g = 1 + 0.1 * torch.randn(L, D, device=dev)
    a, r = torch.randn(1, Q, device=dev), torch.randn(1, D, device=dev)
    errs = []
    for layer in range(L):
        args = (a, r, g, wo, w1, w3, w2, layer, False, eps, False)
        errs += check_offn(f"layer {layer}", hq.gf4_offn(*args), hq.gf4_offn_plain(*args))
    ab = a.bfloat16()

    def offn_lib(i):
        l = i % L
        r1 = r + torch.matmul(ab, wb[3][l].T)
        return ffn_lib(F.rms_norm(r1, (D,), g[l], eps).bfloat16(), l), r1
    n_w = n_ffn + D * Q
    b, by = bound_ms(n_w // 2 + 4 * (Q + 4 * D), 2 * n_w, gbps)
    t = timings(lambda i: hq.gf4_offn(a, r, g, wo, w1, w3, w2, i % L, False, eps, False),
                lambda i: hq.gf4_offn_plain(a, r, g, wo, w1, w3, w2, i % L, False, eps,
                                            False), offn_lib, bound=b)
    log(f"# K7 gf4_offn D={D} H={HID} Qd={Q} B=1: max_abs_err {max(errs):.3e} (tol "
        f"{TOL_MV:g} x max|out|, ffn and r1 each); {ms_line(t)} (4 bf16 matmuls + "
        f"rms_norm) bound_ms {b:.4f} ({by}, {n_w / 2e6:.1f} MB); {share(t, b)}")
    rows["gf4_offn"] = dict(t, bound_ms=b, bound_by=by, max_abs_err=max(errs))
    del w1, w3, w2, wo, wb
    torch.cuda.empty_cache()
    return rows


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
# K4, K5, K13 and dense_matmul round their activations (and q, p) once to
# bf16 as the TPU kernels do: 2^-9 relative per operand, ~1e-3 of max |out|
# on random data; the JAX package's own tests hold its kernels at 3e-2.
TOL_MM = 1e-2
TOL_ATT = 1e-2


def causal_pairs(pos0: int, T: int, kv_len: int) -> int:
    """(query, cache row) pairs the causal mask leaves visible."""
    return sum(min(kv_len, pos0 + t + 1) for t in range(T))


def prefill_kernel_rows(gbps, dev):
    """K13 at Mistral-7B shapes (32 heads, 8 kv heads, hd 128): T=2048 from
    position 0 with bf16 and fp8 KV, and T=512 at position 1024."""
    import torch.nn.functional as F

    from calm_tpu_torch.ops import hopper_attn as ha

    B, KVH, M, S, hd, L = 1, 8, 4, 4096, 128, 2
    errs, best = [], None
    for kvd, kvname, T, pos0 in ((torch.bfloat16, "bf16", 2048, 0),
                                 (torch.float8_e5m2, "fp8", 2048, 0),
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


def gf4_kernel_rows(gbps, dev):
    """K3 at the gf4 lm-head (32000 x 4096) and w2 (4096 x 14336), B=1; K4
    at T=2048 for w1 (14336 x 4096) and K5 for w2 (4096 x 14336); K8 one
    Mistral-7B layer."""
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
        t = timings(lambda i: hq.qmm_decode_gf4(x, w, i % L),
                    lambda i: hq.qmm_decode_gf4_plain(x, w, i % L),
                    lambda i: torch.matmul(x.bfloat16(), wb[i % L].T))
        b, by = bound_ms(d * n // 2 + 4 * (n + d), 2 * d * n, gbps)
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
        t = timings(lambda i: fn(x, w, i % L),
                    lambda i: hq.qmm_prefill_plain(x, w, i % L),
                    lambda i: torch.matmul(xb, wb[i % L].T), 3)
        flops = 2 * R * d * n
        b, by = bound_ms(4 * R * n + d * n // 2 + 4 * R * d, flops, gbps, PEAK_BF16)
        log(f"# {name} {key} {d}x{n} R={R}: max_abs_err {err:.3e} "
            f"(tol {TOL_MM:g} x max|y|); {ms_line(t)} (bf16 matmul, pre-dequantized) "
            f"bound_ms {b:.4f} ({by}, {flops / 1e9:.1f} GFLOP); {share(t, b)}, "
            f"{flops / t['ms'] / 1e9:.1f} TFLOP/s")
        rows[key] = dict(t, bound_ms=b, bound_by=by, max_abs_err=err)
        del w, wb, x, xb

    # K8 gf4_offn_qkv: one Mistral-7B layer, 2-layer stacks (the clamp)
    errs = []
    ws = [rand_w((L, d, n // 8), "gf4", dev)
          for d, n in ((D, Q), (HID, D), (HID, D), (D, HID), (Q, D), (KV, D), (KV, D))]
    g = 1 + 0.1 * torch.randn(L, D, device=dev)
    anx = 1 + 0.1 * torch.randn(L, D, device=dev)
    a, r = torch.randn(1, Q, device=dev), torch.randn(1, D, device=dev)
    for layer in range(L):
        errs.append(check(
            f"gf4_offn_qkv layer {layer}",
            hq.gf4_offn_qkv(a, r, g, anx, *ws, layer, False, 1e-5, False),
            hq.gf4_offn_qkv_plain(a, r, g, anx, *ws, layer, False, 1e-5, False), TOL_MV))
    wb = [dequant(QTensor(w, "gf4"), torch.bfloat16) for w in ws]
    t = timings(lambda i: hq.gf4_offn_qkv(a, r, g, anx, *ws, i % L, False, 1e-5, False),
                lambda i: hq.gf4_offn_qkv_plain(a, r, g, anx, *ws, i % L, False, 1e-5,
                                                False),
                epilogue_chain(a, r, g, anx, wb, L))
    n_w = D * Q + 3 * HID * D + (Q + 2 * KV) * D
    b, by = bound_ms(n_w // 2 + 4 * (3 * D + 2 * Q + 2 * KV), 2 * n_w, gbps)
    log(f"# K8 gf4_offn_qkv one layer D={D} H={HID} Qd={Q} KVd={KV} B=1: "
        f"max_abs_err {max(errs):.3e} (tol {TOL_MV:g} x max|out|); {ms_line(t)} "
        f"(7 bf16 matmuls on pre-dequantized planes) bound_ms {b:.4f} ({by}, "
        f"{n_w / 2e6:.1f} MB); {share(t, b)}")
    rows["gf4_offn_qkv"] = dict(t, bound_ms=b, bound_by=by, max_abs_err=max(errs))
    del ws, wb
    return rows


def ragged_checks_prefill_gf4(dev):
    """K3/K4/K5/K13 on shapes the Mistral-7B rows do not reach: ragged rows
    (33, 100, 2047), a hidden width of 11008 (1376 words a row), a width
    whose words per row are not a multiple of 4, d off the tile; K13 with T
    off the 16-query tile, two sequences at other starts, head_dim 64 with
    8 query heads per kv head, fp16 and fp8 caches. Also the products no
    kernel takes (``dense_matmul``: fp8/fp16 past 16 rows, gf4 at 17..31)
    against the f32 product."""
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
    """kernel name -> (wrapper, the attribute that counts its launches)."""
    from calm_tpu_torch.ops import hopper_attn as ha
    from calm_tpu_torch.ops import hopper_qmm as hq
    from calm_tpu_torch.ops import hopper_stream as hs
    fns = {"qmm_decode": hq.qmm_decode, "qx_offn_qkv": hq.qx_offn_qkv,
           "decode_attention": ha.decode_attention,
           "prefill_attention": ha.prefill_attention,
           "qmm_decode_gf4": hq.qmm_decode_gf4, "qmm_prefill": hq.qmm_prefill,
           "qmm_prefill_w2": hq.qmm_prefill_w2, "gf4_offn_qkv": hq.gf4_offn_qkv,
           "qmm_moe_dense": hq.qmm_moe_dense, "gf4_moe_ffn": hq.gf4_moe_ffn,
           "gf4_ffn": hq.gf4_ffn, "gf4_offn": hq.gf4_offn,
           "stream_sum": hs.stream_sum, "gf4_decode_sum": hs.gf4_decode_sum}
    out = {k: (f, "launches") for k, f in fns.items()}
    out["decode_attention_paged"] = (ha.decode_attention, "paged_launches")
    return out


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


def container_phase(fmt, dev, experts: int = 0, cohere: bool = False):
    """Engine, prefill, perplexity and CLI on a 2-layer Mistral-7B-width
    container, or with ``experts`` a 2-layer Mixtral-width MoE one (top-2,
    bench.py's mixtral4x7b proxy at 4), or with ``cohere`` a 2-layer Aya 23
    8B-width parallel-norm one (tied, its vocab cut to 32000), of seeded
    random bits, held against the CPU plain path; then served. The fp8
    Aya-width container runs generate and prefill against the CPU only;
    the gf4 Mistral-width one also decodes with ROTATED_DECODE off.
    Returns (launch counts of the main path, tokens, launch counts of the
    CALM_ROT=0 decode or None)."""
    from calm_tpu_torch import model as M
    from calm_tpu_torch.config import ModelConfig
    from calm_tpu_torch.engine import Engine
    from calm_tpu_torch.utils.synth import synth_container

    moe = dict(n_experts=experts, n_experts_ac=2, rope_theta=1e6) if experts else {}
    arch = (dict(norm_ln=True, norm_par=True, vocab_size=AYA_VOCAB_CUT) if cohere
            else dict(norm_ln=False))
    cfg = ModelConfig(**{**MISTRAL, "n_layers": 2, "rope_theta": 10000.0, **moe, **arch},
                      seq_len=4096, rotary_dim=128, dtype=fmt, bos_token_id=1,
                      eos_token_id=2)
    name = "aya23-8b" if cohere else f"mixtral{experts}x7b" if experts else "mistral7b"
    what = f"{fmt} {name}-width"
    light = cohere and fmt == "fp8"  # generate and prefill against the CPU only
    rot0 = None
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"{name}-width-2l-{fmt}.calm")
        t0 = time.perf_counter()
        # random bits, not the bit pattern: the pattern's rows are all alike
        synth_container(path, cfg, seed=1, device=dev, random=True, tied=cohere)
        log(f"# {what} engine: wrote {os.path.getsize(path) / 1e9:.2f} GB container "
            f"in {time.perf_counter() - t0:.1f} s")
        text_path = os.path.join(tmp, "ppl.txt")
        with open(text_path, "w") as f:
            f.write(PROMPT_LONG * 3)
        user_path = os.path.join(tmp, "user.txt")  # one user line, then EOF
        with open(user_path, "w") as f:
            f.write("hello there\n")
        # the CLI and the HTTP server run on the card beside the checks below
        procs = [] if light else [
            cli(path, ["-t", "0", "-n", "16", "-i", "hello"]), cli(path, ["-x", text_path]),
            cli(path, ["-y", "be brief", "-n", "24", "-s", "7"], user_path)]
        http_args = ["--page-rows", "16"] if fmt == "gf4" else []
        httpd = None if light else httpd_proc(path, http_args)
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
        prompt = "The quick brown fox" if fmt == "fp8" else PROMPT_LONG
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
        cpu = Engine(path, device="cpu")
        tok, worst, ties, steps_cpu = 1, 0.0, 0, []
        eng.reset()
        for pos in range(8):
            lg, lc = eng.step(tok, pos), cpu.step(tok, pos)
            worst = max(worst, float(np.abs(lg - lc).max() / np.abs(lc).max()))
            ties += not greedy_agrees(f"{what} step {pos}", int(lg.argmax()), lc, TOL_STEP)
            steps_cpu.append((tok, lc))
            tok = int(lc.argmax())
        if worst > TOL_STEP:
            fail(f"{what}: logits differ from the CPU by {worst:.3e} > {TOL_STEP}")
        if fmt == "gf4" and not experts and not cohere:
            rot0 = unrotated_steps(eng, steps_cpu, what)
        eng.reset()
        cpu.reset()
        p_toks = eng.tokenizer.encode(prompt, bos=True)
        gen = same_generation(f"{what} generate", cpu, p_toks,
                              eng.generate(prompt, steps, temperature=0).ids,
                              cpu.generate(prompt, steps, temperature=0).ids, TOL_PREFILL)
        log(f"# {what} engine vs cpu: 8 steps, max logit diff {worst:.3e} of scale "
            f"(tol {TOL_STEP:g}), {ties} near-ties; generate {gen}")

        # batched prefill of > 100 tokens, then 8 greedy steps on each side
        toks = eng.tokenizer.encode(PROMPT_LONG, bos=True)
        eng.reset()
        cpu.reset()
        lg, lc = eng.prefill_tokens(toks), cpu.prefill_tokens(toks)
        ids, worst, ties = [], 0.0, 0
        for i in range(9):
            worst = max(worst, float(np.abs(lg - lc).max() / np.abs(lc).max()))
            if i == 8:
                break
            ties += not greedy_agrees(f"{what} greedy id {i} after prefill",
                                      int(lg.argmax()), lc, TOL_PREFILL)
            ids.append(int(lc.argmax()))
            pos = len(toks) + i
            lg, lc = eng.step(ids[-1], pos), cpu.step(ids[-1], pos)
        if not worst <= TOL_PREFILL:
            fail(f"{what}: logits after prefill differ from the CPU by {worst:.3e} "
                 f"> {TOL_PREFILL}")
        if light:
            log(f"# {what} prefill vs cpu: {len(toks)} tokens, then 8 steps: logits diff "
                f"{worst:.3e} of scale (tol {TOL_PREFILL:g}); next 8 greedy ids {ids}, "
                f"{ties} near-ties; container phase {time.perf_counter() - t0:.1f} s")
            del eng, cpu
            return counts, tokens, rot0
        pg, pc = eng.perplexity(PROMPT_LONG * 3), cpu.perplexity(PROMPT_LONG * 3)
        if not abs(pg[0] - pc[0]) <= 1e-2 * pc[0] or pg[2] != pc[2]:
            fail(f"{what}: perplexity {pg} != CPU {pc}")
        log(f"# {what} prefill vs cpu: {len(toks)} tokens, then 8 steps: logits diff "
            f"{worst:.3e} of scale (tol {TOL_PREFILL:g}); next 8 greedy ids {ids}, "
            f"{ties} near-ties; perplexity {pg[0]:.4f} ± {pg[1]:.4f} vs CPU "
            f"{pc[0]:.4f} ± {pc[1]:.4f} over {pg[2]} tokens (tol 1e-2 rel.)")

        for p, mode in zip(procs, ("generate", "-x", "-y")):
            out, errs = p.communicate(timeout=600)
            if p.returncode != 0:
                fail(f"{what} cli {mode} exited {p.returncode}: {errs[-2000:]}")
            if mode == "generate":
                log(f"# {what} cli: {out.splitlines()[0]} | {errs.strip().splitlines()[-1]}")
            elif mode == "-x":
                line = [l for l in out.splitlines() if l.startswith("# perplexity:")]
                if not line:
                    fail(f"{what} cli -x printed no perplexity line: {out[-1000:]}")
                log(f"# {what} cli -x: {line[0]}")
            elif "Assistant: " not in out:
                fail(f"{what} cli -y printed no reply: {out[-1000:]}")
            else:
                log(f"# {what} cli -y: {len(out)} characters, exit 0")
        t_serve = time.perf_counter()
        serving_checks(path, what, cpu, full=not (experts or cohere))
        http_check(httpd, what + (" paged" if http_args else ""))
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


def serving_checks(path, what, cpu, full=True):
    """``Server`` on the card, dense, paged (16-row pages, a pool of half
    the dense rows) and dense with the prefix cache (``full``; else dense
    and paged on the first two requests, greedy, 8 tokens each), each held
    to a CPU server on the same requests. The CPU server runs on ``cpu``'s
    weights with a slot for each request: a request's ids do not depend on
    the slot count, and the CPU's ticks, each a pass over all weights, are
    fewest so."""
    from calm_tpu_torch import model as M
    from calm_tpu_torch.engine import Engine
    from calm_tpu_torch.serve import Server

    reqs = SERVE_REQUESTS if full else [(p, 8, 0.0, s) for p, _, _, s in SERVE_REQUESTS[:2]]
    t0 = time.perf_counter()
    ref = Engine.from_weights(cpu.cfg, cpu.weights, cpu.tokenizer, n_bytes=cpu.n_bytes,
                              n_params=cpu.n_params, n_bandwidth=cpu.n_bandwidth,
                              batch=len(reqs), device="cpu")
    want, lcs = serve_recorded(Server(batch=len(reqs), engine=ref), reqs)
    log(f"# {what} serve: CPU server ({len(reqs)} slots) "
        f"{time.perf_counter() - t0:.1f} s, {sum(r.n_generated for r in want)} tokens")
    del ref
    rows = 4 * 4096 // 2 // 16
    modes = {"dense": {}, "paged": dict(page_rows=16, pool_pages=rows)}
    if full:
        modes["prefix"] = dict(prefix_cache_tokens=4096)
    for mode, kw in modes.items():
        srv = Server(path, batch=4, **kw)
        if mode == "paged":  # one tick: K12 in paged mode on every layer
            srv.submit("Hi", max_tokens=1)
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


def http_check(proc, what):
    """Health, a streamed and a plain greedy generate (the same text),
    stats, then SIGTERM: the server drains and exits 0."""
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
    if (health.get("status") != "ok" or not same_stream(streamed, plain["text"])
            or proc.returncode != 0
            or "# drained" not in errs or plain["tokens"] < 1):
        fail(f"{what} httpd: health {health}, plain {plain}, streamed {streamed!r}, "
             f"exit {proc.returncode}, stderr {errs[-2000:]}")
    log(f"# {what} httpd on port {m.group(1)}: health ok, generate {plain['tokens']} "
        f"tokens (streamed the same text), ttft {plain['ttft_ms']} ms; stats "
        f"{json.dumps(stats)}; SIGTERM drained, exit 0")


def profile_tokens(run, n_tok: int, ms_tok: float, label: str):
    """Device time per token by kernel, and the busy share against the
    unprofiled ms/tok."""
    rows = kernel_rows(run)
    if not rows:
        log(f"# profile {label}: the profiler saw no device time (not measured)")
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
    rotated path (K8) on the same weights. Returns the launch counts of
    that run, or None."""
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
    random = bool(experts) or cohere
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
            prefill()
        finally:
            M.route = real
        log(f"# prefill {what} T={T}: layer 0 routes its {T} tokens x 2 to the "
            f"{experts} experts as {routed[0]}")
    else:
        prefill()  # warm
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

    token = torch.zeros(1, dtype=torch.int64, device=dev)
    runs = [("first32", 0), ("last32", ctx - 2 * steps)]
    if fmt == "gf4" and not (experts or cohere):
        runs.append(("first32 CALM_ROT=0", 0))
    first, rot0, was = None, None, M.ROTATED_DECODE
    for name, pos0 in runs:
        unrotated = name.endswith("CALM_ROT=0")
        M.ROTATED_DECODE = not unrotated
        try:
            M.decode_loop(cfg, w, token, pos0, cache, 2)  # warm
            secs = []
            for _ in range(3):
                torch.cuda.synchronize()
                t = time.perf_counter()
                toks, cache, logits = M.decode_loop(cfg, w, token, pos0, cache, steps)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t)
            if unrotated:
                (toks, _, logits), rot0 = drive(
                    lambda: M.decode_loop(cfg, w, token, pos0, cache, steps))
            med = statistics.median(secs)
            profile_tokens(lambda: M.decode_loop(cfg, w, token, pos0, cache, 4), 4,
                           1e3 * med / steps, f"{what} {name} (pos {pos0})")
        finally:
            M.ROTATED_DECODE = was
        if not torch.isfinite(logits).all():
            fail(f"decode {what} {name}: non-finite logits")
        if name == "first32":
            first = (toks[0].tolist(), logits[:, 0].float().cpu().numpy())
        spread = 100 * (max(secs) - min(secs)) / med
        read = sum(bw + kv_cache_bytes(cfg, 16, pos0 + i) for i in range(steps))
        gb_s = read / 1e9 / med
        out[name] = dict(tok_s=steps / med, ms_tok=1e3 * med / steps, gb_s=gb_s,
                         pct_hbm=100 * gb_s / gbps, spread_pct=spread)
        if RATES["attainable"]:
            out[name]["pct_attainable"] = 100 * gb_s / RATES["attainable"]
        log(f"# decode {what} {name} (pos {pos0}): {steps / med:.2f} tok/s, "
            f"{1e3 * med / steps:.3f} ms/tok, {rate_share(gb_s)} "
            f"(median of 3, spread {spread:.2f}%) on {smi}")
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
    log(f"# {what}: " + json.dumps(out))
    del w, cache
    torch.cuda.empty_cache()
    return rot0


def full_width_serving_phase(dev, gbps, smi):
    """32-layer Mistral-7B fp8 with seeded random weights built in memory,
    bf16 KV, ctx 4096, 8 slots: 16 requests of seeded random bytes (one
    token a byte) of 128-1024 tokens, 64 greedy tokens each, submitted at
    once and drained, dense and then paged (512-row pages, a pool of half
    the dense rows); 3 drains each. Returns the launch counts of a paged
    drain."""
    from calm_tpu_torch import model as M
    from calm_tpu_torch.config import ModelConfig
    from calm_tpu_torch.engine import Engine, kv_cache_bytes
    from calm_tpu_torch.serve import Server
    from calm_tpu_torch.tokenizer import Tokenizer
    from calm_tpu_torch.utils.synth import byte_vocab, synth_weights, weight_bytes

    ctx, B, n_req, n_gen = 4096, 8, 16, 64
    cfg = ModelConfig(**MISTRAL, rope_theta=10000.0, seq_len=ctx, rotary_dim=128,
                      norm_ln=False, dtype="fp8", bos_token_id=1, eos_token_id=2)
    t0 = time.perf_counter()
    w = synth_weights(cfg, seed=0, device=dev, random=True)
    total, bw = weight_bytes(cfg)
    tokenizer = Tokenizer.from_tensors(*byte_vocab(cfg.vocab_size), 1, 2, cfg.vocab_size)
    rng = np.random.default_rng(0)
    prompts = ["".join(chr(c) for c in rng.integers(97, 123, n))
               for n in rng.integers(128, 1025, n_req)]
    log(f"# serve fp8 mistral7b: 32 layers, {total / 2**30:.2f} GiB random weights in "
        f"{time.perf_counter() - t0:.1f} s; bf16 KV, ctx {ctx}, {B} slots, {n_req} "
        f"requests of {min(map(len, prompts)) + 1}-{max(map(len, prompts)) + 1} "
        f"tokens, {n_gen} greedy tokens each")

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
            t = time.perf_counter()
            real()
            ticks.append((time.perf_counter() - t, admits, kv))
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

    out, ids, seen = {}, {}, {}
    paged_counts = None
    for mode, kw in (("dense", {}), ("paged", dict(page_rows=512, pool_pages=32))):
        srv = Server(batch=B, engine=engine(), **kw)
        # a first drain, warm, keeps each request's ids and logits
        reqs, seen[mode] = serve_recorded(srv, [(p, n_gen, 0.0, 1) for p in prompts])
        ids[mode] = [r.ids for r in reqs]
        runs = []
        for _ in range(3):
            if mode == "paged" and paged_counts is None:
                (reqs, wall, ticks), paged_counts = drive(lambda: drain(srv))
            else:
                reqs, wall, ticks = drain(srv)
            runs.append((wall, reqs, ticks))
        walls = [r[0] for r in runs]
        n_tok = sum(r.n_generated for r in runs[0][1])
        dec = [t for r in runs for t in r[2] if t[1] == 0]  # decode-only ticks
        tick_ms = [1e3 * statistics.median(t[0] for t in r[2] if t[1] == 0) for r in runs]
        med = statistics.median(tick_ms)
        gbs = statistics.median((bw + kv) / dt / 1e9 for dt, _, kv in dec)
        ttft = sorted(1e3 * (r.first_token_at - r.submitted_at) for r in runs[0][1])
        # busy share: device time of 10 decode ticks against their unprofiled time
        for p in prompts[:B]:
            srv.submit(p, max_tokens=n_gen, temperature=0.0)
        srv.tick()  # admits all eight
        rows = kernel_rows(lambda: [srv.tick() for _ in range(10)])
        srv.run_until_drained()
        dev_ms = sum(r[0] for r in rows) / 1e3 / 10 if rows else None
        busy = "not measured" if dev_ms is None else (
            f"device {dev_ms:.3f} ms/tick = busy {100 * dev_ms / med:.1f}%; " + "; ".join(
                f"{name} {us / 1e4:.3f} ms x{cnt / 10:g}" for us, cnt, name in rows[:6]))
        wall = statistics.median(walls)
        out[mode] = dict(wall_s=wall, tok_s=n_tok / wall, tick_ms=med,
                         tick_spread_pct=100 * (max(tick_ms) - min(tick_ms)) / med,
                         ttft_p50_ms=statistics.median(ttft), ttft_max_ms=ttft[-1],
                         gb_s=gbs, busy_pct=None if dev_ms is None else 100 * dev_ms / med)
        log(f"# serve fp8 mistral7b {mode}: drain {wall:.3f} s (median of 3, "
            f"{min(walls):.3f}-{max(walls):.3f}), {n_tok} tokens, {n_tok / wall:.1f} tok/s "
            f"over {B} slots; decode tick {med:.3f} ms (median of each run's median: "
            f"{', '.join(f'{x:.3f}' for x in tick_ms)}; spread "
            f"{out[mode]['tick_spread_pct']:.2f}%); TTFT p50 {statistics.median(ttft):.1f} ms, "
            f"max {ttft[-1]:.1f} ms; {rate_share(gbs)} per decode tick (weights + live "
            f"KV); {busy} on {smi}")
        del srv
        torch.cuda.empty_cache()

    # paged against dense: the same ids, and logits the same kernels give
    split, worst = [], 0.0
    for i, (a, b) in enumerate(zip(ids["paged"], ids["dense"])):
        n = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), len(a))
        for lg, lc in zip(seen["paged"][i][:n], seen["dense"][i][:n]):
            worst = max(worst, float(np.abs(lg - lc).max() / np.abs(lc).max()))
        if n < len(a) or len(a) != len(b):
            split.append(f"{i}: " + same_served(f"serve paged request {i}", a, b, 0.0,
                                                seen["paged"][i], seen["dense"][i], TOL_STEP))
    if worst > TOL_STEP:
        fail(f"serve: paged logits differ from dense by {worst:.3e} > {TOL_STEP}")
    for i in (0, 7):  # and two requests against a single-stream run
        toks = tokenizer.encode(prompts[i], bos=True)
        cache = M.KVCache.create(cfg, 1, torch.bfloat16, dev)
        M.prefill(cfg, w, torch.tensor([toks[:-1]], device=dev), [0], cache, "none")
        st, _, lg = M.decode_loop(cfg, w, torch.tensor([toks[-1]], device=dev),
                                  len(toks) - 1, cache, len(ids["dense"][i]))
        want = st[0].tolist()
        got = ids["dense"][i]
        n = next((j for j, (x, y) in enumerate(zip(got, want)) if x != y), None)
        if n is not None:
            greedy_agrees(f"serve request {i} vs single stream, id {n}", got[n],
                          lg[n, 0].float().cpu().numpy(), TOL_PREFILL)
        log(f"# serve request {i} ({len(toks)} tokens) against prefill + decode_loop: "
            + ("ids equal" if n is None else f"equal up to {n}, then a near-tie")
            + f" ({len(set(got))} distinct of {len(got)}: {got[:8]}...)")
        del cache
    distinct = len({t for r in ids["dense"] for t in r})
    if distinct < 2:
        fail("serve: every request generated one id")
    log(f"# serve fp8 mistral7b paged vs dense: {n_req - len(split)} of {n_req} requests "
        f"with equal ids ({distinct} distinct ids in all), their logits within {worst:.3e} "
        f"of scale (tol {TOL_STEP:g}); split: {split or 'none'}; " + json.dumps(out))
    del w
    torch.cuda.empty_cache()
    return paged_counts


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
    build_s = build.build_all()
    gbps = info.hbm_gbps or 3350.0
    log(f"# probe: {smi}; torch {info.torch_version} cuda {info.cuda_version} "
        f"{info.sm} HBM {info.hbm_bytes} B, nominal {gbps:.0f} GB/s; nvcc "
        f"{info.nvcc}; kernel build {build_s:.2f} s; {ptxas_summary(build)}")
    if info.sm != "sm_90":
        fail(f"the kernels are built for sm_90a, this card is {info.sm}")
    dev = torch.device("cuda")

    RATES["nominal"] = gbps
    rows = kernel_phase(gbps, dev)
    log(f"# kernel phase done at {time.perf_counter() - t_start:.1f} s")
    # the tools' chains are K1's and K15's main path; the 3 GB rows give the
    # attainable read rate every later GB/s is also read against
    counts_tools = tools_phase(smi)
    log(f"# tools done at {time.perf_counter() - t_start:.1f} s")
    # each kernel's launches come from the main path that uses it: the fp8
    # decode path (K2, K9, K12), the gf4 prefill + decode path (K3, K4, K5,
    # K8, K13) and its CALM_ROT=0 decode (K7); each container is then served
    # (Server, httpd)
    counts8, tok8, _ = container_phase("fp8", dev)
    counts4, tok4, counts_rot0 = container_phase("gf4", dev)
    # the parallel-norm (Cohere) paths: gf4 prefill + decode (K6)
    counts4c, tok4c, _ = container_phase("gf4", dev, cohere=True)
    container_phase("fp8", dev, cohere=True)
    # and the MoE paths: fp8 decode (K10), gf4 decode (K11)
    counts8m, tok8m, _ = container_phase("fp8", dev, experts=4)
    counts4m, tok4m, _ = container_phase("gf4", dev, experts=4)
    log(f"# container phases done at {time.perf_counter() - t_start:.1f} s")
    for experts, cohere in ((0, False), (0, True), (EXPERTS, False)):
        for fmt in ("fp8", "gf4"):
            full_width_phase(fmt, dev, gbps, smi, experts, cohere)
            log(f"# full-width {fmt} {experts} experts{' aya23-8b' if cohere else ''} "
                f"done at {time.perf_counter() - t_start:.1f} s")
    # the paged serving path: K12 in paged mode
    counts_pg = full_width_serving_phase(dev, gbps, smi)
    log(f"# full-width serving done at {time.perf_counter() - t_start:.1f} s")

    sources = {"qmm_decode": ("calm_tpu_torch/csrc/qmm.cu",
                              "calm_tpu/ops/pallas_qmm.py:92", counts8),
               "qx_offn_qkv": ("calm_tpu_torch/csrc/qmm.cu",
                               "calm_tpu/ops/pallas_qmm.py:942", counts8),
               "decode_attention": ("calm_tpu_torch/csrc/attn.cu",
                                    "calm_tpu/ops/pallas_attn.py:77", counts8),
               "decode_attention_paged": ("calm_tpu_torch/csrc/attn.cu",
                                          "calm_tpu/ops/pallas_attn.py:77", counts_pg),
               "prefill_attention": ("calm_tpu_torch/csrc/attn.cu",
                                     "calm_tpu/ops/pallas_attn.py:326", counts4),
               "qmm_decode_gf4": ("calm_tpu_torch/csrc/gf4.cu",
                                  "calm_tpu/ops/pallas_qmm.py:100", counts4),
               "qmm_prefill": ("calm_tpu_torch/csrc/gf4.cu",
                               "calm_tpu/ops/pallas_qmm.py:238", counts4),
               "qmm_prefill_w2": ("calm_tpu_torch/csrc/gf4.cu",
                                  "calm_tpu/ops/pallas_qmm.py:346", counts4),
               "gf4_offn_qkv": ("calm_tpu_torch/csrc/qmm.cu",
                                "calm_tpu/ops/pallas_qmm.py:737", counts4),
               "qmm_moe_dense": ("calm_tpu_torch/csrc/moe.cu",
                                 "calm_tpu/ops/pallas_qmm.py:1248", counts8m),
               "gf4_moe_ffn": ("calm_tpu_torch/csrc/moe.cu",
                               "calm_tpu/ops/pallas_qmm.py:1361", counts4m),
               "gf4_ffn": ("calm_tpu_torch/csrc/qmm.cu",
                           "calm_tpu/ops/pallas_qmm.py:464", counts4c),
               "gf4_offn": ("calm_tpu_torch/csrc/qmm.cu",
                            "calm_tpu/ops/pallas_qmm.py:601", counts_rot0),
               "stream_sum": ("calm_tpu_torch/csrc/stream.cu",
                              "tools/dma_ceiling.py:26", counts_tools),
               "gf4_decode_sum": ("calm_tpu_torch/csrc/stream.cu",
                                  "tools/gf4_bound.py:55", counts_tools)}
    kernels = []
    for name, (src, rep, counts) in sources.items():
        if counts[name] <= 0:
            fail(f"{name} was not launched on its main path")
        r = rows[name]
        kernels.append(dict(name=name, route="cuda", source=src, replaces=rep,
                            launches=counts[name], max_abs_err=r["max_abs_err"],
                            ms=r["ms"], plain_ms=r["plain_ms"],
                            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                            library_ms=r["library_ms"], timed_by=r["timed_by"]))
    log(f"# main paths: fp8 {tok8} positions, gf4 {tok4}, gf4 Aya-width {tok4c}, fp8 "
        f"MoE {tok8m}, gf4 MoE {tok4m}; total "
        f"{time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
