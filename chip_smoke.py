"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from ``calm_tpu_torch/csrc``, holds each
against its plain PyTorch version at Mistral-7B shapes and times it
beside its bound, drives ``Engine.generate`` and the CLI on a 2-layer
Mistral-7B-width fp8 container (checked against the CPU plain path), runs
the 32-layer Mistral-7B fp8 decode protocol of ``bench.py``, and ends with
a ``kernels`` JSON line and ``{"ok": true, "device": ...}``. Any failure
exits non-zero before the last line; without a GPU it exits 1 at once.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import torch

PEAK_F32 = 67e12  # H100 SXM, f32 outside the tensor cores (NVIDIA data sheet)
MISTRAL = dict(dim=4096, hidden_dim=14336, head_dim=128, n_layers=32,
               n_heads=32, n_kv_heads=8, vocab_size=32000)
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


def timed(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device ms per call: the summed duration of the kernels that
    ``iters`` calls launch, so that the host's own pace (Python and
    wrapper checks between launches) does not enter."""
    for i in range(warmup):
        fn(i)

    def run():
        for i in range(iters):
            fn(i)
    rows = kernel_rows(run)
    if not rows:
        fail("the profiler saw no device time")
    return sum(r[0] for r in rows) / 1e3 / iters


def bound_ms(nbytes: float, ops: float, gbps: float) -> tuple[float, str]:
    tb, to = nbytes / (gbps * 1e9) * 1e3, ops / PEAK_F32 * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def rand_w(shape, fmt, dev):
    if fmt == "fp8":  # small finite e5m2 (exponent <= 7), random sign
        b = torch.randint(0, 256, shape, device=dev, dtype=torch.int32) & 0x9F
        return b.to(torch.uint8).view(torch.float8_e5m2)
    return (torch.randn(shape, device=dev) * 0.02).half()


def max_err(got, want):
    if isinstance(got, (tuple, list)):
        return max(max_err(g, w) for g, w in zip(got, want))
    return (got.float() - want.float()).abs().max().item()


def scale_of(want):
    if isinstance(want, (tuple, list)):
        return max(scale_of(w) for w in want)
    return want.float().abs().max().item()


def check(name, got, want, rel_tol):
    err, sc = max_err(got, want), scale_of(want)
    if not err <= rel_tol * sc:
        fail(f"{name}: max_abs_err {err:.3e} > {rel_tol:g} * {sc:.3e}")
    return err


def kernel_phase(gbps, dev):
    """Each kernel against its plain version, and timed, at 7B shapes."""
    import torch.nn.functional as F

    from calm_tpu_torch.ops import hopper_attn as ha
    from calm_tpu_torch.ops import hopper_qmm as hq
    from calm_tpu_torch.ops.qmm import QTensor, dequant

    rows = {}
    D, H, Qd, KVd, V = 4096, 14336, 4096, 1024, 32000
    tol_mv = 1e-5  # f32 sums in both, in another order: rel. to max |y|

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
                              hq.qmm_decode_plain(x, w, fmt, L - 1), tol_mv))
            ms = timed(lambda i: hq.qmm_decode(x, w, fmt, i % L))
            plain = timed(lambda i: hq.qmm_decode_plain(x, w, fmt, i % L), 5, 1)
            wb = dequant(QTensor(w, fmt), torch.bfloat16)
            lib = timed(lambda i: torch.matmul(x.bfloat16(), wb[i % L].T))
            b, by = bound_ms(d * D * esz + 4 * (D + d), 2 * d * D, gbps)
            log(f"# K2 qmm_decode {fmt} {name} {d}x{D} B=1: max_abs_err "
                f"{errs[-1]:.3e} (tol {tol_mv:g} x max|y|); kernel_ms {ms:.4f} "
                f"plain_ms {plain:.4f} library_ms {lib:.4f} (bf16 matmul) "
                f"bound_ms {b:.4f} ({by}); {100 * b / ms:.1f}% of bound")
            if fmt == "fp8" and name == "lm-head":
                best = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b,
                            bound_by=by)
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
                                     False), tol_mv))
        ms = timed(lambda i: hq.qx_offn_qkv(a, r, g, anx, *ws, i % L, fmt,
                                            False, 1e-5, False))
        plain = timed(lambda i: hq.qx_offn_qkv_plain(
            a, r, g, anx, *ws, i % L, fmt, False, 1e-5, False), 5, 1)
        wb = [dequant(QTensor(w, fmt), torch.bfloat16) for w in ws]

        def chain(i):  # the same function as bf16 torch.matmul calls
            l = i % L
            r1 = r + torch.matmul(a.bfloat16(), wb[0][l].T)
            xn = (r1 * torch.rsqrt(r1.pow(2).mean(-1, keepdim=True) + 1e-5) * g[l]).bfloat16()
            h = F.silu(torch.matmul(xn, wb[1][l].T)) * torch.matmul(xn, wb[2][l].T)
            x = r1 + torch.matmul(h, wb[3][l].T)
            xq = (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-5) * anx[l]).bfloat16()
            return [torch.matmul(xq, w[l].T) for w in wb[4:]]
        chain_ms = timed(chain)
        n_w = D * Qd + 3 * H * D + (Qd + 2 * KVd) * D
        b, by = bound_ms(n_w * esz + 4 * (3 * D + 2 * Qd + 2 * KVd), 2 * n_w, gbps)
        log(f"# K9 qx_offn_qkv {fmt} one layer D={D} H={H} Qd={Qd} KVd={KVd} "
            f"B=1: max_abs_err {max(errs):.3e} (tol {tol_mv:g} x max|out|); "
            f"kernel_ms {ms:.4f} plain_ms {plain:.4f} bf16_matmul_chain_ms "
            f"{chain_ms:.4f} bound_ms {b:.4f} ({by}, {n_w * esz / 1e6:.1f} MB); "
            f"{100 * b / ms:.1f}% of bound")
        if fmt == "fp8":
            best = dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=b,
                        bound_by=by)
    rows["qx_offn_qkv"] = dict(best, max_abs_err=max(errs))

    # K12 decode_attention, fresh mode: kv_len 32 and 4096, bf16 and fp8 KV
    errs, best = [], None
    tol_at = 1e-4  # absolute; outputs are O(1)
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
            if not e <= tol_at:
                fail(f"decode_attention {kvname} kv_len {kv_len}: {e:.3e} > {tol_at}")
            errs.append(e)
            ms = timed(lambda i: ha.decode_attention(q, kc, vc, kl, i % L, fr))
            plain = timed(lambda i: ha.decode_attention_plain(q, kc, vc, kl, i % L, fr), 5, 1)
            kb, vb = kc.bfloat16(), vc.bfloat16()
            q4 = q.reshape(B, KVH * M, 1, hd).bfloat16()
            lib = timed(lambda i: F.scaled_dot_product_attention(
                q4, kb[i % L, :, :, :kv_len], vb[i % L, :, :, :kv_len],
                enable_gqa=True))
            nb = 2 * KVH * kv_len * hd * esz + 2 * KVH * hd * esz + 8 * B * KVH * M * hd
            b, by = bound_ms(nb, 4 * KVH * M * kv_len * hd, gbps)
            log(f"# K12 decode_attention fresh {kvname} KV kv_len {kv_len} "
                f"(B=1, KVH=8, M=4, hd=128, S=4096): max_abs_err {e:.3e} "
                f"(tol {tol_at:g}); kernel_ms {ms:.4f} plain_ms {plain:.4f} "
                f"library_ms {lib:.4f} (bf16 SDPA) bound_ms {b:.4f} ({by}); "
                f"{100 * b / ms:.1f}% of bound")
            if kvname == "bf16" and kv_len == 4096:
                best = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b,
                            bound_by=by)
    rows["decode_attention"] = dict(best, max_abs_err=max(errs))
    ragged_checks(dev)
    return rows


def ragged_checks(dev):
    """The kernels' other template paths, which the B=1 Mistral-7B path
    does not reach, against their plain versions at small shapes: 3 and 16
    activation rows with a ragged last block of rows; the fused epilogue at
    B=2 and 5 with GELU and LayerNorm over a 3-layer stack; attention in
    plain and fresh mode at B=2 with per-row kv_len, head_dim 64 and 128,
    8 and 16 query rows per kv head, every cache dtype."""
    from calm_tpu_torch.ops import hopper_attn as ha
    from calm_tpu_torch.ops import hopper_qmm as hq

    worst = {"qmm_decode": 0.0, "qx_offn_qkv": 0.0, "decode_attention": 0.0}
    for fmt in ("fp8", "fp16"):
        w = rand_w((2, 1003, 1040), fmt, dev)  # 1003 rows: a ragged last block
        for B in (3, 16):
            x = torch.randn(B, 1040, device=dev)
            e = check(f"qmm_decode {fmt} B={B}", hq.qmm_decode(x, w, fmt, 1),
                      hq.qmm_decode_plain(x, w, fmt, 1), 1e-5)
            worst["qmm_decode"] = max(worst["qmm_decode"], e)
        L, D, H, Qd, KVd = 3, 512, 768, 512, 128
        ws = [rand_w(s, fmt, dev) for s in ((L, D, Qd), (L, H, D), (L, H, D),
                                             (L, D, H), (L, Qd, D), (L, KVd, D),
                                             (L, KVd, D))]
        g = 1 + 0.1 * torch.randn(L, D, device=dev)
        anx = 1 + 0.1 * torch.randn(L, D, device=dev)
        for B in (2, 5):
            a, r = torch.randn(B, Qd, device=dev), torch.randn(B, D, device=dev)
            for layer in range(L):
                args = (a, r, g, anx, *ws, layer, fmt, True, 1e-5, True)
                e = check(f"qx_offn_qkv {fmt} B={B} layer {layer}",
                          hq.qx_offn_qkv(*args), hq.qx_offn_qkv_plain(*args), 1e-5)
                worst["qx_offn_qkv"] = max(worst["qx_offn_qkv"], e)
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
                if not e <= 1e-4:
                    fail(f"decode_attention {kvd} hd={hd} M={M} "
                         f"fresh={fresh is not None}: {e:.3e} > 1e-4")
                worst["decode_attention"] = max(worst["decode_attention"], e)
    torch.cuda.synchronize()
    log("# ragged shapes: max_abs_err " + ", ".join(
        f"{k} {v:.3e}" for k, v in worst.items()))


def engine_phase(dev):
    """Engine + CLI on a 2-layer Mistral-7B-width fp8 container, held
    against the CPU plain path. Returns (launch counts, tokens)."""
    import numpy as np

    from calm_tpu_torch.config import ModelConfig
    from calm_tpu_torch.engine import Engine
    from calm_tpu_torch.ops import hopper_attn as ha
    from calm_tpu_torch.ops import hopper_qmm as hq
    from calm_tpu_torch.utils.synth import synth_container

    cfg = ModelConfig(**dict(MISTRAL, n_layers=2), seq_len=4096,
                      rope_theta=10000.0, rotary_dim=128, norm_ln=False,
                      dtype="fp8", bos_token_id=1, eos_token_id=2)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mistral7b-width-2l-fp8.calm")
        t0 = time.perf_counter()
        # random bits, not the bit pattern: the pattern's rows are all alike
        synth_container(path, cfg, seed=1, device=dev, random=True)
        log(f"# engine: wrote {os.path.getsize(path) / 1e9:.2f} GB container "
            f"in {time.perf_counter() - t0:.1f} s")
        eng = Engine(path)
        log(eng.banner())
        prompt = "The quick brown fox"

        # the main path: counts from 0 just before, read just after
        hq.qmm_decode.launches = hq.qx_offn_qkv.launches = 0
        ha.decode_attention.launches = 0
        s1 = eng.generate(prompt, 32, temperature=0)
        torch.cuda.synchronize()
        counts = {"qmm_decode": hq.qmm_decode.launches,
                  "qx_offn_qkv": hq.qx_offn_qkv.launches,
                  "decode_attention": ha.decode_attention.launches}
        tokens = s1.tokens
        eng.reset()
        s2 = eng.generate(prompt, 32, temperature=0)
        log(s1.perf_line())
        log(s2.perf_line())
        if s1.logits_hash != s2.logits_hash or s1.ids != s2.ids:
            fail("two greedy generations differ")
        if tokens < 8 or len(set(s1.ids)) < 2:
            fail(f"degenerate generation: {tokens} tokens, ids {s1.ids}")
        log(f"# engine: {tokens} tokens, ids {s1.ids[:12]}..., launches {counts}"
            f" = {[round(c / tokens, 2) for c in counts.values()]} per token")

        r = subprocess.run([sys.executable, "-m", "calm_tpu_torch.cli", path,
                            "-t", "0", "-n", "16", "-i", "hello"], cwd=ROOT,
                           capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            fail(f"cli exited {r.returncode}: {r.stderr[-2000:]}")
        log(f"# cli: {r.stdout.splitlines()[0]} | {r.stderr.strip().splitlines()[-1]}")

        # the whole slice on the card against the plain path on the CPU
        cpu = Engine(path, device="cpu")
        tol = 1e-3  # rel. to max |logit|: f32 sums in another order, bf16 KV
        tok, worst = 1, 0.0
        eng.reset()
        for pos in range(8):
            lg, lc = eng.step(tok, pos), cpu.step(tok, pos)
            worst = max(worst, float(np.abs(lg - lc).max() / np.abs(lc).max()))
            if int(lg.argmax()) != int(lc.argmax()):
                fail(f"greedy id differs from the CPU at step {pos}")
            tok = int(lg.argmax())
        if worst > tol:
            fail(f"logits differ from the CPU by {worst:.3e} > {tol}")
        eng.reset()
        cpu.reset()
        steps = len(eng.tokenizer.encode(prompt, bos=True)) + 8  # 8 past the prompt
        g_ids = eng.generate(prompt, steps, temperature=0).ids
        c_ids = cpu.generate(prompt, steps, temperature=0).ids
        if g_ids != c_ids or len(g_ids) < 8:
            fail(f"greedy ids {g_ids} != CPU {c_ids}")
        log(f"# engine vs cpu: 8 steps, greedy ids equal ({g_ids}), max logit "
            f"diff {worst:.3e} of scale (tol {tol:g})")
        del eng, cpu
    return counts, tokens


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
    log(f"# profile {label}: device {dev_ms:.3f} ms/tok of {ms_tok:.3f} ms/tok "
        f"= busy {100 * dev_ms / ms_tok:.1f}%; per token: {top}")


def decode_phase(dev, gbps, smi):
    """bench.py's protocol on 32-layer Mistral-7B fp8 pattern weights."""
    from calm_tpu_torch import model as M
    from calm_tpu_torch.config import ModelConfig
    from calm_tpu_torch.engine import kv_cache_bytes
    from calm_tpu_torch.utils.synth import synth_weights, weight_bytes

    ctx, steps = 4096, 32
    cfg = ModelConfig(**MISTRAL, seq_len=ctx, rope_theta=10000.0,
                      rotary_dim=128, norm_ln=False, dtype="fp8")
    t0 = time.perf_counter()
    w = synth_weights(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    total, bw = weight_bytes(cfg)
    log(f"# decode: mistral7b fp8 32 layers, {total / 2**30:.2f} GiB pattern "
        f"weights in {time.perf_counter() - t0:.1f} s; bf16 KV, ctx {ctx}")
    cache = M.KVCache.create(cfg, 1, torch.bfloat16, dev)
    token = torch.zeros(1, dtype=torch.int64, device=dev)
    out = {}
    for name, pos0 in (("first32", 0), ("last32", ctx - 2 * steps)):
        M.decode_loop(cfg, w, token, pos0, cache, 2)  # warm
        secs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            toks, cache, logits = M.decode_loop(cfg, w, token, pos0, cache, steps)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
        if not torch.isfinite(logits).all():
            fail(f"decode {name}: non-finite logits")
        med = statistics.median(secs)
        spread = 100 * (max(secs) - min(secs)) / med
        read = sum(bw + kv_cache_bytes(cfg, 16, pos0 + i) for i in range(steps))
        gb_s = read / 1e9 / med
        out[name] = dict(tok_s=steps / med, ms_tok=1e3 * med / steps, gb_s=gb_s,
                         pct_hbm=100 * gb_s / gbps, spread_pct=spread)
        log(f"# decode {name} (pos {pos0}): {steps / med:.2f} tok/s, "
            f"{1e3 * med / steps:.3f} ms/tok, {gb_s:.1f} GB/s = "
            f"{100 * gb_s / gbps:.2f}% of nominal {gbps:.0f} GB/s "
            f"(median of 3, spread {spread:.2f}%) on {smi}")
        profile_tokens(lambda: M.decode_loop(cfg, w, token, pos0, cache, 4), 4,
                       1e3 * med / steps, f"{name} (pos {pos0})")
    log("# decode: " + json.dumps(out))
    del w, cache


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

    rows = kernel_phase(gbps, dev)
    counts, tokens = engine_phase(dev)
    decode_phase(dev, gbps, smi)

    sources = {"qmm_decode": ("calm_tpu_torch/csrc/qmm.cu",
                              "calm_tpu/ops/pallas_qmm.py:92"),
               "qx_offn_qkv": ("calm_tpu_torch/csrc/qmm.cu",
                               "calm_tpu/ops/pallas_qmm.py:942"),
               "decode_attention": ("calm_tpu_torch/csrc/attn.cu",
                                    "calm_tpu/ops/pallas_attn.py:77")}
    kernels = []
    for name, (src, rep) in sources.items():
        if counts[name] <= 0:
            fail(f"{name} was not launched on the main path")
        r = rows[name]
        kernels.append(dict(name=name, route="cuda", source=src, replaces=rep,
                            launches=counts[name], max_abs_err=r["max_abs_err"],
                            ms=r["ms"], plain_ms=r["plain_ms"],
                            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                            library_ms=r["library_ms"]))
    log(f"# main path: {tokens} tokens; total {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
