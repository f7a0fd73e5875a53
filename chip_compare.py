"""Times another tree's gf4 matvecs with this tree's checks.

    python3 chip_compare.py <directory holding another checkout's calm_tpu_torch> [--mixtral | --prefill | --precise | --verify | --wide]

Puts that directory first on ``sys.path``, builds its kernels, and runs
``chip_smoke.multirow_kernel_rows_gf4_decode`` (K3 on the Aya 23 8B
lm-head and a q plane, K7 on one Mistral-7B layer, at B = 4, 8, 16),
``chip_smoke.onerow_kernel_rows_gf4`` (K8, K7 and K6 at one row on
Mistral-7B widths, K6 also at B = 8, each split by launch) and
``chip_smoke.moe_multirow_kernel_rows`` (K10 and K11 at B = 8 on Mixtral
8x7B shapes in 8 expert slots, 8 and 7 live; on a tree without
``qmm_moe_ffn`` the fp8 expert FFN is its three ``qmm_moe_dense`` calls),
every row checked against its plain version and timed beside its bound
and library call, on that tree's wrappers. With ``--mixtral`` it also runs
``chip_smoke.full_width_phase`` on the 16-layer Mixtral 8x7B, fp8 and gf4
(prefill, decode and the 8-slot serving drains) on that tree. With
``--prefill`` it times only the 2048-token prefill of the 32-layer fp8
Mistral-7B (the bit-pattern weights, bf16 KV; median of 10 by the host
clock, the card synchronised around each). With ``--precise`` it runs
only ``chip_smoke.precise_kernel_rows`` (K2 fp8/fp8e4 and K3 gf4 at B = 8
on the lm-head under the quality mode, beside the default call and the
f32 matmul) and ``chip_smoke.precise_short_prefill`` (a 17-token prompt's
prefill of that Mistral-7B under ``--precise`` beside the default's): on
an older tree they time whatever its quality mode takes at 2-16 rows.
With ``--verify`` it runs only ``chip_smoke.verify_kernel_rows`` (K13 at a
speculative verify's T = 1-5, B = 1, 2 and 8, and the draft tree's
attention at 10 and 13 nodes, each beside its plain version, SDPA and T
launches of K12): on a tree without the split-S route it times the
persistent kernel and the tree's plain attention. With ``--wide`` it runs
only the products of 17-64 rows: ``chip_smoke.wide_kernel_rows`` (K2
fp8/fp16/fp8e4 and K3 gf4 on the Mistral-7B lm-head, the expert FFN on
Mixtral 8x7B and OLMoE widths, at 24, 40 and 64 rows), the served verify of
the 32-layer fp8 Mistral-7B (B = 8, T = 5, replayed, against its eager
forward bit for bit; ``chip_smoke.verify_bits``) and a 32-slot tick of it
(``chip_smoke.tick_wide``, with the parent commit's route beside).
Run it before and after
``chip_smoke.py`` in one call on the card to compare two commits there, or
on two trees in turns (A, B, B, A). Needs a GPU.
"""

import importlib.util
import json
import os
import sys


def main():
    if len(sys.argv) not in (2, 3) or sys.argv[2:] not in ([], ["--mixtral"], ["--prefill"],
                                                            ["--precise"], ["--verify"],
                                                            ["--wide"]):
        sys.exit(__doc__)
    pkg = os.path.abspath(sys.argv[1])
    sys.path.insert(0, pkg)
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_compare: no CUDA GPU available")
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(here, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import calm_tpu_torch
    from calm_tpu_torch import device
    from calm_tpu_torch.ops import build

    if not calm_tpu_torch.__file__.startswith(pkg + os.sep):
        sys.exit(f"chip_compare: calm_tpu_torch came from {calm_tpu_torch.__file__}, not {pkg}")
    cs.log(f"# {calm_tpu_torch.__file__} on {device.smi_name_power()}; kernel build "
           f"{build.build_all():.1f} s")
    dev = torch.device("cuda")
    if sys.argv[2:] == ["--prefill"]:
        cs.log(json.dumps(prefill_ms(cs, dev)))
        return
    if sys.argv[2:] == ["--verify"]:
        rows = cs.verify_kernel_rows(3350.0, dev)["verify_rows"]
        cs.log(json.dumps({k: {f: v[f] for f in ("ms", "plain_ms", "library_ms", "bound_ms")}
                           for k, v in rows.items()}))
        return
    if sys.argv[2:] == ["--precise"]:
        rows = cs.precise_kernel_rows(3350.0, dev)
        cfg, w, cache, prompt = mistral_fp8(cs, dev)
        rows["prefill 17-token --precise"] = cs.precise_short_prefill(
            cfg, w, cache, prompt, device.smi_name_power())
        cs.log(json.dumps(rows))
        return
    if sys.argv[2:] == ["--wide"]:
        cs.log(json.dumps(wide(cs, dev, device.smi_name_power())))
        return
    rows = cs.multirow_kernel_rows_gf4_decode(3350.0, dev)
    rows.update(cs.onerow_kernel_rows_gf4(3350.0, dev))
    rows.update(cs.moe_multirow_kernel_rows(3350.0, dev))
    cs.log(json.dumps(rows))
    if sys.argv[2:] == ["--mixtral"]:
        smi = device.smi_name_power()
        for fmt in ("fp8", "gf4"):
            cs.full_width_phase(fmt, dev, 3350.0, smi, cs.EXPERTS)


def mistral_fp8(cs, dev):
    """The 32-layer fp8 Mistral-7B of ``chip_smoke.full_width_phase`` on
    this tree (the bit-pattern weights, bf16 KV, ctx 4096) and its
    2048-token prompt: (cfg, weights, cache, prompt)."""
    import torch

    from calm_tpu_torch import model as M
    from calm_tpu_torch.config import ModelConfig
    from calm_tpu_torch.utils.synth import synth_weights

    cfg = ModelConfig(**cs.MISTRAL, rope_theta=10000.0, seq_len=4096, rotary_dim=128,
                      dtype="fp8", norm_ln=False)
    w = synth_weights(cfg, seed=0, device=dev)
    cache = M.KVCache.create(cfg, 1, torch.bfloat16, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    prompt = torch.randint(3, cfg.vocab_size, (1, 2048), generator=gen, device=dev)
    return cfg, w, cache, prompt


def wide(cs, dev, smi) -> dict:
    """The products of 17-64 rows on this tree: the wide rows (ms, library,
    the parent's route, bound), the fp8 Mistral-7B served verify of 8 x 5
    rows (replayed and eager ms) and its 32-slot tick (ms a step)."""
    import numpy as np
    import torch

    from calm_tpu_torch import model as M
    from calm_tpu_torch.config import ModelConfig
    from calm_tpu_torch.utils.synth import synth_weights

    rows = cs.wide_kernel_rows(3350.0, dev)
    out = {k: {f: v[f] for f in ("ms", "library_ms", "route_ms", "bound_ms") if f in v}
           for k, v in rows.items() if "ms" in v}
    cfg = ModelConfig(**cs.MISTRAL, rope_theta=10000.0, seq_len=4096, rotary_dim=128,
                      dtype="fp8", norm_ln=False, bos_token_id=1, eos_token_id=2)
    w = synth_weights(cfg, seed=0, device=dev, random=True)
    B, T = 8, cs.GAMMA + 1
    cache = M.KVCache.create(cfg, B, torch.bfloat16, dev)
    toks = np.random.default_rng(3).integers(3, cfg.vocab_size, (B, T))
    v_ms, e_ms = cs.verify_bits("served verify", cfg, w, cache, toks,
                                [300 + 400 * b for b in range(B)])
    cs.log(f"# fp8 mistral7b served verify B={B} T={T}: replayed {v_ms:.3f} ms, eager "
           f"{e_ms:.3f} ms, bit-equal, on {smi}")
    out["verify"] = dict(replayed_ms=v_ms, eager_ms=e_ms)
    del cache
    torch.cuda.empty_cache()
    out["tick32"] = cs.tick_wide(cfg, w, dev, smi)
    return out


def prefill_ms(cs, dev) -> dict:
    """The 2048-token prefill of the 32-layer fp8 Mistral-7B on this tree:
    ms by the host clock (median, min, max of 10 after 3 warm)."""
    import statistics
    import time

    import torch

    from calm_tpu_torch import model as M

    cfg, w, cache, prompt = mistral_fp8(cs, dev)
    for _ in range(3):
        M.prefill(cfg, w, prompt, [0], cache, "last")
    ts = []
    for _ in range(10):
        torch.cuda.synchronize()
        t = time.perf_counter()
        M.prefill(cfg, w, prompt, [0], cache, "last")
        torch.cuda.synchronize()
        ts.append(1e3 * (time.perf_counter() - t))
    return {"prefill_fp8_mistral7b_T2048_ms": statistics.median(ts), "min": min(ts),
            "max": max(ts)}


if __name__ == "__main__":
    main()
