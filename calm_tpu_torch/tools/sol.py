"""Speed-of-light roofline of decode on a GPU (the port of
``tools/sol.py``).

    python -m calm_tpu_torch.tools.sol                  # preset sweep on every card
    python -m calm_tpu_torch.tools.sol --model mistral7b --dtype fp8 --ctx 8192 -v
    python -m calm_tpu_torch.tools.sol --sweep-ctx      # context sweep table
    python -m calm_tpu_torch.tools.sol --scaling        # analytic tp/ep/dp scaling

Per (model, card) it computes bytes and operations a token from the
model's geometry (``profiler.stage_bytes``, ``step_flops``), takes latency
>= max(bytes / HBM rate, operations / peak) against the card's data-sheet
rates (``device.HBM_GBPS``, ``profiler.PEAKS``) and prints the SoL tokens
a second and where the bytes go. Arithmetic only: it runs anywhere.
"""

from __future__ import annotations

import argparse

from calm_tpu_torch.config import ModelConfig
from calm_tpu_torch.device import HBM_GBPS
from calm_tpu_torch.parallel.mesh import Topology
from calm_tpu_torch.profiler import roofline, stage_bytes

# a copy of tools/sol.py's PRESETS
PRESETS = {
    "tinyllama": dict(dim=2048, hidden_dim=5632, head_dim=64, n_layers=22,
                      n_heads=32, n_kv_heads=4, vocab_size=32000),
    "llama2-7b": dict(dim=4096, hidden_dim=11008, head_dim=128, n_layers=32,
                      n_heads=32, n_kv_heads=32, vocab_size=32000),
    "mistral7b": dict(dim=4096, hidden_dim=14336, head_dim=128, n_layers=32,
                      n_heads=32, n_kv_heads=8, vocab_size=32000),
    "llama3-8b": dict(dim=4096, hidden_dim=14336, head_dim=128, n_layers=32,
                      n_heads=32, n_kv_heads=8, vocab_size=128256),
    "llama2-13b": dict(dim=5120, hidden_dim=13824, head_dim=128, n_layers=40,
                       n_heads=40, n_kv_heads=40, vocab_size=32000),
    "yi-34b": dict(dim=7168, hidden_dim=20480, head_dim=128, n_layers=60,
                   n_heads=56, n_kv_heads=8, vocab_size=64000),
    "mixtral8x7b": dict(dim=4096, hidden_dim=14336, head_dim=128, n_layers=32,
                        n_heads=32, n_kv_heads=8, vocab_size=32000,
                        n_experts=8, n_experts_ac=2),
}

# HBM capacity in GB of each card of device.HBM_GBPS (NVIDIA H100 and H200
# data sheets)
HBM_GB = {"H100 NVL": 94.0, "H100 PCIe": 80.0, "H100": 80.0, "H200": 141.0}
CARDS = {k: (HBM_GB[k], HBM_GBPS[k]) for k in HBM_GBPS}  # card -> (GB, GB/s)
DEFAULT_CARD = "H100"  # SXM, the card this port is built for

# --scaling's analytic model, not a measurement: a card's NVLink rate in
# one direction, GB/s (the data sheets' bidirectional 900 GB/s for SXM,
# 600 for the PCIe and NVL bridges, halved); the network between hosts
# (one 400 Gb/s NIC a card); a collective's launch and hop latency, us.
NVLINK_GBPS = {"H100 NVL": 300.0, "H100 PCIe": 300.0, "H100": 450.0, "H200": 450.0}
NET_GBPS = 50.0
COLL_LAT_US = {"nvlink": 2.0, "net": 25.0}


def make_cfg(name: str, dtype: str, ctx: int) -> ModelConfig:
    shape = dict(PRESETS[name])
    return ModelConfig(**shape, seq_len=ctx, rope_theta=10000.0,
                       norm_ln=False, dtype=dtype,
                       rotary_dim=shape["head_dim"])


def topo_for(card: str) -> Topology:
    gb, gbps = CARDS[card]
    return Topology(1, card, gb, gbps)


def report_one(model: str, dtype: str, ctx: int, pos: int, kv_bits: int,
               card: str, verbose: bool):
    cfg = make_cfg(model, dtype, ctx)
    r = roofline(cfg, kv_bits, pos, topo_for(card))
    tok_s = 1000.0 / r.sol_ms_per_token
    print(f"{model:>12} {dtype:>4} ctx={ctx:<6} pos={pos:<6} {card:>12}: "
          f"SoL {tok_s:7.1f} tok/s  ({r.bytes_per_token / 1e9:.2f} GB/tok, "
          f"{r.bound}-bound)")
    if verbose:
        stages = stage_bytes(cfg, kv_bits, pos)
        total = sum(stages.values())
        for name, b in sorted(stages.items(), key=lambda kv: -kv[1]):
            print(f"    {name:<14} {b / 1e6:9.2f} MB/tok ({100 * b / total:4.1f}%)")


def scaling_report(model: str, dtype: str, ctx: int, pos: int, kv_bits: int, card: str):
    """Analytic decode scaling over tp (NVLink inside a host) and a 2-host
    dp/ep split (the network), as ``tools/sol.py:82-140`` models it over
    ICI and DCN: per card time = the one-card SoL / n plus, a layer, two
    psums of the f32 activation row, each a latency and its ring bytes."""
    cfg = make_cfg(model, dtype, ctx)
    t1 = roofline(cfg, kv_bits, pos, topo_for(card)).sol_ms_per_token
    act_bytes = cfg.dim * 4  # f32 activation row psummed per residual close
    link = NVLINK_GBPS[card]
    print(f"# analytic decode scaling — {model} {dtype} ctx={ctx} on {card}"
          f" (1-card SoL {1000.0 / t1:.1f} tok/s)")

    for n in (2, 4, 8):
        # tp over NVLink: weights and kv shard n ways; 2 psums a layer
        coll = 2 * cfg.n_layers * (COLL_LAT_US["nvlink"] / 1e3
                                   + act_bytes * (n - 1) / n / (link * 1e6))
        tn = t1 / n + coll
        eff = t1 / (n * tn) * 100.0
        # rs_ag: the bound where the all-gather half overlaps fully
        coll_ov = 2 * cfg.n_layers * (COLL_LAT_US["nvlink"] / 1e3
                                      + 0.5 * act_bytes * (n - 1) / n / (link * 1e6))
        tn_ov = t1 / n + coll_ov
        eff_ov = t1 / (n * tn_ov) * 100.0
        print(f"  tp={n} (NVLink): {1000.0 / tn:7.1f} tok/s/stream, "
              f"scaling efficiency {eff:5.1f}% "
              f"(rs_ag overlap bound: {1000.0 / tn_ov:.1f} tok/s, "
              f"{eff_ov:.1f}%)")

    if cfg.n_experts:
        coll = cfg.n_layers * (COLL_LAT_US["net"] / 1e3 + act_bytes / (NET_GBPS * 1e6))
        t2 = t1 / 2 + coll
        eff = t1 / (2 * t2) * 100.0
        tgt = "meets" if eff >= 80.0 else "MISSES"
        print(f"  ep=2 x 1 host each (network): {1000.0 / t2:7.1f} tok/s/stream, "
              f"efficiency {eff:5.1f}% — {tgt} the >=80% BASELINE target "
              f"(analytic)")
    print("  dp=2 hosts (network): 2x aggregate tokens/s at unchanged latency "
          "(no per-layer collectives; efficiency ~100%)")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m calm_tpu_torch.tools.sol")
    ap.add_argument("--model", choices=sorted(PRESETS), default=None)
    ap.add_argument("--dtype", choices=["fp16", "fp8", "fp8e4", "gf4"], default="fp8")
    ap.add_argument("--ctx", type=int, default=4096)
    ap.add_argument("--pos", type=int, default=None,
                    help="decode position (default ctx-1)")
    ap.add_argument("--kv-bits", type=int, default=16, choices=[8, 16])
    ap.add_argument("--chip", choices=sorted(CARDS), default=None,
                    help="the card (default: every card of the table)")
    ap.add_argument("--sweep-ctx", action="store_true",
                    help="sweep context 2k..128k for one model/card")
    ap.add_argument("--scaling", action="store_true",
                    help="analytic tp/ep/dp scaling-efficiency report")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="per-stage byte breakdown")
    args = ap.parse_args(argv)

    pos = args.pos if args.pos is not None else args.ctx - 1
    cards = [args.chip] if args.chip else sorted(CARDS)
    models = [args.model] if args.model else sorted(PRESETS)

    if args.scaling:
        scaling_report(args.model or "mixtral8x7b",
                       args.dtype if args.model else "gf4",
                       args.ctx, pos, args.kv_bits, args.chip or DEFAULT_CARD)
        return

    if args.sweep_ctx:
        model = args.model or "mistral7b"
        card = args.chip or DEFAULT_CARD
        for ctx in (2048, 4096, 8192, 16384, 32768, 65536, 131072):
            kv_bits = 8 if ctx > 4096 else args.kv_bits
            report_one(model, args.dtype, ctx, ctx - 1, kv_bits, card, args.verbose)
        return

    for card in cards:
        for model in models:
            report_one(model, args.dtype, args.ctx, pos, args.kv_bits, card, args.verbose)


if __name__ == "__main__":
    main()
