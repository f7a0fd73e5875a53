"""Quantization quality: per-tensor error and end-to-end logit drift (the
port of ``tools/quality.py``).

1. each format's SNR and max error over weight-like N(0, 0.02) values,
   quantized and dequantized by the port's ``quant`` (the format math,
   reference encode tools/convert.py:245-268);
2. the logit drift of a synthetic model written at fp16/fp8/fp8e4/gf4
   (``utils.modelgen``) against its f32 oracle (``utils.oracle``): six
   greedy-forced ``model.decode_step`` calls, on the card's kernels on a
   GPU and on the plain PyTorch path under ``CALM_CPU=1``.

The drift model is the one its header names: ``--layers`` layers of width
``--dim``, head dim 64, ffn width 2 x dim, 272-piece vocab, every format
alike (``tools/quality.py`` prints the flags but builds
``tests/modelgen.tiny_config``'s defaults, head dim 12, which the card's
attention kernels do not take). Without a GPU (and without
``CALM_CPU=1``) it exits 1.

Usage: python -m calm_tpu_torch.tools.quality [--dim 256] [--layers 4]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

from calm_tpu_torch import quant

FORMATS = ("fp16", "fp8", "fp8e4", "gf4")
TOKENS = [1, 5, 9, 200, 42, 7]


def format_snr():
    rng = np.random.default_rng(0)
    print("# format error on N(0, 0.02) weights (typical trained scale):")
    w = (rng.standard_normal((512, 512)) * 0.02).astype(np.float32)
    for fmt in FORMATS:
        q, s = quant.quantize_scaled(w, fmt)
        deq = np.asarray(quant.dequantize(q, fmt, s), np.float32)
        err = deq - w
        snr = 10 * np.log10(np.mean(w * w) / max(np.mean(err * err), 1e-30))
        rel = np.abs(err).max() / np.abs(w).max()
        bits = quant.dtype_bits(fmt)
        print(f"  {fmt:>5} ({bits:2d} bpw): SNR {snr:6.1f} dB, "
              f"max |err| {rel * 100:5.2f}% of max |w|")


def drift_config(fmt: str, dim: int, layers: int):
    from calm_tpu_torch.utils.modelgen import tiny_config

    return tiny_config(dtype=fmt, dim=dim, hidden_dim=2 * dim, head_dim=64,
                       rotary_dim=64, n_heads=dim // 64, n_kv_heads=max(1, dim // 128),
                       n_layers=layers, vocab_size=272)


def logit_drift(dim: int, layers: int, device) -> dict:
    """Print one line a format; returns {fmt: (max rel drift, argmax
    agreements)}."""
    from calm_tpu_torch import model as M
    from calm_tpu_torch.container import TensorFile
    from calm_tpu_torch.utils.modelgen import write_tiny_model
    from calm_tpu_torch.utils.oracle import Oracle

    print(f"# end-to-end logit drift, synthetic {layers}-layer dim-{dim} "
          f"model, 6-token greedy decode vs f32 oracle:")
    out = {}
    with tempfile.TemporaryDirectory() as d:
        for fmt in FORMATS:
            cfg = drift_config(fmt, dim, layers)
            path = os.path.join(d, f"{fmt}.calm")
            write_tiny_model(path, cfg, seed=5)
            tf = TensorFile(path)
            w = M.load_weights(tf, cfg, device)
            oracle = Oracle(tf, cfg)

            cache = M.KVCache.create(cfg, 1, torch.float16, device)
            drifts, agree = [], 0
            for pos, t in enumerate(TOKENS):
                got, cache = M.decode_step(cfg, w, torch.tensor([t], device=device),
                                           pos, cache)
                got = got[0].float().cpu().numpy()
                want = oracle.forward(t, pos)
                drifts.append(np.abs(got - want).max() / max(np.abs(want).max(), 1e-9))
                agree += int(got.argmax() == want.argmax())
            out[fmt] = (float(max(drifts)), agree)
            print(f"  {fmt:>4}: max rel logit drift "
                  f"{100 * max(drifts):5.2f}%, argmax agreement "
                  f"{agree}/{len(TOKENS)} (drift here is engine-vs-oracle "
                  f"numerics; quantization loss is in the oracle too)")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m calm_tpu_torch.tools.quality")
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    args = ap.parse_args(argv)
    cpu = os.environ.get("CALM_CPU", "0") == "1"
    if not cpu and not torch.cuda.is_available():
        print("quality: no CUDA GPU available (CALM_CPU=1 runs on the CPU)", file=sys.stderr)
        sys.exit(1)
    format_snr()
    return logit_drift(args.dim, args.layers, torch.device("cpu" if cpu else "cuda"))


if __name__ == "__main__":
    main()
