"""The gf4 decode ceiling, measured on the card (the port of
``tools/gf4_bound.py``).

    python -m calm_tpu_torch.tools.gf4_bound

Four rates over one 16384 x 4096 gf4 matrix (16384 x 512 words, 33.5 MB),
by the slope of chains of 16, 48 and 80 calls, each call's seed the
previous call's result (chains captured as CUDA graphs and timed with
CUDA events, as ``dma_ceiling``):

  dma     the streaming read alone (``stream_sum``, K1's kernel);
  decode  the decode of all 8 planes of every word, summed
          (``gf4_decode_sum``, K15), without and with a bf16 round trip
          of each plane;
  dot     the production gf4 matvec (``qmm_decode_gf4``, K3), its x
          perturbed by the seed so that the calls stay distinct.

If decode ~= dot the matvec is bound by the decode; if dot is much
slower, by what feeds the products. ``td`` is the TPU tool's row tile,
printed so that the lines pair with its output. On an H100 the 33.5 MB
matrix fits in the 50 MB L2 cache, so these rates are L2's, not HBM's:
``dma_ceiling``'s 3 GB lines give the HBM read rate. Needs a CUDA GPU:
without one it exits 1 ("no CUDA GPU").
"""

from __future__ import annotations

import numpy as np
import torch

from calm_tpu_torch.ops.hopper_qmm import qmm_decode_gf4
from calm_tpu_torch.ops.hopper_stream import gf4_decode_sum, stream_sum
from calm_tpu_torch.tools.dma_ceiling import require_gpu, time_chain


def rnd_gf4(rng, shape) -> torch.Tensor:
    """Random codes under an e5m2 scale byte of 0x30, as the TPU tool's."""
    w = rng.integers(0, 2**31, shape, dtype=np.int64).astype(np.uint32)
    w = (w & ~np.uint32(0xFF)) | np.uint32(0x30)
    return torch.from_numpy(w.view(np.int32))


def main() -> list[dict]:
    """Print the tool's lines; returns the rows (what, td, us, gb_s)."""
    require_gpu("gf4_bound")
    rng = np.random.default_rng(0)
    d, n = 16384, 4096
    w = rnd_gf4(rng, (1, d, n // 8)).cuda()
    mb = w.numel() * 4 / 1e6
    x = torch.from_numpy(rng.standard_normal((1, n)).astype(np.float32)).cuda()
    out = []

    def slope(call, n1=16, n2=80):
        ts = {k: time_chain(call, k) for k in (n1, 48, n2)}
        per = (ts[n2] - ts[n1]) / (n2 - n1) / 1e3
        mid = (ts[48] - ts[n1]) / (48 - n1) / 1e3
        print(f"    [t16={ts[n1]:.2f} t48={ts[48]:.2f} t80={ts[n2]:.2f} ms; "
              f"mid-slope {mid * 1e6:.1f} us]", flush=True)
        return per, mb * 1e6 / per / 1e9

    def row(what, td, per, rate, note=""):
        print(f"{what:<6} td={td}: {per * 1e6:7.1f} us  {rate:5.0f} GB/s{note}", flush=True)
        out.append(dict(what=what + note, td=td, us=per * 1e6, gb_s=rate))

    # td does not change the port's kernels: each rate is timed once and
    # printed on both of the TPU tool's td lines
    dma = slope(lambda s: stream_sum(w, s))
    dec = {full: slope(lambda s, full=full: gf4_decode_sum(w, s, full))
           for full in (False, True)}
    for td in (2048, 4096):
        row("dma", td, *dma)
    for td in (2048, 4096):
        row("decode", td, *dec[False], " (no bf16 cast)")
        row("decode", td, *dec[True], " (with bf16 round-trip)")

    def dot_call(s):
        return qmm_decode_gf4(x + s, w, 0)[:, :1].reshape(1) * 1e-30
    per, rate = slope(dot_call)
    print(f"dot          : {per * 1e6:7.1f} us  {rate:5.0f} GB/s (gf4 matvec, K3)",
          flush=True)
    out.append(dict(what="dot", td=None, us=per * 1e6, gb_s=rate))
    return out


if __name__ == "__main__":
    main()
