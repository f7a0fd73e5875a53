"""Times another tree's gf4 matvecs with this tree's checks.

    python3 chip_compare.py <directory holding another checkout's calm_tpu_torch> [--mixtral]

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
(prefill, decode and the 8-slot serving drains) on that tree. Run it
before and after ``chip_smoke.py`` in one call on the card to compare two
commits there. Needs a GPU.
"""

import importlib.util
import json
import os
import sys


def main():
    if len(sys.argv) not in (2, 3) or sys.argv[2:] not in ([], ["--mixtral"]):
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
    rows = cs.multirow_kernel_rows_gf4_decode(3350.0, dev)
    rows.update(cs.onerow_kernel_rows_gf4(3350.0, dev))
    rows.update(cs.moe_multirow_kernel_rows(3350.0, dev))
    cs.log(json.dumps(rows))
    if sys.argv[2:] == ["--mixtral"]:
        smi = device.smi_name_power()
        for fmt in ("fp8", "gf4"):
            cs.full_width_phase(fmt, dev, 3350.0, smi, cs.EXPERTS)


if __name__ == "__main__":
    main()
