"""Device selection and the card's capabilities.

Entry points run on ``cuda`` unless the caller asks for the CPU; nothing
falls back to the CPU when no GPU is present. :func:`probe` reports what
the measurement lines need: card name, SM version, HBM bytes, torch/CUDA
versions, ``nvcc`` presence and the nominal HBM rate used for bounds.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import subprocess

import torch

# nominal HBM read rate (GB/s) by card name (NVIDIA data sheets); longest
# matching substring wins, so "H100 NVL" and "H100 PCIe" beat "H100"
HBM_GBPS = {
    "H100 NVL": 3900.0,
    "H100 PCIe": 2000.0,
    "H100": 3350.0,       # SXM
    "H200": 4800.0,
}


class NoGPUError(RuntimeError):
    pass


def pick(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else cuda.
    Raises when cuda is asked for and no GPU is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoGPUError(
            "no CUDA GPU available; pass device='cpu' (CALM_CPU=1 for the "
            "CLI) to run the plain PyTorch path on the CPU")
    return dev


def hbm_gbps(name: str) -> float | None:
    best = None
    for key, rate in HBM_GBPS.items():
        if key in name and (best is None or len(key) > len(best[0])):
            best = (key, rate)
    return best[1] if best else None


def nvcc_path() -> str | None:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    return shutil.which("nvcc")


def smi_name_power() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=30)
    return out.stdout.strip().splitlines()[0]


@dataclasses.dataclass(frozen=True)
class DeviceInfo:
    name: str
    sm: str
    hbm_bytes: int
    hbm_gbps: float | None
    torch_version: str
    cuda_version: str | None
    nvcc: str | None


def probe(index: int = 0) -> DeviceInfo:
    pick("cuda")
    p = torch.cuda.get_device_properties(index)
    return DeviceInfo(
        name=p.name, sm=f"sm_{p.major}{p.minor}", hbm_bytes=p.total_memory,
        hbm_gbps=hbm_gbps(p.name), torch_version=torch.__version__,
        cuda_version=torch.version.cuda, nvcc=nvcc_path())
