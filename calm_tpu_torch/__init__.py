"""calm_tpu_torch: the PyTorch/CUDA port of calm-tpu for NVIDIA Hopper.

A second package beside ``calm_tpu`` (the JAX reference, which it never
imports). Plain tensor code is PyTorch; every Pallas kernel on the decode
path has a hand-written CUDA C++ counterpart for ``sm_90a`` under
``csrc/``, compiled with ``nvcc`` at first use (``ops/build.py``).

Importing the package touches no GPU and builds nothing.
"""

__version__ = "0.1.0"

from calm_tpu_torch.config import ModelConfig  # noqa: F401
