"""Tensor ops of the port: plain PyTorch references and the Hopper kernels
beside them (``hopper_*``, built by ``build``)."""
