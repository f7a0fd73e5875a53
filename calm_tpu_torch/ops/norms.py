"""Normalization: RMSNorm, and bias-free LayerNorm as RMSNorm with the mean
subtracted first; epsilon inside the square root (``calm_tpu.ops.norms``)."""

from __future__ import annotations

import torch


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float,
            subtract_mean: bool = False) -> torch.Tensor:
    """Normalize the last axis and scale by weight, in float32."""
    xf = x.float()
    if subtract_mean:
        xf = xf - xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)
