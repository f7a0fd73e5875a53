"""Interleaved (complex-pair) RoPE with partial rotary dimension.

Rotation acts on interleaved pairs (v[2i], v[2i+1]) within each head (the
container stores Q/K with HF's head permutation reversed); pairs at offsets
>= rotary_dim pass through unrotated. Not HF's rotate-half.
"""

from __future__ import annotations

import torch


def rope_tables(pos: torch.Tensor, head_dim: int, theta: float,
                rotary_dim: int):
    """(cos, sin) tables for integer positions ``pos``, shaped
    pos.shape + (head_dim // 2,), float32 on pos's device."""
    j = torch.arange(0, head_dim, 2, dtype=torch.float32, device=pos.device)
    freq = torch.where(
        j < rotary_dim,
        # a fill, not a copy from the host: no sync on the decode path
        1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                   device=pos.device), j / rotary_dim),
        torch.zeros((), dtype=torch.float32, device=pos.device))
    angles = pos.to(torch.float32)[..., None] * freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(v: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate v (..., n_heads, head_dim) by tables shaped
    v.shape[:-2] + (head_dim // 2,)."""
    hd = v.shape[-1]
    c = cos[..., None, :]
    s = sin[..., None, :]
    vf = v.float().reshape(*v.shape[:-1], hd // 2, 2)
    v0, v1 = vf[..., 0], vf[..., 1]
    out = torch.stack([v0 * c - v1 * s, v0 * s + v1 * c], dim=-1)
    return out.reshape(v.shape).to(v.dtype)
