"""The plain reference: the decoder's forward pass in float32 PyTorch, with
TF32 off, no kernel, no cache and no batching.

It follows the published Mistral / Mixtral layer as the calm container
stores it: RMSNorm (epsilon inside the square root), q/k/v, RoPE on
interleaved pairs (the container undoes Hugging Face's head permutation,
so its rotate-half becomes pairs (2i, 2i+1)) at theta from the
configuration, causal attention with grouped KV heads and scale
1/sqrt(head_dim), wo and the residual; a second RMSNorm, then SwiGLU
(silu(w1 x) * w3 x, then w2), or for a MoE layer the router's softmax
over its top-2 logits (ties to the lower expert) and the two experts'
SwiGLU outputs weighted by it; a final RMSNorm and the untied lm-head.

The weights are the benchmark's (``benchmark.weights``), made again from
the seed one layer at a time and widened from fp8 to f32 exactly. It runs
layer by layer over every sequence at once, so that each layer is made
once, and attention in blocks of query rows, so that it fits beside
nothing else on the card.

Two controls, each the reference computed in the precision below one
that the configuration states: ``control="kv_fp8"`` rounds K (after
RoPE) and V to fp8 e5m2 before attention reads them (below the cache's
bf16); ``control="w4"`` rounds every matrix to 4 bits (below the
weights' fp8): symmetric, one absmax scale a group of 32 along the
contraction, as a 4-bit format of calm's kind stores them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark import weights as W

CONTROLS = (None, "kv_fp8", "w4")
W4_GROUP = 32
Q_BLOCK = 512    # query rows a block of attention
HEAD_BLOCK = 1024  # rows a block of lm-head logits


def _f32(w: torch.Tensor, control) -> torch.Tensor:
    """A stored matrix widened to f32, or under ``control="w4"`` rounded
    to 4 bits first."""
    w = w.float()
    if control != "w4":
        return w
    g = w.reshape(*w.shape[:-1], w.shape[-1] // W4_GROUP, W4_GROUP)
    s = g.abs().amax(-1, keepdim=True) / 7.0
    q = torch.where(s > 0, torch.clamp(torch.round(g / s), -8, 7) * s, g)
    return q.reshape(w.shape)


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _rope(x: torch.Tensor, d: W.Dims) -> torch.Tensor:
    """Rotate interleaved pairs of x (T, heads, head_dim) by position t."""
    t = torch.arange(x.shape[0], dtype=torch.float64, device=x.device)
    j = torch.arange(0, d.head_dim, 2, dtype=torch.float64, device=x.device)
    ang = t[:, None] * (1.0 / d.rope_theta ** (j / d.head_dim))
    c = torch.cos(ang).float()[:, None, :]
    s = torch.sin(ang).float()[:, None, :]
    x0, x1 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x0 * c - x1 * s, x0 * s + x1 * c], dim=-1).reshape(x.shape)


def _attention(q, k, v, d: W.Dims) -> torch.Tensor:
    """Causal attention of q (T, H, hd) over k, v (T, KVH, hd)."""
    T = q.shape[0]
    rep = d.heads // d.kv_heads
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    out = torch.empty_like(q)
    scale = 1.0 / math.sqrt(d.head_dim)
    for a in range(0, T, Q_BLOCK):
        b = min(T, a + Q_BLOCK)
        s = torch.einsum("thd,shd->hts", q[a:b], k[:b]) * scale
        rows = torch.arange(a, b, device=q.device)
        mask = torch.arange(b, device=q.device)[None, :] > rows[:, None]
        s.masked_fill_(mask[None], float("-inf"))
        out[a:b] = torch.einsum("hts,shd->thd", torch.softmax(s, dim=-1), v[:b])
    return out


def _swiglu(x, w1, w3, w2, control) -> torch.Tensor:
    h = F.silu(x @ _f32(w1, control).T) * (x @ _f32(w3, control).T)
    return h @ _f32(w2, control).T


def _moe(x, lw, d: W.Dims, control) -> torch.Tensor:
    gate = x @ _f32(lw["moegate"], control).T
    vals, idx = torch.sort(gate, dim=-1, descending=True, stable=True)
    k = d.experts_per_token
    wts, idx = torch.softmax(vals[:, :k], dim=-1), idx[:, :k]
    out = torch.zeros_like(x)
    for e in range(d.experts):
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel():
            y = _swiglu(x[rows], lw["w1"][e], lw["w3"][e], lw["w2"][e], control)
            out.index_add_(0, rows, y * wts[rows, slot, None])
    return out


def _layer(x: torch.Tensor, lw: dict, d: W.Dims, control) -> torch.Tensor:
    T = x.shape[0]
    xb = _rms(x, lw["attn_norm"], d.norm_eps)
    q = _rope((xb @ _f32(lw["wq"], control).T).reshape(T, d.heads, d.head_dim), d)
    k = _rope((xb @ _f32(lw["wk"], control).T).reshape(T, d.kv_heads, d.head_dim), d)
    v = (xb @ _f32(lw["wv"], control).T).reshape(T, d.kv_heads, d.head_dim)
    if control == "kv_fp8":
        k = k.to(torch.float8_e5m2).float()
        v = v.to(torch.float8_e5m2).float()
    att = _attention(q, k, v, d).reshape(T, d.q_dim)
    x = x + att @ _f32(lw["wo"], control).T
    xb2 = _rms(x, lw["ffn_norm"], d.norm_eps)
    if d.experts:
        return x + _moe(xb2, lw, d, control)
    return x + _swiglu(xb2, lw["w1"], lw["w3"], lw["w2"], control)


@torch.no_grad()
def logits_at(d: W.Dims, seed: int, seqs: list[list[int]], rows: list[list[int]],
              device, control=None) -> list[torch.Tensor]:
    """For each token sequence, the f32 logits (len(rows[i]), V) at the
    positions rows[i]: the logits there predict the token after."""
    if control not in CONTROLS:
        raise ValueError(f"unknown control {control!r}")
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        g = W.globals_(d, seed, device)
        embed = _f32(g["embed"], control)
        xs = [embed[torch.tensor(s, device=device)] for s in seqs]
        del embed
        del g
        for l in range(d.layers):
            lw = W.layer(d, seed, l, device)
            xs = [_layer(x, lw, d, control) for x in xs]
            del lw
        g = W.globals_(d, seed, device)
        head = _f32(g["output"], control)
        out = []
        for x, r in zip(xs, rows):
            xn = _rms(x[torch.tensor(r, device=device)], g["final_norm"], d.norm_eps)
            out.append(torch.cat([xn[a:a + HEAD_BLOCK] @ head.T
                                  for a in range(0, xn.shape[0], HEAD_BLOCK)]))
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
