"""Flash-decode attention on Hopper: the port of pallas_attn's decode kernel.

:func:`decode_attention` replaces ``_attn_body``
(``calm_tpu/ops/pallas_attn.py:77``) in its plain and fresh modes; the
kernel lives in ``csrc/attn.cu``. The wrapper takes the plain PyTorch
version (:func:`decode_attention_plain`, f32) for tensors on the CPU, and
launches the kernel for CUDA tensors or raises; it counts its launches in
``decode_attention.launches``.
"""

from __future__ import annotations

import math

import torch

from calm_tpu_torch.ops import build

_KV_CODE = {torch.float16: 0, torch.bfloat16: 1, torch.float8_e5m2: 2}
_TARGET_BLOCKS = 264  # two blocks per SM on a 132-SM H100


def decode_attention_plain(q, k_cache, v_cache, kv_len, layer, fresh=None):
    B, H, hd = q.shape
    KVH, S = k_cache.shape[2], k_cache.shape[3]
    M = H // KVH
    scale = 1.0 / math.sqrt(hd)
    qg = q.float().reshape(B, KVH, M, hd)
    kc = k_cache[int(layer)].float()                     # (B, KVH, S, hd)
    vc = v_cache[int(layer)].float()
    scores = torch.einsum("bkmh,bksh->bkms", qg, kc) * scale
    col = torch.arange(S, device=q.device)
    live = col[None, :] < kv_len.to(q.device).long()[:, None]   # (B, S)
    if fresh is not None:
        fk, fv, kv_pos = fresh                            # (B, KVH, hd), (B,)
        live = live & (col[None, :] != kv_pos.to(q.device).long()[:, None])
        fs = (qg * fk.float()[:, :, None, :]).sum(-1, keepdim=True) * scale
        scores = torch.cat([fs, scores], dim=-1)
        vc = torch.cat([fv.float()[:, :, None, :], vc], dim=2)
        live = torch.cat([torch.ones_like(live[:, :1]), live], dim=1)
    scores = scores.masked_fill(~live[:, None, None, :], float("-inf"))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bkms,bksh->bkmh", p, vc).reshape(B, H, hd)


def _chunk_rows(B: int, KVH: int, S: int) -> int:
    """Rows per block: enough blocks to fill the card, at least 64 rows."""
    want = max(1, -(-_TARGET_BLOCKS // (B * KVH)))
    cs = 64
    while cs * want < S:
        cs *= 2
    return cs


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def decode_attention(q, k_cache, v_cache, kv_len, layer, fresh=None):
    """q (B, H, hd) f32; caches (L, B, KVH, S, hd) in bf16/fp16/fp8-e5m2
    with ``layer`` selecting the plane; kv_len (B,) int32 -> (B, H, hd) f32.

    ``fresh`` = (fresh_k (B, KVH, hd) in the cache dtype, fresh_v, kv_pos
    (B,) int32): the current token's rows join the softmax directly and the
    stale cache row kv_pos is masked (deferred-write decode)."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, kv_len, layer, fresh)
    B, H, hd = q.shape
    L, Bc, KVH, S, hd_c = k_cache.shape
    _check(q.dtype == torch.float32 and q.is_contiguous(), "q must be contiguous float32")
    _check(k_cache.dtype in _KV_CODE and v_cache.dtype == k_cache.dtype,
           f"no CUDA kernel for a {k_cache.dtype} cache")
    _check(tuple(v_cache.shape) == tuple(k_cache.shape) and Bc == B and hd_c == hd,
           "cache shape mismatch")
    _check(k_cache.is_contiguous() and v_cache.is_contiguous(), "caches must be contiguous")
    _check(hd in (64, 128), "the attention kernel takes head_dim 64 or 128")
    _check(H % KVH == 0 and H // KVH <= 16, "the attention kernel takes <= 16 query rows per kv head")
    _check(0 <= int(layer) < L, f"layer {layer} out of range for {L}")
    _check(kv_len.dtype == torch.int32 and tuple(kv_len.shape) == (B,)
           and kv_len.device == q.device, "kv_len must be (B,) int32 on the card")
    for t in (k_cache, v_cache, kv_len):
        _check(t.device == q.device, "all inputs must be on one device")
    fk = fv = kv_pos = None
    if fresh is not None:
        fk, fv, kv_pos = fresh
        for t in (fk, fv):
            _check(t.dtype == k_cache.dtype and tuple(t.shape) == (B, KVH, hd)
                   and t.is_contiguous() and t.device == q.device,
                   "fresh rows must be contiguous (B, KVH, hd) in the cache dtype")
        _check(kv_pos.dtype == torch.int32 and tuple(kv_pos.shape) == (B,)
               and kv_pos.device == q.device, "kv_pos must be (B,) int32 on the card")
    M = H // KVH
    cs = _chunk_rows(B, KVH, S)
    nc = -(-S // cs)
    dev = q.device
    pacc = torch.empty((B, KVH, nc, M, hd), dtype=torch.float32, device=dev)
    pm = torch.empty((B, KVH, nc, M), dtype=torch.float32, device=dev)
    pl = torch.empty((B, KVH, nc, M), dtype=torch.float32, device=dev)
    out = torch.empty((B, H, hd), dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = build.lib("attn").calm_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), kv_len.data_ptr(),
        ptr(fk), ptr(fv), ptr(kv_pos), pacc.data_ptr(), pm.data_ptr(),
        pl.data_ptr(), out.data_ptr(), B, KVH, M, S, hd, int(layer), cs,
        _KV_CODE[k_cache.dtype], torch.cuda.current_stream(dev).cuda_stream)
    build.check("attn", rc)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
