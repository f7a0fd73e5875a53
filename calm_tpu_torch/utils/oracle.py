"""Serial numpy oracle of the calm forward pass (the port's copy of
``tests/oracle.py``, over the port's ``config`` and ``quant``).

A deliberately naive transcription of the reference semantics
(src/infer.c:311-472): one token at a time, per-head loops, f32
activations, an fp16 KV cache. The quality tool holds the engine's logits
to it.
"""

from __future__ import annotations

import math

import numpy as np

from calm_tpu_torch import quant
from calm_tpu_torch.config import ModelConfig

KV_SINKS = 2


def _norm(x, w, eps, ln):
    mean = x.mean() if ln else 0.0
    d = x - mean
    var = (d * d).mean()
    return d / math.sqrt(var + eps) * w


def _rope(v, head_dim, pos, theta, rotary_dim):
    v = v.copy()
    for i in range(0, v.size, 2):
        j = i % head_dim
        freq = 0.0 if j >= rotary_dim else theta ** (-j / rotary_dim)
        a = pos * freq
        c, s = math.cos(a), math.sin(a)
        v0, v1 = v[i], v[i + 1]
        v[i] = v0 * c - v1 * s
        v[i + 1] = v0 * s + v1 * c
    return v


def _silu(x):
    return x / (1.0 + np.exp(-x))


def _gelu(x):
    return 0.5 * x * (1.0 + np.tanh(0.797885 * (x + 0.044715 * x ** 3)))


class Oracle:
    def __init__(self, tf, cfg: ModelConfig):
        self.cfg = cfg
        fmt = cfg.dtype
        gs = 8 if fmt == "gf4" else 1
        D, Hd, Q, KV, V, E, L = (cfg.dim, cfg.hidden_dim, cfg.q_dim, cfg.kv_dim,
                                 cfg.vocab_size, cfg.n_experts, cfg.n_layers)

        def deq(name, layer, shape):
            raw = np.array(tf.get(name, layer, None, shape))  # a writable copy for torch
            if fmt == "gf4":
                return quant.gf4_dequantize(raw)
            if fmt == "fp8":  # the port's container hands 8-bit floats out as bytes
                return quant.fp8_dequantize(raw)
            if fmt == "fp8e4":  # per-tensor scale rides as <name>.scale
                vals = quant.fp8e4_dequantize(raw, np.ones(1, np.float32))
                s = np.asarray(tf.get(name + ".scale", layer, "F32", None))
                return vals * s.reshape(s.shape[:-1] + (1,) * (vals.ndim - s.ndim + 1))
            return raw.astype(np.float32)

        self.embed = deq("model.embed.weight", None, (V, D // gs))
        self.attn_norm = [np.asarray(tf.get("model.layers.%d.attn.norm.weight", l,
                                            "F32", (D,))) for l in range(L)]
        self.ffn_norm = None if cfg.norm_par else [
            np.asarray(tf.get("model.layers.%d.mlp.norm.weight", l,
                              "F32", (D,))) for l in range(L)]
        self.wq = [deq("model.layers.%d.attn.wq.weight", l, (Q, D // gs)) for l in range(L)]
        self.wk = [deq("model.layers.%d.attn.wk.weight", l, (KV, D // gs)) for l in range(L)]
        self.wv = [deq("model.layers.%d.attn.wv.weight", l, (KV, D // gs)) for l in range(L)]
        self.wo = [deq("model.layers.%d.attn.wo.weight", l, (D, Q // gs)) for l in range(L)]
        if tf.find("model.layers.%d.attn.wqkv.bias", 0):
            self.bqkv = [np.asarray(tf.get("model.layers.%d.attn.wqkv.bias", l,
                                           "F32", (Q + 2 * KV,))) for l in range(L)]
        else:
            self.bqkv = None
        if E:
            self.w1 = [deq("model.layers.%d.mlp.w1.weight", l, (E, Hd, D // gs)) for l in range(L)]
            self.w2 = [deq("model.layers.%d.mlp.w2.weight", l, (E, D, Hd // gs)) for l in range(L)]
            self.w3 = [deq("model.layers.%d.mlp.w3.weight", l, (E, Hd, D // gs)) for l in range(L)]
            self.moegate = [deq("model.layers.%d.moegate.weight", l, (E, D // gs)) for l in range(L)]
        else:
            self.w1 = [deq("model.layers.%d.mlp.w1.weight", l, (Hd, D // gs)) for l in range(L)]
            self.w2 = [deq("model.layers.%d.mlp.w2.weight", l, (D, Hd // gs)) for l in range(L)]
            self.w3 = [deq("model.layers.%d.mlp.w3.weight", l, (Hd, D // gs)) for l in range(L)]
            self.moegate = None
        self.final_norm = np.asarray(tf.get("model.norm.weight", None, "F32", (D,)))
        if tf.find("model.output.weight") is None:
            self.wcls = self.embed
        else:
            self.wcls = deq("model.output.weight", None, (V, D // gs))

        S = cfg.seq_len
        self.k_cache = np.zeros((L, S, KV), np.float16)
        self.v_cache = np.zeros((L, S, KV), np.float16)

    def forward(self, token: int, pos: int) -> np.ndarray:
        cfg = self.cfg
        hd = cfg.head_dim
        H, KVH = cfg.n_heads, cfg.n_kv_heads
        Q, KV = cfg.q_dim, cfg.kv_dim
        S = cfg.seq_len
        kv_mul = H // KVH
        clip = cfg.qkv_clip

        kv_sink = KV_SINKS if pos >= S else 0
        kv_pos = kv_sink + (pos - kv_sink) % (S - kv_sink)
        kv_len = S if pos >= S else pos + 1

        x = self.embed[token].astype(np.float32).copy()

        for l in range(cfg.n_layers):
            xb = _norm(x, self.attn_norm[l], cfg.norm_eps, cfg.norm_ln)

            q = self.wq[l] @ xb
            k = self.wk[l] @ xb
            v = self.wv[l] @ xb
            if self.bqkv is not None:
                q += self.bqkv[l][:Q]
                k += self.bqkv[l][Q:Q + KV]
                v += self.bqkv[l][Q + KV:]
            if math.isfinite(clip):
                q = np.clip(q, -clip, clip)
                k = np.clip(k, -clip, clip)
                v = np.clip(v, -clip, clip)

            q = _rope(q, hd, pos, cfg.rope_theta, cfg.rotary_dim)
            k = _rope(k, hd, pos, cfg.rope_theta, cfg.rotary_dim)

            self.k_cache[l, kv_pos] = k.astype(np.float16)
            self.v_cache[l, kv_pos] = v.astype(np.float16)

            for r in range(kv_sink):
                rk = self.k_cache[l, r].astype(np.float32)
                self.k_cache[l, r] = _rope(rk, hd, 1, cfg.rope_theta,
                                           cfg.rotary_dim).astype(np.float16)

            att_out = np.zeros(Q, np.float32)
            for h in range(H):
                qh = q[h * hd:(h + 1) * hd]
                kh = self.k_cache[l, :kv_len,
                                  (h // kv_mul) * hd:(h // kv_mul + 1) * hd].astype(np.float32)
                vh = self.v_cache[l, :kv_len,
                                  (h // kv_mul) * hd:(h // kv_mul + 1) * hd].astype(np.float32)
                scores = kh @ qh / math.sqrt(hd)
                scores -= scores.max()
                e = np.exp(scores)
                att_out[h * hd:(h + 1) * hd] = (e / e.sum()) @ vh

            x = x + self.wo[l] @ att_out

            xb2 = xb if cfg.norm_par else _norm(x, self.ffn_norm[l],
                                                cfg.norm_eps, cfg.norm_ln)
            act = _gelu if cfg.act_gelu else _silu

            if cfg.n_experts:
                gate = self.moegate[l] @ xb2
                order = np.argsort(-gate, kind="stable")[: cfg.n_experts_ac]
                ew = np.exp(gate[order] - gate.max())
                ew /= ew.sum()
                for e_i, eidx in enumerate(order):
                    h1 = act(self.w1[l][eidx] @ xb2) * (self.w3[l][eidx] @ xb2)
                    x = x + ew[e_i] * (self.w2[l][eidx] @ h1)
            else:
                h1 = act(self.w1[l] @ xb2) * (self.w3[l] @ xb2)
                x = x + self.w2[l] @ h1

        x = _norm(x, self.final_norm, cfg.norm_eps, cfg.norm_ln)
        return self.wcls @ x
