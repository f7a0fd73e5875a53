"""The port's ops against the JAX package's, on the CPU: formats and
containers bit for bit, norms and RoPE to 1e-6, and each kernel's plain
PyTorch version against the f32 reference path and against the Pallas
kernel it replaces (run in interpret mode, bf16 operands there)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calm_tpu import container as jcontainer
from calm_tpu import quant as jquant
from calm_tpu.ops import pallas_attn, pallas_qmm
from calm_tpu.ops import qmm as jqmm
from calm_tpu.ops.norms import rmsnorm as jrmsnorm
from calm_tpu.ops.rope import apply_rope as japply_rope
from calm_tpu.ops.rope import rope_tables as jrope_tables
from calm_tpu_torch import container, quant
from calm_tpu_torch.ops import hopper_attn, hopper_qmm, qmm
from calm_tpu_torch.ops.norms import rmsnorm
from calm_tpu_torch.ops.rope import apply_rope, rope_tables

torch.set_num_threads(1)

_TORCH = {"fp16": torch.float16, "fp8": torch.float8_e5m2}


@pytest.fixture
def interpret():
    pallas_qmm.set_interpret(True)
    pallas_attn.set_interpret(True)
    yield
    pallas_qmm.set_interpret(False)
    pallas_attn.set_interpret(False)


def _t(a: np.ndarray, fmt=None) -> torch.Tensor:
    """numpy (ml_dtypes included) -> torch, 8-bit floats by their bytes."""
    a = np.ascontiguousarray(a)
    if fmt == "fp8":
        return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e5m2)
    return torch.from_numpy(a)


def _weights(rng, shape, fmt):
    w = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    return jquant.quantize(w, fmt)


# -- formats and containers ---------------------------------------------------


@pytest.mark.parametrize("fmt", ["fp16", "fp8"])
def test_dequant_bit_equal(rng, fmt):
    if fmt == "fp8":
        codes = rng.integers(0, 256, (64, 96)).astype(np.uint8)
        # e5m2 inf/nan encodings: torch decodes them to inf/nan, the Pallas
        # decode to large finite values (pallas_qmm.py:40-46) -- skip them
        codes[(codes & 0x7F) >= 0x7C] = 0x3C
        jd = codes.view(jnp.float8_e5m2.dtype)
    else:
        bits = rng.integers(0, 1 << 16, (64, 96)).astype(np.uint16)
        bits[(bits & 0x7C00) == 0x7C00] = 0x3C00  # finite halves only
        jd = bits.view(np.float16)
    want = np.asarray(jqmm.dequant(jqmm.QTensor(jnp.asarray(jd), fmt)))
    got = qmm.dequant(qmm.QTensor(_t(jd, fmt), fmt)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_gf4_and_fp8e4_dequant_bit_equal(rng):
    w = rng.standard_normal((16, 64)).astype(np.float32)
    words = jquant.gf4_quantize(w)
    want = np.asarray(jqmm.gf4_decode_words(jnp.asarray(words)))
    got = qmm.gf4_decode_words(torch.from_numpy(words)).numpy()
    np.testing.assert_array_equal(got, want)
    codes, scale = jquant.fp8e4_quantize(w)
    want = jquant.fp8e4_dequantize(codes, scale)
    got = quant.fp8e4_dequantize(codes.view(np.uint8), scale)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fmt", ["fp16", "fp8", "gf4"])
def test_quantize_matches_jax(rng, fmt):
    w = (rng.standard_normal((8, 64)) * 3).astype(np.float32)
    want = np.asarray(jquant.quantize(w, fmt))
    got = quant.quantize(w, fmt)
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
    np.testing.assert_array_equal(quant.dequantize(got, fmt),
                                  jquant.dequantize(want, fmt))


def test_container_round_trip_both_ways(rng, tmp_path):
    w8 = jquant.quantize(rng.standard_normal((4, 32)).astype(np.float32), "fp8")
    f16 = rng.standard_normal((3, 5)).astype(np.float16)
    # JAX writer -> port reader
    p = str(tmp_path / "a.calm")
    jcontainer.write_tensors(p, {"w": w8, "h": f16}, {"k": "v"})
    tf = container.TensorFile(p)
    assert tf.metadata == {"k": "v"}
    t = container.to_torch(tf.get("w", tag="F8_E5M2", shape=(4, 32)), "F8_E5M2")
    assert t.dtype == torch.float8_e5m2
    np.testing.assert_array_equal(t.view(torch.uint8).numpy(), w8.view(np.uint8))
    np.testing.assert_array_equal(tf.get("h", tag="F16"), f16)
    with pytest.raises(container.ContainerError):
        tf.get("w", tag="F16")
    # port writer (torch fp8 + bf16 + numpy) -> JAX reader
    q = str(tmp_path / "b.calm")
    bf = torch.randn(2, 8).to(torch.bfloat16)
    container.write_tensors(q, {"w": torch.from_numpy(w8.view(np.uint8))
                                .view(torch.float8_e5m2), "b": bf, "h": f16})
    jf = jcontainer.TensorFile(q)
    np.testing.assert_array_equal(jf.get("w").view(np.uint8), w8.view(np.uint8))
    np.testing.assert_array_equal(jf.get("b").astype(np.float32),
                                  bf.float().numpy())
    np.testing.assert_array_equal(jf.get("h"), f16)


# -- norms and rope -----------------------------------------------------------


@pytest.mark.parametrize("sub_mean", [False, True])
def test_rmsnorm_matches_jax(rng, sub_mean):
    x = rng.standard_normal((3, 96)).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(96)).astype(np.float32)
    want = np.asarray(jrmsnorm(jnp.asarray(x), jnp.asarray(g), 1e-5, sub_mean))
    got = rmsnorm(torch.from_numpy(x), torch.from_numpy(g), 1e-5, sub_mean).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("rotary_dim", [16, 8])
def test_rope_matches_jax(rng, rotary_dim):
    pos = np.array([0, 7, 4099], np.int32)
    v = rng.standard_normal((3, 4, 16)).astype(np.float32)
    jc, js = jrope_tables(jnp.asarray(pos), 16, 10000.0, rotary_dim)
    c, s = rope_tables(torch.from_numpy(pos), 16, 10000.0, rotary_dim)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-6)
    want = np.asarray(japply_rope(jnp.asarray(v), jc, js))
    got = apply_rope(torch.from_numpy(v), c, s).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# -- K2: qmm_decode -----------------------------------------------------------


@pytest.mark.parametrize("fmt", ["fp16", "fp8"])
@pytest.mark.parametrize("b", [1, 3])
def test_qmm_decode_plain(rng, interpret, fmt, b):
    L, d, n = 2, 256, 384
    w = _weights(rng, (L, d, n), fmt)
    x = rng.standard_normal((b, n)).astype(np.float32)
    for layer in range(L):
        got = hopper_qmm.qmm_decode(torch.from_numpy(x), _t(w, fmt), fmt, layer).numpy()
        want = np.asarray(jqmm.qmatmul(jnp.asarray(x), jqmm.QTensor(jnp.asarray(w), fmt),
                                       layer=jnp.int32(layer)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        pal = np.asarray(pallas_qmm.qmm_decode(jnp.asarray(x), jnp.asarray(w), fmt, layer))
        np.testing.assert_allclose(got, pal, rtol=3e-2, atol=3e-2)
    # 2-D weight (the lm-head)
    got = hopper_qmm.qmm_decode(torch.from_numpy(x), _t(w[0], fmt), fmt).numpy()
    want = np.asarray(jqmm.qmatmul(jnp.asarray(x), jqmm.QTensor(jnp.asarray(w[0]), fmt)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# -- K9: qx_offn_qkv ----------------------------------------------------------


@pytest.mark.parametrize("fmt,sub_mean,b,gelu", [("fp8", False, 1, False),
                                                 ("fp8", True, 2, True),
                                                 ("fp16", False, 1, False),
                                                 ("fp16", True, 2, False)])
def test_qx_offn_qkv_plain(rng, interpret, fmt, sub_mean, b, gelu):
    L, D, H, Qd, KVd = 2, 256, 384, 256, 128
    eps = 1e-5
    ws = [_weights(rng, s, fmt) for s in ((L, D, Qd), (L, H, D), (L, H, D),
                                          (L, D, H), (L, Qd, D), (L, KVd, D),
                                          (L, KVd, D))]
    wo, w1, w3, w2, wq, wk, wv = ws
    g = (1.0 + rng.standard_normal((L, D)) * 0.1).astype(np.float32)
    anx = (1.0 + rng.standard_normal((L, D)) * 0.1).astype(np.float32)
    a = (rng.standard_normal((b, Qd)) * 0.5).astype(np.float32)
    r = (rng.standard_normal((b, D)) * 0.5).astype(np.float32)

    def jq(w, l):
        return jqmm.QTensor(jnp.asarray(w[l]), fmt)

    for l in range(L):  # l = L-1 reads wq/wk/wv[L-1] (the clamp)
        got = [t.numpy() for t in hopper_qmm.qx_offn_qkv(
            torch.from_numpy(a), torch.from_numpy(r), torch.from_numpy(g),
            torch.from_numpy(anx), *[_t(w, fmt) for w in ws], l, fmt, gelu,
            eps, sub_mean)]
        # the f32 chain of tests/test_pallas_qmm.py:665-677
        ln = min(l + 1, L - 1)
        r1 = r + np.asarray(jqmm.qmatmul(jnp.asarray(a), jq(wo, l)))
        xn = jrmsnorm(jnp.asarray(r1), jnp.asarray(g[l]), eps, sub_mean)
        act = (jax.nn.gelu(jqmm.qmatmul(xn, jq(w1, l)), approximate=True) if gelu
               else jax.nn.silu(jqmm.qmatmul(xn, jq(w1, l))))
        h = act * jqmm.qmatmul(xn, jq(w3, l))
        x = r1 + np.asarray(jqmm.qmatmul(h, jq(w2, l)))
        xq = jrmsnorm(jnp.asarray(x), jnp.asarray(anx[ln]), eps, sub_mean)
        want = [x] + [np.asarray(jqmm.qmatmul(xq, jq(w, ln))) for w in (wq, wk, wv)]
        for gt, wt in zip(got, want):
            np.testing.assert_allclose(gt, wt, rtol=1e-5, atol=1e-5)
        pal = pallas_qmm.qx_offn_qkv(
            jnp.asarray(a), jnp.asarray(r), jnp.asarray(g), jnp.asarray(anx),
            *[jnp.asarray(w) for w in ws], jnp.int32(l), fmt, gelu, eps, sub_mean)
        for gt, pt in zip(got, pal):
            np.testing.assert_allclose(gt, np.asarray(pt), rtol=5e-2, atol=5e-2)


# -- K12: decode_attention ----------------------------------------------------


@pytest.mark.parametrize("kv", ["bf16", "fp8"])
@pytest.mark.parametrize("fresh", [False, True])
def test_decode_attention_plain(rng, interpret, kv, fresh):
    L, B, KVH, M, S, hd = 2, 2, 2, 2, 256, 128
    layer = 1
    jdt = {"bf16": jnp.bfloat16, "fp8": jnp.float8_e5m2}[kv]
    tdt = {"bf16": torch.bfloat16, "fp8": torch.float8_e5m2}[kv]
    q = rng.standard_normal((B, KVH * M, hd)).astype(np.float32)
    kc = jnp.asarray(rng.standard_normal((L, B, KVH, S, hd)) * 0.5, jdt)
    vc = jnp.asarray(rng.standard_normal((L, B, KVH, S, hd)) * 0.5, jdt)
    kv_len = np.array([100, 256], np.int32)
    kv_pos = np.array([37, 200], np.int32)  # stale rows inside the window
    fk = jnp.asarray(rng.standard_normal((B, KVH, hd)) * 0.5, jdt)
    fv = jnp.asarray(rng.standard_normal((B, KVH, hd)) * 0.5, jdt)

    def tt(x):
        a = np.asarray(x)
        if kv == "fp8":
            return torch.from_numpy(a.view(np.uint8).copy()).view(tdt)
        return torch.from_numpy(a.astype(np.float32)).to(tdt)  # exact

    tfresh = ((tt(fk), tt(fv), torch.from_numpy(kv_pos)) if fresh else None)
    got = hopper_attn.decode_attention(
        torch.from_numpy(q), tt(kc), tt(vc), torch.from_numpy(kv_len), layer,
        tfresh).numpy()
    jfresh = (fk, fv, jnp.asarray(kv_pos)) if fresh else None
    want = np.asarray(pallas_attn.decode_attention(
        jnp.asarray(q), kc, vc, jnp.asarray(kv_len), jnp.int32(layer),
        fresh=jfresh))
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)

    # and the exact softmax, in numpy, over the same rows
    kf = np.asarray(kc[layer], np.float32)
    vf = np.asarray(vc[layer], np.float32)
    for b in range(B):
        for h in range(KVH * M):
            rows = [s for s in range(kv_len[b]) if not (fresh and s == kv_pos[b])]
            keys, vals = kf[b, h // M, rows], vf[b, h // M, rows]
            if fresh:
                keys = np.vstack([np.asarray(fk[b, h // M], np.float32), keys])
                vals = np.vstack([np.asarray(fv[b, h // M], np.float32), vals])
            sc = keys @ q[b, h] / math.sqrt(hd)
            p = np.exp(sc - sc.max())
            np.testing.assert_allclose(got[b, h], p @ vals / p.sum(), rtol=1e-5,
                                       atol=1e-5)


def test_plane_address_and_fused_eligibility():
    w = torch.zeros(3, 8, 16, dtype=torch.float8_e5m2)
    assert [hopper_qmm._plane_ptr(w, l) for l in range(3)] == [
        w[l].data_ptr() for l in range(3)]
    ok = (4096, 14336, 4096, 1024)
    assert hopper_qmm.qx_offn_supported("fp8", 1, ok)
    assert not hopper_qmm.qx_offn_supported("fp8", 17, ok)
    assert not hopper_qmm.qx_offn_supported("gf4", 1, ok)
    assert not hopper_qmm.qx_offn_supported("fp16", 1, (4096, 14336, 4096, 1000))
    assert not hopper_qmm.qx_offn_supported(  # past the norm launch's rows
        "fp16", 1, (hopper_qmm.MAX_NORM_DIM + 128, 14336, 4096, 1024))


def test_cpu_wrappers_take_the_plain_path(rng):
    before = (hopper_qmm.qmm_decode.launches, hopper_qmm.qx_offn_qkv.launches,
              hopper_attn.decode_attention.launches)
    w = torch.from_numpy(_weights(rng, (2, 32, 32), "fp16"))
    hopper_qmm.qmm_decode(torch.randn(1, 32), w, "fp16", 1)
    hopper_attn.decode_attention(
        torch.randn(1, 4, 64), torch.zeros(1, 1, 2, 8, 64, dtype=torch.bfloat16),
        torch.zeros(1, 1, 2, 8, 64, dtype=torch.bfloat16),
        torch.tensor([3], dtype=torch.int32), 0)
    assert before == (0, 0, 0)
    assert (hopper_qmm.qmm_decode.launches, hopper_qmm.qx_offn_qkv.launches,
            hopper_attn.decode_attention.launches) == (0, 0, 0)
