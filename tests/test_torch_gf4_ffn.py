"""K6 (``gf4_ffn``) and K7 (``gf4_offn``) on the port against calm_tpu
on the CPU: the plain versions against the f32 three-matvec chain and
against the Pallas kernels in interpret mode, fed the plane-major,
word-transposed and plane-permuted layouts built from the same words."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calm_tpu import quant as jquant
from calm_tpu.ops import pallas_qmm
from calm_tpu.ops import qmm as jqmm
from calm_tpu.ops.norms import rmsnorm as jrmsnorm
from calm_tpu_torch.ops import hopper_qmm

torch.set_num_threads(1)


@pytest.fixture
def interpret():
    pallas_qmm.set_interpret(True)
    yield
    pallas_qmm.set_interpret(False)


def _words(rng, L, d, n):
    """(L, d, n/8) natural gf4 words of small random weights."""
    return np.stack([jquant.quantize(
        (rng.standard_normal((d, n)) * 0.05).astype(np.float32), "gf4")
        for _ in range(L)])


def _planes(w):
    """Natural (L, d, n/8) words -> plane-major (L, 8, d/8, n/8):
    [l, k, c] = w[l, 8c + k] (fuse_gf4_weights' w1p/w3p/wo_p)."""
    L, d, g = w.shape
    return jnp.asarray(w).reshape(L, d // 8, 8, g).transpose(0, 2, 1, 3)


def _act(act_gelu):
    return (lambda v: jax.nn.gelu(v, approximate=True)) if act_gelu else jax.nn.silu


def _chain(x, w1, w3, w2, act_gelu):
    """The f32 three-matvec FFN of the JAX package (one layer's words)."""
    q = [jqmm.QTensor(jnp.asarray(w), "gf4") for w in (w1, w3, w2)]
    xj = jnp.asarray(x)
    h = _act(act_gelu)(jqmm.qmatmul(xj, q[0])) * jqmm.qmatmul(xj, q[1])
    return np.asarray(jqmm.qmatmul(h, q[2]))


# -- K6: gf4_ffn ----------------------------------------------------------------


@pytest.mark.parametrize("act_gelu", [False, True])
@pytest.mark.parametrize("b", [1, 4, 16])
def test_gf4_ffn_plain(rng, interpret, act_gelu, b):
    """As tests/test_pallas_qmm.py:102-139: natural words on the port's
    side, the TPU kernel's plane-major w1/w3 and word-transposed w2 built
    from them; H/8 = 72 takes its tail mask."""
    L, D, H = 2, 256, 8 * 72
    w1, w3, w2 = _words(rng, L, H, D), _words(rng, L, H, D), _words(rng, L, D, H)
    x = (rng.standard_normal((b, D)) * 0.5).astype(np.float32)
    tw = [torch.from_numpy(w) for w in (w1, w3, w2)]
    assert hopper_qmm.gf4_ffn_supported(x.shape, tw[0], tw[2])
    for l in range(L):
        got = hopper_qmm.gf4_ffn(torch.from_numpy(x), *tw, l, act_gelu).numpy()
        assert got.shape == (b, D)
        np.testing.assert_allclose(got, _chain(x, w1[l], w3[l], w2[l], act_gelu),
                                   rtol=1e-5, atol=1e-5)
        pal = np.asarray(pallas_qmm.gf4_ffn(
            jnp.asarray(x), _planes(w1), _planes(w3), jnp.asarray(w2).transpose(0, 2, 1),
            jnp.int32(l), act_gelu))
        np.testing.assert_allclose(got, pal, rtol=4e-2, atol=4e-2)  # bf16 operands


def test_gf4_ffn_supported():
    w1, w2 = torch.zeros(2, 64, 4, dtype=torch.int32), torch.zeros(2, 32, 8, dtype=torch.int32)
    assert hopper_qmm.gf4_ffn_supported((16, 32), w1, w2)
    assert not hopper_qmm.gf4_ffn_supported((17, 32), w1, w2)
    assert not hopper_qmm.gf4_ffn_supported((1, 40), w1, w2)


# -- K7: gf4_offn ---------------------------------------------------------------


@pytest.mark.parametrize("sub_mean", [False, True])
@pytest.mark.parametrize("act_gelu,b", [(False, 1), (True, 4)])
def test_gf4_offn_plain(rng, interpret, sub_mean, act_gelu, b):
    """As tests/test_pallas_qmm.py:153-211 (Q != D, H/8 = 72): the TPU
    kernel takes the plane-permuted stream and layouts built from the same
    words; its outputs are un-permuted. ffn and r1 are held apart."""
    L, D, Q, H = 2, 256, 128, 8 * 72
    eps = 1e-5
    wo, w1, w3 = _words(rng, L, D, Q), _words(rng, L, H, D), _words(rng, L, H, D)
    w2 = _words(rng, L, D, H)
    g = (1.0 + rng.standard_normal((L, D)) * 0.1).astype(np.float32)
    a = (rng.standard_normal((b, Q)) * 0.5).astype(np.float32)
    r = (rng.standard_normal((b, D)) * 0.5).astype(np.float32)

    def perm(v):  # natural (B, n) -> plane-permuted (B, 8, n/8)
        return jnp.asarray(v.reshape(v.shape[0], -1, 8).transpose(0, 2, 1))

    def unperm(v):
        v = np.asarray(v).reshape(b, 8, D // 8)
        return v.transpose(0, 2, 1).reshape(b, D)

    w2t = jnp.asarray(w2).transpose(0, 2, 1)
    w2tp = w2t.reshape(L, H // 8, D // 8, 8).transpose(0, 1, 3, 2).reshape(L, H // 8, D)
    g_pl = jnp.asarray(g).reshape(L, D // 8, 8).transpose(0, 2, 1)
    tw = [torch.from_numpy(w) for w in (wo, w1, w3, w2)]
    for l in range(L):
        ffn, r1 = hopper_qmm.gf4_offn(torch.from_numpy(a), torch.from_numpy(r),
                                      torch.from_numpy(g), *tw, l, act_gelu, eps, sub_mean)
        r1_want = r + np.asarray(jqmm.qmatmul(jnp.asarray(a),
                                              jqmm.QTensor(jnp.asarray(wo[l]), "gf4")))
        xn = np.asarray(jrmsnorm(jnp.asarray(r1_want), jnp.asarray(g[l]), eps,
                                 subtract_mean=sub_mean))
        np.testing.assert_allclose(r1.numpy(), r1_want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ffn.numpy(), _chain(xn, w1[l], w3[l], w2[l], act_gelu),
                                   rtol=1e-5, atol=1e-5)
        ffn_pl, r1_pl = pallas_qmm.gf4_offn(
            perm(a), perm(r), g_pl, _planes(wo), _planes(w1), _planes(w3), w2tp,
            jnp.int32(l), act_gelu, eps, sub_mean)
        np.testing.assert_allclose(r1.numpy(), unperm(r1_pl), rtol=4e-2, atol=4e-2)
        np.testing.assert_allclose(ffn.numpy(), unperm(ffn_pl), rtol=5e-2, atol=5e-2)


def test_k6_k7_wrappers_on_cpu_take_the_plain_path(rng):
    w = torch.from_numpy(_words(rng, 1, 64, 32))
    w2 = torch.from_numpy(_words(rng, 1, 32, 64))
    hopper_qmm.gf4_ffn(torch.randn(2, 32), w, w, w2, 0, False)
    hopper_qmm.gf4_offn(torch.randn(2, 32), torch.randn(2, 32), torch.ones(1, 32),
                        torch.from_numpy(_words(rng, 1, 32, 32)), w, w, w2, 0, False,
                        1e-5, True)
    assert hopper_qmm.gf4_ffn.launches == hopper_qmm.gf4_offn.launches == 0
