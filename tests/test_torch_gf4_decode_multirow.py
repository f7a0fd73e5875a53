"""K3 (``qmm_decode_gf4``) and K7 (``gf4_offn``) on the gf4 multi-row path
(``csrc/qmm.cu`` ``mmv_kernel`` at 2-16 rows) on the CPU, and the port's
fp8 bytes against the JAX package's.

- K3's arithmetic emulated (the f16 decode of the words times x staged as
  :func:`hopper_qmm.split_operand` stages it, hi and lo products per
  64-value chunk summed in float64, times 2^e) against the plain version
  and the JAX package's f32 ``qmatmul`` (1e-6 of each row's max |out|),
  and against ``pallas_qmm.qmm_decode`` in interpret mode on the same
  natural words (bf16 operands there: 3e-2); d off the warp's 32, n with
  an odd word count a row (1000, 1032) and on the steps (4096), slots 2^20
  apart in scale.
- :func:`hopper_qmm.qmv_plan` with ``gf4``: every (row, chunk) a warp's
  once for the 256000-row lm-head of Aya 23 8B and for 1000 rows, B =
  2..16.
- K7's chain built from that product (wo + residual, ffn-norm, the dual
  w1/w3 product and activation, w2 with no residual; ffn and r1 apart)
  against the JAX package's f32 chain (1e-5) and ``pallas_qmm.gf4_offn``
  in interpret mode on its plane layouts (3e-2), Qd != D.
- ``_launch_plans`` for K3's one launch and K7's three: the plans the
  kernel reads and one staging scratch sized for the largest n.
- ``quant.fp8_quantize`` byte-equal to ``calm_tpu.quant.fp8_quantize`` on
  ±NaN (every payload), ±inf and the overflow and subnormal edges.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calm_tpu import quant as jquant
from calm_tpu.ops import pallas_qmm
from calm_tpu.ops import qmm as jqmm
from calm_tpu.ops.norms import rmsnorm as jrmsnorm
from calm_tpu_torch import quant as tquant
from calm_tpu_torch.ops import hopper_qmm
from calm_tpu_torch.ops.hopper_qmm import MV_CHUNK, MV_WARPS, qmv_plan
from calm_tpu_torch.ops.norms import rmsnorm
from tests.test_torch_gf4_multirow import _close_rows, _emulated, _planes, _words, _x

torch.set_num_threads(1)


@pytest.fixture
def interpret():
    pallas_qmm.set_interpret(True)
    yield
    pallas_qmm.set_interpret(False)


# -- K3: the emulated product ---------------------------------------------------


@pytest.mark.parametrize("n", [1000, 1032, 4096])
@pytest.mark.parametrize("B", [2, 9, 16])
@pytest.mark.parametrize("spread", [False, True])
def test_k3_product_matches_plain_jax_and_pallas(rng, interpret, n, B, spread):
    """d = 100 rows (not a multiple of 32); n % 16 == 8 for 1000 and 1032
    (the ODD instantiation's rows)."""
    d, l = 100, 1
    w = _words(rng, 2, d, n)
    x = _x(rng, B, n, spread)
    tw = torch.from_numpy(w)
    got = _emulated(x, tw[l])
    plain = hopper_qmm.qmm_decode_gf4_plain(x, tw, l)
    want = np.asarray(jqmm.qmatmul(jnp.asarray(x.numpy()), jqmm.QTensor(jnp.asarray(w), "gf4"),
                                   layer=jnp.int32(l)))
    for ref in (plain, want):
        _close_rows(got, ref, 1e-6)
    if not spread:  # bf16 operands in the Pallas kernel: one scale a check
        pal = np.asarray(pallas_qmm.qmm_decode(jnp.asarray(x.numpy()), jnp.asarray(w), "gf4",
                                               jnp.int32(l)))
        np.testing.assert_allclose(got.float().numpy(), pal, rtol=3e-2, atol=3e-2)
    # the wrapper on the CPU: its plain version, no launch counted
    assert torch.equal(hopper_qmm.qmm_decode_gf4(x, tw, l), plain)
    assert hopper_qmm.qmm_decode_gf4.launches == hopper_qmm.qmm_decode_gf4.multirow_launches == 0


# -- K3: the plan ---------------------------------------------------------------


def _cover_once(p, rows: int) -> bool:
    """Every (row, chunk) of one segment in exactly one warp's work."""
    counts = np.zeros((rows, p.chunks), np.int8)
    for block in range(p.grid):
        for warp in range(MV_WARPS):
            work = p.warp_work(block, warp, (rows,))
            if work is not None:
                _, r0, r1, c0, c1 = work
                counts[r0:r1, c0:c1] += 1
    return bool((counts == 1).all())


@pytest.mark.parametrize("B", range(2, 17))
def test_k3_plan_covers_lm_head_and_ragged_rows(B):
    """The Aya 23 8B lm-head (256000 x 4096: 32 rows a warp, 8000 row
    groups, k whole) and 1000 rows at n = 1000 (odd words: one m-tile) and
    4096."""
    p = qmv_plan(B, (256000,), 4096, gf4=True)
    assert (p.mt, p.ks, p.nt) == (2, 1, 1 if B <= 8 else 2) and p.groups == (8000,)
    assert _cover_once(p, 256000)
    for n in (1000, 4096):
        p = qmv_plan(B, (1000,), n, gf4=True)
        assert p.mt == 1 and p.chunks == -(-n // MV_CHUNK)
        assert _cover_once(p, 1000)


# -- K7: the chain --------------------------------------------------------------


def _k7_chain(a, r, g, wo, w1, w3, w2, act_gelu, eps, sub_mean):
    """K7 on the multi-row path, emulated (one layer's words): a staged,
    r1 = r + a . wo^T, ffn-norm(r1) staged, the dual product and
    activation in f32, h staged, the w2 product with no residual."""
    r1 = r + _emulated(a, wo).float()
    xn = rmsnorm(r1, g, eps, sub_mean)
    h = hopper_qmm.act(_emulated(xn, w1).float(), act_gelu) * _emulated(xn, w3).float()
    return _emulated(h, w2).float(), r1


@pytest.mark.parametrize("B,act_gelu,sub_mean", [(2, False, False), (3, True, False),
                                                 (9, True, True), (16, False, True)])
def test_k7_chain(rng, interpret, B, act_gelu, sub_mean):
    """D = 256, Qd = 128 != D, H/8 = 72 (the Pallas kernel's tail mask);
    ffn and r1 each held to its reference. The Pallas kernel takes the
    plane-permuted stream and layouts built from the same words
    (tests/test_torch_gf4_ffn.py's K7 case)."""
    L, D, Qd, H, eps, l = 2, 256, 128, 8 * 72, 1e-5, 1
    wo, w1, w3, w2 = (_words(rng, L, *s) for s in ((D, Qd), (H, D), (H, D), (D, H)))
    g = (1.0 + rng.standard_normal((L, D)) * 0.1).astype(np.float32)
    a = (rng.standard_normal((B, Qd)) * 0.5).astype(np.float32)
    r = (rng.standard_normal((B, D)) * 0.5).astype(np.float32)
    tw = [torch.from_numpy(w) for w in (wo, w1, w3, w2)]
    ffn, r1 = _k7_chain(torch.from_numpy(a), torch.from_numpy(r), torch.from_numpy(g[l]),
                        *(w[l] for w in tw), act_gelu, eps, sub_mean)

    def jq(w):
        return jqmm.QTensor(jnp.asarray(w[l]), "gf4")
    act = (lambda v: jax.nn.gelu(v, approximate=True)) if act_gelu else jax.nn.silu
    r1_want = r + np.asarray(jqmm.qmatmul(jnp.asarray(a), jq(wo)))
    xn = jrmsnorm(jnp.asarray(r1_want), jnp.asarray(g[l]), eps, sub_mean)
    h = act(jqmm.qmatmul(xn, jq(w1))) * jqmm.qmatmul(xn, jq(w3))
    ffn_want = np.asarray(jqmm.qmatmul(h, jq(w2)))
    np.testing.assert_allclose(r1.numpy(), r1_want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ffn.numpy(), ffn_want, rtol=1e-5, atol=1e-5)

    def perm(v):  # natural (rows, n) -> plane-permuted (rows, 8, n/8)
        return jnp.asarray(v.reshape(v.shape[0], -1, 8).transpose(0, 2, 1))

    def unperm(v):
        return np.asarray(v).reshape(B, 8, D // 8).transpose(0, 2, 1).reshape(B, D)
    w2tp = (jnp.asarray(w2).transpose(0, 2, 1).reshape(L, H // 8, D // 8, 8)
            .transpose(0, 1, 3, 2).reshape(L, H // 8, D))
    g_pl = jnp.asarray(g).reshape(L, D // 8, 8).transpose(0, 2, 1)
    ffn_pl, r1_pl = pallas_qmm.gf4_offn(perm(a), perm(r), g_pl, _planes(wo), _planes(w1),
                                        _planes(w3), w2tp, jnp.int32(l), act_gelu, eps,
                                        sub_mean)
    np.testing.assert_allclose(r1.numpy(), unperm(r1_pl), rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(ffn.numpy(), unperm(ffn_pl), rtol=3e-2, atol=3e-2)
    # the wrapper on the CPU: its plain version, no launch counted
    got = hopper_qmm.gf4_offn(torch.from_numpy(a), torch.from_numpy(r), torch.from_numpy(g),
                              *tw, l, act_gelu, eps, sub_mean)
    for gt, want in zip(got, (ffn_want, r1_want)):
        np.testing.assert_allclose(gt.numpy(), want, rtol=1e-5, atol=1e-5)
    assert hopper_qmm.gf4_offn.launches == hopper_qmm.gf4_offn.multirow_launches == 0


# -- the wrappers' launch plans -------------------------------------------------


@pytest.mark.parametrize("B", [2, 8, 9, 16])
@pytest.mark.parametrize("D,Qd,H", [(4096, 4096, 14336), (1032, 512, 11032)])
def test_launch_plans_of_k3_and_k7(B, D, Qd, H):
    """K7's three launches (wo, the dual w1/w3, w2) in one int32 array
    with one staging scratch sized for the largest n and one n-tile count
    (the kernel reads the staging's row slots from the first plan); K3's
    one launch on the lm-head."""
    launches = (((D,), Qd, False), ((H,), D, True), ((D,), H, False))
    arr, words, floats = hopper_qmm._launch_plans(B, launches, True)
    ps = [qmv_plan(B, rows, n, dual, gf4=True) for rows, n, dual in launches]
    assert arr.dtype == np.int32 and arr.tolist() == [v for p in ps for v in p.args()]
    assert len({p.nt for p in ps}) == 1
    assert (words, floats) == ps[0].staging(max(D, Qd, H)) == ps[0].staging(H)
    arr, words, floats = hopper_qmm._launch_plans(B, (((256000,), D, False),), True)
    p = qmv_plan(B, (256000,), D, gf4=True)
    assert tuple(arr) == p.args() and (words, floats) == p.staging(D)


# -- fp8 bytes ------------------------------------------------------------------


def _nans():
    """+NaN, -NaN and other payloads, quiet and signalling."""
    return np.array([0x7FC00000, 0xFFC00000, 0x7FC00001, 0xFFFFFFFF, 0x7F800001,
                     0xFF800001, 0x7FFFFFFF], np.uint32).view(np.float32)


@pytest.mark.parametrize("case,values", [
    ("nan", _nans()),
    ("inf", [np.inf, -np.inf]),
    ("overflow", [57344.0, 57345.0, 61439.0, 61440.0, 65504.0, 1e30, -61440.0, -3.4e38]),
    ("subnormal", [2.0 ** -14, 2.0 ** -16, 2.0 ** -17, 1.5 * 2.0 ** -17, 3 * 2.0 ** -18,
                   2.0 ** -18, 1e-30, -2.0 ** -17, 0.0, -0.0]),
    ("random", np.random.default_rng(7).standard_normal(4096)
     * np.exp(np.random.default_rng(8).uniform(-20, 12, 4096))),
])
def test_fp8_quantize_bytes_match_jax(case, values):
    """e5m2: the port's bytes are the JAX package's (ml_dtypes') on every
    input, NaN (0x7e, sign kept) included. e4m3fn NaN needs no pin: both
    casts write 0x7f / 0xff (the port has no e4m3 writer; its torch cast
    saturates inf and overflow to 0x7e where ml_dtypes writes NaN)."""
    x = np.asarray(values, np.float32)
    with np.errstate(invalid="ignore"):
        want = jquant.fp8_quantize(x).view(np.uint8)
        got = tquant.fp8_quantize(x)
        assert got.dtype == np.uint8 and np.array_equal(got, want)
        if case == "nan":
            assert np.array_equal(np.unique(got), [0x7E, 0xFE])
            e4 = tquant._to_fp8_bytes(x, torch.float8_e4m3fn)
            assert np.array_equal(e4, x.astype(jquant.FP8E4).view(np.uint8))
