"""The one-row gf4 kernel (``csrc/qmm.cu`` ``gf4_row_kernel``: K8
``gf4_offn_qkv``, K7 ``gf4_offn`` and K6 ``gf4_ffn`` at B = 1) on the CPU.

- Its decode written out in numpy bit operations, with the masks,
  exponents and shift read from the kernel's source: each code field masked
  where it lies (codes 5-7 after one shift of the word), ORed under the
  exponent that puts the field's lowest bit at 1, less 2^p + 4, is
  ``code - 4`` exactly for every code at every position k = 0..7; times
  the scale byte read as the high byte of an f16 and the row's -1/4, it is
  the plain decode (and the JAX package's) bit for bit for all 248 finite
  e5m2 scale bytes, subnormals included. Its products with x are the
  plain code's f32 products bit for bit, x at the subnormal and overflow
  edges included: the kernel never scales x, so no product underflows
  that the plain one does not.
- :func:`hopper_qmm.gf4_row_plan`: every (row, word) of every segment in
  exactly one warp's work for the launches of Mistral-7B and Aya 23 8B
  (the same widths) and for rows 1, 100, 1000 at n = 8, 1000, 1032,
  14336; ragged refusals; the wrappers' plan arrays.
- The K8, K7 and K6 chains at B = 1 built from the emulated product (each
  warp's word range in the plan's order, its partials summed in warp
  order; float64 sums) against the JAX package's f32 chains (1e-5) and
  ``pallas_qmm.gf4_offn_qkv`` / ``gf4_offn`` / ``gf4_ffn`` in interpret
  mode on their plane layouts (bf16 operands there: 3e-2), RMSNorm and
  LayerNorm, SiLU and GELU.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calm_tpu.ops import pallas_qmm
from calm_tpu.ops import qmm as jqmm
from calm_tpu.ops.norms import rmsnorm as jrmsnorm
from calm_tpu_torch.ops import hopper_qmm
from calm_tpu_torch.ops.hopper_qmm import MV_WARPS, gf4_row_plan
from calm_tpu_torch.ops.norms import rmsnorm
from calm_tpu_torch.ops.qmm import QTensor, dequant
from tests.test_torch_gf4_multirow import _planes, _words

torch.set_num_threads(1)


def _kernel_constants():
    """gf4_dot8's fields, read from csrc/qmm.cu: (word or shifted word,
    mask, exponent field, 2^p + 4) for k = 0..7, and the shift."""
    with open(os.path.join(hopper_qmm.build.CSRC, "qmm.cu")) as f:
        src = f.read()
    body = src[src.index("float gf4_dot8("):]
    body = body[:body.index("\n}\n")]
    shift = int(re.search(r"const uint32_t h = w >> (\d+);", body).group(1))
    fields = re.findall(r"gf4_field<(0x[0-9A-Fa-f]+)u>\((w|h), e\[(\d)\]\) - ([0-9.]+)f", body)
    kernel = src[src.index("gf4_row_kernel(Args a, int ks)"):]
    exps = dict((int(i), int(v, 16)) for v, i in re.findall(
        r'mov\.b32 %0, (0x[0-9A-Fa-f]+);" : "=r"\(e\[(\d)\]\)', kernel))
    assert len(fields) == 8 and len(exps) == 5
    return [(word, np.uint32(int(m, 16)), np.uint32(exps[int(i)]), np.float32(b))
            for m, word, i, b in fields], np.uint32(shift)


FIELDS, SHIFT = _kernel_constants()


@pytest.fixture
def interpret():
    pallas_qmm.set_interpret(True)
    yield
    pallas_qmm.set_interpret(False)


def kernel_codes(w: np.ndarray) -> np.ndarray:
    """code_k - 4 (float32, (..., 8)) of int32 words as gf4_dot8 decodes
    them: a LOP3 of the field under its exponent, one f32 subtract."""
    u = np.asarray(w).astype(np.int64).astype(np.uint32)
    words = {"w": u, "h": u >> SHIFT}
    return np.stack([((words[word] & mask) | exp).view(np.float32) - base
                     for word, mask, exp, base in FIELDS], -1)


def kernel_scale(w: np.ndarray) -> np.ndarray:
    """The scale byte as the high byte of an f16, as float32."""
    u = np.asarray(w).astype(np.int64).astype(np.uint32)
    return ((u & np.uint32(0xFF)) << np.uint32(8)).astype(np.uint16).view(np.float16).astype(
        np.float32)


def _all_words(sign):
    """Every finite scale byte of one sign x every code at every position:
    word (s, c) holds code (c + k) % 8 at position k."""
    sb = np.array([b for b in range(sign, sign + 0x80) if (b & 0x7F) < 0x7C], np.int64)
    codes = sum(((np.arange(8, dtype=np.int64) + k) % 8) << (8 + 3 * k) for k in range(8))
    return (sb[:, None] | codes[None, :]).astype(np.uint32).view(np.int32), sb


# -- the decode -----------------------------------------------------------------


@pytest.mark.parametrize("sign", [0x00, 0x80])
def test_decode_is_exact_for_every_code_and_scale(sign):
    w, sb = _all_words(sign)  # (124, 8) words
    c = kernel_codes(w)
    codes = np.array([[((cc + k) % 8) - 4 for k in range(8)] for cc in range(8)], np.float32)
    assert np.array_equal(c, np.broadcast_to(codes, c.shape))
    vals = c * (kernel_scale(w) * np.float32(-0.25))[..., None]  # (124, 8, 8)
    t = torch.from_numpy(np.ascontiguousarray(w))
    want = dequant(QTensor(t, "gf4"), torch.float32).numpy().reshape(vals.shape)
    assert np.isfinite(want).all()
    assert np.array_equal(vals.view(np.int32), want.view(np.int32))
    jw = np.asarray(jqmm.gf4_decode_words(jnp.asarray(w))).reshape(vals.shape)
    assert np.array_equal(vals.view(np.int32), jw.view(np.int32))
    assert len(sb) == 124  # 248 finite bytes over both signs


EDGE_X = np.array([2.0 ** -149, -2.0 ** -149, 3 * 2.0 ** -149, 2.0 ** -126, -2.0 ** -126,
                   2.0 ** -126 - 2.0 ** -149, 1.5 * 2.0 ** -125, 2.0 ** -100, 1.0, -0.7,
                   1e20, 3.4e38, -3.4e38, 8.5e37, 0.0], np.float32)


@pytest.mark.parametrize("sign", [0x00, 0x80])
def test_products_with_x_match_the_plain_code_bit_for_bit(sign):
    """(code - 4) x_k in f32 from the kernel's decode and from the plain
    decode (its value over the scale / -4, exact), x at the subnormal,
    underflow and overflow edges: the same bits, inf and zero alike."""
    w, _ = _all_words(sign)
    kc = kernel_codes(w)  # (124, 8, 8)
    t = torch.from_numpy(np.ascontiguousarray(w))
    plain = dequant(QTensor(t, "gf4"), torch.float32).numpy().reshape(kc.shape)
    with np.errstate(invalid="ignore"):  # a zero scale byte: 0 / 0
        pc = plain / (kernel_scale(w) * np.float32(-0.25))[..., None]
    nz = kernel_scale(w) != 0
    assert np.array_equal(pc[nz], kc[nz])
    with np.errstate(over="ignore"):
        for xv in EDGE_X:
            got = (kc[nz] * xv).view(np.int32)
            want = (pc[nz] * xv).view(np.int32)
            assert np.array_equal(got, want)


# -- the plan -------------------------------------------------------------------


def _cover(p, seg_rows):
    counts = [np.zeros((r, p.words), np.int32) for r in seg_rows]
    for block in range(p.grid):
        for warp in range(MV_WARPS):
            work = p.warp_work(block, warp, seg_rows)
            if work is not None:
                s, r0, r1, c0, c1 = work
                counts[s][r0:r1, c0:c1] += 1
    return counts


# D, H, Qd, KVd: Mistral-7B and Aya 23 8B share these widths
LAUNCHES_7B = [((4096,), 4096, False), ((14336,), 4096, True), ((4096,), 14336, False),
               ((4096, 1024, 1024), 4096, False)]


@pytest.mark.parametrize("seg_rows,n,dual", LAUNCHES_7B + [
    ((rows,), n, dual) for rows in (1, 100, 1000) for n in (8, 1000, 1032, 14336)
    for dual in (False, True)] + [((100, 1, 1000), 1032, False)])
def test_plan_covers_every_row_and_word_once(seg_rows, n, dual):
    p = gf4_row_plan(seg_rows, n, dual)
    assert p.words == n // 8 and p.ks in (1, 2, 4, 8)
    assert p.rows == (hopper_qmm.G1_ROWS_DUAL if dual else hopper_qmm.G1_ROWS)
    assert p.grid * (MV_WARPS // p.ks) >= sum(p.groups)
    assert all((c == 1).all() for c in _cover(p, seg_rows))


def test_plan_splits_the_narrow_launches():
    """wo and w2 (4096 rows) split k; the dual launch (14336 rows, 2 a
    warp) has warps enough with k whole; q/k/v in between."""
    wo, dual, w2, qkv = (gf4_row_plan(*launch) for launch in LAUNCHES_7B)
    with open(os.path.join(hopper_qmm.build.CSRC, "qmm.cu")) as f:
        defines = dict(re.findall(r"#define (G1_\w+) (\d+)", f.read()))
    assert int(defines["G1_ROWS"]) == hopper_qmm.G1_ROWS  # the kernel's, not the plan's
    assert int(defines["G1_ROWS_DUAL"]) == hopper_qmm.G1_ROWS_DUAL
    assert int(defines["G1_PLAN"]) == len(wo.args())
    assert dual.rows == hopper_qmm.G1_ROWS_DUAL and dual.ks == 1
    assert wo.rows == w2.rows == qkv.rows == hopper_qmm.G1_ROWS
    assert wo.ks > 1 and w2.ks > 1 and qkv.ks > 1
    for p in (wo, w2, qkv):
        assert p.words // p.ks >= hopper_qmm.G1_MIN_WORDS


def test_plan_refusals_and_wrapper_arrays():
    for bad in (((16,), 12), ((16,), 0), ((16,), 4), ((), 64), ((1, 1, 1, 1), 64), ((0,), 64)):
        with pytest.raises(ValueError):
            gf4_row_plan(*bad)
    launches = tuple(LAUNCHES_7B)
    arr = hopper_qmm._row_plans(launches)
    assert arr.dtype == np.int32 and arr.tolist() == [
        v for launch in launches for v in gf4_row_plan(*launch).args()]


# -- the emulated product and the chains ----------------------------------------


def _row_product(x, words, dual_with=None):
    """The kernel's product of one row of x (n,) against words (d, n/8):
    each warp's words of the plan, its per-word sums times the word's
    scale, the warps' partials in warp order, times -1/4; float64. With
    ``dual_with`` (w3's words) the dual launch's plan and both products."""
    x = np.asarray(x, np.float64)
    ws = [np.asarray(words)] + ([np.asarray(dual_with)] if dual_with is not None else [])
    d, nw = ws[0].shape
    p = gf4_row_plan((d,), 8 * nw, dual_with is not None)
    xs = x.reshape(nw, 8)
    dots = [(kernel_codes(w).astype(np.float64) * xs).sum(-1) * kernel_scale(w) for w in ws]
    ys = [np.zeros(d) for _ in ws]
    for block in range(p.grid):
        for warp in range(MV_WARPS):
            work = p.warp_work(block, warp, (d,))
            if work is not None:
                _, r0, r1, c0, c1 = work
                for y, dot in zip(ys, dots):
                    y[r0:r1] += dot[r0:r1, c0:c1].sum(-1)
    return [y * -0.25 for y in ys]


def _act(v, act_gelu):
    return hopper_qmm.act(torch.from_numpy(np.asarray(v, np.float32)), act_gelu).numpy()


def _ffn_chain(x, w1, w3, w2, act_gelu):
    """K6 at one row, emulated: the dual launch, the activation in f32,
    the w2 launch."""
    y1, y3 = _row_product(x, w1, w3)
    h = _act(y1.astype(np.float32), act_gelu) * y3.astype(np.float32)
    return _row_product(h, w2)[0].astype(np.float32)


def _norm(x, g, eps, sub_mean):
    return rmsnorm(torch.from_numpy(np.asarray(x, np.float32)), torch.from_numpy(g), eps,
                   sub_mean).numpy()


def _offn_chain(a, r, g, wo, w1, w3, w2, act_gelu, eps, sub_mean):
    """K7 at one row, emulated: (ffn, r1)."""
    r1 = (r + _row_product(a, wo)[0]).astype(np.float32)
    return _ffn_chain(_norm(r1, g, eps, sub_mean), w1, w3, w2, act_gelu), r1


def _jq(w):
    return jqmm.QTensor(jnp.asarray(w), "gf4")


def _jact(act_gelu):
    return (lambda v: jax.nn.gelu(v, approximate=True)) if act_gelu else jax.nn.silu


def _jffn(x, w1, w3, w2, act_gelu):
    h = _jact(act_gelu)(jqmm.qmatmul(x, _jq(w1))) * jqmm.qmatmul(x, _jq(w3))
    return np.asarray(jqmm.qmatmul(h, _jq(w2)))


def _pl(v):  # natural (rows, n) -> plane-permuted (rows, 8, n/8)
    return jnp.asarray(v.reshape(v.shape[0], -1, 8).transpose(0, 2, 1))


def _w2tp(w2, D, H):
    L = w2.shape[0]
    return (jnp.asarray(w2).transpose(0, 2, 1).reshape(L, H // 8, D // 8, 8)
            .transpose(0, 1, 3, 2).reshape(L, H // 8, D))


@pytest.mark.parametrize("D,H", [(256, 8 * 72), (1032, 8 * 125)])
@pytest.mark.parametrize("act_gelu", [False, True])
def test_k6_chain(rng, interpret, D, H, act_gelu):
    """1032: 129 words a row of w1/w3 (odd); H/8 = 72 and 125 take the
    Pallas kernel's tail mask."""
    L, l = 2, 1
    w1, w3, w2 = _words(rng, L, H, D), _words(rng, L, H, D), _words(rng, L, D, H)
    x = (rng.standard_normal((1, D)) * 0.5).astype(np.float32)
    got = _ffn_chain(x[0], w1[l], w3[l], w2[l], act_gelu)
    want = _jffn(jnp.asarray(x), w1[l], w3[l], w2[l], act_gelu)[0]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if D % 128 == 0:  # the Pallas kernel's plane layouts need whole 8-row planes of words
        pal = np.asarray(pallas_qmm.gf4_ffn(jnp.asarray(x), _planes(w1), _planes(w3),
                                            jnp.asarray(w2).transpose(0, 2, 1), jnp.int32(l),
                                            act_gelu))[0]
        np.testing.assert_allclose(got, pal, rtol=3e-2, atol=3e-2)
    plain = hopper_qmm.gf4_ffn(torch.from_numpy(x), *(torch.from_numpy(w) for w in (w1, w3, w2)),
                               l, act_gelu)
    np.testing.assert_allclose(got, plain.numpy()[0], rtol=1e-5, atol=1e-5)
    assert hopper_qmm.gf4_ffn.launches == 0


@pytest.mark.parametrize("act_gelu,sub_mean", [(False, False), (True, False), (False, True),
                                               (True, True)])
def test_k7_chain(rng, interpret, act_gelu, sub_mean):
    """D = 256, Qd = 128 != D, H/8 = 72; ffn and r1 each to its reference;
    the Pallas kernel on the plane-permuted stream."""
    L, D, Qd, H, eps, l = 2, 256, 128, 8 * 72, 1e-5, 1
    wo, w1, w3, w2 = (_words(rng, L, *s) for s in ((D, Qd), (H, D), (H, D), (D, H)))
    g = (1.0 + rng.standard_normal((L, D)) * 0.1).astype(np.float32)
    a = (rng.standard_normal((1, Qd)) * 0.5).astype(np.float32)
    r = (rng.standard_normal((1, D)) * 0.5).astype(np.float32)
    ffn, r1 = _offn_chain(a[0], r[0], g[l], wo[l], w1[l], w3[l], w2[l], act_gelu, eps,
                          sub_mean)
    r1_want = r + np.asarray(jqmm.qmatmul(jnp.asarray(a), _jq(wo[l])))
    xn = jrmsnorm(jnp.asarray(r1_want), jnp.asarray(g[l]), eps, sub_mean)
    ffn_want = _jffn(xn, w1[l], w3[l], w2[l], act_gelu)
    np.testing.assert_allclose(r1, r1_want[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ffn, ffn_want[0], rtol=1e-5, atol=1e-5)

    def unpl(v):
        return np.asarray(v).reshape(1, 8, D // 8).transpose(0, 2, 1).reshape(D)
    ffn_pl, r1_pl = pallas_qmm.gf4_offn(
        _pl(a), _pl(r), jnp.asarray(g).reshape(L, D // 8, 8).transpose(0, 2, 1), _planes(wo),
        _planes(w1), _planes(w3), _w2tp(w2, D, H), jnp.int32(l), act_gelu, eps, sub_mean)
    np.testing.assert_allclose(r1, unpl(r1_pl), rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(ffn, unpl(ffn_pl), rtol=3e-2, atol=3e-2)
    got = hopper_qmm.gf4_offn(torch.from_numpy(a), torch.from_numpy(r), torch.from_numpy(g),
                              *(torch.from_numpy(w) for w in (wo, w1, w3, w2)), l, act_gelu,
                              eps, sub_mean)
    for gt, want in zip(got, (ffn_want, r1_want)):
        np.testing.assert_allclose(gt.numpy(), want, rtol=1e-5, atol=1e-5)
    assert hopper_qmm.gf4_offn.launches == 0


@pytest.mark.parametrize("act_gelu,sub_mean,layer", [(False, False, 0), (True, False, 1),
                                                     (False, True, 1), (True, True, 0)])
def test_k8_chain(rng, interpret, act_gelu, sub_mean, layer):
    """One row through wo + residual, ffn-norm, the FFN + residual, the
    next layer's attn-norm and q/k/v (from layer + 1, clamped at the last)
    against the JAX f32 chain and the Pallas kernel on the plane layouts."""
    L, D, Qd, KVd, H, eps = 2, 256, 128, 32, 8 * 72, 1e-5
    l, ln = layer, min(layer + 1, L - 1)
    wo, w1, w3, w2 = (_words(rng, L, *s) for s in ((D, Qd), (H, D), (H, D), (D, H)))
    wqkv = _words(rng, L, Qd + 2 * KVd, D)
    g = (1.0 + rng.standard_normal((L, D)) * 0.1).astype(np.float32)
    anx = (1.0 + rng.standard_normal((L, D)) * 0.1).astype(np.float32)
    a = (rng.standard_normal((1, Qd)) * 0.5).astype(np.float32)
    r = (rng.standard_normal((1, D)) * 0.5).astype(np.float32)
    ffn, r1 = _offn_chain(a[0], r[0], g[l], wo[l], w1[l], w3[l], w2[l], act_gelu, eps,
                          sub_mean)
    x = r1 + ffn
    xq = _norm(x, anx[ln], eps, sub_mean)
    # q/k/v: one launch of three segments, each its own rows of the plan
    segs = (wqkv[ln, :Qd], wqkv[ln, Qd:Qd + KVd], wqkv[ln, Qd + KVd:])
    p = gf4_row_plan(tuple(s.shape[0] for s in segs), D)
    dots = [(kernel_codes(s).astype(np.float64) * xq.astype(np.float64).reshape(-1, 8)).sum(-1)
            * kernel_scale(s) for s in segs]
    qkv = [np.zeros(s.shape[0]) for s in segs]
    for block in range(p.grid):
        for warp in range(MV_WARPS):
            work = p.warp_work(block, warp, tuple(s.shape[0] for s in segs))
            if work is not None:
                s, r0, r1_, c0, c1 = work
                qkv[s][r0:r1_] += dots[s][r0:r1_, c0:c1].sum(-1)
    got = [x, np.concatenate(qkv) * -0.25]

    r1_j = r + np.asarray(jqmm.qmatmul(jnp.asarray(a), _jq(wo[l])))
    xn = jrmsnorm(jnp.asarray(r1_j), jnp.asarray(g[l]), eps, sub_mean)
    x_j = r1_j + _jffn(xn, w1[l], w3[l], w2[l], act_gelu)
    xq_j = jrmsnorm(jnp.asarray(x_j), jnp.asarray(anx[ln]), eps, sub_mean)
    want = [x_j[0], np.asarray(jqmm.qmatmul(xq_j, _jq(wqkv[ln])))[0]]
    for gt, wt in zip(got, want):
        np.testing.assert_allclose(gt, wt, rtol=1e-5, atol=1e-5)
    x_pl, qkv_pl = pallas_qmm.gf4_offn_qkv(
        _pl(a), _pl(r), _pl(g), _pl(anx), _planes(wo), _planes(w1), _planes(w3),
        _w2tp(w2, D, H), jnp.asarray(wqkv), jnp.int32(l), act_gelu, eps, sub_mean)
    x_pal = np.asarray(x_pl).transpose(0, 2, 1).reshape(D)
    for gt, pt in zip(got, (x_pal, np.asarray(qkv_pl)[0])):
        np.testing.assert_allclose(gt, pt, rtol=3e-2, atol=3e-2)  # bf16 operands there
    assert hopper_qmm.gf4_offn_qkv.launches == 0
