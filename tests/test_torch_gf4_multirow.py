"""The gf4 multi-row path (``csrc/qmm.cu`` ``mmv_kernel`` on gf4 words:
K8 ``gf4_offn_qkv`` and K6 ``gf4_ffn`` at 2-16 rows) on the CPU.

- :func:`hopper_qmm.gf4_f16_operand`, the kernel's f16 decode of a gf4
  word written out, is bit-equal as float32 to the plain dequantization for
  every finite scale byte (subnormals, zeros and negatives included) and
  every code.
- The kernel's arithmetic emulated: those f16 weights times x staged as
  :func:`hopper_qmm.split_operand` stages it (hi and lo products per
  64-value chunk summed in float64, times 2^e) is the plain version's and
  the JAX package's f32 product to 1e-6 of each row's max |out|, with k =
  n off the 16-value steps (125 words a row) and on them, and slots 2^20
  apart in scale.
- K8's and K6's chains built from that product against the JAX package's
  f32 chains (1e-5) and the Pallas kernels on their plane layouts in
  interpret mode (bf16 operands there: 3e-2).
- :func:`hopper_qmm.qmv_plan` with ``gf4``: every (row, chunk) a warp's
  once and every k below n a lane's once where n % 16 == 8, for B = 1..16;
  the fp16/fp8 refusals unchanged.
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
from calm_tpu_torch.ops import hopper_qmm
from calm_tpu_torch.ops.hopper_qmm import MV_CHUNK, MV_WARPS, qmv_plan, split_operand
from calm_tpu_torch.ops.qmm import QTensor, dequant

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


# -- the f16 decode -------------------------------------------------------------


@pytest.mark.parametrize("sign", [0x00, 0x80])
def test_f16_operand_is_exact(sign):
    """Every finite scale byte of one sign (0x00 and 0x80, the subnormals
    0x01-0x03 and 0x81-0x83 included) x every code at every position:
    word (s, c) holds code (c + k) % 8 at position k."""
    sb = np.array([b for b in range(sign, sign + 0x80) if (b & 0x7F) < 0x7C], np.int64)
    codes = sum(((np.arange(8, dtype=np.int64) + k) % 8) << (8 + 3 * k) for k in range(8))
    w = (sb[:, None] | codes[None, :]).astype(np.uint32).view(np.int32)
    t = torch.from_numpy(np.ascontiguousarray(w))  # (124, 8) words
    got = hopper_qmm.gf4_f16_operand(t)
    assert got.dtype == torch.float16 and got.shape == (len(sb), 64)
    want = dequant(QTensor(t, "gf4"), torch.float32)
    assert torch.isfinite(want).all()
    assert torch.equal(got.float().view(torch.int32), want.view(torch.int32))
    # and the JAX package's decode
    jw = np.asarray(jqmm.gf4_decode_words(jnp.asarray(w)))
    assert np.array_equal(got.float().numpy().view(np.int32), jw.view(np.int32))


# -- the emulated product -------------------------------------------------------


def _emulated(x, words, chunk=MV_CHUNK):
    """The kernel's arithmetic on gf4 words (d, n/8): the f16 operand
    (exact) times x's staged hi and lo parts, summed per chunk in float64,
    times 2^e."""
    hi, lo, e = split_operand(x, chunk)
    wf = hopper_qmm.gf4_f16_operand(words).double()
    B, n = x.shape
    y = torch.zeros((B, wf.shape[0]), dtype=torch.float64)
    for c in range(e.shape[1]):
        ks = slice(c * chunk, min(n, (c + 1) * chunk))
        part = hi[:, ks].double() @ wf[:, ks].T + lo[:, ks].double() @ wf[:, ks].T
        y += part * torch.ldexp(torch.ones(()), e[:, c].double())[:, None]
    return y


def _x(rng, B, n, spread=False):
    x = rng.standard_normal((B, n)).astype(np.float32)
    if spread:  # rows 2^20 apart in scale, and chunks of mixed magnitude
        x[0::2] *= 1e-3
        x[1::2] *= 1e3
        x[:, :MV_CHUNK] *= 1e-4
    return torch.from_numpy(x)


def _close_rows(got, want, rel):
    """Each row within ``rel`` of its own max |want|."""
    want = torch.as_tensor(np.array(want), dtype=torch.float64)
    tol = rel * want.abs().amax(-1, keepdim=True)
    assert ((got.double() - want).abs() <= tol).all()


@pytest.mark.parametrize("n", [1000, 1040, 4096])
@pytest.mark.parametrize("B", [2, 8, 16])
@pytest.mark.parametrize("spread", [False, True])
def test_staged_product_matches_plain_and_jax(rng, n, B, spread):
    d = 96
    w = _words(rng, 2, d, n)
    x = _x(rng, B, n, spread)
    tw = torch.from_numpy(w)
    got = _emulated(x, tw[1])
    plain = hopper_qmm.qmm_decode_gf4_plain(x, tw, 1)
    want = np.asarray(jqmm.qmatmul(jnp.asarray(x.numpy()), jqmm.QTensor(jnp.asarray(w), "gf4"),
                                   layer=jnp.int32(1)))
    for ref in (plain, want):
        _close_rows(got, ref, 1e-6)


# -- K8 and K6 chains -----------------------------------------------------------


def _act_t(v, act_gelu):
    return hopper_qmm.act(v, act_gelu)


def _norm_t(x, g, eps, sub_mean):
    from calm_tpu_torch.ops.norms import rmsnorm
    return rmsnorm(x, g, eps, sub_mean)


def _k6_chain(x, w1, w3, w2, act_gelu):
    """K6 on the multi-row path, emulated: stage x, the dual product and
    activation in f32, stage h, the w2 product."""
    h = (_act_t(_emulated(x, w1).float(), act_gelu) * _emulated(x, w3).float())
    return _emulated(h, w2).float()


def _jax_chain(x, w1, w3, w2, act_gelu):
    """The f32 three-matvec FFN of the JAX package (one layer's words)."""
    q = [jqmm.QTensor(jnp.asarray(w), "gf4") for w in (w1, w3, w2)]
    xj = jnp.asarray(x)
    act = (lambda v: jax.nn.gelu(v, approximate=True)) if act_gelu else jax.nn.silu
    h = act(jqmm.qmatmul(xj, q[0])) * jqmm.qmatmul(xj, q[1])
    return np.asarray(jqmm.qmatmul(h, q[2]))


def _planes(w):
    """Natural (L, d, n/8) words -> plane-major (L, 8, d/8, n/8)."""
    L, d, g = w.shape
    return jnp.asarray(w).reshape(L, d // 8, 8, g).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("B,act_gelu", [(2, False), (9, True), (16, False)])
def test_k6_chain(rng, interpret, B, act_gelu):
    """H/8 = 72 takes the Pallas kernel's tail mask."""
    L, D, H, l = 2, 256, 8 * 72, 1
    w1, w3, w2 = _words(rng, L, H, D), _words(rng, L, H, D), _words(rng, L, D, H)
    x = (rng.standard_normal((B, D)) * 0.5).astype(np.float32)
    got = _k6_chain(torch.from_numpy(x), *(torch.from_numpy(w[l]) for w in (w1, w3, w2)),
                    act_gelu).numpy()
    np.testing.assert_allclose(got, _jax_chain(x, w1[l], w3[l], w2[l], act_gelu),
                               rtol=1e-5, atol=1e-5)
    pal = np.asarray(pallas_qmm.gf4_ffn(
        jnp.asarray(x), _planes(w1), _planes(w3), jnp.asarray(w2).transpose(0, 2, 1),
        jnp.int32(l), act_gelu))
    np.testing.assert_allclose(got, pal, rtol=3e-2, atol=3e-2)  # bf16 operands there
    # the wrapper on the CPU: its plain version, no launch counted
    plain = hopper_qmm.gf4_ffn(torch.from_numpy(x), *(torch.from_numpy(w) for w in (w1, w3, w2)),
                               l, act_gelu)
    np.testing.assert_allclose(got, plain.numpy(), rtol=1e-5, atol=1e-5)
    assert hopper_qmm.gf4_ffn.multirow_launches == 0


def _k8_chain(a, r, g, anx, ws, l, ln, act_gelu, eps, sub_mean):
    """K8 on the multi-row path, emulated: wo + residual, ffn-norm, K6's
    chain + residual, the next layer's attn-norm, q/k/v."""
    wo, w1, w3, w2, wq, wk, wv = ws
    r1 = r + _emulated(a, wo[l]).float()
    xn = _norm_t(r1, g[l], eps, sub_mean)
    x = r1 + _k6_chain(xn, w1[l], w3[l], w2[l], act_gelu)
    xq = _norm_t(x, anx[ln], eps, sub_mean)
    return [x] + [_emulated(xq, w[ln]).float() for w in (wq, wk, wv)]


@pytest.mark.parametrize("B,act_gelu,sub_mean", [(2, False, False), (9, True, True),
                                                 (16, False, True)])
def test_k8_chain(rng, interpret, B, act_gelu, sub_mean):
    """The chain at the last layer (q/k/v from the clamped layer) against
    the JAX f32 chain and the Pallas kernel on the plane-permuted layouts
    (as tests/test_torch_ops.py's one-row case)."""
    L, D, Qd, KVd, H, eps = 2, 256, 128, 32, 8 * 72, 1e-5
    l, ln = L - 1, L - 1
    wo, w1, w3, w2 = (_words(rng, L, *s) for s in ((D, Qd), (H, D), (H, D), (D, H)))
    wqkv = _words(rng, L, Qd + 2 * KVd, D)
    wq, wk, wv = wqkv[:, :Qd], wqkv[:, Qd:Qd + KVd], wqkv[:, Qd + KVd:]
    g = (1.0 + rng.standard_normal((L, D)) * 0.1).astype(np.float32)
    anx = (1.0 + rng.standard_normal((L, D)) * 0.1).astype(np.float32)
    a = (rng.standard_normal((B, Qd)) * 0.5).astype(np.float32)
    r = (rng.standard_normal((B, D)) * 0.5).astype(np.float32)
    tws = [torch.from_numpy(np.ascontiguousarray(w)) for w in (wo, w1, w3, w2, wq, wk, wv)]
    got = _k8_chain(torch.from_numpy(a), torch.from_numpy(r), torch.from_numpy(g),
                    torch.from_numpy(anx), tws, l, ln, act_gelu, eps, sub_mean)
    got = [got[0].numpy(), torch.cat(got[1:], 1).numpy()]

    def jq(w, i):
        return jqmm.QTensor(jnp.asarray(w[i]), "gf4")
    act = (lambda v: jax.nn.gelu(v, approximate=True)) if act_gelu else jax.nn.silu
    r1 = r + np.asarray(jqmm.qmatmul(jnp.asarray(a), jq(wo, l)))
    xn = jrmsnorm(jnp.asarray(r1), jnp.asarray(g[l]), eps, sub_mean)
    h = act(jqmm.qmatmul(xn, jq(w1, l))) * jqmm.qmatmul(xn, jq(w3, l))
    x = r1 + np.asarray(jqmm.qmatmul(h, jq(w2, l)))
    xq = jrmsnorm(jnp.asarray(x), jnp.asarray(anx[ln]), eps, sub_mean)
    want = [x, np.asarray(jqmm.qmatmul(xq, jq(wqkv, ln)))]
    for gt, wt in zip(got, want):
        np.testing.assert_allclose(gt, wt, rtol=1e-5, atol=1e-5)

    def pl(v):  # natural (rows, n) -> plane-permuted (rows, 8, n/8)
        return jnp.asarray(v.reshape(v.shape[0], -1, 8).transpose(0, 2, 1))
    w2tp = (jnp.asarray(w2).transpose(0, 2, 1).reshape(L, H // 8, D // 8, 8)
            .transpose(0, 1, 3, 2).reshape(L, H // 8, D))
    x_pl, qkv = pallas_qmm.gf4_offn_qkv(
        pl(a), pl(r), pl(g), pl(anx), _planes(wo), _planes(w1), _planes(w3), w2tp,
        jnp.asarray(wqkv), jnp.int32(l), act_gelu, eps, sub_mean)
    x_pal = np.asarray(x_pl).transpose(0, 2, 1).reshape(B, D)
    for gt, pt in zip(got, (x_pal, np.asarray(qkv))):
        np.testing.assert_allclose(gt, pt, rtol=3e-2, atol=3e-2)  # bf16 operands there
    assert hopper_qmm.gf4_offn_qkv.multirow_launches == 0


# -- the plan with gf4 words ----------------------------------------------------


def _cover(p, seg_rows):
    counts = [np.zeros((r, p.chunks), np.int32) for r in seg_rows]
    for block in range(p.grid):
        for warp in range(MV_WARPS):
            work = p.warp_work(block, warp, seg_rows)
            if work is not None:
                s, r0, r1, c0, c1 = work
                counts[s][r0:r1, c0:c1] += 1
    return counts


@pytest.mark.parametrize("B", range(1, 17))
def test_gf4_plan_covers_rows_off_the_step(B):
    """n % 16 == 8 (an odd number of words a row): K6's w1/w3 and w2 at a
    width of 1032 and a hidden width of 11032, q/k/v beside it, one and
    two n-tiles; every (row, chunk) once."""
    for seg_rows, n, dual in (((11032,), 1032, True), ((1032,), 11032, False),
                              ((1032, 264, 264), 1032, False), ((100,), 8, False)):
        p = qmv_plan(B, seg_rows, n, dual, gf4=True)
        assert p.nt == (1 if B <= 8 else 2) and p.chunks == -(-n // MV_CHUNK)
        assert p.mt == 1 or n % 16 == 0  # the kernel's word loads take one m-tile
        assert all((c == 1).all() for c in _cover(p, seg_rows))
    # a wide launch of whole 16-value steps keeps 32 rows a warp
    assert qmv_plan(B, (11032,), 4096, gf4=True).mt == 2
    assert qmv_plan(B, (11032,), 4104, gf4=True).mt == 1


@pytest.mark.parametrize("n", [8, 24, 56, 72, 1000, 1032, 4096 + 8, 11032])
def test_gf4_lanes_cover_k_once(n):
    """A lane reads the two words of k = 64 c + 16 t .. + 15 where the
    first is inside the row, the second only where it is too (the kernel
    zeroes it past n): over the warps of a row group, every k below n
    once, nothing past it."""
    seg_rows = (100,)
    p = qmv_plan(8, seg_rows, n, gf4=True)
    seen = np.zeros(p.chunks * MV_CHUNK, np.int32)
    for warp in range(p.ks):
        _, _, _, c0, c1 = p.warp_work(0, warp, seg_rows)
        for c in range(c0, c1):
            for t in range(4):
                k0 = c * MV_CHUNK + 16 * t
                left = n - k0
                if left > 0:
                    seen[k0:k0 + 8] += 1
                    if left > 8:
                        seen[k0 + 8:k0 + 16] += 1
    assert (seen[:n] == 1).all() and (seen[n:] == 0).all()


def test_gf4_plan_refuses_and_fp_refusals_stay():
    for bad in ((2, (16,), 12), (2, (16,), 0), (2, (16,), 4), (65, (16,), 16)):
        with pytest.raises(ValueError):
            qmv_plan(*bad, gf4=True)
    for bad in ((2, (16,), 24), (2, (16,), 8), (2, (16,), 1032)):
        with pytest.raises(ValueError):
            qmv_plan(*bad)
        qmv_plan(*bad, gf4=True)
    # K6's launches as the wrapper hands them to the kernel
    arr, words, floats = hopper_qmm._launch_plans(8, (((11032,), 1032, True),
                                                      ((1032,), 11032, False)), True)
    assert arr.shape == (8,) and tuple(arr[:4]) == qmv_plan(8, (11032,), 1032, True,
                                                            True).args()
    assert (words, floats) == qmv_plan(8, (1032,), 11032, gf4=True).staging(11032)
