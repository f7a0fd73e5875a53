"""The multi-row matvec path's tiling and staging on the CPU.

- :func:`hopper_qmm.qmv_plan`, the tiling of ``csrc/qmm.cu``'s
  ``mmv_kernel`` (a pure function of B, the segments' rows and k): the
  warps of its grid, as :meth:`QmvPlan.warp_work` walks them the way the
  kernel does, cover every (segment row, 64-value chunk of k) exactly
  once, and a lane's 16 values of a chunk cover every k below n once; for
  B = 1..16, one segment and q/k/v's three with Qd != KVd, ragged row
  counts and k off the chunk edges.
- :func:`hopper_qmm.split_operand`, the kernel's staging of x written out:
  hi + lo times 2^e rebuilds x to 2^-21 of its chunk's scale, 1e6 stays
  finite, zero rows stay zero, and the product of the staged operands
  (hi and lo products summed per chunk in float64, times 2^e) is the
  plain version's and the JAX package's f32 product to 1e-6 of max |out|.
"""

import numpy as np
import pytest
import torch

from calm_tpu_torch.ops import hopper_qmm
from calm_tpu_torch.ops.hopper_qmm import MV_CHUNK, MV_WARPS, qmv_plan, split_operand

torch.set_num_threads(1)

# (B, segment rows, n): the serving tick's launches at Mistral-7B widths
# (wo, w1/w3, w2, q/k/v, lm-head), chip_smoke.py's ragged shapes, q/k/v
# of other head layouts, and small ones
CASES = [
    (8, (4096,), 4096), (8, (14336,), 4096), (8, (4096,), 14336),
    (8, (4096, 1024, 1024), 4096), (8, (32000,), 4096), (16, (32001,), 4112),
    (3, (1003,), 1040), (16, (1003,), 1040), (5, (512, 128, 128), 512),
    (2, (768,), 512), (9, (512,), 768), (4, (3072, 3072, 3072), 3072),
    (16, (2048, 256, 256), 2048), (2, (100,), 16), (7, (100, 33, 33), 48),
    (1, (4096,), 4096), (12, (17,), 80), (16, (11008,), 4096),
]


def _cover(p, B, seg_rows, n):
    """Count, per segment, how often each (row, chunk) is a warp's, and
    check the grid's shape on the way."""
    counts = [np.zeros((r, p.chunks), np.int32) for r in seg_rows]
    assert MV_WARPS % p.ks == 0 and p.mt in (1, 2) and p.nt in (1, 2)
    assert 8 * p.nt >= B and (B <= 8) == (p.nt == 1)
    assert p.chunks * MV_CHUNK >= n > (p.chunks - 1) * MV_CHUNK
    G = sum(p.groups)
    per = MV_WARPS // p.ks
    assert (p.grid - 1) * per < G <= p.grid * per  # no block without a group
    for block in range(p.grid):
        for warp in range(MV_WARPS):
            work = p.warp_work(block, warp, seg_rows)
            if work is None:
                continue
            s, r0, r1, c0, c1 = work
            assert r0 < r1 and r1 - r0 <= 16 * p.mt
            counts[s][r0:r1, c0:c1] += 1
    return counts


@pytest.mark.parametrize("B,seg_rows,n", CASES)
@pytest.mark.parametrize("dual", [False, True])
def test_plan_covers_each_row_and_chunk_once(B, seg_rows, n, dual):
    p = qmv_plan(B, seg_rows, n, dual=dual)
    for c in _cover(p, B, seg_rows, n):
        assert (c == 1).all()
    assert p.groups == tuple(-(-r // (16 * p.mt)) for r in seg_rows)
    assert p.mt == 1 or not dual


@pytest.mark.parametrize("B", range(1, 17))
def test_plan_every_row_count(B):
    """Every B on the narrow launch and on q/k/v with Qd != KVd."""
    for seg_rows, n in (((4096,), 4096), ((4096, 1024, 1024), 4096),
                        ((4096,), 14336), ((32001,), 4112)):
        p = qmv_plan(B, seg_rows, n)
        assert all((c == 1).all() for c in _cover(p, B, seg_rows, n))


@pytest.mark.parametrize("n", [16, 48, 64, 80, 112, 128, 4096 - 16, 4096, 4112,
                               14336 - 48, 14336])
def test_plan_k_off_the_chunk_edges(n):
    """A lane reads k = 64 c + 16 t .. + 15 of its chunks where that is
    below n (n % 16 == 0: all of the 16 or none): over the warps of one row
    group, every k below n once."""
    seg_rows = (100,)
    p = qmv_plan(8, seg_rows, n)
    ks = np.zeros(p.chunks * MV_CHUNK, np.int32)
    for warp in range(p.ks):  # the ks warps of group 0
        s, r0, r1, c0, c1 = p.warp_work(0, warp, seg_rows)
        for c in range(c0, c1):
            for t in range(4):
                k0 = c * MV_CHUNK + 16 * t
                if k0 < n:
                    ks[k0:k0 + 16] += 1
    assert (ks[:n] == 1).all() and (ks[n:] == 0).all()
    assert all((c == 1).all() for c in _cover(p, 8, seg_rows, n))


def test_plan_fills_the_card():
    """The serving tick's launches keep thousands of warps in flight; a
    short k is not split below MV_MIN_CHUNKS chunks a warp."""
    for seg_rows, n, dual in (((4096,), 4096, False), ((4096,), 14336, False),
                              ((14336,), 4096, True), ((4096, 1024, 1024), 4096, False),
                              ((32000,), 4096, False)):
        p = qmv_plan(8, seg_rows, n, dual=dual)
        assert sum(p.groups) * p.ks >= 2048 or p.ks == MV_WARPS
        assert p.chunks // p.ks >= hopper_qmm.MV_MIN_CHUNKS
    assert qmv_plan(8, (4096,), 128).ks == 1
    words, floats = qmv_plan(16, (4096,), 4112).staging(4112)
    assert words == 65 * 4 * 16 * 4 * 4 and floats == 65 * 16


@pytest.mark.parametrize("B", [2, 8, 9, 16])
def test_epilogue_launch_plans(B):
    """The fused epilogue's four launches (wo, w1/w3, w2, q/k/v) as the
    wrapper hands them to the kernel: {mt, nt, ks, grid} each, the dual
    launch at 16 rows a warp, and one staging scratch for the widest x."""
    D, H, Qd, KVd = 4096, 14336, 4096, 1024
    launches = (((D,), Qd, False), ((H,), D, True), ((D,), H, False),
                ((Qd, KVd, KVd), D, False))
    arr, words, floats = hopper_qmm._launch_plans(B, launches)
    assert arr.dtype == np.int32 and arr.shape == (16,)
    for i, (rows, n, dual) in enumerate(launches):
        assert tuple(arr[4 * i:4 * i + 4]) == qmv_plan(B, rows, n, dual).args()
    assert arr[4] == 1 and all(arr[4 * i + 1] == (1 if B <= 8 else 2) for i in range(4))
    assert (words, floats) == qmv_plan(B, (D,), H).staging(H)


@pytest.mark.parametrize("bad", [(0, (16,), 16), (65, (16,), 16), (2, (16,), 24),
                                 (2, (), 16), (2, (1, 2, 3, 4), 16), (2, (0,), 16)])
def test_plan_refuses(bad):
    with pytest.raises(ValueError):
        qmv_plan(*bad)


# -- the staging of x --------------------------------------------------------


def _x(rng, B, n, spread=False):
    x = rng.standard_normal((B, n)).astype(np.float32)
    if spread:  # rows 2^20 apart in scale, and chunks of mixed magnitude
        x[0::2] *= 1e-3
        x[1::2] *= 1e3
        x[:, :MV_CHUNK] *= 1e-4
    return torch.from_numpy(x)


@pytest.mark.parametrize("n", [16, 64, 1040, 4112])
@pytest.mark.parametrize("spread", [False, True])
def test_split_rebuilds_x(rng, n, spread):
    x = _x(rng, 16, n, spread)
    hi, lo, e = split_operand(x)
    assert hi.dtype == lo.dtype == torch.float16 and e.shape == (16, -(-n // MV_CHUNK))
    scale = torch.ldexp(torch.ones(()), e.double()).repeat_interleave(MV_CHUNK, 1)[:, :n]
    got = (hi.double() + lo.double()) * scale
    assert ((got - x.double()).abs() <= 2.0 ** -21 * scale).all()
    # the scale bounds the chunk: |x| < 2^e, and within a factor 2 of its max
    xc = torch.nn.functional.pad(x.abs(), (0, e.shape[1] * MV_CHUNK - n))
    m = xc.reshape(16, -1, MV_CHUNK).amax(-1).double()
    s = torch.ldexp(torch.ones(()), e.double())
    assert (m < s).all() and (m >= s / 2).all()


def test_split_large_and_zero(rng):
    x = _x(rng, 4, 128)
    x[0] = 0.0
    x[1] = 1e6
    x[2, ::2] = -1e6
    hi, lo, e = split_operand(x)
    assert torch.isfinite(hi).all() and torch.isfinite(lo).all()
    assert (hi[0] == 0).all() and (lo[0] == 0).all() and (e[0] == 0).all()
    assert (e[1] == 20).all() and (e[2] == 20).all()
    rebuilt = (hi.double() + lo.double()) * torch.ldexp(
        torch.ones(()), e.double()).repeat_interleave(MV_CHUNK, 1)
    assert torch.equal(rebuilt[1], x[1].double())


_TORCH = {"fp16": torch.float16, "fp8": torch.float8_e5m2}


def _emulated(x, w_f64, chunk=MV_CHUNK):
    """The kernel's arithmetic on the staged operands: per chunk, the hi
    and lo products (exact: f16 times f16) summed in float64, times 2^e."""
    hi, lo, e = split_operand(x, chunk)
    B, n = x.shape
    y = torch.zeros((B, w_f64.shape[0]), dtype=torch.float64)
    for c in range(e.shape[1]):
        ks = slice(c * chunk, min(n, (c + 1) * chunk))
        part = hi[:, ks].double() @ w_f64[:, ks].T + lo[:, ks].double() @ w_f64[:, ks].T
        y += part * torch.ldexp(torch.ones(()), e[:, c].double())[:, None]
    return y


@pytest.mark.parametrize("fmt", ["fp8", "fp16"])
@pytest.mark.parametrize("B", [2, 8, 16])
@pytest.mark.parametrize("spread", [False, True])
def test_split_product_matches_plain_and_jax(rng, fmt, B, spread):
    import jax.numpy as jnp

    from calm_tpu import quant as jquant
    from calm_tpu.ops import qmm as jqmm

    d, n = 96, 1040
    wj = jquant.quantize((rng.standard_normal((2, d, n)) * 0.1).astype(np.float32), fmt)
    wa = np.ascontiguousarray(wj)
    w = (torch.from_numpy(wa.view(np.uint8)).view(torch.float8_e5m2) if fmt == "fp8"
         else torch.from_numpy(wa))
    assert w.dtype == _TORCH[fmt]
    x = _x(rng, B, n, spread)
    wf = w[1].double()
    got = _emulated(x, wf)
    plain = hopper_qmm.qmm_decode_plain(x, w, fmt, 1).double()
    want = torch.tensor(np.asarray(jqmm.qmatmul(
        jnp.asarray(x.numpy()), jqmm.QTensor(jnp.asarray(wj), fmt), layer=jnp.int32(1))),
        dtype=torch.float64)
    exact = x.double() @ wf.T
    # to max |out|; the JAX package's f32 sums are themselves ~1e-6 from
    # the exact product, so only it is held to the whole output's scale
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()
    for ref in (plain, exact):
        # each row to its own scale: a row 2^20 below another keeps its digits
        tol = 1e-6 * ref.abs().amax(-1, keepdim=True)
        assert ((got - ref).abs() <= tol).all()
