"""The wide multi-row path (17-64 rows: a speculative verify's 8 x 5, a
tick of 17-64 slots) against calm_tpu on the CPU: its routing as pure
functions (``qmv_plan``, ``decode_path``, ``mm_route``,
``moe_multirow_supported``, ``moe_sweeps``) at 17, 24, 40 and 64 rows and
the refusal past 64; each format's product as the kernel computes it (x
staged with one power-of-two scale a row, one f16 term or two under
--precise, the weights exact in f16) against ``calm_tpu.ops.qmm.qmatmul``'s
f32 path; the MoE FFN at 40 rows (the expert sweep) against JAX's per-token
vmap for Mixtral-style top-2 with renorm and OLMoE-style top-8 of 16
without; the MoE verify (B=8 at T=5, the k=3, m=4 tree) against JAX's
``prefill(..., logits_mode="all")`` and ``tree_verify``, its captured body
free of host reads; and a speculative MoE ``Server``'s greedy ids against
``calm_tpu.serve.Server``'s."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calm_tpu import model as JM
from calm_tpu import quant as jquant
from calm_tpu import serve as JS
from calm_tpu.container import TensorFile as JTensorFile
from calm_tpu.ops import qmm as jqmm
from calm_tpu_torch import model as TM
from calm_tpu_torch import serve as TS
from calm_tpu_torch.config import ModelConfig
from calm_tpu_torch.container import TensorFile
from calm_tpu_torch.ops import hopper_attn, hopper_qmm
from calm_tpu_torch.ops import qmm as tqmm
from calm_tpu_torch.ops.hopper_qmm import (MAX_MV_ROWS, MAX_ROWS, MV_WARPS, WIDE_K,
                                           WIDE_NT, WIDE_PREC_ROWS, WIDE_WIDTHS, qmv_plan)
from tests.modelgen import tiny_config, write_tiny_model
from tests.test_torch_model import jax_leaves
from tests.test_torch_speculative import _rand_cache, _tree_inputs, no_host_reads

torch.set_num_threads(1)
ROWS = (17, 24, 40, 64)
FMTS = ("fp16", "fp8", "fp8e4", "gf4")


# -- routing, as pure functions ----------------------------------------------


def _tma_cover(p, rows):
    """Every (output row, WIDE_K-value stage) of one slot, and every (tile,
    row of x) stored, counted over the plan's blocks as the kernel walks
    them; the k parts of each tile in rank order (block % ks) with their
    stages and their rows of x."""
    rows_k = np.zeros((rows, p.stages), np.int32)
    stored = np.zeros((p.tiles, p.B), np.int32)
    order = {}
    for blk in range(p.grid):
        r0, r1, s0, s1, b0, b1 = p.block_work(blk, rows)
        rows_k[r0:r1, s0:s1] += 1
        stored[blk // p.ks, b0:b1] += 1
        order.setdefault(blk // p.ks, []).append((blk % p.ks, s0, s1))
    return rows_k, stored, order


def _check_tma_plan(p, B, rows, n, dual, slots=1):
    assert isinstance(p, hopper_qmm.WidePlan)
    assert p.width == min(w for w in WIDE_WIDTHS if w >= B) and p.B == B
    assert p.tile == (64 if dual else 128) and p.slots == slots
    assert p.ks in (1, 2, 4, 8) and p.stages == -(-n // WIDE_K) and p.stages // p.ks >= 1
    assert p.args() == (p.tile // 16, p.width // 8, p.ks, p.tiles * p.ks)
    rows_k, stored, order = _tma_cover(p, rows)
    assert (rows_k == 1).all() and (stored == 1).all()
    for parts in order.values():  # the sums meet in rank order, each part's k after the last
        assert [kp for kp, _, _ in parts] == list(range(p.ks))
        assert parts[0][1] == 0 and parts[-1][2] == p.stages
        assert all(a[2] == b[1] for a, b in zip(parts, parts[1:]))
    # the split stops at a block an SM, or at the parts' least stages
    more = p.tiles * 2 * p.ks * slots <= hopper_qmm.WIDE_TARGET_BLOCKS
    assert p.ks == 8 or not more or p.stages // (2 * p.ks) < hopper_qmm.WIDE_MIN_STAGES
    npad = -(-n // WIDE_K) * WIDE_K
    assert p.staging(n) == (64 * npad // 2, 64)


@pytest.mark.parametrize("B", ROWS)
@pytest.mark.parametrize("seg,n,dual,gf4", [((32000,), 4096, False, False),
                                            ((4096,), 14336, False, False),
                                            ((14336,), 4096, True, False),
                                            ((4096, 1024, 1024), 4096, False, False),
                                            ((1000,), 1032, False, True),
                                            ((24,), 8, True, True)])
@pytest.mark.parametrize("terms", [1, 2])
def test_wide_plan_covers_every_row_and_chunk_once(B, seg, n, dual, gf4, terms):
    """Past 16 rows one segment a launch (q/k/v side by side refused). x in
    one term on weight rows TMA reads (every format but gf4 rows of n % 32
    != 0): ``wide_kernel``'s plan, every (row, stage) once and every row of
    x stored once a tile. Else ``mmw_kernel``'s: WIDE_NT n-tiles
    (WIDE_PREC_ROWS / 8 under --precise), 32 rows a warp for one weight's
    launches of whole 16-value steps (16 under --precise, in the dual launch
    and for rows of an odd word count), k split as at 2-16 rows; every
    (row, chunk) of every segment taken by exactly one warp; the staging
    holds 64 row slots of `terms` terms."""
    if len(seg) > 1:
        with pytest.raises(ValueError):
            qmv_plan(B, seg, n, dual, gf4, terms=terms)
        return
    p = qmv_plan(B, seg, n, dual, gf4, terms=terms)
    if hopper_qmm.wide_tma(n, gf4, terms):
        _check_tma_plan(p, B, seg[0], n, dual)
        return
    assert p.nt == (WIDE_NT if terms == 1 else WIDE_PREC_ROWS // 8)
    assert p.mt == (2 if terms == 1 and not dual and n % 16 == 0 else 1)
    assert MV_WARPS % p.ks == 0 and 8 * WIDE_NT >= B
    seen = [np.zeros((r, p.chunks), np.int32) for r in seg]
    for blk in range(p.grid):
        for warp in range(MV_WARPS):
            wk = p.warp_work(blk, warp, seg)
            if wk is not None:
                s, r0, r1, c0, c1 = wk
                seen[s][r0:r1, c0:c1] += 1
    assert all((v == 1).all() for v in seen)
    nc = -(-n // 64)
    assert p.staging(n, terms) == (nc * 4 * 64 * 4 * 2 * terms, 64)


# (rows, n, dual, slots) of the launches the served paths make past 16 rows
SERVED_SHAPES = {
    "mistral7b q/wo": (4096, 4096, False, 1), "mistral7b k/v": (1024, 4096, False, 1),
    "mistral7b w1/w3": (14336, 4096, False, 1), "mistral7b w2": (4096, 14336, False, 1),
    "mistral7b lm-head": (32000, 4096, False, 1), "aya23-8b lm-head": (256000, 4096, False, 1),
    "mixtral w1/w3 dual": (14336, 4096, True, 8), "mixtral w2": (4096, 14336, False, 8),
    "olmoe w1/w3 dual": (1024, 2048, True, 64), "olmoe w2": (2048, 1024, False, 64),
    "ragged": (1000, 1040, False, 1), "ragged dual": (1000, 1040, True, 7),
    "ragged short k": (200, 16, False, 1), "one tile": (24, 4096, True, 1),
}


@pytest.mark.parametrize("name", sorted(SERVED_SHAPES))
def test_wide_plan_covers_the_served_shapes(name):
    """``wide_plan`` at 17, 24, 40 and 64 rows for each launch of the
    served paths (Mistral-7B, the Aya 23 8B lm-head, Mixtral 8x7B's and
    OLMoE's expert sweeps, ragged rows and k): every (output row, stage) of
    a slot once, every row of x stored once a tile, the k parts of a tile
    in rank order covering k once (their sums meet in that order), the
    split stopped where the plan says; the same plan from ``qmv_plan``."""
    rows, n, dual, slots = SERVED_SHAPES[name]
    for B in ROWS:
        p = hopper_qmm.wide_plan(B, rows, n, dual, slots)
        _check_tma_plan(p, B, rows, n, dual, slots)
        assert qmv_plan(B, (rows,), n, dual, slots=slots) == p
    # Mistral-7B's verify: a whole k where tiles fill the card, split where few
    p = {k: hopper_qmm.wide_plan(40, *SERVED_SHAPES[k]) for k in SERVED_SHAPES}
    assert p["mistral7b lm-head"].ks == 1 and p["mistral7b k/v"].ks == 8
    assert p["mistral7b q/wo"].ks == 4 and p["mistral7b w2"].ks == 4


@pytest.mark.parametrize("B", [0, 1, 2, 16, 65, 128])
def test_wide_plan_refuses_rows_outside_17_to_64(B):
    """The wide kernel takes 17..64 rows of x: below, the multi-row path's
    plan (mmv_kernel); past 64 nothing (``qmv_plan`` refuses too)."""
    with pytest.raises(ValueError):
        hopper_qmm.wide_plan(B, 4096, 4096)
    if 1 <= B <= MAX_ROWS:
        assert isinstance(qmv_plan(B, (4096,), 4096), hopper_qmm.QmvPlan)
    else:
        with pytest.raises(ValueError):
            qmv_plan(B, (4096,), 4096)
    with pytest.raises(ValueError):
        hopper_qmm.wide_plan(40, 4096, 4104)  # k off the 16-value steps


@pytest.mark.parametrize("B", ROWS)
def test_wide_routes(B):
    """17-64 rows: ``decode_path`` "wide", ``mm_route`` "mv" in every
    format and mode (gf4 too, which K4 could take from 32 rows), the MoE
    sweep supported in every format; the launch arrays the wrappers hand
    the kernels are their plans' arguments."""
    assert hopper_qmm.decode_path(B) == "wide"
    for fmt in FMTS:
        assert hopper_qmm.moe_multirow_supported(fmt, B, 4096, 14336)
        qt = tqmm.QTensor(torch.zeros((2, 64, 128 // (8 if fmt == "gf4" else 1)),
                                      dtype=tqmm.STORAGE[fmt]), fmt)
        assert TM.mm_route(B, qt) == TM.mm_route(B, qt, precise=True) == "mv"
    assert not hopper_qmm.moe_multirow_supported("fp8", B, 1040 + 8)
    for terms in (1, 2):
        arr, words, floats = hopper_qmm._launch_plans(B, (((4096,), 4096, False),), False,
                                                      terms)
        p = qmv_plan(B, (4096,), 4096, terms=terms)
        assert tuple(arr) == p.args() and (words, floats) == p.staging(4096, terms)
        arr, words, floats = hopper_qmm._moe_plans(B, 8, ((1024, 512, True, 1),
                                                          (512, 1024, False, 8)), False, terms)
        assert tuple(arr[:4]) == qmv_plan(B, (1024,), 512, True, slots=8, terms=terms).args()
        assert tuple(arr[4:]) == qmv_plan(B, (512,), 1024, slots=8, terms=terms).args()
        assert (words, floats) == tuple(8 * v for v in qmv_plan(B, (512,), 1024, slots=8,
                                                                 terms=terms).staging(1024,
                                                                                      terms))


def test_wide_refusals_past_64():
    """65 rows: the plan and the decode path raise, ``mm_route`` goes to
    ``qmm_mm8`` (gf4: its matmul kernel; ``dense_matmul`` under --precise),
    the sweep declines and the
    MoE FFN takes the grouped products; the fused epilogues keep 16."""
    for bad in ((65, (16,), 16), (65, (16,), 8)):
        with pytest.raises(ValueError):
            qmv_plan(*bad, gf4=bad[2] == 8)
    with pytest.raises(ValueError):
        hopper_qmm.decode_path(MAX_MV_ROWS + 1)
    for fmt in FMTS:
        assert not hopper_qmm.moe_multirow_supported(fmt, 65, 4096)
        qt = tqmm.QTensor(torch.zeros((2, 64, 128 // (8 if fmt == "gf4" else 1)),
                                      dtype=tqmm.STORAGE[fmt]), fmt)
        assert TM.mm_route(65, qt) == ("mm" if fmt == "gf4" else "mm8")
        assert TM.mm_route(65, qt, precise=True) == "dense"
    shapes = (128, 256, 128, 128)
    assert hopper_qmm.qx_offn_supported("fp8", MAX_ROWS, shapes)
    assert not hopper_qmm.qx_offn_supported("fp8", MAX_ROWS + 1, shapes)
    assert not hopper_qmm.gf4_offn_supported(MAX_ROWS + 1, shapes)


# -- the product as the kernel computes it ------------------------------------


def _plane(rng, d, n, fmt):
    """A quantized (d, n) plane from calm_tpu.quant, its fp8e4 scale."""
    w = (rng.standard_normal((d, n)) * 0.1).astype(np.float32)
    if fmt == "fp8e4":
        q, s = jquant.quantize_scaled(w, "fp8e4")
        return np.asarray(q), np.asarray(s, np.float32).reshape(1)
    return np.asarray(jquant.quantize(w, fmt)), None


def _torch_plane(q, fmt):
    q = np.ascontiguousarray(q)
    if fmt == "fp8":
        return torch.from_numpy(q.view(np.uint8)).view(torch.float8_e5m2)
    if fmt == "fp8e4":
        return torch.from_numpy(q.view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(q)


def _emulated(x, wt, fmt, scale, terms):
    """The wide kernel's product in PyTorch: x staged by
    ``hopper_qmm.wide_operand`` (one scale a row, f16 terms), the weights
    exact in f16, f32 sums, the row's scale and the fp8e4 scale after."""
    hi, lo, e = hopper_qmm.wide_operand(x, terms)
    xs = hi.float() if lo is None else hi.float() + lo.float()
    wf = tqmm.dequant(tqmm.QTensor(wt, fmt), torch.float32)
    assert torch.equal(wf.half().float(), wf)  # every weight exact in f16
    y = (xs.double() @ wf.double().T).float() * torch.ldexp(torch.ones(()), e.float())[:, None]
    return y if scale is None else y * scale


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("B", ROWS)
def test_wide_product_matches_jax_qmatmul(rng, fmt, B):
    """Each format at 17-64 rows against ``calm_tpu.ops.qmm.qmatmul``'s f32
    path (rows 2^20 apart): the wrapper on the CPU (its plain version)
    within 1e-5 of each row's max (f32 sums in another order); the kernel's staging with one f16 term
    within 2^-11 of sum |x| |w| of each output (x rounded to f16 once: at
    most 2^-12 of each value), with hi + lo (--precise) within 2^-21."""
    d, n = 96, 1040 if fmt != "gf4" else 1032
    q, s = _plane(rng, d, n, fmt)
    x = rng.standard_normal((B, n)).astype(np.float32)
    x[::3] *= 2.0 ** 20
    want = np.asarray(jqmm.qmatmul(jnp.asarray(x), jqmm.QTensor(jnp.asarray(q), fmt,
                                   None if s is None else jnp.asarray(s))), np.float32)
    wt = _torch_plane(q, fmt)
    sc = None if s is None else torch.from_numpy(s)
    xt = torch.from_numpy(x)
    got = hopper_qmm.qmm_decode(xt, wt, fmt, None, sc).numpy()
    row = np.abs(want).max(-1, keepdims=True)
    assert (np.abs(got - want) / row).max() < 1e-5
    wf = tqmm.dequant(tqmm.QTensor(wt, fmt), torch.float32).numpy()
    mag = np.abs(x).astype(np.float64) @ np.abs(wf).T.astype(np.float64) * (
        1.0 if s is None else float(s[0]))
    for terms, bound in ((1, 2.0 ** -11), (2, 2.0 ** -21)):
        emu = _emulated(xt, wt, fmt, sc, terms).numpy()
        assert (np.abs(emu - want) <= bound * mag + 1e-5 * row).all(), terms


def test_wide_operand_keeps_each_row_to_its_scale(rng):
    """One power-of-two scale a row: 2^e > max |x| >= 2^(e-1), hi + lo
    carries every value to 2^-22 of 2^e; a row of zeros stages zeros."""
    x = rng.standard_normal((40, 200)).astype(np.float32)
    x[1] *= 2.0 ** 30
    x[2] *= 2.0 ** -30
    x[3] = 0
    xt = torch.from_numpy(x)
    hi, lo, e = hopper_qmm.wide_operand(xt, 2)
    m = np.abs(x).max(-1)
    p = np.ldexp(1.0, e.numpy())
    live = m > 0
    assert (m[live] < p[live]).all() and (m[live] >= p[live] / 2).all()
    back = (hi.double() + lo.double()).numpy() * p[:, None]
    assert (np.abs(back - x) <= 2.0 ** -22 * p[:, None]).all()
    assert not hi[3].any() and not lo[3].any()
    one, none, _ = hopper_qmm.wide_operand(xt, 1)
    assert none is None and torch.equal(one, hi)


def _stage_wide_emulated(x):
    """``stage_wide_kernel``'s writes, its index arithmetic written out:
    the row's scale 2^e (frexp of its max), and for float4 c of the row (k
    = 4 c; zeros past n to the stage's end), t = (k >> 5) % 4 and s = (k >>
    2) % 8: x[k], x[k + 1] to p = (k & ~127) + 16 s + 2 t, x[k + 2], x[k +
    3] to p + 8."""
    B, n = x.shape
    npad = -(-n // WIDE_K) * WIDE_K
    _, e = torch.frexp(x.abs().amax(-1))
    v = torch.zeros((B, npad), dtype=torch.float16)
    v[:, :n] = torch.ldexp(x, -e[:, None].float()).half()
    out = torch.zeros((B, npad), dtype=torch.float16)
    for c in range(npad // 4):
        k = 4 * c
        t, st = (k >> 5) & 3, (k >> 2) & 7
        p = (k & ~(WIDE_K - 1)) + 16 * st + 2 * t
        out[:, p:p + 2] = v[:, k:k + 2]
        out[:, p + 8:p + 10] = v[:, k + 2:k + 4]
    return out, e.to(torch.int32)


def _split_rows_emulated(x, terms):
    """``split_rows_kernel``'s writes for ``mmw_kernel`` (--precise, gf4
    rows of n % 32 != 0): float4 c of row b ({hi01, hi23}, and lo the same
    at the second term's offset) to uint2 ((c // 16 * 4 + c % 4) 64 + b) 4 +
    c // 4 % 4; read back as ``mmw_kernel``'s lane (g, t) reads it, x row g,
    k = 64 chunk + 16 t + 4 s + j at step s: (hi, lo) in natural order."""
    B, n = x.shape
    nc = -(-n // 64)
    _, e = torch.frexp(x.abs().amax(-1))
    f = torch.zeros((B, nc * 64))
    f[:, :n] = torch.ldexp(x, -e[:, None].float())
    hi = f.half()
    lo = (f - hi.float()).half()
    frags = torch.zeros((terms, nc * 4 * 64 * 4, 4), dtype=torch.float16)
    for c in range(nc * 16):
        o = ((c // 16 * 4 + c % 4) * 64 + np.arange(B)) * 4 + c // 4 % 4
        frags[0, o] = hi[:, 4 * c:4 * c + 4]
        if terms == 2:
            frags[1, o] = lo[:, 4 * c:4 * c + 4]
    back = torch.zeros((terms, B, nc * 64), dtype=torch.float16)
    for chunk in range(nc):
        for t in range(4):
            for st in range(4):
                k = 64 * chunk + 16 * t + 4 * st
                back[:, :, k:k + 4] = frags[:, ((chunk * 4 + st) * 64 + np.arange(B)) * 4 + t]
    return back[0, :, :n], (back[1, :, :n] if terms == 2 else None), e.to(torch.int32)


@pytest.mark.parametrize("n", [16, 208, 1040, 4096])
def test_wide_staging_bytes_match_wide_operand(rng, n):
    """The stagings' byte layouts written out from the kernels' index
    arithmetic: ``stage_wide_kernel``'s equals ``hopper_qmm.wide_staged``,
    and un-permuted by ``wide_perm`` (zeros past n) it is ``wide_operand``'s
    hi with its e; ``split_rows_kernel``'s, read back in ``mmw_kernel``'s
    lane order, is ``wide_operand``'s hi, lo and e (one and two terms).
    Rows 2^20 apart, a row of zeros."""
    x = rng.standard_normal((40, n)).astype(np.float32)
    x[::3] *= 2.0 ** 20
    x[5] = 0
    xt = torch.from_numpy(x)
    hi, lo, e = hopper_qmm.wide_operand(xt, 2)
    staged, es = _stage_wide_emulated(xt)
    got, eg = hopper_qmm.wide_staged(xt)
    assert torch.equal(staged, got) and torch.equal(es, e) and torch.equal(eg, e)
    npad = staged.shape[1]
    assert npad % WIDE_K == 0 and npad - n < WIDE_K
    back = torch.zeros_like(staged)
    k = torch.from_numpy(hopper_qmm.wide_perm())
    idx = (torch.arange(npad // WIDE_K)[:, None] * WIDE_K + k[None, :]).reshape(-1)
    back[:, idx] = staged
    assert torch.equal(back[:, :n], hi) and not back[:, n:].any()
    assert qmv_plan(40, (64,), n).staging(n) == (64 * npad // 2, 64)
    for terms in (1, 2):
        h, l, ee = _split_rows_emulated(xt, terms)
        assert torch.equal(h, hi) and torch.equal(ee, e)
        assert (l is None) if terms == 1 else torch.equal(l, lo)


def _lane_k(fmt: str, r: int, t: int) -> list:
    """The stage's k of each value of lane t's words of row r, as
    ``wt_load`` reads shared memory that TMA filled: the 128-byte swizzle
    puts logical 16-byte chunk c of row r at chunk c ^ (r % 8) (e5m2/e4m3 128
    bytes a row, fp16 two boxes of 128, gf4 64 bytes unswizzled); the lane
    reads physical chunks and so gets logical ones. A word's values, k
    ascending."""
    words = []
    if fmt == "gf4":  # chunk t of 64 bytes: 4 words of 8 values
        for w in range(4):
            words.append([8 * (4 * t + w) + j for j in range(8)])
    elif fmt == "fp16":  # box t // 2, physical chunks (4 (t % 2) + h) ^ (r % 8)
        for h in range(4):
            phys = (4 * (t & 1) + h) ^ (r & 7)
            logical = phys ^ (r & 7)
            for w in range(4):
                words.append([64 * (t >> 1) + 8 * logical + 2 * w + j for j in range(2)])
    else:  # physical chunks (2 t + h) ^ (r % 8)
        for h in range(2):
            logical = ((2 * t + h) ^ (r & 7)) ^ (r & 7)
            for w in range(4):
                words.append([16 * logical + 4 * w + j for j in range(4)])
    return words


def _frag_k(fmt: str, words: list, s: int) -> tuple:
    """``wt_frag``'s step s: the k of its a01 pair and its a23 pair."""
    if fmt == "gf4":  # half s % 2 of word s // 2: codes 4 h .. 4 h + 3
        v = words[s >> 1][4 * (s & 1):4 * (s & 1) + 4]
        return v[:2], v[2:]
    if fmt == "fp16":
        return words[2 * s], words[2 * s + 1]
    return words[s][:2], words[s][2:]


@pytest.mark.parametrize("fmt", ["fp16", "fp8", "gf4"])
def test_wide_fragments_read_the_staged_order(fmt):
    """For every row of a warpgroup's 64, lane quad t and step s: the A
    operand slots 2 t, 2 t + 1 (a01) and 8 + 2 t, 9 + 2 t (a23) that
    ``wt_load`` and ``wt_frag`` give hold the weights of the very k that
    the staging put at x's positions 16 s + slot (``wide_perm``), and each
    lane's 32 values of a row are k = 32 t .. 32 t + 31 once."""
    perm = hopper_qmm.wide_perm()
    for r in range(64):
        for t in range(4):
            words = _lane_k(fmt, r, t)
            assert sorted(k for w in words for k in w) == list(range(32 * t, 32 * t + 32))
            for st in range(8):
                a01, a23 = _frag_k(fmt, words, st)
                assert list(a01) == [perm[16 * st + 2 * t], perm[16 * st + 2 * t + 1]]
                assert list(a23) == [perm[16 * st + 8 + 2 * t], perm[16 * st + 9 + 2 * t]]


@pytest.mark.parametrize("fmt", FMTS)
def test_wide_k_split_emulated_matches_qmatmul(rng, fmt):
    """The kernel's arithmetic with its k split, written out: x staged
    (``wide_staged``, one scale a row), the weights exact in f16 in the
    staged order, each k part's f32 sums over its stages, the parts added in
    rank order, then the row's scale (and the fp8e4 scale): within 2^-11 of
    sum |x| |w| of ``calm_tpu.ops.qmm.qmatmul``'s f32 path, as the unsplit
    product (rows 2^20 apart)."""
    B, d, n = 40, 256, 2048
    p = hopper_qmm.wide_plan(B, d, n)
    assert p.ks > 1
    q, sc = _plane(rng, d, n, fmt)
    x = rng.standard_normal((B, n)).astype(np.float32)
    x[::3] *= 2.0 ** 20
    want = np.asarray(jqmm.qmatmul(jnp.asarray(x), jqmm.QTensor(jnp.asarray(q), fmt,
                                   None if sc is None else jnp.asarray(sc))), np.float32)
    wt = _torch_plane(q, fmt)
    wf = tqmm.dequant(tqmm.QTensor(wt, fmt), torch.float32)
    staged, e = hopper_qmm.wide_staged(torch.from_numpy(x))
    k = torch.from_numpy(hopper_qmm.wide_perm())
    idx = (torch.arange(p.stages)[:, None] * WIDE_K + k[None, :]).reshape(-1)
    wp = torch.zeros((d, p.stages * WIDE_K))
    wp[:, :n] = wf
    wp = wp[:, idx]  # the weights in the staged order, zeros past n
    y = torch.zeros((B, d))
    for blk in range(p.ks):  # tile 0's parts, rank order
        _, _, s0, s1, _, _ = p.block_work(blk, d)
        cols = slice(s0 * WIDE_K, s1 * WIDE_K)
        y = y + staged[:, cols].float() @ wp[:, cols].T
    y = y * torch.ldexp(torch.ones(()), e.float())[:, None]
    if sc is not None:
        y = y * torch.from_numpy(sc)
    mag = np.abs(x).astype(np.float64) @ np.abs(wf.numpy()).T.astype(np.float64) * (
        1.0 if sc is None else float(sc[0]))
    row = np.abs(want).max(-1, keepdims=True)
    assert (np.abs(y.numpy() - want) <= 2.0 ** -11 * mag + 1e-5 * row).all()


# -- the MoE FFN at 40 rows against JAX's per-token vmap ---------------------

MOE = {"mixtral": dict(dtype="fp16", n_experts=8, n_experts_ac=2),
       "olmoe": dict(dtype="fp16", n_experts=16, n_experts_ac=8, moe_renorm=False),
       "fp8": dict(dtype="fp8", n_experts=8, n_experts_ac=2),
       "gf4": dict(dtype="gf4", n_experts=8, n_experts_ac=2, dim=64, hidden_dim=64,
                   head_dim=16, rotary_dim=16)}


def _moe_pair(tmp_path, name, seed=5):
    cfg = tiny_config(seq_len=32, moe=True, **MOE[name])
    path = str(tmp_path / f"wide-{name}.calm")
    write_tiny_model(path, cfg, seed=seed)
    jtf = JTensorFile(path)
    cfg_j = JM.ModelConfig.from_metadata(jtf.metadata)
    wj = JM.load_weights(jtf, cfg_j)
    cfg_t = ModelConfig.from_metadata(TensorFile(path).metadata)
    return path, (cfg_j, wj), (cfg_t, TM.weights_from_numpy(jax_leaves(wj), cfg_t))


@pytest.mark.parametrize("name", ["mixtral", "olmoe"])
def test_moe_ffn_40_rows_matches_jax_vmap(tmp_path, rng, name):
    """40 rows of one layer's MoE FFN: the port's expert sweep (every unique
    expert's weights once for all rows, ``moe_sweeps``) against JAX's
    per-token vmap (``calm_tpu/model.py:829-857``), within 1e-5 of each
    row's max; the grouped products (the route past 64 rows) give the same
    rows."""
    _, (cfg_j, wj), (cfg, w) = _moe_pair(tmp_path, name)
    R = 40
    assert TM.moe_sweeps(w.layers, R) and not TM.moe_sweeps(w.layers, MAX_MV_ROWS + 1)
    x = rng.standard_normal((R, cfg.dim)).astype(np.float32)
    for layer in range(cfg.n_layers):
        want = np.asarray(JM._moe_ffn(cfg_j, jnp.asarray(x)[None], wj.layers, layer,
                                      JM.NO_SHARDING), np.float32)[0]
        got = TM._moe_ffn(cfg, w.layers, layer, torch.from_numpy(x)).numpy()
        row = np.abs(want).max(-1, keepdims=True)
        assert (np.abs(got - want) / row).max() < 1e-5
        wts, idx = TM.route(cfg, TM._mm(torch.from_numpy(x), w.layers.moegate, layer))
        grouped = TM._moe_grouped(cfg, w.layers, layer, torch.from_numpy(x), wts, idx,
                                  TM.NO_SHARDING, None).numpy()
        assert (np.abs(grouped - got) / row).max() < 1e-5


# -- the MoE verify ----------------------------------------------------------


@pytest.mark.parametrize("name", ["mixtral", "fp8", "gf4"])
def test_moe_verify_matches_jax(tmp_path, rng, name):
    """B=8 at T=5 (40 rows: the sweep) from a 6-token prefill each, and the
    k=3, m=4 tree at B=1: ``verify_once`` on the CPU against JAX's
    ``prefill(..., logits_mode="all")`` and ``tree_verify``, within 1e-4 of
    each row's max logit and the same argmaxes."""
    _, (cfg_j, wj), (cfg, w) = _moe_pair(tmp_path, name)
    B, T = 8, 5
    pre = rng.integers(3, cfg.vocab_size, (B, 6))
    toks = rng.integers(3, cfg.vocab_size, (B, T))
    cj = JM.KVCache.create(cfg_j, B, jnp.float32)
    ct = TM.KVCache.create(cfg, B, torch.float32)
    _, cj = JM.prefill(cfg_j, wj, jnp.asarray(pre, jnp.int32), jnp.zeros(B, jnp.int32), cj)
    TM.prefill(cfg, w, torch.from_numpy(pre), [0] * B, ct)
    want, cj = JM.prefill(cfg_j, wj, jnp.asarray(toks, jnp.int32), jnp.full(B, 6, jnp.int32),
                          cj, logits_mode="all")
    got = TM.verify_once(cfg, w, toks.tolist(), [6] * B, ct)
    want = np.asarray(want, np.float32)
    row = np.abs(want).max(-1, keepdims=True)
    assert (np.abs(got.numpy() - want) / row).max() < 1e-4
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))

    c1j = JM.KVCache.create(cfg_j, 1, jnp.float32)
    c1 = TM.KVCache.create(cfg, 1, torch.float32)
    _, c1j = JM.prefill(cfg_j, wj, jnp.asarray(pre[:1], jnp.int32), jnp.zeros(1, jnp.int32),
                        c1j)
    TM.prefill(cfg, w, torch.from_numpy(pre[:1]), [0], c1)
    N, tree, depth, ttoks = _tree_inputs(cfg, rng, 3, 4)
    want, _ = JM.tree_verify(cfg_j, wj, jnp.asarray(ttoks, jnp.int32), jnp.array([6], jnp.int32),
                             jnp.asarray(depth), jnp.asarray(tree), c1j)
    got = TM.verify_once(cfg, w, ttoks.tolist(), [6], c1, depth, tree)
    want = np.asarray(want, np.float32)
    row = np.abs(want).max(-1, keepdims=True)
    assert (np.abs(got.numpy() - want) / row).max() < 1e-4
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("tree", [False, True])
def test_moe_verify_graph_body_reads_nothing_on_the_host(tmp_path, rng, monkeypatch, tree):
    """A MoE target's VerifyGraph body (B=8, T=5: 40 rows through the
    expert sweep, or the k=3, m=4 tree) runs with every host read and
    upload refused, as a capture needs, and gives the eager forward's
    logits and cache rows bit for bit; ``verify_once`` would replay it on
    the card (``moe_sweeps``)."""
    S = tiny_config().seq_len
    monkeypatch.setattr(TM, "prefill_attention",
                        lambda *a: hopper_attn.prefill_attention_plain(*a, rows=S))
    _, _, (cfg, w) = _moe_pair(tmp_path, "mixtral")
    B = 1 if tree else 8
    base = _rand_cache(rng, (cfg.n_layers, B, cfg.n_kv_heads, cfg.seq_len, cfg.head_dim),
                       torch.bfloat16)
    a = TM.KVCache(base.clone(), base.clone() * 0.5)
    b = TM.KVCache(a.k.clone(), a.v.clone())
    if tree:
        T, mask, depth, toks = _tree_inputs(cfg, rng, 3, 4)
        starts = [7]
        want = TM.tree_verify(cfg, w, torch.from_numpy(toks), starts,
                              torch.from_numpy(depth), torch.from_numpy(mask), b)[0]
    else:
        T, mask, depth = 5, None, None
        toks = rng.integers(3, cfg.vocab_size, (B, T))
        starts = [3, 20, 0, 9, 1, 14, 5, 26]
        want = TM.prefill(cfg, w, torch.from_numpy(toks), starts, b, "all")[0]
    assert TM.moe_sweeps(w.layers, B * T)
    g = TM.verify_graph(cfg, w, a, B, T, tree)
    g.load(toks, starts, depth, mask)
    with no_host_reads():
        got = g.body()
    assert torch.equal(got, want)
    assert torch.equal(a.k, b.k) and torch.equal(a.v, b.v)


def test_speculative_moe_server_matches_jax(tmp_path):
    """A speculative MoE Server (target and a self draft, gamma 4, three
    greedy requests on 2 slots) gives ``calm_tpu.serve.Server``'s texts and
    counters, and the plain server's ids."""
    path, _, _ = _moe_pair(tmp_path, "mixtral")
    reqs = ["hello world", "the quick", "pack my box"]

    def run(S, **kw):
        srv = S.Server(path, batch=2, kv_dtype="fp16", **kw)
        out = [srv.submit(p, max_tokens=8, temperature=0.0, seed=1) for p in reqs]
        srv.run_until_drained(max_ticks=80)
        assert all(r.done for r in out)
        return srv, out

    js, jr = run(JS, draft_path=path, gamma=4)
    ts, tr = run(TS, draft_path=path, gamma=4, device="cpu")
    _, pr = run(TS, device="cpu")
    assert [r.text for r in tr] == [r.text for r in jr] == [r.text for r in pr]
    assert [r.ids for r in tr] == [r.ids for r in pr]
    counters = lambda s: (s.spec_rounds, s.spec_accepted, s.spec_emitted)
    assert counters(ts) == counters(js) and ts.spec_rounds > 0
    assert ts.spec_accepted == ts.spec_emitted  # a perfect draft
