"""Products past 64 rows of fp16/fp8/fp8e4 weights (``hopper_qmm.qmm_mm8``,
``csrc/mm.cu``) on the CPU: the route as a pure function (``mm_route``),
the kernel's tiling (``mm8_plan``: every output row and token once, each k
stage once, N from R, k split where that timed fastest), the
kernel's widening of e5m2/e4m3/fp16 to bf16 written out bit for bit, the
wrapper's CPU path against ``qmatmul`` on the planes ``_moe_grouped``
passes, and the counters of the path taken."""

import numpy as np
import pytest
import torch

from calm_tpu_torch import model as TM
from calm_tpu_torch.ops import cost, hopper_qmm
from calm_tpu_torch.ops import qmm as tqmm
from calm_tpu_torch.ops.hopper_qmm import (MM8_FEW_UNITS, MM8_K, MM8_MAX_KS, MM8_MIN_STAGES,
                                           MM8_WAVE_GAIN, MM8_WIDTHS, SMS, mm8_plan, qmm_mm8,
                                           qmm_mm8_plain)

torch.set_num_threads(1)
FMTS = ("fp16", "fp8", "fp8e4")
PLAN_R = (65, 128, 257, 1025, 2048)
PLAN_D = (1024, 4096, 14336, 32000)  # k/v, q/o and w2, w1/w3, the lm-head
FILLED = ((4096, 14336), (1024, 4096))  # (d, n): w2's and k/v's shapes, split in k


def _plane(rng, shape, fmt):
    """A weight in its storage dtype: e5m2/e4m3 from every finite byte,
    fp16 from a normal draw."""
    if fmt == "fp16":
        return torch.from_numpy((rng.standard_normal(shape) * 0.05).astype(np.float16))
    b = rng.integers(0, 256, shape, dtype=np.uint8)
    if fmt == "fp8e4":
        b[(b & 0x7F) == 0x7F] = 0x3C  # NaN is no weight
        return torch.from_numpy(b).view(torch.float8_e4m3fn)
    b[(b & 0x7C) == 0x7C] = 0x3C  # nor inf/NaN
    return torch.from_numpy(b).view(torch.float8_e5m2)


def _qtensor(rng, lead, d, n, fmt):
    data = _plane(rng, lead + (d, n), fmt)
    scale = None
    if fmt == "fp8e4":  # a power-of-two scale per plane, read on the device
        scale = torch.from_numpy(2.0 ** rng.integers(-6, 4, lead + (1,))).float()
    return tqmm.QTensor(data, fmt, scale)


# -- the route ------------------------------------------------------------------


@pytest.mark.parametrize("fmt", FMTS + ("gf4",))
def test_mm_route_past_64_rows(fmt):
    """fp16/fp8/fp8e4 past 64 rows go to ``qmm_mm8`` outside --precise; gf4
    keeps its matmul kernel ("mm"), 64 rows and fewer the matvec kernels
    ("mv"), --precise the library's f32 product ("dense")."""
    qt = tqmm.QTensor(torch.zeros((2, 64, 128 // (8 if fmt == "gf4" else 1)),
                                  dtype=tqmm.STORAGE[fmt]), fmt)
    for rows in (1, 16, 17, 64):
        assert TM.mm_route(rows, qt) == TM.mm_route(rows, qt, precise=True) == "mv"
    for rows in (65, 128, 257, 1025, 2048):
        assert TM.mm_route(rows, qt) == ("mm" if fmt == "gf4" else "mm8")
        assert TM.mm_route(rows, qt, precise=True) == "dense"


# -- the tiling -------------------------------------------------------------------


def _cover(p):
    """The plan's blocks as the kernel walks them: each (row tile, token
    tile)'s rows, tokens, and its parts' k ranges and stored tokens in part
    order; a tile's parts consecutive (one cluster)."""
    tiles = {}
    for blk in range(p.grid):
        r0, r1, t0, t1, s0, s1, b0, b1 = p.block_work(blk)
        assert r0 < r1 and t0 < t1 and s0 < s1 and t0 <= b0 <= b1 <= t1
        parts = tiles.setdefault((r0, r1, t0, t1), [])
        assert len(parts) == blk % p.ks  # the parts of a tile adjacent, in rank order
        parts.append((s0, s1, b0, b1))
    return tiles


def _once(spans, end, start=0):
    """Half-open spans that tile [start, end) exactly once (empty ones aside)."""
    at = start
    for a, b in sorted(x for x in spans if x[0] < x[1]):
        assert a == at, (a, at)
        at = b
    assert at == end


@pytest.mark.parametrize("R", PLAN_R)
@pytest.mark.parametrize("d", PLAN_D)
@pytest.mark.parametrize("n", (4096, 14336))
def test_mm8_plan_covers_each_row_token_and_stage_once(R, d, n):
    """Every output row and every token of x in exactly one tile, each
    tile's k parts (the blocks of one cluster, in rank order) covering the
    k stages once and storing its tokens once."""
    p = mm8_plan(R, d, n)
    assert p.stages == -(-n // MM8_K) and p.grid == p.rtiles * p.ttiles * p.ks
    assert p.ks in (1, 2, 4, MM8_MAX_KS)
    tiles = _cover(p)
    assert len(tiles) == p.units
    _once({(r0, r1) for r0, r1, _, _ in tiles}, d)
    _once({(t0, t1) for _, _, t0, t1 in tiles}, R)
    for (_, _, t0, t1), parts in tiles.items():
        assert len(parts) == p.ks
        _once([(s0, s1) for s0, s1, _, _ in parts], p.stages)
        _once([(b0, b1) for _, _, b0, b1 in parts], t1, t0)
        assert all(s1 - s0 >= min(MM8_MIN_STAGES, p.stages) for s0, s1, _, _ in parts)


@pytest.mark.parametrize("R, width, ttiles", [
    (65, 128, 1), (128, 128, 1), (129, 192, 1), (192, 192, 1), (193, 256, 1), (256, 256, 1),
    (257, 192, 2), (300, 192, 2), (512, 256, 2), (513, 192, 3), (1025, 192, 6), (2048, 256, 8)])
def test_mm8_plan_chooses_the_token_tile_from_r(R, width, ttiles):
    """Of the splits of R into tiles of at most 256 rows, the one that pads
    R the least, then the one of the fewest tiles, each tile the narrowest
    compiled width holding its share (one tile up to 256 rows: an expert
    group reads each weight tile once)."""
    p = mm8_plan(R, 14336, 4096)
    assert (p.width, p.ttiles) == (width, ttiles)
    assert p.width in MM8_WIDTHS and (p.ttiles - 1) * p.width < R <= p.ttiles * p.width
    for t in range(-(-R // 256), -(-R // 128) + 1):
        w = next(w for w in MM8_WIDTHS if w >= -(-R // t))
        assert t * w > p.ttiles * p.width or (t * w == p.ttiles * p.width and t >= p.ttiles)


def _filled(blocks):
    return blocks / (-(-blocks // SMS) * SMS)


@pytest.mark.parametrize("R", PLAN_R)
@pytest.mark.parametrize("d, n", FILLED + ((14336, 4096), (32000, 4096), (8, 4096)))
def test_mm8_plan_splits_k_where_it_fills_the_waves(R, d, n):
    """The k split as an H100 timed it fastest (PERF.md §6): 8 parts where a
    launch has 16 row x token tiles or fewer (k/v up to 512 rows, a
    router), 2 where that fills the waves of one block an SM better by
    MM8_WAVE_GAIN, else none; never 4 (clusters of 4 timed slower than of 2
    or 8 everywhere). So w2 and q/o at up to 256 rows run 64 blocks of 2
    parts (as fast as 256 of 8 on w2, faster on q/o), k/v 64 of 8: the
    card's 132 SMs are not all filled where filling them timed slower."""
    p = mm8_plan(R, d, n)
    if p.units <= MM8_FEW_UNITS:
        assert p.ks == MM8_MAX_KS
    else:
        assert p.ks == (2 if _filled(2 * p.units) >= _filled(p.units) + MM8_WAVE_GAIN else 1)
    if (d, n) == (4096, 14336):  # w2: split up to 256 rows, whole at 2048
        assert p.ks == (2 if R <= 1025 else 1)
    if (d, n) == (1024, 4096):  # k/v: 8 parts to 512 rows, then 2
        assert p.ks == (8 if R <= 512 else 2)


def test_mm8_plan_keeps_k_whole_where_the_tiles_fill_half_the_card():
    """w1 of Mistral-7B/Mixtral (112 row tiles) keeps k whole at every R; a
    few stages cap the split; R, d and k off their limits raise."""
    for R in PLAN_R:
        assert mm8_plan(R, 14336, 4096).ks == 1
    p = mm8_plan(65, 1024, 512)  # 8 stages: two parts of 4
    assert p.ks == 2 and p.grid == 16
    assert mm8_plan(65, 1024, 256).ks == 1
    assert mm8_plan(65, 8, 4096).ks == MM8_MAX_KS  # a router's 8 rows
    for bad in ((0, 16, 16), (65, 0, 16), (65, 16, 8), (65, 16, 24)):
        with pytest.raises(ValueError):
            mm8_plan(*bad)


# -- the kernel's widening, bit for bit ----------------------------------------------


def _f16x2_bf16(h: np.ndarray) -> np.ndarray:
    """``csrc/mm.cu`` f16x2_bf16x2 on one half: the magnitude shifted down 3
    under bf16's exponent, the sign back, times 2^112 (exact in bf16)."""
    h = h.astype(np.uint32)
    m = (((h & 0x7FFF) >> 3) | (h & 0x8000)).astype(np.uint16)
    b = torch.from_numpy(m.view(np.int16)).view(torch.bfloat16)
    return (b.float() * 2.0 ** 112).bfloat16()


def test_widening_of_every_fp8_byte_is_exact():
    """Every finite e5m2 byte (subnormals included) by byte placement and
    every finite e4m3 byte by its f16 conversion, then the kernel's f16 ->
    bf16 step: the value ``.to(torch.bfloat16)`` gives, bit for bit."""
    b = np.arange(256, dtype=np.uint8)
    e5 = torch.from_numpy(b[(b & 0x7C) != 0x7C]).view(torch.float8_e5m2)
    h5 = e5.view(torch.uint8).numpy().astype(np.uint16) << 8  # the byte in f16's high half
    assert torch.equal(torch.from_numpy(h5.view(np.int16)).view(torch.float16).float(),
                       e5.float())
    assert torch.equal(_f16x2_bf16(h5).view(torch.int16), e5.to(torch.bfloat16).view(torch.int16))
    e4 = torch.from_numpy(b[(b & 0x7F) != 0x7F]).view(torch.float8_e4m3fn)
    h4 = e4.to(torch.float16).view(torch.int16).numpy().view(np.uint16)
    assert torch.equal(_f16x2_bf16(h4).view(torch.int16), e4.to(torch.bfloat16).view(torch.int16))


def test_kernel_arithmetic_is_the_bf16_product():
    """What the kernel sums: bf16(x) times the exactly widened bf16 plane
    in f32, the e4m3 scale on the output, i.e. the library's former
    product (``dense_matmul`` before this kernel) up to the order of the f32
    sums; held to ``qmatmul``'s f32 product within bf16's rounding of x."""
    rng = np.random.default_rng(3)
    for fmt in FMTS:
        qt = _qtensor(rng, (2,), 96, 160, fmt)
        x = torch.from_numpy(rng.standard_normal((70, 160)).astype(np.float32))
        wb = tqmm.dequant(tqmm.QTensor(qt.data[1], fmt), torch.bfloat16).double()
        if fmt != "fp16":  # the widening is exact
            assert torch.equal(wb, tqmm.dequant(tqmm.QTensor(qt.data[1], fmt),
                                                torch.float32).double())
        y = x.bfloat16().double() @ wb.T
        if qt.scale is not None:
            y = y * qt.scale[1].double()
        want = tqmm.qmatmul(x, qt, 1).double()
        assert (y - want).abs().max() <= 2 ** -7 * want.abs().max()


# -- the wrapper's CPU path ---------------------------------------------------------


@pytest.mark.parametrize("fmt", FMTS)
def test_qmm_mm8_cpu_is_qmatmul(fmt):
    """A layer-stacked plane (L, d, n) with its layer, one plane (d, n), and
    an expert's plane of an (L, E, d, n) stack as ``_moe_grouped`` passes it
    (``lw.w1[layer, e]``): ``qmatmul``'s f32 product, fp8e4's scale on the
    output (``qmatmul`` is held to ``calm_tpu``'s in test_torch_ops.py)."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((80, 64)).astype(np.float32))
    qt = _qtensor(rng, (3,), 48, 64, fmt)
    for layer in (0, 2):
        got = qmm_mm8(x, qt.data, fmt, layer, qt.scale)
        torch.testing.assert_close(got, tqmm.qmatmul(x, qt, layer), rtol=0, atol=0)
        torch.testing.assert_close(got, qmm_mm8_plain(x, qt.data, fmt, layer, qt.scale),
                                   rtol=0, atol=0)
    one = qt[1]
    torch.testing.assert_close(qmm_mm8(x, one.data, fmt, None, one.scale),
                               tqmm.qmatmul(x, qt, 1), rtol=0, atol=0)
    stack = _qtensor(rng, (2, 4), 48, 64, fmt)
    for layer, e in ((0, 3), (1, 0)):
        pe = stack[layer, e]
        assert pe.data.shape == (48, 64) and (pe.scale is None or pe.scale.shape == (1,))
        got = TM._mm(TM._mm_operand(x, pe), pe)
        want = x @ tqmm.dequant(tqmm.QTensor(stack.data[layer, e], fmt)).T
        if pe.scale is not None:
            want = want * pe.scale
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_counters_count_the_rows_on_the_path_taken():
    """On the CPU every product past 64 rows goes to the library's plain
    product (``qmm.dense_rows``), in either mode; ``qmm.mm8_rows`` counts
    launches only, none here; the matvecs count neither."""
    rng = np.random.default_rng(11)
    qt = _qtensor(rng, (2,), 32, 48, "fp8")
    before = cost.counters()

    def delta(name):
        return cost.counters().get(name, 0) - before.get(name, 0)
    launches = qmm_mm8.launches
    TM._mm(torch.zeros(100, 48), qt, 1)
    TM._mm(torch.zeros(64, 48), qt, 1)
    assert (delta("qmm.dense_rows"), delta("qmm.mm8_rows")) == (100, 0)
    tqmm.enable_precise(True)
    try:
        TM._mm(torch.zeros(70, 48), qt, 0)
    finally:
        tqmm.enable_precise(False)
    assert (delta("qmm.dense_rows"), delta("qmm.mm8_rows")) == (170, 0)
    assert qmm_mm8.launches == launches
