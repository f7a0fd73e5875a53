"""The MoE expert sweep on the multi-row path (``csrc/qmm.cu``
``mmv_kernel`` with an expert-slot axis: K10 ``qmm_moe_dense`` and
``qmm_moe_ffn``, K11 ``gf4_moe_ffn`` at 2-16 rows) on the CPU.

- :func:`hopper_qmm.qmv_plan` with ``slots``: every (slot, row, chunk) is a
  warp's once over the grid's slots x blocks, and every k below n a lane's
  once; the warps that fill the card are counted over slots x row groups
  (Mixtral 8x7B's dual launch needs no k split at 8 slots, w2 keeps one).
- The kernel's arithmetic emulated: the f16 A operand of each slot's
  expert (fp16 and e5m2 exact, gf4 through :func:`hopper_qmm.gf4_f16_operand`)
  times x staged as :func:`hopper_qmm.split_operand` stages it, once for
  every slot (Ax = 1) or once a slot (Ax = A, and the FFN's h), hi and lo
  products summed per 64-value chunk in float64, times 2^e. Against the
  float64 product and the plain version to 1e-6 of each slot row's max
  |out| and the JAX package's f32 product to 3e-6 (its own sums are ~1e-6
  from the exact one) for one product, 1e-5 for the FFN chain (activation
  and a second staging between), and against the Pallas kernels in interpret
  mode (bf16 operands there: 3e-2 one product, 5e-2 the chain); B in {2, 3,
  8, 16}, fp16/fp8/gf4 (gf4 also at an odd word count a row), SiLU and
  tanh-GELU, a dead slot (exact zeros) and ids repeated as ep's fill
  repeats them.
- The dual launch's h = act(x w1^T) (x w3^T) equals JAX's act(y1) * y3 of
  its three ``qmm_moe_dense`` calls (``calm_tpu/model.py:810-816``).
- The wrappers on the CPU take their plain versions and count nothing;
  ``model._moe_sweep`` makes one ``qmm_moe_ffn`` call from 2 rows and three
  ``qmm_moe_dense`` calls at one row.
- A gf4 MoE ``Server`` at 8 slots against ``calm_tpu.serve.Server``.
- Every C entry point of ``csrc/`` has its ctypes argtypes in
  ``ops/build.py``, argument by argument.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calm_tpu import quant as jquant
from calm_tpu import serve as JS
from calm_tpu.ops import pallas_qmm
from calm_tpu.ops import qmm as jqmm
from calm_tpu_torch import model as TM
from calm_tpu_torch import serve as TS
from calm_tpu_torch.config import ModelConfig
from calm_tpu_torch.ops import build, hopper_qmm
from calm_tpu_torch.ops.hopper_qmm import MV_CHUNK, MV_WARPS, qmv_plan, split_operand
from calm_tpu_torch.utils.synth import synth_weights
from tests.modelgen import tiny_config, write_tiny_model

torch.set_num_threads(1)

SLOT_SETS = [([0, 2, 3, 3], 3),  # sorted unique, padded: the last slot dead
             ([1, 1, 3, 3], 4)]  # all live, ids repeated as ep's fill repeats a local one
L, E = 2, 4


@pytest.fixture
def interpret():
    pallas_qmm.set_interpret(True)
    yield
    pallas_qmm.set_interpret(False)


def _t(a: np.ndarray, fmt: str) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if fmt == "fp8":
        return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e5m2)
    return torch.from_numpy(a)


def _experts(rng, d, n, fmt):
    """(L, E, d, n) quantized expert stack (gf4: (L, E, d, n/8) words)."""
    return np.stack([np.stack([jquant.quantize(
        (rng.standard_normal((d, n)) * 0.1).astype(np.float32), fmt)
        for _ in range(E)]) for _ in range(L)])


def _slots(ids, cnt):
    return (torch.tensor(ids, dtype=torch.int32), torch.tensor([cnt], dtype=torch.int32))


# -- the plan over slots --------------------------------------------------------

# (B, rows, n, dual, gf4, slots): Mixtral 8x7B's dual, w2 and single w1 launches
# at the serving tick's 8 slots, chip_smoke.py's ragged MoE shapes, small ones
PLAN_CASES = [
    (8, 14336, 4096, True, False, 8), (8, 4096, 14336, False, False, 8),
    (8, 14336, 4096, False, False, 8), (8, 14336, 4096, True, True, 8),
    (2, 1003, 1040, False, False, 4), (16, 11008, 1040, True, True, 4),
    (5, 1040, 11008, False, True, 4), (3, 1003, 1032, False, True, 4),
    (9, 100, 48, False, False, 3), (16, 33, 16, True, False, 2),
]


@pytest.mark.parametrize("B,rows,n,dual,gf4,slots", PLAN_CASES)
def test_plan_over_slots_covers_each_row_and_chunk_once(B, rows, n, dual, gf4, slots):
    """Blocks (x < grid, slot < slots) as the kernel walks them: every
    (slot, row, chunk) once; in one row group every k below n once."""
    p = qmv_plan(B, (rows,), n, dual, gf4, slots=slots)
    assert p.slots == slots and p.mt in (1, 2) and (p.mt == 1 or not dual)
    assert MV_WARPS % p.ks == 0 and 8 * p.nt >= B
    per = MV_WARPS // p.ks
    assert (p.grid - 1) * per < p.groups[0] <= p.grid * per
    counts = np.zeros((slots, rows, p.chunks), np.int32)
    for slot in range(slots):
        for block in range(p.grid):
            for warp in range(MV_WARPS):
                work = p.warp_work(block, warp, (rows,))
                if work is not None:
                    s, r0, r1, c0, c1 = work
                    assert s == 0 and r0 < r1 <= rows and r1 - r0 <= 16 * p.mt
                    counts[slot, r0:r1, c0:c1] += 1
    assert (counts == 1).all()
    ks = np.zeros(p.chunks * MV_CHUNK, np.int32)
    for warp in range(p.ks):
        _, _, _, c0, c1 = p.warp_work(0, warp, (rows,))
        for c in range(c0, c1):
            for t in range(4):
                k0 = c * MV_CHUNK + 16 * t
                if k0 < n:
                    ks[k0:min(k0 + 16, n)] += 1
    assert (ks[:n] == 1).all()


def test_plan_counts_warps_over_slots():
    """The k split stops once slots x groups x ks fill the card: Mixtral's
    dual launch (896 groups) splits k 4 ways alone, not at all over 8
    slots; w2 (256 groups a slot) keeps a split of 2."""
    assert qmv_plan(8, (14336,), 4096, True).ks == 4
    assert qmv_plan(8, (14336,), 4096, True, slots=8).ks == 1
    assert qmv_plan(8, (4096,), 14336, slots=8).ks == 2
    for B, rows, n, dual, gf4, slots in PLAN_CASES:
        p = qmv_plan(B, (rows,), n, dual, gf4, slots=slots)
        assert (sum(p.groups) * slots * p.ks >= hopper_qmm.MV_TARGET_WARPS
                or p.ks == MV_WARPS or p.chunks // (2 * p.ks) < hopper_qmm.MV_MIN_CHUNKS)


@pytest.mark.parametrize("B,A", [(2, 4), (8, 8), (16, 8)])
def test_moe_launch_plans(B, A):
    """The FFN's two launches as the wrapper hands them to the kernel, and
    one scratch for the larger staging: x once (D) or h once a slot (A x H)."""
    D, H = 4096, 14336
    arr, words, floats = hopper_qmm._moe_plans(B, A, ((H, D, True, 1), (D, H, False, A)),
                                               False)
    assert arr.dtype == np.int32 and arr.shape == (8,)
    assert tuple(arr[:4]) == qmv_plan(B, (H,), D, True, slots=A).args()
    assert tuple(arr[4:]) == qmv_plan(B, (D,), H, slots=A).args()
    w, f = qmv_plan(B, (D,), H, slots=A).staging(H)
    assert (words, floats) == (A * w, A * f)
    _, w1, f1 = hopper_qmm._moe_plans(B, A, ((H, D, False, 1),), False)
    assert (w1, f1) == qmv_plan(B, (H,), D, slots=A).staging(D)


@pytest.mark.parametrize("bad", [dict(slots=0), dict(slots=65536), dict(slots=2, rows=(8, 8))])
def test_plan_refuses_slots(bad):
    with pytest.raises(ValueError):
        qmv_plan(8, bad.get("rows", (16,)), 64, slots=bad["slots"])


def test_multirow_supported_by_shape():
    ok = hopper_qmm.moe_multirow_supported
    assert ok("fp8", 2, 4096, 14336) and ok("fp16", 16, 1040) and ok("gf4", 8, 1032)
    assert not ok("fp8", 1, 4096) and not ok("gf4", 1, 4096) and not ok("fp8", 65, 4096)
    assert not ok("fp8", 8, 1044) and not ok("fp16", 8, 8) and not ok("gf4", 8, 1036)
    assert ok("fp8e4", 8, 4096)


# -- the staged sweep, emulated ---------------------------------------------------


def _w64(w: torch.Tensor, fmt: str) -> torch.Tensor:
    """One expert's plane as the kernel's f16 A operand, in float64."""
    if fmt == "gf4":
        return hopper_qmm.gf4_f16_operand(w).double()
    return w.to(torch.float16).double()  # e5m2 -> f16 is exact


def _staged(x: torch.Tensor, w64: torch.Tensor) -> torch.Tensor:
    """x (B, n) staged as the kernel stages it, times w64 (d, n)."""
    hi, lo, e = split_operand(x)
    B, n = x.shape
    y = torch.zeros((B, w64.shape[0]), dtype=torch.float64)
    for c in range(e.shape[1]):
        ks = slice(c * MV_CHUNK, min(n, (c + 1) * MV_CHUNK))
        part = hi[:, ks].double() @ w64[:, ks].T + lo[:, ks].double() @ w64[:, ks].T
        y += part * torch.ldexp(torch.ones(()), e[:, c].double())[:, None]
    return y


def _sweep(x, w, ids, cnt, fmt, layer) -> torch.Tensor:
    """K10 on the multi-row path, emulated: x (Ax, B, n) f32, w (L, E, d,
    n_packed) -> (A, B, d) f32; a dead slot stays zero."""
    Ax, B, _ = x.shape
    A = len(ids)
    y = torch.zeros((A, B, w.shape[2]), dtype=torch.float64)
    for a in range(cnt):
        e = min(max(ids[a], 0), w.shape[1] - 1)
        y[a] = _staged(x[min(a, Ax - 1)], _w64(w[layer, e], fmt))
    return y.float()


def _close_rows(got, want, rel):
    """Each slot row within ``rel`` of its own max |want|."""
    got, want = torch.as_tensor(got).double(), torch.as_tensor(np.array(want)).double()
    tol = rel * want.abs().amax(-1, keepdim=True)
    assert ((got - want).abs() <= tol).all()


def _jax_mm(x, w_plane, fmt):
    return np.asarray(jqmm.qmatmul(jnp.asarray(np.asarray(x)),
                                   jqmm.QTensor(jnp.asarray(w_plane), fmt)))


SWEEP_N = {"fp16": 1040, "fp8": 1040, "gf4": 1040}


@pytest.mark.parametrize("fmt", ["fp16", "fp8", "gf4"])
@pytest.mark.parametrize("B", [2, 3, 8, 16])
@pytest.mark.parametrize("per_slot", [False, True])
def test_staged_sweep_matches_plain_and_jax(rng, fmt, B, per_slot):
    """w1's shape (x shared, Ax = 1) and w2's (x per slot, Ax = A), a dead
    slot and repeated ids; n = 1040 ends a 64-value chunk short."""
    d, n, layer = 96, SWEEP_N[fmt], 1
    w = _experts(rng, d, n, fmt)
    tw = _t(w, fmt)
    for ids, cnt in SLOT_SETS:
        A = len(ids)
        x = torch.from_numpy(rng.standard_normal((A if per_slot else 1, B, n))
                             .astype(np.float32))
        got = _sweep(x, tw, ids, cnt, fmt, layer)
        plain = hopper_qmm.qmm_moe_dense_plain(x, tw, *_slots(ids, cnt), fmt, layer)
        assert not got[cnt:].any() and not plain[cnt:].any()
        for a in range(cnt):
            xa = x[min(a, x.shape[0] - 1)]
            _close_rows(got[a], xa.double() @ _w64(tw[layer, ids[a]], fmt).T, 1e-6)
            _close_rows(got[a], plain[a], 1e-6)
            # the JAX package's f32 sums are themselves ~1e-6 of max |out| from
            # the exact product
            _close_rows(got[a], _jax_mm(xa, w[layer, ids[a]], fmt), 3e-6)
        if ids[0] == ids[1]:  # one expert in two slots: the same product
            assert torch.equal(got[0], got[1]) or per_slot


@pytest.mark.parametrize("B", [2, 8, 16])
def test_staged_sweep_gf4_odd_words(rng, B):
    """n = 1032: 129 words a row, the ODD instantiation's half-step."""
    d, n, layer = 72, 1032, 0
    w = _experts(rng, d, n, "gf4")
    ids, cnt = SLOT_SETS[0]
    x = torch.from_numpy(rng.standard_normal((1, B, n)).astype(np.float32))
    got = _sweep(x, torch.from_numpy(w), ids, cnt, "gf4", layer)
    plain = hopper_qmm.qmm_moe_dense_plain(x, torch.from_numpy(w), *_slots(ids, cnt), "gf4",
                                           layer)
    for a in range(cnt):
        _close_rows(got[a], plain[a], 1e-6)
        _close_rows(got[a], _jax_mm(x[0], w[layer, ids[a]], "gf4"), 3e-6)


@pytest.mark.parametrize("fmt", ["fp16", "fp8", "gf4"])
@pytest.mark.parametrize("B", [2, 16])
def test_staged_sweep_matches_pallas(rng, interpret, fmt, B):
    """Against pallas_qmm.qmm_moe_dense in interpret mode on its live slots
    (it repeats the last live id where the port writes zeros)."""
    d, n, layer = 96, 1040, 1
    w = _experts(rng, d, n, fmt)
    ids, cnt = SLOT_SETS[0]
    for per_slot in (False, True):
        x = rng.standard_normal((len(ids) if per_slot else 1, B, n)).astype(np.float32)
        got = _sweep(torch.from_numpy(x), _t(w, fmt), ids, cnt, fmt, layer)
        pal = np.asarray(pallas_qmm.qmm_moe_dense(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(ids, jnp.int32), fmt, jnp.int32(layer)))
        np.testing.assert_allclose(got[:cnt].numpy(), pal[:cnt], rtol=3e-2, atol=3e-2)


# -- the expert FFN chain, emulated -----------------------------------------------


def _act(v, act_gelu):
    return hopper_qmm.act(v, act_gelu)


def _chain(x, w1, w3, w2, ids, cnt, fmt, layer, act_gelu):
    """The FFN on the multi-row path, emulated: x staged once, the dual
    w1/w3 product and activation in f32 (h), h staged a slot at a time,
    the w2 product."""
    x1 = x[None]
    h = (_act(_sweep(x1, w1, ids, cnt, fmt, layer), act_gelu)
         * _sweep(x1, w3, ids, cnt, fmt, layer))
    return h, _sweep(h, w2, ids, cnt, fmt, layer)


def _jax_act(act_gelu):
    return (lambda v: jax.nn.gelu(v, approximate=True)) if act_gelu else jax.nn.silu


FFN_DIMS = {"fp16": (144, 592), "fp8": (144, 592), "gf4": (144, 592), "gf4-odd": (136, 584)}


def _ffn_weights(rng, key):
    fmt = key.split("-")[0]
    D, H = FFN_DIMS[key]
    return fmt, D, H, [_experts(rng, *s, fmt) for s in ((H, D), (H, D), (D, H))]


@pytest.mark.parametrize("key", ["fp16", "fp8", "gf4", "gf4-odd"])
@pytest.mark.parametrize("B", [2, 3, 8, 16])
@pytest.mark.parametrize("act_gelu", [False, True])
def test_ffn_chain_matches_plain_and_jax(rng, key, B, act_gelu):
    """D = 144 ends a chunk short; gf4-odd has 17 and 73 words a row."""
    fmt, D, H, ws = _ffn_weights(rng, key)
    tws = [_t(w, fmt) for w in ws]
    layer = 1
    x = torch.from_numpy((rng.standard_normal((B, D)) * 0.5).astype(np.float32))
    jact = _jax_act(act_gelu)
    for ids, cnt in SLOT_SETS:
        _, got = _chain(x, *tws, ids, cnt, fmt, layer, act_gelu)
        plain = hopper_qmm.qmm_moe_ffn_plain(x, *tws, *_slots(ids, cnt), fmt, layer, act_gelu)
        assert got.shape == (len(ids), B, D) and not got[cnt:].any() and not plain[cnt:].any()
        for a in range(cnt):
            _close_rows(got[a], plain[a], 1e-5)
            q = [jqmm.QTensor(jnp.asarray(w[layer, ids[a]]), fmt) for w in ws]
            xj = jnp.asarray(x.numpy())
            want = jqmm.qmatmul(jact(jqmm.qmatmul(xj, q[0])) * jqmm.qmatmul(xj, q[1]), q[2])
            _close_rows(got[a], want, 1e-5)


@pytest.mark.parametrize("fmt", ["fp16", "fp8", "gf4"])
@pytest.mark.parametrize("act_gelu", [False, True])
def test_dual_h_is_jax_act_of_y1_times_y3(rng, fmt, act_gelu):
    """The dual launch's h against JAX's act(y1) * y3 (calm_tpu/model.py
    :810-816) on its f32 products of each slot's w1 and w3: 3e-6 of each
    slot row's max |h|, the JAX side's own f32 sums ~1e-6 from exact."""
    _, D, H, ws = _ffn_weights(rng, fmt)
    tws = [_t(w, fmt) for w in ws]
    layer, B = 0, 8
    x = (rng.standard_normal((B, D)) * 0.5).astype(np.float32)
    ids, cnt = SLOT_SETS[0]
    h, _ = _chain(torch.from_numpy(x), *tws, ids, cnt, fmt, layer, act_gelu)
    y1, y3 = (jnp.stack([jqmm.qmatmul(jnp.asarray(x), jqmm.QTensor(jnp.asarray(w[layer, i]), fmt))
                         for i in ids]) for w in ws[:2])
    want = np.asarray(_jax_act(act_gelu)(y1) * y3)
    assert not h[cnt:].any()
    for a in range(cnt):
        _close_rows(h[a], want[a], 3e-6)


@pytest.mark.parametrize("fmt", ["fp16", "fp8", "gf4"])
@pytest.mark.parametrize("B", [2, 16])
def test_ffn_chain_matches_pallas(rng, interpret, fmt, B):
    """gf4 against pallas_qmm.gf4_moe_ffn (plane-major w1/w3 built from the
    natural words), fp16/fp8 against three pallas_qmm.qmm_moe_dense calls
    and the activation, in interpret mode, on the live slots."""
    _, D, H, ws = _ffn_weights(rng, fmt)
    layer, act_gelu = 1, fmt == "fp16"
    ids, cnt = SLOT_SETS[0]
    x = (rng.standard_normal((B, D)) * 0.5).astype(np.float32)
    _, got = _chain(torch.from_numpy(x), *[_t(w, fmt) for w in ws], ids, cnt, fmt, layer,
                    act_gelu)
    jids = jnp.asarray(ids, jnp.int32)
    if fmt == "gf4":
        pe = [jnp.asarray(w).reshape(L, E, H // 8, 8, D // 8).transpose(0, 1, 3, 2, 4)
              for w in ws[:2]]
        pal = pallas_qmm.gf4_moe_ffn(jnp.asarray(x), *pe, jnp.asarray(ws[2]), jids, cnt,
                                     jnp.int32(layer), act_gelu)
    else:
        jl = jnp.int32(layer)
        y1, y3 = (pallas_qmm.qmm_moe_dense(jnp.asarray(x)[None], jnp.asarray(w), jids, fmt, jl)
                  for w in ws[:2])
        pal = pallas_qmm.qmm_moe_dense(_jax_act(act_gelu)(y1) * y3, jnp.asarray(ws[2]), jids,
                                       fmt, jl)
    np.testing.assert_allclose(got[:cnt].numpy(), np.asarray(pal)[:cnt], rtol=5e-2, atol=5e-2)


# -- the wrappers and the model's sweep on the CPU ----------------------------------


def test_wrappers_on_cpu_take_the_plain_path(rng):
    fmt, D, H, ws = _ffn_weights(rng, "fp8")
    tws = [_t(w, fmt) for w in ws]
    eidx, cnt = _slots(*SLOT_SETS[0])
    x = torch.from_numpy(rng.standard_normal((8, D)).astype(np.float32))
    got = hopper_qmm.qmm_moe_ffn(x, *tws, eidx, cnt, fmt, 0, False)
    assert torch.equal(got, hopper_qmm.qmm_moe_ffn_plain(x, *tws, eidx, cnt, fmt, 0, False))
    hopper_qmm.qmm_moe_dense(x[None], tws[0], eidx, cnt, fmt, 0)
    _, _, _, gs = _ffn_weights(rng, "gf4")
    hopper_qmm.gf4_moe_ffn(x, *[torch.from_numpy(w) for w in gs], eidx, cnt, 0, True)
    for f in (hopper_qmm.qmm_moe_ffn, hopper_qmm.qmm_moe_dense, hopper_qmm.gf4_moe_ffn):
        assert f.launches == f.multirow_launches == 0


@pytest.mark.parametrize("fmt", ["fp8", "fp16", "gf4"])
def test_sweep_calls_one_ffn_from_two_rows(monkeypatch, fmt):
    """``_moe_ffn`` at 1, 2 and 8 rows: fp16/fp8 one ``qmm_moe_ffn`` call
    a layer from 2 rows and three ``qmm_moe_dense`` at one; gf4 one
    ``gf4_moe_ffn`` at any; the result as the three-call composition's."""
    cfg = tiny_config(dtype=fmt, moe=True, dim=64, hidden_dim=64, head_dim=16,
                      rotary_dim=16)
    cfg = ModelConfig(**{k: getattr(cfg, k) for k in ModelConfig.__dataclass_fields__})
    w = synth_weights(cfg, seed=4, random=True)
    calls = []
    for name in ("qmm_moe_ffn", "qmm_moe_dense", "gf4_moe_ffn"):
        real = getattr(TM, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(TM, name, spy)
    rng = np.random.default_rng(3)
    for R in (1, 2, 8):
        calls.clear()
        xb2 = torch.from_numpy(rng.standard_normal((R, cfg.dim)).astype(np.float32))
        got = TM._moe_ffn(cfg, w.layers, 1, xb2)
        if fmt == "gf4":
            assert calls == ["gf4_moe_ffn"]
            continue
        assert calls == (["qmm_moe_dense"] * 3 if R == 1 else ["qmm_moe_ffn"])
        wts, idx = TM.route(cfg, TM._mm(xb2, w.layers.moegate, 1))
        uniq, cnt = TM.expert_slots(idx, cfg.n_experts)
        lw = w.layers
        z = hopper_qmm.qmm_moe_ffn_plain(xb2, lw.w1.data, lw.w3.data, lw.w2.data, uniq, cnt,
                                         fmt, 1, cfg.act_gelu)
        wmat = (wts[:, :, None] * (idx[:, :, None] == uniq)).sum(1)
        torch.testing.assert_close(got, torch.einsum("ra,ard->rd", wmat, z), rtol=0, atol=0)


# -- a gf4 MoE server at 8 slots --------------------------------------------------

SERVE_REQS = [("hello world", 8, 0.0, 1), ("the quick", 10, 0.0, 1),
              ("pack my box", 6, 1.2, 3), ("jumps over", 7, 0.0, 1),
              ("lazy dogs", 9, 0.8, 5), ("five boxing", 6, 0.0, 1),
              ("wizards jump", 8, 0.0, 1), ("quickly", 5, 1.0, 2),
              ("sphinx of", 7, 0.0, 1), ("black quartz", 6, 0.0, 1)]


def test_gf4_moe_server_8_slots_matches_jax(tmp_path):
    """Ten requests, eight admitted at once: every decode tick sweeps 8
    rows (the port's gf4_moe_ffn at 8 rows, 4 slots of 4 experts), two
    admitted into reused slots; greedy and host-sampled texts as JAX's."""
    path = str(tmp_path / "moe-gf4.calm")
    write_tiny_model(path, tiny_config(dtype="gf4", seq_len=64, moe=True, dim=64,
                                       hidden_dim=64, head_dim=16, rotary_dim=16), seed=6)

    def serve(srv):
        out = [srv.submit(p, max_tokens=n, temperature=t, seed=s) for p, n, t, s in SERVE_REQS]
        srv.run_until_drained(max_ticks=400)
        assert all(r.done for r in out)
        return [(r.text, r.n_generated) for r in out]

    want = serve(JS.Server(path, batch=8, kv_dtype="bf16"))
    got = serve(TS.Server(path, batch=8, device="cpu"))
    assert got == want
    assert len({t for t, _ in got}) > 1


# -- the C entry points' ctypes signatures -------------------------------------------

_CTYPE = {"const void*": "P", "void*": "P", "int": "I", "float": "F", "long long": "I64"}


@pytest.mark.parametrize("name", build.SOURCES)
def test_every_c_entry_point_has_its_ctypes_signature(name):
    """ctypes passes an int where no argtypes are set, which cuts a pointer
    to 32 bits: each ``extern "C"`` function of a source (its error string
    aside) has its argtypes in ``build.SIGNATURES``, argument by argument."""
    src = open(os.path.join(build.CSRC, name + ".cu")).read()
    body = src[src.index('extern "C"'):]
    found = {}
    for m in re.finditer(r"^(?:int|const char\*)\s+(calm_\w+)\(([^)]*)\)", body, re.M):
        if m.group(1) != f"calm_{name}_error_string":
            found[m.group(1)] = [_CTYPE[a.strip().rsplit(" ", 1)[0]]
                                 for a in m.group(2).split(",") if a.strip()]
    kinds = {build.P: "P", build.I: "I", build.F: "F", build.I64: "I64"}
    assert found == {fn: [kinds[t] for t in args]
                     for fn, args in build.SIGNATURES[name].items()}
