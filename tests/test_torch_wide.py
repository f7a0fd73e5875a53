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
from calm_tpu_torch.ops.hopper_qmm import (MAX_MV_ROWS, MAX_ROWS, MV_WARPS, WIDE_NT,
                                           WIDE_PREC_ROWS, qmv_plan)
from tests.modelgen import tiny_config, write_tiny_model
from tests.test_torch_model import jax_leaves
from tests.test_torch_speculative import _rand_cache, _tree_inputs, no_host_reads

torch.set_num_threads(1)
ROWS = (17, 24, 40, 64)
FMTS = ("fp16", "fp8", "fp8e4", "gf4")


# -- routing, as pure functions ----------------------------------------------


@pytest.mark.parametrize("B", ROWS)
@pytest.mark.parametrize("seg,n,dual,gf4", [((32000,), 4096, False, False),
                                            ((4096,), 14336, False, False),
                                            ((14336,), 4096, True, False),
                                            ((4096, 1024, 1024), 4096, False, False),
                                            ((1000,), 1032, False, True),
                                            ((24,), 8, True, True)])
@pytest.mark.parametrize("terms", [1, 2])
def test_wide_plan_covers_every_row_and_chunk_once(B, seg, n, dual, gf4, terms):
    """Past 16 rows: WIDE_NT n-tiles (WIDE_PREC_ROWS / 8 under --precise),
    32 rows a warp for one weight's launches of whole 16-value steps (16
    under --precise, in the dual launch and for rows of an odd word count),
    k split as at 2-16 rows; every (row, chunk) of every segment taken by
    exactly one warp; the staging holds 64 row slots of `terms` terms."""
    p = qmv_plan(B, seg, n, dual, gf4, terms=terms)
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
    ``dense_matmul`` (gf4: its matmul kernel), the sweep declines and the
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
        assert TM.mm_route(65, qt) == ("mm" if fmt == "gf4" else "dense")
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
