"""fp8e4 (e4m3 codes and a power-of-two scale per tensor, per (layer,
expert) in MoE stacks) and ``--precise`` on the port, against calm_tpu on
the CPU: the quantizer's bytes bit for bit (non-finite inputs included);
the kernels' e4m3 decode (read from ``csrc/``: the exact f16 conversion,
in k order); the multi-row product and the dual MoE launch
emulated as the kernels compute them (each sum scaled before the
activation) against JAX's f32 path; decode, prefill and ``Server`` of tiny
fp8e4 models whose scales differ by layer and expert; the quality mode's
plumbing and its routing decisions as pure functions; and the new C
arguments against ``ops/build.py``'s signatures."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calm_tpu import cli as JC
from calm_tpu import container as jcontainer
from calm_tpu import model as JM
from calm_tpu import quant as jquant
from calm_tpu import serve as JS
from calm_tpu.container import TensorFile as JTensorFile
from calm_tpu.ops import qmm as jqmm
from calm_tpu.parallel.plan import NO_SHARDING as J_NO_SHARDING
from calm_tpu_torch import cli as TC
from calm_tpu_torch import model as TM
from calm_tpu_torch import quant
from calm_tpu_torch import serve as TS
from calm_tpu_torch.config import ModelConfig
from calm_tpu_torch.container import TensorFile
from calm_tpu_torch.engine import Engine
from calm_tpu_torch.ops import build, hopper_qmm
from calm_tpu_torch.ops import qmm as tqmm
from calm_tpu_torch.ops.qmm import QTensor, dense_matmul, qmatmul
from tests.modelgen import tiny_config, write_tiny_model
from tests.test_torch_model import _run_both, jax_leaves

torch.set_num_threads(1)

TOL = 1e-5  # f32 on both sides, sums in another order: of each row's max |logit|


# -- the quantizer -------------------------------------------------------------

def _edge_cases():
    rng = np.random.default_rng(3)
    s = 2.0 ** -5
    return {
        "random": (rng.standard_normal((64, 96)) * 0.05).astype(np.float32),
        "random-wide": (rng.standard_normal(4096) * 30).astype(np.float32),
        "zeros": np.zeros((8, 16), np.float32),
        "empty": np.zeros((0, 4), np.float32),
        # values that round to +-448 s, and the ties around the top code
        "top": np.array([448 * s, -448 * s, 447 * s, 440 * s, -436 * s, 432 * s, 1e-3],
                        np.float32),
        # e4m3's subnormal edges after the scale: 2^-9 s, half of it, ties
        "subnormal": np.array([448, 2.0 ** -9, 2.0 ** -10, 1.5 * 2.0 ** -10, 2.0 ** -11,
                               -2.0 ** -9, 0.875 * 2.0 ** -6, 2.0 ** -6, 2.0 ** -12],
                              np.float32),
        "tiny-amax": np.array([1e-40, -3e-41, 0.0], np.float32),
        "inf": np.array([1.0, np.inf, -2.0, -np.inf, 0.0], np.float32),
        "nan": np.array([np.nan, 5e3, -1e4, 1.0, -np.nan, 463.0, 465.0, -470.0], np.float32),
    }


@pytest.mark.parametrize("case", sorted(_edge_cases()))
def test_fp8e4_quantize_bytes_equal_jax(case):
    """Codes and scale bit for bit as ``calm_tpu.quant.fp8e4_quantize``:
    finite inputs stay within +-448 after the power-of-two scale; an inf
    amax gives scale inf, a NaN amax scale 1, and the bytes past 464 that
    torch's cast saturates are pinned to ml_dtypes' NaN, sign kept."""
    t = _edge_cases()[case]
    with np.errstate(invalid="ignore", divide="ignore"):
        want, wscale = jquant.fp8e4_quantize(t)
    got, scale = quant.fp8e4_quantize(t)
    assert got.dtype == np.uint8 and scale.dtype == np.float32 and scale.shape == (1,)
    np.testing.assert_array_equal(got, want.view(np.uint8))
    np.testing.assert_array_equal(scale.view(np.uint32), wscale.view(np.uint32))


def test_quantize_scaled_and_dtype_bits_match_jax(rng):
    t = (rng.standard_normal((16, 64)) * 0.1).astype(np.float32)
    for fmt in ("fp16", "fp8", "fp8e4", "gf4"):
        got, gs = quant.quantize_scaled(t, fmt)
        want, ws = jquant.quantize_scaled(t, fmt)
        np.testing.assert_array_equal(np.asarray(got).view(np.uint8),
                                      np.asarray(want).view(np.uint8))
        assert (gs is None) == (ws is None)
        if gs is not None:
            np.testing.assert_array_equal(gs, ws)
        assert quant.dtype_bits(fmt) == jquant.dtype_bits(fmt)
    with pytest.raises(ValueError):  # the side scale needs quantize_scaled
        quant.quantize(t, "fp8e4")


def test_fp8e4_quantize_tensor_is_the_same_function(rng):
    t = (rng.standard_normal((3, 40)) * 7).astype(np.float32)
    codes, scale = quant.fp8e4_quantize_tensor(torch.from_numpy(t))
    want, ws = quant.fp8e4_quantize(t)
    assert codes.dtype == torch.float8_e4m3fn and scale.dtype == torch.float32
    np.testing.assert_array_equal(codes.view(torch.uint8).numpy(), want)
    np.testing.assert_array_equal(scale.numpy(), ws)
    np.testing.assert_array_equal(quant.fp8e4_dequantize(want, ws),
                                  jquant.fp8e4_dequantize(want, ws))


# -- the kernels' decode ---------------------------------------------------------

_FINITE = np.array([b for b in range(256) if b not in (0x7F, 0xFF)], np.uint8)


@pytest.mark.parametrize("name", ["qmm", "moe"])
def test_e4m3_decode_is_the_exact_f16_conversion(name):
    """The kernels turn each pair of e4m3 bytes into f16x2 by Hopper's
    conversion (``cvt.rn.f16x2.e4m3x2``, the low byte into the low half):
    every finite e4m3 value is exact in f16 (torch's e4m3fn -> f16 -> f32
    equals e4m3fn -> f32 on all 254 bytes, subnormals included), and the
    words' halves go in k order, (b0, b1) then (b2, b3), as e5m2's byte
    placement (0x1404, 0x3424) puts them."""
    src = open(os.path.join(build.CSRC, name + ".cu")).read()
    defined = src if "uint32_t e4m3x2_f16x2(unsigned short v)" in src else open(
        os.path.join(build.CSRC, "hopper.cuh")).read()  # the shared definition
    body = defined[defined.index("uint32_t e4m3x2_f16x2(unsigned short v)"):]
    assert "cvt.rn.f16x2.e4m3x2" in body[:body.index("}")]
    halves = re.findall(r"e4m3x2_f16x2\(\(unsigned short\)\((\w+(?:\[s\])?) (& 0xffffu|>> 16)\)\)",
                        src)
    assert [h[1] for h in halves] == ["& 0xffffu", ">> 16"] * (len(halves) // 2)
    assert len(halves) == (4 if name == "qmm" else 2)  # qmv_kernel and mmv_kernel; moe.cu
    b = torch.from_numpy(_FINITE).view(torch.float8_e4m3fn)
    via_f16 = b.to(torch.float16).float()
    np.testing.assert_array_equal(via_f16.numpy(), b.float().numpy())
    assert torch.isfinite(via_f16).all() and (via_f16[_FINITE % 128 != 0] != 0).all()


# -- the products, emulated as the kernels compute them --------------------------

def _e4m3(rng, shape):
    """Random finite e4m3 bytes (no NaN codes)."""
    return torch.from_numpy(rng.choice(_FINITE, size=shape)).view(torch.float8_e4m3fn)


def _operand(w: torch.Tensor) -> torch.Tensor:
    """The kernels' A operand of e4m3 weights: their f16 values, float64."""
    return w.to(torch.float16).double()


def _staged(x: torch.Tensor) -> torch.Tensor:
    """x as the multi-row kernel stages it: (hi + lo) 2^e per (row, chunk)."""
    hi, lo, e = hopper_qmm.split_operand(x)
    scale = torch.ldexp(torch.ones_like(e, dtype=torch.float64),
                        e.double()).repeat_interleave(hopper_qmm.MV_CHUNK, -1)
    return (hi.double() + lo.double()) * scale[:, :x.shape[1]]


def _emulated_mv(x, w, s) -> torch.Tensor:
    """One product of the multi-row path on e4m3: the staged x against the
    decoded plane, float64 sums, times s."""
    return (_staged(x) @ _operand(w).T) * float(s)


@pytest.mark.parametrize("B,d,n", [(2, 40, 64), (8, 33, 1040), (16, 16, 80)])
def test_emulated_multirow_product_matches_jax(rng, B, d, n):
    """K2 at 2-16 rows on e4m3, n a multiple of 16 and not of 64 too,
    against the JAX f32 qmatmul with the scale on the output."""
    w = _e4m3(rng, (d, n))
    s = 2.0 ** -3
    x = torch.from_numpy(rng.standard_normal((B, n)).astype(np.float32))
    got = _emulated_mv(x, w, s)
    want = np.asarray(jqmm.qmatmul(jnp.asarray(x.numpy()), jqmm.QTensor(
        jnp.asarray(w.view(torch.uint8).numpy().view(jquant.FP8E4)), "fp8e4",
        jnp.full((1,), s, jnp.float32))))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TOL * np.abs(want).max())
    plain = hopper_qmm.qmm_decode(x, w, "fp8e4", None, torch.full((1,), s))
    np.testing.assert_allclose(plain.numpy(), want, rtol=0, atol=TOL * np.abs(want).max())


def _tiny_moe_fp8e4(tmp_path, seed=4, **kw):
    cfg = tiny_config(dtype="fp8e4", moe=True, seq_len=32, **kw)
    path = str(tmp_path / f"moe-fp8e4-{seed}.calm")
    write_tiny_model(path, cfg, seed=seed)
    return _spread_scales(path)


def _spread_scales(path: str) -> str:
    """Rewrite a container's fp8e4 scales by powers of two from 2^-3 to
    2^2 that differ by tensor kind, layer and expert (the codes stay), so
    a dropped or misindexed scale shows."""
    tf = JTensorFile(path)
    t = {}
    kinds = {}
    for name in tf.names():
        a = np.array(tf.get(name))
        if name.endswith(".scale"):
            m = re.search(r"layers\.(\d+)\.", name)
            layer = int(m.group(1)) if m else 0
            kind = kinds.setdefault(re.sub(r"\d+", "", name), len(kinds))
            steps = np.arange(a.size).reshape(a.shape) + 2 * layer + kind
            a = (a * 2.0 ** (steps % 6 - 3)).astype(np.float32)
            assert (a != 1).all()
        t[name] = a
    jcontainer.write_tensors(path, t, tf.metadata)
    return path


def _scales_differ(w: TM.Weights):
    lw = w.layers
    for qt in (lw.wq, lw.w1, lw.w2, lw.w3):
        s = qt.scale.reshape(qt.scale.shape[0], -1)
        assert len(set(s.flatten().tolist())) > 1 and (s != 1).all()
        assert not torch.equal(s[0], s[1])  # by layer
        if qt.scale.ndim == 3:  # by expert
            assert len(set(s[0].tolist())) > 1


@pytest.mark.parametrize("act_gelu", [False, True])
@pytest.mark.parametrize("B", [2, 8])
def test_emulated_dual_moe_launch_matches_jax_moe_ffn(tmp_path, act_gelu, B):
    """The sweep's FFN as ``qmm_moe_ffn``'s kernels compute it (each
    product's sum times the scale of its own expert, w1's and w3's before the
    activation, w2's on its own sum), put in the port's ``_moe_ffn`` in
    place of the wrapper, against ``calm_tpu.model._moe_ffn`` on the same
    weights: per-expert scales differ, so a scale on the wrong expert, or
    one applied after the activation, fails."""
    path = _tiny_moe_fp8e4(tmp_path, act_gelu=act_gelu, seed=5 + B)
    jtf = JTensorFile(path)
    jcfg = JM.ModelConfig.from_metadata(jtf.metadata)
    wj = JM.load_weights(jtf, jcfg)
    cfg = ModelConfig.from_metadata(TensorFile(path).metadata)
    wt = TM.weights_from_numpy(jax_leaves(wj), cfg)
    _scales_differ(wt)
    rng = np.random.default_rng(B)
    xb2 = rng.standard_normal((B, cfg.dim)).astype(np.float32)
    act = hopper_qmm.act
    calls, wrong = [], []

    def emulated(x, w1, w3, w2, eidx, cnt, fmt, layer, gelu, scales):
        calls.append(fmt)
        s1, s3, s2 = (s[layer] for s in scales)
        z = torch.zeros((eidx.shape[0], x.shape[0], w2.shape[2]), dtype=torch.float64)
        for a in range(int(cnt)):
            e = int(eidx[a])
            y1 = _emulated_mv(x, w1[layer, e], s1[e])
            y3 = _emulated_mv(x, w3[layer, e], s3[e])
            h = act(y1, gelu) * y3
            z[a] = _emulated_mv(h.float(), w2[layer, e], s2[e])
            late = act(y1 / float(s1[e]), gelu) * float(s1[e]) * y3  # scaled after act
            wrong.append(float((late - h).abs().max() / h.abs().max()))
        return z.float()

    real = TM.qmm_moe_ffn
    TM.qmm_moe_ffn = emulated
    try:
        for layer in range(cfg.n_layers):
            got = TM._moe_ffn(cfg, wt.layers, layer, torch.from_numpy(xb2)).numpy()
            want = np.asarray(JM._moe_ffn(jcfg, jnp.asarray(xb2)[:, None], wj.layers,
                                          layer, J_NO_SHARDING))[:, 0]
            np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())
    finally:
        TM.qmm_moe_ffn = real
    assert calls == ["fp8e4"] * cfg.n_layers
    assert max(wrong) > 1e-3  # the activation is not linear


def test_moe_wrappers_on_the_cpu_scale_each_slot(rng):
    """``qmm_moe_dense`` and ``qmm_moe_ffn`` on the CPU (their plain
    versions): each live slot times its own expert's scale of the layer,
    dead slots zero."""
    L, E, d, n = 2, 4, 24, 32
    w = _e4m3(rng, (L, E, d, n))
    scale = torch.from_numpy(2.0 ** (np.arange(L * E).reshape(L, E, 1) % 6 - 3.0)).float()
    ids = torch.tensor([3, 0, 2, 2], dtype=torch.int32)
    cnt = torch.tensor([3], dtype=torch.int32)
    x = torch.from_numpy(rng.standard_normal((1, 5, n)).astype(np.float32))
    got = hopper_qmm.qmm_moe_dense(x, w, ids, cnt, "fp8e4", 1, scale)
    for a in range(3):
        want = qmatmul(x[0], QTensor(w[1, int(ids[a])], "fp8e4", scale[1, int(ids[a])]))
        torch.testing.assert_close(got[a], want, rtol=0, atol=1e-6 * want.abs().max())
    assert not got[3].any()


# -- the model -----------------------------------------------------------------

def _dense_fp8e4(tmp_path, seed=7, **kw):
    cfg = tiny_config(dtype="fp8e4", seq_len=32, **kw)
    path = str(tmp_path / f"fp8e4-{seed}.calm")
    write_tiny_model(path, cfg, seed=seed)
    return _spread_scales(path)


def _rel(got, want):
    return (np.abs(got - want).max(axis=-1) / np.abs(want).max(axis=-1)).max()


@pytest.mark.parametrize("moe", [False, True])
def test_decode_steps_match_jax(tmp_path, moe):
    """40 steps at seq_len 32 (past the window), per-layer and per-expert
    scales other than 1: every matvec and the sweep through the wrappers
    (their plain versions here), against ``calm_tpu.model.decode_step``."""
    path = _tiny_moe_fp8e4(tmp_path) if moe else _dense_fp8e4(tmp_path)
    got, want = _run_both(path, "bf16", 40, JM.decode_step)
    assert _rel(got, want) < TOL
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("moe", [False, True])
def test_batched_decode_and_prefill_match_jax(tmp_path, rng, moe):
    """B=4 decode rows (the sweep's 2-16-row path for MoE) and a prefill of
    two sequences of 20 tokens (40 rows: ``dense_matmul``, the grouped
    experts), logits of every position."""
    path = _tiny_moe_fp8e4(tmp_path, seed=9) if moe else _dense_fp8e4(tmp_path, seed=9)
    jtf = JTensorFile(path)
    jcfg = JM.ModelConfig.from_metadata(jtf.metadata)
    wj = JM.load_weights(jtf, jcfg)
    cfg = ModelConfig.from_metadata(TensorFile(path).metadata)
    wt = TM.load_weights(TensorFile(path), cfg)
    _scales_differ(wt)
    tok = np.array([3, 9, 17, 40])
    want, _ = JM.decode_step(jcfg, wj, jnp.asarray(tok, jnp.int32), jnp.zeros((4,), jnp.int32),
                             JM.KVCache.create(jcfg, 4, jnp.bfloat16))
    got, _ = TM.decode_step(cfg, wt, torch.from_numpy(tok), 0, TM.KVCache.create(cfg, 4))
    assert _rel(got.numpy(), np.asarray(want, np.float32)) < TOL
    toks = rng.integers(3, cfg.vocab_size, (2, 20))
    want, _ = JM.prefill(jcfg, wj, jnp.asarray(toks, jnp.int32), jnp.asarray([0, 3], jnp.int32),
                         JM.KVCache.create(jcfg, 2, jnp.bfloat16), logits_mode="all")
    got, _ = TM.prefill(cfg, wt, torch.from_numpy(toks), [0, 3], TM.KVCache.create(cfg, 2),
                        "all")
    want = np.asarray(want, np.float32)
    assert _rel(got.numpy(), want) < TOL
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("moe", [False, True])
def test_server_matches_jax(tmp_path, moe):
    """Four requests (greedy and host-sampled) on a 2-slot ``Server``, one
    admitted into a reused slot, against ``calm_tpu.serve.Server``."""
    path = _tiny_moe_fp8e4(tmp_path, seed=11) if moe else _dense_fp8e4(tmp_path, seed=11)
    reqs = [("hello world", 8, 0.0, 1), ("the quick", 6, 0.9, 7), ("pack my", 6, 0.0, 1),
            ("one two", 5, 1.1, 3)]

    def run(srv):
        out = [srv.submit(p, max_tokens=n, temperature=t, seed=s) for p, n, t, s in reqs]
        srv.run_until_drained(max_ticks=200)
        assert all(r.done for r in out)
        return [(r.text, r.n_generated) for r in out]
    want = run(JS.Server(path, batch=2, kv_dtype="bf16"))
    got = run(TS.Server(path, batch=2, kv_dtype="bf16", device="cpu"))
    assert got == want


def test_dense_matmul_on_the_cpu_is_qmatmul(rng):
    w = _e4m3(rng, (2, 24, 48))
    qt = QTensor(w, "fp8e4", torch.tensor([[0.25], [8.0]]))
    x = torch.from_numpy(rng.standard_normal((20, 48)).astype(np.float32))
    for layer in (0, 1):
        torch.testing.assert_close(dense_matmul(x, qt, layer), qmatmul(x, qt, layer))


# -- the quality mode ------------------------------------------------------------

@pytest.fixture
def no_precise():
    yield
    tqmm.enable_precise(False)


def test_engine_sets_the_flag_every_time(tmp_path, no_precise):
    """As ``calm_tpu/engine.py:82-84``: ``Engine(precise=True)`` turns the
    process-wide flag on, a later ``Engine()`` back off; the results on the
    CPU do not change (the plain path is f32 already)."""
    path = _dense_fp8e4(tmp_path)
    plain = Engine(path, device="cpu")
    assert tqmm._PRECISE is False
    a = plain.prefill_tokens([1, 5, 9, 12, 40])
    precise = Engine(path, device="cpu", precise=True)
    assert tqmm._PRECISE is True
    np.testing.assert_array_equal(precise.prefill_tokens([1, 5, 9, 12, 40]), a)
    Engine(path, device="cpu")
    assert tqmm._PRECISE is False
    Engine.from_weights(plain.cfg, plain.weights, plain.tokenizer, n_bytes=1, n_params=1,
                        n_bandwidth=1, device="cpu", precise=True)
    assert tqmm._PRECISE is True


@pytest.mark.parametrize("how", ["flag", "env"])
def test_cli_takes_precise(tmp_path, monkeypatch, capsys, no_precise, how):
    """``--precise`` and ``CALM_PRECISE=1`` reach the Engine. On the CPU the
    plain path is f32 already, so the greedy text and the logits hash are
    those of a run without the flag, and the text is the JAX CLI's under
    the same flag."""
    path = _dense_fp8e4(tmp_path)
    args = [path, "-t", "0", "-n", "6", "-i", "hello"]
    monkeypatch.setenv("CALM_CPU", "1")
    TC.main(args)
    out_plain = capsys.readouterr()
    seen = []
    real = TC.Engine

    def spy(*a, **k):
        seen.append(k.get("precise"))
        return real(*a, **k)
    monkeypatch.setattr(TC, "Engine", spy)
    if how == "env":
        monkeypatch.setenv("CALM_PRECISE", "1")
    flag = ["--precise"] if how == "flag" else []
    TC.main(args + flag)
    out_t = capsys.readouterr()
    assert seen == [True] and tqmm._PRECISE is True
    try:
        JC.main(args + flag)
    finally:
        jqmm.enable_precise(False)
    out_j = capsys.readouterr()
    text = lambda o: [l for l in o.out.splitlines() if not l.startswith("#")]
    hashes = lambda o: [l.split("#")[-1] for l in o.err.splitlines() if "tokens:" in l]
    assert text(out_t) == text(out_plain) == text(out_j)
    assert hashes(out_t) == hashes(out_plain) and len(hashes(out_t)) == 1


def _weights_of(fmt: str, **kw):
    cfg = tiny_config(dtype=fmt, **kw)
    from calm_tpu_torch.utils.synth import synth_weights
    return cfg, synth_weights(cfg)


@pytest.mark.parametrize("fmt", ["fp16", "fp8", "fp8e4", "gf4"])
def test_routing_under_precise(fmt):
    """The decisions as pure functions: ``decode_path`` keeps one row on
    its loop, sends 2-16 rows to the multi-row path and 17-64 to the wide
    one, in either mode (it takes no mode); ``mm_route`` keeps <= 64 rows
    on the matvecs and sends gf4 past them to its matmul kernel and the
    other formats to ``qmm_mm8`` only without precise;
    ``_fused`` declines the fp8/fp16 epilogue under precise (gf4's stays,
    fp8e4 has none)."""
    assert hopper_qmm.decode_path(1) == "one-row"
    for B in (2, 8, 16):
        assert hopper_qmm.decode_path(B) == "multi-row"
    for B in (17, 40, 64):
        assert hopper_qmm.decode_path(B) == "wide"
    with pytest.raises(ValueError):
        hopper_qmm.decode_path(65)
    cfg, w = _weights_of(fmt, dim=128, hidden_dim=256, head_dim=64, n_heads=2, n_kv_heads=2,
                         rotary_dim=64)
    qt = w.layers.w1
    for rows, want in ((1, "mv"), (16, "mv"), (17, "mv"), (31, "mv"), (32, "mv"), (64, "mv"),
                       (65, "mm" if fmt == "gf4" else "mm8"),
                       (2048, "mm" if fmt == "gf4" else "mm8")):
        assert TM.mm_route(rows, qt) == want
        assert TM.mm_route(rows, qt, precise=True) == ("mv" if rows <= 64 else "dense")
    for B in (1, 8):
        fused = TM._fused(cfg, w, B)
        assert fused == (fmt != "fp8e4")
        assert TM._fused(cfg, w, B, precise=True) == (fmt == "gf4")


def test_precise_decode_matches_jax_on_the_cpu(tmp_path, no_precise):
    """Under the flag the port's CPU path is JAX's precise path: decode and
    a prefill past 16 rows within TOL."""
    path = _dense_fp8e4(tmp_path, seed=13)
    tqmm.enable_precise(True)
    jqmm.enable_precise(True)
    try:
        got, want = _run_both(path, "bf16", 12, JM.decode_step)
    finally:
        jqmm.enable_precise(False)
    assert _rel(got, want) < TOL


# -- the C arguments -------------------------------------------------------------

_NEW_ARGS = {  # function -> (source, arguments that carry the new meaning)
    "calm_qmm_decode": ("qmm", ["scale"]),
    "calm_moe_mmv": ("qmm", ["scale"]),
    "calm_moe_ffn": ("qmm", ["s1", "s3", "s2"]),
    "calm_moe_dense": ("moe", ["scale"]),
    "calm_gf4_matvec": ("gf4", ["B"]),
}


@pytest.mark.parametrize("fn", sorted(_NEW_ARGS))
def test_new_c_arguments_have_their_ctypes(fn):
    """Each scale pointer (and the matvec's row count) sits where
    ``build.SIGNATURES`` puts a pointer (an int), as the wrappers pass it:
    a pointer passed without its argtype would be cut to 32 bits."""
    name, args = _NEW_ARGS[fn]
    src = open(os.path.join(build.CSRC, name + ".cu")).read()
    m = re.search(rf"^int {fn}\(([^)]*)\)", src, re.M)
    params = [a.strip().rsplit(" ", 1) for a in m.group(1).split(",")]
    names = [p[1].lstrip("*") for p in params]
    sig = build.SIGNATURES[name][fn]
    assert len(sig) == len(params)
    for a in args:
        i = names.index(a)
        want = build.I if params[i][0] == "int" else build.P
        assert sig[i] is want, (fn, a)
        assert (params[i][0] == "const void*") == (want is build.P), (fn, a)


def test_scale_pointers_and_checks():
    """The wrappers' scale addresses: a stack's (L, 1) at the layer's
    entry, one plane's (1,) as it is, an expert stack's (L, E, 1) at the
    layer's E entries (the kernel adds the slot's id); a missing, extra or
    misshapen scale raises."""
    x = torch.zeros(1, 16)
    w3, w2 = torch.zeros(4, 8, 16), torch.zeros(8, 16)
    s = torch.zeros(4, 1)
    assert hopper_qmm._scale_ptr("fp8e4", s, w3, 2, x) == s.data_ptr() + 8
    p = torch.zeros(1)
    assert hopper_qmm._scale_ptr("fp8e4", p, w2, None, x) == p.data_ptr()
    we, se = torch.zeros(3, 5, 8, 16), torch.zeros(3, 5, 1)
    assert hopper_qmm._scale_ptr("fp8e4", se, we, 2, x, experts=True) == se.data_ptr() + 40
    assert hopper_qmm._scale_ptr("fp8", None, w3, 2, x) is None
    for bad in ((None, w3), (torch.zeros(4), w3), (torch.zeros(4, 1, dtype=torch.float64), w3),
                (torch.zeros(3, 1), w3)):
        with pytest.raises(ValueError):
            hopper_qmm._scale_ptr("fp8e4", bad[0], bad[1], 0, x)
    with pytest.raises(ValueError):
        hopper_qmm._scale_ptr("fp16", s, w3, 0, x)


def test_card_loads_fp8e4_and_holds_its_dims_to_16():
    TM.check_supported(tiny_config(dtype="fp8e4", head_dim=64, rotary_dim=64, dim=64), "cuda")
    with pytest.raises(NotImplementedError, match="multiples of 16"):
        TM.check_supported(tiny_config(dtype="fp8e4", head_dim=64, rotary_dim=64, dim=72),
                           "cuda")
