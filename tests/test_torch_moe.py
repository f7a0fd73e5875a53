"""The port's MoE path against calm_tpu on the CPU: the plain K10
(``qmm_moe_dense_plain``) and K11 (``gf4_moe_ffn_plain``) against the
Pallas kernels in interpret mode and the f32 products, routing and the
expert-slot compaction against JAX's, MoE weights (natural and the fused
gf4 layouts the JAX engine holds) bit for bit, and decode and prefill of
tiny Mixtral- and OLMoE-style models against ``calm_tpu.model``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calm_tpu import container as jcontainer
from calm_tpu import model as JM
from calm_tpu import quant as jquant
from calm_tpu.container import TensorFile as JTensorFile
from calm_tpu.ops import pallas_attn, pallas_qmm
from calm_tpu.ops import qmm as jqmm
from calm_tpu.utils.synth import synth_weights as jsynth
from calm_tpu.utils.synth import weight_bytes as jweight_bytes
from calm_tpu_torch import model as TM
from calm_tpu_torch.config import ModelConfig
from calm_tpu_torch.container import TensorFile
from calm_tpu_torch.ops import hopper_qmm
from calm_tpu_torch.utils.synth import synth_weights, weight_bytes
from tests.modelgen import tiny_config, write_tiny_model
from tests.test_torch_model import _assert_same_weights, _run_both, jax_leaves

torch.set_num_threads(1)


@pytest.fixture
def interpret():
    pallas_qmm.set_interpret(True)
    pallas_attn.set_interpret(True)
    yield
    pallas_qmm.set_interpret(False)
    pallas_attn.set_interpret(False)


def _t(a: np.ndarray, fmt: str) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if fmt == "fp8":
        return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e5m2)
    return torch.from_numpy(a)


def _experts(rng, L, E, d, n, fmt):
    """(L, E, d, n) quantized expert stack (gf4: (L, E, d, n/8) words)."""
    return np.stack([np.stack([jquant.quantize(
        (rng.standard_normal((d, n)) * 0.1).astype(np.float32), fmt)
        for _ in range(E)]) for _ in range(L)])


def _slots(ids, cnt):
    return (torch.tensor(ids, dtype=torch.int32),
            torch.tensor([cnt], dtype=torch.int32))


# -- K10: the expert sweep ----------------------------------------------------


@pytest.mark.parametrize("fmt", ["fp16", "fp8", "gf4"])
@pytest.mark.parametrize("per_slot", [False, True])
def test_qmm_moe_dense_plain(rng, interpret, fmt, per_slot):
    """As tests/test_pallas_qmm.py:330-367: shared x (Ax = 1, w1/w3) and
    one x per slot (Ax = A, w2), the last slot dead (cnt = 3): the port
    gives zeros there, where the TPU kernel repeats the last live id."""
    L, E, d, n, B = 2, 4, 256, 384, 3
    w = _experts(rng, L, E, d, n, fmt)
    ids = [0, 2, 3, 3]
    A = len(ids)
    x = rng.standard_normal((A if per_slot else 1, B, n)).astype(np.float32)
    eidx, cnt = _slots(ids, 3)
    for layer in range(L):
        got = hopper_qmm.qmm_moe_dense(torch.from_numpy(x), _t(w, fmt), eidx, cnt,
                                       fmt, layer).numpy()
        assert got.shape == (A, B, d)
        assert not got[3].any()
        pal = np.asarray(pallas_qmm.qmm_moe_dense(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(ids, jnp.int32), fmt,
            jnp.int32(layer)))
        for a in range(3):
            xa = x[min(a, x.shape[0] - 1)]
            want = np.asarray(jqmm.qmatmul(jnp.asarray(xa), jqmm.QTensor(
                jnp.asarray(w[layer, ids[a]]), fmt)))
            np.testing.assert_allclose(got[a], want, rtol=1e-5, atol=1e-5)
            # the Pallas side rounds x to bf16
            np.testing.assert_allclose(got[a], pal[a], rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("act_gelu,b", [(False, 1), (True, 4)])
def test_gf4_moe_ffn_plain(rng, interpret, act_gelu, b):
    """As tests/test_pallas_qmm.py:284-326: natural words on the port's
    side, the plane-major w1pe/w3pe the TPU kernel reads built from them
    (H/8 = 72 < 128: its tail-mask path), one dead slot."""
    L, E, D, H = 2, 4, 128, 8 * 72
    w1, w3 = _experts(rng, L, E, H, D, "gf4"), _experts(rng, L, E, H, D, "gf4")
    w2 = _experts(rng, L, E, D, H, "gf4")
    w1pe = jnp.asarray(w1).reshape(L, E, H // 8, 8, D // 8).transpose(0, 1, 3, 2, 4)
    w3pe = jnp.asarray(w3).reshape(L, E, H // 8, 8, D // 8).transpose(0, 1, 3, 2, 4)
    x = (rng.standard_normal((b, D)) * 0.5).astype(np.float32)
    ids, cnt = [1, 3, 3], 2
    eidx, tcnt = _slots(ids, cnt)
    act = ((lambda v: jax.nn.gelu(v, approximate=True)) if act_gelu else jax.nn.silu)
    for layer in range(L):
        got = hopper_qmm.gf4_moe_ffn(
            torch.from_numpy(x), *[torch.from_numpy(w) for w in (w1, w3, w2)],
            eidx, tcnt, layer, act_gelu).numpy()
        assert got.shape == (3, b, D) and not got[2].any()
        pal = np.asarray(pallas_qmm.gf4_moe_ffn(
            jnp.asarray(x), w1pe, w3pe, jnp.asarray(w2), jnp.asarray(ids, jnp.int32),
            cnt, jnp.int32(layer), act_gelu))
        for a in range(cnt):
            q = [jqmm.QTensor(jnp.asarray(w[layer, ids[a]]), "gf4") for w in (w1, w3, w2)]
            h = act(jqmm.qmatmul(jnp.asarray(x), q[0])) * jqmm.qmatmul(jnp.asarray(x), q[1])
            want = np.asarray(jqmm.qmatmul(h, q[2]))
            np.testing.assert_allclose(got[a], want, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(got[a], pal[a], rtol=5e-2, atol=5e-2)


def test_moe_wrappers_on_cpu_take_the_plain_path(rng):
    w = torch.from_numpy(_experts(rng, 1, 2, 16, 32, "gf4"))
    eidx, cnt = _slots([0, 1], 2)
    w2 = torch.from_numpy(_experts(rng, 1, 2, 32, 16, "gf4"))
    hopper_qmm.qmm_moe_dense(torch.randn(1, 2, 32), w, eidx, cnt, "gf4", 0)
    hopper_qmm.gf4_moe_ffn(torch.randn(2, 32), w, w, w2, eidx, cnt, 0, False)
    assert hopper_qmm.qmm_moe_dense.launches == hopper_qmm.gf4_moe_ffn.launches == 0


# -- routing and the expert slots ---------------------------------------------


@pytest.mark.parametrize("renorm", [True, False])
def test_route_matches_jax_with_ties(rng, renorm):
    """Top-k as lax.top_k: the lowest expert index wins an exact tie (row 0
    is all equal, row 1 ties experts 2 and 5 for first place)."""
    E, k = 8, 2
    gate = rng.standard_normal((6, E)).astype(np.float32)
    gate[0] = 0.25
    gate[1, [2, 5]] = 3.0
    cfg = tiny_config(moe=True, n_experts=E, n_experts_ac=k, moe_renorm=renorm)
    wts, idx = TM.route(cfg, torch.from_numpy(gate))
    g = jnp.asarray(gate)
    if renorm:
        vals, jidx = jax.lax.top_k(g, k)
        jw = jax.nn.softmax(vals, axis=-1)
    else:
        jw, jidx = jax.lax.top_k(jax.nn.softmax(g, axis=-1), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(wts.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)
    assert idx[0].tolist() == [0, 1] and idx[1].tolist() == [2, 5]


@pytest.mark.parametrize("rows,E", [(1, 8), (3, 8), (16, 4), (5, 32)])
def test_expert_slots(rng, rows, E):
    """Sorted unique ids first, padded with the last unique one, and their
    count (calm_tpu/model.py:776-788, in numpy)."""
    idx = np.stack([rng.choice(E, 2, replace=False) for _ in range(rows)])
    uniq, cnt = TM.expert_slots(torch.from_numpy(idx), E)
    u = np.unique(idx)
    A = min(E, idx.size)
    want = np.concatenate([u, np.full(A - len(u), u[-1])])[:A]
    np.testing.assert_array_equal(uniq.numpy(), want)
    assert uniq.dtype == cnt.dtype == torch.int32 and cnt.tolist() == [len(u)]


# -- weights ------------------------------------------------------------------


def _moe_model(tmp_path, name, seed=5):
    cfg = tiny_config(seq_len=32, moe=True, **MOE_CASES[name])
    path = str(tmp_path / f"moe-{name}.calm")
    write_tiny_model(path, cfg, seed=seed)
    if cfg.norm_qk:  # the q/k norm weights tests/modelgen.py does not write
        rng = np.random.default_rng(seed)
        tf = JTensorFile(path)
        t = {}
        for name in tf._tensors:
            if name.startswith("tokenizer.") and "model.layers.0.attn.q_norm.weight" not in t:
                for l in range(cfg.n_layers):
                    for key, n in (("q_norm", cfg.q_dim), ("k_norm", cfg.kv_dim)):
                        t[f"model.layers.{l}.attn.{key}.weight"] = (
                            1 + 0.1 * rng.standard_normal(n)).astype(np.float32)
            t[name] = np.array(tf.get(name))  # a copy: the file is rewritten
        jcontainer.write_tensors(path, t, tf.metadata)
    return path


MOE_CASES = {
    "fp8": dict(dtype="fp8"),
    "fp16": dict(dtype="fp16"),
    "gf4": dict(dtype="gf4", dim=64, hidden_dim=64, head_dim=16, rotary_dim=16),
    "fp8e4": dict(dtype="fp8e4"),
    "olmoe": dict(dtype="fp16", moe_renorm=False, norm_qk=True),
}


@pytest.mark.parametrize("name", ["fp8", "fp8e4", "gf4"])
def test_moe_weights_from_numpy_equals_load_weights(tmp_path, name):
    path = _moe_model(tmp_path, name)
    jtf = JTensorFile(path)
    leaves = jax_leaves(JM.load_weights(jtf, JM.ModelConfig.from_metadata(jtf.metadata)))
    tf = TensorFile(path)
    cfg = ModelConfig.from_metadata(tf.metadata)
    w = TM.load_weights(tf, cfg)
    assert tuple(w.layers.w1.data.shape[:2]) == (2, 4)
    assert tuple(w.layers.moegate.data.shape[:2]) == (2, 4)
    if name == "fp8e4":
        assert tuple(w.layers.w2.scale.shape) == (2, 4, 1)
    _assert_same_weights(TM.weights_from_numpy(leaves, cfg), w)


def test_weights_from_numpy_takes_the_jax_engines_fused_gf4(tmp_path):
    """The JAX engine holds gf4 MoE weights fused (row-concat wqkv,
    plane-major w1pe/w3pe): the port takes them as they are and gets the
    natural load bit for bit."""
    path = _moe_model(tmp_path, "gf4")
    jtf = JTensorFile(path)
    jcfg = JM.ModelConfig.from_metadata(jtf.metadata)
    fused = JM.fuse_gf4_weights(JM.load_weights(jtf, jcfg), jcfg)
    leaves = jax_leaves(fused)
    assert "layers.w1pe" in leaves and "layers.wqkv" in leaves
    assert "layers.w1" not in leaves and "layers.wq" not in leaves
    tf = TensorFile(path)
    cfg = ModelConfig.from_metadata(tf.metadata)
    _assert_same_weights(TM.weights_from_numpy(leaves, cfg), TM.load_weights(tf, cfg))


@pytest.mark.parametrize("fmt", ["fp8", "gf4"])
def test_moe_synth_weights_and_bytes_match_jax(fmt):
    cfg = tiny_config(dtype=fmt, moe=True, dim=64, hidden_dim=64, head_dim=16,
                      rotary_dim=16)
    want = TM.weights_from_numpy(jax_leaves(jsynth(cfg, seed=3)), cfg)
    _assert_same_weights(synth_weights(cfg, seed=3), want)
    assert weight_bytes(cfg) == jweight_bytes(cfg)


# -- decode and prefill -------------------------------------------------------


@pytest.mark.parametrize("name", sorted(MOE_CASES))
def test_moe_decode_steps_match_jax(tmp_path, name):
    """40 steps at seq_len 32, through the sinks and the rolling write: the
    port's expert sweep (K10 x3, or K11 for gf4; fp8e4's with its
    scales) against JAX's per-token vmap, f32 on both sides."""
    got, want = _run_both(_moe_model(tmp_path, name), "bf16", 40, JM.decode_step)
    err = np.abs(got - want).max(axis=-1) / np.abs(want).max(axis=-1)
    assert err.max() < 1e-4, err
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("fmt", ["fp8", "gf4"])
def test_moe_batch_decode_matches_jax_sweep_interpret(tmp_path, interpret, fmt):
    """B=4 rows share experts: the dedup, the dead slots and the combine,
    against the JAX sweep with its Pallas kernels in interpret mode (as
    tests/test_pallas_qmm.py:407-470; bf16 operands there). gf4 runs the
    JAX engine's fused layouts, as it holds them."""
    path = str(tmp_path / "moe-b4.calm")
    write_tiny_model(path, tiny_config(dtype=fmt, moe=True, seq_len=32, dim=128,
                                       hidden_dim=256, head_dim=32, rotary_dim=32),
                     seed=8)
    jtf = JTensorFile(path)
    jcfg = JM.ModelConfig.from_metadata(jtf.metadata)
    wj = JM.load_weights(jtf, jcfg)
    cfg = ModelConfig.from_metadata(TensorFile(path).metadata)
    wt = TM.weights_from_numpy(jax_leaves(wj), cfg)
    wj = JM.fuse_gf4_weights(wj, jcfg)
    B = 4
    tok = np.array([3, 9, 17, 40])
    calls = []
    name = "gf4_moe_ffn" if fmt == "gf4" else "qmm_moe_dense"
    real = getattr(pallas_qmm, name)

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    jqmm.enable_pallas(True)
    setattr(pallas_qmm, name, spy)
    try:
        want, _ = jax.jit(JM.decode_step_fn, static_argnames=("cfg",))(
            jcfg, wj, jnp.asarray(tok, jnp.int32), jnp.zeros((B,), jnp.int32),
            JM.KVCache.create(jcfg, B, jnp.bfloat16))
    finally:
        setattr(pallas_qmm, name, real)
        jqmm.enable_pallas(False)
    assert calls, f"the JAX side did not take {name}"
    got, _ = TM.decode_step(cfg, wt, torch.from_numpy(tok), 0,
                            TM.KVCache.create(cfg, B))
    want = np.asarray(want, np.float32)
    err = np.abs(got.numpy() - want).max(axis=-1) / np.abs(want).max(axis=-1)
    assert err.max() < 5e-2, err


@pytest.mark.parametrize("name", ["fp8", "gf4", "olmoe"])
def test_moe_prefill_matches_jax(tmp_path, rng, name):
    """T=20 for two sequences at starts 0 and 3: 40 rows, the grouped
    products; logits of every position."""
    path = _moe_model(tmp_path, name)
    jtf = JTensorFile(path)
    cfg_j = JM.ModelConfig.from_metadata(jtf.metadata)
    wj = JM.load_weights(jtf, cfg_j)
    cfg = ModelConfig.from_metadata(TensorFile(path).metadata)
    wt = TM.weights_from_numpy(jax_leaves(wj), cfg)
    toks = rng.integers(3, cfg.vocab_size, (2, 20))
    starts = [0, 3]
    want, _ = JM.prefill(cfg_j, wj, jnp.asarray(toks, jnp.int32),
                         jnp.asarray(starts, jnp.int32),
                         JM.KVCache.create(cfg_j, 2, jnp.bfloat16), logits_mode="all")
    got, _ = TM.prefill(cfg, wt, torch.from_numpy(toks), starts,
                        TM.KVCache.create(cfg, 2), "all")
    want = np.asarray(want, np.float32)
    scale = np.abs(want).max(axis=-1, keepdims=True)
    assert (np.abs(got.numpy() - want) / scale).max() < 1e-4
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))
