"""The port's decode step against calm_tpu.model on the CPU: the same
weights bit for bit, per-step logits within 1e-4 of the f32 path with
identical greedy ids past the rolling window, and the fused-epilogue
wiring against the JAX qx decode path with its Pallas kernels in
interpret mode."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calm_tpu import model as JM
from calm_tpu.container import TensorFile as JTensorFile
from calm_tpu.ops import pallas_attn, pallas_qmm
from calm_tpu.ops import qmm as jqmm
from calm_tpu.utils.synth import synth_weights as jsynth
from calm_tpu_torch import model as TM
from calm_tpu_torch.container import TensorFile
from calm_tpu_torch.utils.synth import synth_weights
from tests.modelgen import tiny_config, write_tiny_model

torch.set_num_threads(1)

_JKV = {"bf16": jnp.bfloat16, "fp16": jnp.float16, "fp8": jnp.float8_e5m2}


def jax_leaves(w) -> dict:
    """The JAX Weights pytree's leaves as numpy, keyed by field path."""
    out = {}

    def put(key, leaf):
        if leaf is None:
            return
        if isinstance(leaf, jqmm.QTensor):
            a = np.asarray(leaf.data)
            out[key] = a.view(np.uint8) if a.dtype.itemsize == 1 else a
            if leaf.scale is not None:
                out[key + ".scale"] = np.asarray(leaf.scale)
        else:
            out[key] = np.asarray(leaf)

    for f in dataclasses.fields(w.layers):
        put("layers." + f.name, getattr(w.layers, f.name))
    put("embed", w.embed)
    put("final_norm", w.final_norm)
    if w.output.data is not w.embed.data:
        put("output", w.output)
    return out


def _tensors(w: TM.Weights) -> dict:
    out = {}
    for pre, obj in (("", w), ("layers.", w.layers)):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if isinstance(v, TM.QTensor):
                out[pre + f.name] = v.data
                if v.scale is not None:
                    out[pre + f.name + ".scale"] = v.scale
            elif isinstance(v, torch.Tensor) or v is None:
                out[pre + f.name] = v
    return out


def _assert_same_weights(a: TM.Weights, b: TM.Weights):
    ta, tb = _tensors(a), _tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        if ta[k] is None or tb[k] is None:
            assert ta[k] is None and tb[k] is None, k
            continue
        assert ta[k].dtype == tb[k].dtype and ta[k].shape == tb[k].shape, k
        assert torch.equal(ta[k].view(torch.uint8), tb[k].view(torch.uint8)), k
    assert (a.output is a.embed) == (b.output is b.embed)


CASES = {
    "fp16": (dict(dtype="fp16"), {}),
    "fp8": (dict(dtype="fp8"), {}),
    "fp16-gelu-ln": (dict(dtype="fp16", act_gelu=True, norm_ln=True), {}),
    "fp8-bias": (dict(dtype="fp8"), dict(bias=True)),
    "fp16-tied": (dict(dtype="fp16"), dict(tied=True)),
    "fp8e4": (dict(dtype="fp8e4"), {}),
    "gf4": (dict(dtype="gf4", dim=64, hidden_dim=64, head_dim=16,
                 rotary_dim=16), {}),
    # the head dims of the converter's Phi-3-mini (96) and Gemma (256)
    # containers, which the card's attention kernels take since they widened
    "hd96": (dict(dtype="fp16", dim=192, hidden_dim=128, head_dim=96, n_heads=2,
                  n_kv_heads=2, rotary_dim=96), {}),
    "hd256": (dict(dtype="fp8", dim=128, hidden_dim=128, head_dim=256, n_heads=2,
                   n_kv_heads=1, rotary_dim=256, act_gelu=True), {}),
}


def _model(tmp_path, name, seed=7):
    cfg_kw, write_kw = CASES[name]
    cfg = tiny_config(seq_len=32, **cfg_kw)
    path = str(tmp_path / f"{name}.calm")
    write_tiny_model(path, cfg, seed=seed, **write_kw)
    return path


@pytest.mark.parametrize("name", sorted(CASES))
def test_weights_from_numpy_equals_load_weights(tmp_path, name):
    path = _model(tmp_path, name)
    jtf = JTensorFile(path)
    jcfg = JM.ModelConfig.from_metadata(jtf.metadata)
    leaves = jax_leaves(JM.load_weights(jtf, jcfg))
    tf = TensorFile(path)
    cfg = TM.ModelConfig.from_metadata(tf.metadata)
    _assert_same_weights(TM.weights_from_numpy(leaves, cfg),
                         TM.load_weights(tf, cfg))


@pytest.mark.parametrize("fmt", ["fp8", "fp16", "gf4"])
def test_synth_weights_match_jax(fmt):
    cfg = tiny_config(dtype=fmt, dim=64, hidden_dim=64, head_dim=16,
                      rotary_dim=16)
    want = TM.weights_from_numpy(jax_leaves(jsynth(cfg, seed=3)), cfg)
    _assert_same_weights(synth_weights(cfg, seed=3), want)


def test_random_synth_weights_are_seeded_and_varied():
    """The bit pattern repeats every 256 values, so in a 256-wide fp8 matrix
    all rows are alike; random=True gives distinct rows, fixed by the seed."""
    cfg = tiny_config(dtype="fp8", dim=256, hidden_dim=256, head_dim=64,
                      rotary_dim=64, n_heads=4, n_kv_heads=2)
    pat = synth_weights(cfg, seed=3).output.data.view(torch.uint8)
    assert torch.equal(pat[0], pat[1])
    a = synth_weights(cfg, seed=3, random=True)
    rows = a.output.data.view(torch.uint8)
    assert not torch.equal(rows[0], rows[1])
    _assert_same_weights(a, synth_weights(cfg, seed=3, random=True))
    assert not torch.equal(rows, synth_weights(cfg, seed=4, random=True)
                           .output.data.view(torch.uint8))
    assert (rows & 0x60).max() == 0  # the finite, small fp8 mask holds


def _run_both(path, kv, steps, jax_step, prompt_tok=1):
    jtf = JTensorFile(path)
    cfg_j = JM.ModelConfig.from_metadata(jtf.metadata)
    # gf4 in the JAX engine's layouts (calm_tpu/engine.py:114); a no-op else
    wj = JM.fuse_gf4_weights(JM.load_weights(jtf, cfg_j), cfg_j)
    tf = TensorFile(path)
    cfg = TM.ModelConfig.from_metadata(tf.metadata)
    wt = TM.load_weights(tf, cfg)
    cj = JM.KVCache.create(cfg_j, 1, _JKV[kv])
    ct = TM.KVCache.create(cfg, 1, TM.KV_DTYPES[kv])
    tok = prompt_tok
    got, want = [], []
    for pos in range(steps):
        lj, cj = jax_step(cfg_j, wj, jnp.array([tok], jnp.int32),
                          jnp.array([pos], jnp.int32), cj)
        lt, ct = TM.decode_step(cfg, wt, torch.tensor([tok]), pos, ct)
        want.append(np.asarray(lj[0], np.float32))
        got.append(lt[0].numpy())
        tok = int(np.argmax(want[-1]))
    return np.stack(got), np.stack(want)


@pytest.mark.parametrize("name,kv", [("fp16", "bf16"), ("fp8", "bf16"),
                                     ("fp16-gelu-ln", "fp16"),
                                     ("fp8-bias", "fp8"), ("fp16-tied", "bf16"),
                                     ("fp8", "fp16"), ("fp8e4", "bf16"),
                                     ("gf4", "fp16"), ("hd96", "bf16"),
                                     ("hd256", "bf16")])
def test_decode_steps_match_jax(tmp_path, name, kv):
    """40 steps at seq_len 32: through the sinks and the rolling write."""
    path = _model(tmp_path, name)
    got, want = _run_both(path, kv, 40, JM.decode_step)
    err = np.abs(got - want).max(axis=-1) / np.abs(want).max(axis=-1)
    assert err.max() < 1e-4, err
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_fused_path_matches_jax_qx_interpret(tmp_path):
    """128-aligned dims take the fused epilogue in both packages: the port's
    plain qx_offn_qkv chain against the JAX qx decode path, its Pallas
    kernels in interpret mode (bf16 operands there)."""
    cfg = tiny_config(dtype="fp8", seq_len=32, dim=256, hidden_dim=384,
                      head_dim=64, rotary_dim=64, n_heads=4, n_kv_heads=2)
    path = str(tmp_path / "aligned.calm")
    write_tiny_model(path, cfg, seed=11)
    tf = TensorFile(path)
    assert TM._fused(TM.ModelConfig.from_metadata(tf.metadata),
                     TM.load_weights(tf, TM.ModelConfig.from_metadata(tf.metadata)), 1)

    calls = []
    real = pallas_qmm.qx_offn_qkv

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    jqmm.enable_pallas(True)
    pallas_qmm.set_interpret(True)
    pallas_attn.set_interpret(True)
    pallas_qmm.qx_offn_qkv = spy
    try:
        # a fresh jit: traced with the Pallas switch on
        step = jax.jit(JM.decode_step_fn, static_argnames=("cfg",))
        got, want = _run_both(path, "bf16", 34, step)
    finally:
        pallas_qmm.qx_offn_qkv = real
        jqmm.enable_pallas(False)
        pallas_qmm.set_interpret(False)
        pallas_attn.set_interpret(False)
    assert calls, "the JAX side did not take the qx path"
    # relative to each step's logit scale (~20 here): the Pallas side rounds
    # operands to bf16, which moves logits by ~0.5% of that scale
    err = np.abs(got - want).max(axis=-1) / np.abs(want).max(axis=-1)
    assert err.max() < 5e-2, err
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_fused_gf4_path_matches_jax_offn_qkv_interpret(tmp_path):
    """128-aligned gf4 dims take the fused epilogue in both packages: the
    port's plain gf4_offn_qkv chain on natural words against the JAX planed
    decode path (gf4_offn_qkv on the fused layouts), its Pallas kernels in
    interpret mode (bf16 operands there)."""
    cfg = tiny_config(dtype="gf4", seq_len=32, dim=256, hidden_dim=384,
                      head_dim=64, rotary_dim=64, n_heads=4, n_kv_heads=2)
    path = str(tmp_path / "aligned-gf4.calm")
    write_tiny_model(path, cfg, seed=12)
    tf = TensorFile(path)
    tcfg = TM.ModelConfig.from_metadata(tf.metadata)
    assert TM._fused(tcfg, TM.load_weights(tf, tcfg), 1)

    calls = []
    real = pallas_qmm.gf4_offn_qkv

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    jqmm.enable_pallas(True)
    pallas_qmm.set_interpret(True)
    pallas_attn.set_interpret(True)
    pallas_qmm.gf4_offn_qkv = spy
    try:
        step = jax.jit(JM.decode_step_fn, static_argnames=("cfg",))
        got, want = _run_both(path, "bf16", 6, step)
    finally:
        pallas_qmm.gf4_offn_qkv = real
        jqmm.enable_pallas(False)
        pallas_qmm.set_interpret(False)
        pallas_attn.set_interpret(False)
    assert calls, "the JAX side did not take the gf4 offn_qkv path"
    # as the fp8 case above: bf16 operands on the Pallas side
    err = np.abs(got - want).max(axis=-1) / np.abs(want).max(axis=-1)
    assert err.max() < 5e-2, err
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_card_refuses_at_load_what_its_kernels_do_not_take():
    """A head dim the attention kernels are not built for is refused when
    the model loads for the card, not at its first step; the CPU takes
    every head dim."""
    for hd in (64, 96, 128, 256):
        TM.check_supported(tiny_config(head_dim=hd, rotary_dim=hd), "cuda")
    TM.check_supported(tiny_config(dtype="fp8e4", head_dim=64, rotary_dim=64), "cuda")
    with pytest.raises(NotImplementedError, match="head_dim 12"):
        TM.check_supported(tiny_config(), "cuda")
    with pytest.raises(NotImplementedError, match="multiples of 16"):
        TM.check_supported(tiny_config(head_dim=64, rotary_dim=64, dim=72), "cuda")
    TM.check_supported(tiny_config(), "cpu")


def test_decode_indices():
    cfg = tiny_config(seq_len=8)
    assert [TM.decode_indices(cfg, p) for p in (0, 7, 8, 9, 13, 14)] == [
        (0, 1), (7, 8), (2, 8), (3, 8), (7, 8), (2, 8)]
    for p in range(30):
        kp, kl = JM.decode_indices(cfg, jnp.int32(p))
        assert TM.decode_indices(cfg, p) == (int(kp), int(kl))
