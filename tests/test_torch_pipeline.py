"""The port's pipeline stages, ring sp prefill and sharded decode scan
against the JAX package: the cases of tests/test_parallel.py (pp, GPipe,
pp x ep, the scan, the ring prefill and its hand-off to sp decode) at its
tolerances, each against the JAX package's unsharded result on the same
container, and the plan fields the port now keeps (``pp`` refused where it
is not served, ``ring`` taken).

As in test_torch_parallel.py one world of 4 gloo ranks on the CPU is
spawned for the module and runs every case; the rank bodies live in the
jax-free ``test_torch_parallel_ranks``. JAX's pp x ep x tp case takes 8
devices: here it is pp=2 x ep=2 on the 4 ranks.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calm_tpu import container
from calm_tpu import model as JM
from calm_tpu_torch.parallel import ShardingPlan, spawn
from tests import test_torch_parallel_ranks as R
from tests.modelgen import tiny_config, write_tiny_model

torch.set_num_threads(1)

TOKENS = [1, 5, 9, 200, 42, 7]
PROMPT = [1, 5, 9, 200, 42, 7, 3, 11, 8, 2, 250, 17, 33, 4, 99, 6]
SEQS = [[1, 5, 9], [7, 3, 11], [2, 8, 4], [200, 42, 6]]  # JAX's GPipe slots
WORLD = 4
N_SCAN = 8
CONFIGS = {
    "fp16": tiny_config(dtype="fp16"),
    "fp8_l4": tiny_config(dtype="fp8", n_layers=4),  # one layer a stage at pp=4
    "moe": tiny_config(dtype="fp16", moe=True),
    "sp": tiny_config(dtype="fp16", seq_len=16),
}


def _cases(p):
    return [
        ("pp2_tp2", "pp_case", (p["fp16"], TOKENS, 2, 2)),
        ("pp4", "pp_case", (p["fp8_l4"], TOKENS, 4)),
        ("pp2_ep2_moe", "pp_case", (p["moe"], TOKENS, 2, 1, 2)),
        ("gpipe", "gpipe_case", (p["fp16"], SEQS, 2, 2, 2)),
        ("gpipe_4micro", "gpipe_case", (p["fp8_l4"], SEQS, 4, 1, 4)),
        ("scan_tp2", "scan_case", (p["fp16"], 7, N_SCAN, 2)),
        ("scan_tp2_sp2", "scan_case", (p["sp"], 7, 24, 2, 2)),
        ("ring_tp2_sp2", "ring_case", (p["sp"], PROMPT, 2, 2, "dp")),
        ("ring_sp4_decode", "ring_case", (p["sp"], PROMPT, 1, 4, "sp", [12, 3, 77, 5])),
        ("no_stages", "no_stages_case", (p["fp16"],)),
    ]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipeline")
    paths = {}
    for name, cfg in CONFIGS.items():
        paths[name] = os.path.join(d, name + ".calm")
        write_tiny_model(paths[name], cfg)
    return paths, spawn(R.run, WORLD, _cases(paths), device="cpu", timeout_s=600)


def result(ranks, name):
    """Rank 0's result of a case (the mesh's ranks return global values)."""
    got = [r[name] for r in ranks[1] if r[name] is not None]
    return got[0], got


def jax_weights(ranks, name):
    path = ranks[0][name]
    return CONFIGS[name], JM.load_weights(container.TensorFile(path), CONFIGS[name])


def reference_logits(cfg, w, tokens):
    cache = JM.KVCache.create(cfg, 1, jnp.float16)
    out = []
    for pos, tok in enumerate(tokens):
        logits, cache = JM.decode_step(cfg, w, jnp.array([tok]), jnp.array([pos]), cache)
        out.append(np.asarray(logits[0]))
    return np.stack(out)


@pytest.mark.parametrize("case,model,stages", [
    ("pp2_tp2", "fp16", 2),      # test_pp2_decode_parity
    ("pp4", "fp8_l4", 4),        # four stages, one layer each, tp=1
    ("pp2_ep2_moe", "moe", 2),   # test_pp2_ep2_moe_decode, pp=2 x ep=2
])
def test_pp_decode_parity(ranks, case, model, stages):
    """Pipeline-parallel decode matches the JAX package's single-device
    decode; every rank returns the same logits, and each holds its stage's
    layers of the weights and the cache only."""
    cfg, w = jax_weights(ranks, model)
    want = reference_logits(cfg, w, TOKENS)
    got, every = result(ranks, case)
    np.testing.assert_allclose(got["logits"], want, rtol=1e-4, atol=1e-4)
    for g in every:
        np.testing.assert_array_equal(g["logits"], got["logits"])
        assert g["layers"] == g["cache_layers"] == cfg.n_layers // stages


@pytest.mark.parametrize("case,model", [("gpipe", "fp16"), ("gpipe_4micro", "fp8_l4")])
def test_gpipe_decode_parity(ranks, case, model):
    """GPipe (2 stages x tp2, 2 microbatches; 4 stages, 4 microbatches of
    one slot) over 4 slots matches the JAX package's batched decode slot
    for slot (test_gpipe_decode_parity)."""
    cfg, w = jax_weights(ranks, model)
    B = len(SEQS)
    cache = JM.KVCache.create(cfg, B, jnp.float16)
    got, _ = result(ranks, case)
    for pos in range(len(SEQS[0])):
        toks = jnp.asarray([SEQS[b][pos] for b in range(B)], jnp.int32)
        want, cache = JM.decode_step(cfg, w, toks, jnp.full((B,), pos, jnp.int32), cache)
        np.testing.assert_allclose(got[pos], np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case,model,n", [("scan_tp2", "fp16", N_SCAN),
                                          ("scan_tp2_sp2", "sp", 24)])
def test_sharded_decode_scan(ranks, case, model, n):
    """The sharded greedy scan (test_sharded_decode_scan; and tp2 x sp2
    across the window wrap): its ids equal the JAX package's unsharded
    decode_scan and the sharded step loop's, its last logits within JAX's
    tolerance."""
    cfg, w = jax_weights(ranks, model)
    want_toks, _, want_logits = JM.decode_scan(cfg, w, jnp.array([7]), jnp.array([0]),
                                               JM.KVCache.create(cfg, 1, jnp.float16), n)
    ids, last, loop, loop_last = result(ranks, case)[0]
    assert ids == np.asarray(want_toks)[0].tolist() == loop
    np.testing.assert_allclose(last, np.asarray(want_logits)[-1, 0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(last, loop_last, rtol=1e-5, atol=1e-5)


def test_sp_ring_prefill_parity(ranks):
    """Ring sp prefill (tp2, the sp axis on dp) matches the JAX package's
    plain prefill: logits and the cache rows it writes
    (test_sp_ring_prefill_parity); each layer folds sp hops, and no K/V is
    all-gathered."""
    cfg, w = jax_weights(ranks, "sp")
    want, want_cache = JM.prefill(cfg, w, jnp.asarray([PROMPT], jnp.int32),
                                  jnp.zeros((1,), jnp.int32),
                                  JM.KVCache.create(cfg, 1, jnp.float16), logits_mode="all")
    logits, k, _, calls = result(ranks, "ring_tp2_sp2")[0]
    np.testing.assert_allclose(logits, np.asarray(want)[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(k, np.asarray(want_cache.k, np.float32), rtol=1e-3, atol=1e-3)
    sp = 2
    assert calls == dict(ppermute=2 * (sp - 1) * cfg.n_layers, all_gather=0)


def test_sp_ring_prefill_then_decode(ranks):
    """Ring prefill over sp=4 hands off to sp decode on the same S-sharded
    cache: the last row's logits match serial prefill + decode
    (test_sp_ring_prefill_then_decode), and 4 decode steps after it match
    the JAX package's decode past the window."""
    cfg, w = jax_weights(ranks, "sp")
    cache = JM.KVCache.create(cfg, 1, jnp.float16)
    _, cache = JM.prefill(cfg, w, jnp.asarray([PROMPT[:-1]], jnp.int32),
                          jnp.zeros((1,), jnp.int32), cache, logits_mode="none")
    want_last, _ = JM.decode_step(cfg, w, jnp.array([PROMPT[-1]]), jnp.array([15]), cache)
    logits, _, steps, calls = result(ranks, "ring_sp4_decode")[0]
    np.testing.assert_allclose(logits[-1], np.asarray(want_last)[0], rtol=1e-3, atol=1e-3)
    assert calls == dict(ppermute=2 * 3 * cfg.n_layers, all_gather=0)  # 4 hops a layer

    cache = JM.KVCache.create(cfg, 1, jnp.float16)
    _, cache = JM.prefill(cfg, w, jnp.asarray([PROMPT], jnp.int32),
                          jnp.zeros((1,), jnp.int32), cache)
    want = []
    for i, tok in enumerate([12, 3, 77, 5]):
        lg, cache = JM.decode_step(cfg, w, jnp.array([tok]), jnp.array([16 + i]), cache)
        want.append(np.asarray(lg[0]))
    np.testing.assert_allclose(steps, np.stack(want), rtol=1e-4, atol=1e-4)


def test_unstaged_steps_refuse_pp(ranks):
    """A plan with pp stages is refused by the steps that run every layer
    on a rank, each naming the pipeline step."""
    got = result(ranks, "no_stages")[0]
    assert set(got) == {"sharded_decode_step", "sharded_prefill", "sharded_prefill_slot",
                        "sharded_decode_scan"}
    for name, msg in got.items():
        assert msg is not None and "sharded_decode_step_pp" in msg, (name, msg)


def test_validate_pp():
    """plan.validate_pp (called when a pipeline step is made) refuses a layer
    count that pp does not divide, as JAX's."""
    with pytest.raises(AssertionError):
        ShardingPlan(pp="pp").validate_pp(tiny_config(), 3)
    ShardingPlan(pp="pp").validate_pp(tiny_config(), 2)
