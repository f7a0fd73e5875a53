"""The port's sharded paths against the JAX package: tp/ep/dp/sp decode,
rs_ag, shard-aware loading, tp and sp prefill, greedy_next, health_check
(the cases of tests/test_parallel.py, on the same configs, tokens and
tolerances).

The port's ranks are gloo processes on the CPU: one world of 4 is spawned
for the whole module (a module-scoped fixture), runs every case and hands
back each rank's results (the rank bodies live in the jax-free
``test_torch_parallel_ranks``). The JAX side runs here, unsharded on one
CPU device: tests/test_parallel.py already holds its sharded paths to it.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calm_tpu import container
from calm_tpu import model as JM
from calm_tpu_torch import model as TM
from calm_tpu_torch.container import TensorFile
from calm_tpu_torch.parallel import ShardingPlan, spawn
from tests import test_torch_parallel_ranks as R
from tests.modelgen import tiny_config, write_tiny_model

torch.set_num_threads(1)

TOKENS = [1, 5, 9, 200, 42, 7]
PROMPT = [1, 5, 9, 200, 42, 7, 3, 11, 8, 2, 250, 17, 33, 4, 99, 6]
WORLD = 4
GF4 = dict(dim=64, hidden_dim=64, head_dim=16, rotary_dim=16, vocab_size=272)
CONFIGS = {
    "fp16": tiny_config(dtype="fp16"),
    "fp8": tiny_config(dtype="fp8"),
    "gf4": tiny_config(dtype="gf4", **GF4),
    "fp8e4": tiny_config(dtype="fp8e4"),
    "moe": tiny_config(dtype="fp16", moe=True),
    "moe_fp8e4": tiny_config(dtype="fp8e4", moe=True),
    "sp": tiny_config(dtype="fp16", seq_len=16),
    "kv4": tiny_config(dtype="fp16", n_kv_heads=4),  # tp=4 shards 4 kv heads
}
SP_TOKS = list(range(1, 25))  # 24 steps > seq_len 16: wraps the window


def _tree(k=3, m=3):
    """The nodes, depths and mask of a k-lane, depth-m draft tree."""
    n = 1 + k * (m - 1)
    mask = np.zeros((n, n), bool)
    mask[:, 0] = True
    for i in range(k):
        b = 1 + i * (m - 1)
        for d in range(m - 1):
            mask[b + d, b:b + d + 1] = True
    depth = [0] + [d for _ in range(k) for d in range(1, m)]
    return [3 + 11 * i for i in range(n)], depth, mask


TREE = _tree()


def tie_logits():
    """(3, 268) logits whose maximum appears twice: across the two tp
    slices of 134 (first in rank 0's), within rank 1's, within rank 0's."""
    x = np.random.default_rng(3).standard_normal((3, 268)).astype(np.float32)
    for b, (i, j) in enumerate(((50, 200), (150, 200), (3, 90))):
        x[b, i] = x[b, j] = 10.0
    return x


def _cases(paths):
    p = paths
    return [
        ("tp2_fp16", "decode_case", (p["fp16"], TOKENS, 2)),
        ("tp2_fp8", "decode_case", (p["fp8"], TOKENS, 2)),
        ("tp2_gf4", "decode_case", (p["gf4"], TOKENS, 2)),
        ("tp2_fp8e4", "decode_case", (p["fp8e4"], TOKENS, 2)),
        ("rs_ag_dense", "decode_case", (p["fp16"], TOKENS[:4], 2, 1, 1, 1, True)),
        ("rs_ag_moe", "decode_case", (p["moe"], TOKENS[:4], 2, 2, 1, 1, True)),
        ("ep4_moe", "decode_case", (p["moe"], TOKENS, 1, 4)),
        ("tp2_ep2_moe", "decode_case", (p["moe"], TOKENS, 2, 2)),
        ("ep2_fp8e4_moe", "decode_case", (p["moe_fp8e4"], TOKENS, 1, 2)),
        ("dp2_tp2", "decode_case", (p["fp16"], TOKENS, 2, 1, 2, 1, False, 4)),
        *[(f"load_{f}", "loading_case", (p[f], TOKENS[:3]))
          for f in ("fp16", "fp8", "gf4", "fp8e4")],
        ("tp2_prefill", "prefill_case", (p["fp16"], TOKENS)),
        ("dp2_prefill_slot", "prefill_slot_case", (p["fp16"], TOKENS + [0, 0, 0], 6, 3)),
        ("sp_prefill", "sp_prefill_case", (p["sp"], PROMPT, 2, 2, "dp")),
        ("sp_decode_tp1_sp4", "decode_case", (p["sp"], SP_TOKS, 1, 1, 1, 4)),
        ("sp_decode_tp2_sp2", "decode_case", (p["sp"], SP_TOKS, 2, 1, 1, 2)),
        ("sp_prefill_decode", "sp_prefill_case", (p["sp"], PROMPT, 1, 4, "sp",
                                                  [12, 3, 77, 5])),
        ("greedy_tie", "greedy_case", (tie_logits(),)),
        *[(f"tree_tp{tp}", "tree_verify_case", (p[name], TOKENS, *TREE, tp))
          for tp, name in ((2, "fp16"), (4, "kv4"))],
        ("health", "health_case", ()),
    ]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel")
    paths = {}
    for name, cfg in CONFIGS.items():
        paths[name] = os.path.join(d, name + ".calm")
        write_tiny_model(paths[name], cfg)
    return paths, spawn(R.run, WORLD, _cases(paths), device="cpu", timeout_s=600)


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def result(ranks, name):
    """Rank 0's result of a case, after checking that every rank of its
    mesh returned the same (the gathered logits are global)."""
    got = [r[name] for r in ranks[1] if r[name] is not None]
    assert all(_same(got[0], g) for g in got[1:]), f"{name}: ranks disagree"
    return got[0]


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


@pytest.mark.parametrize("case,model,tol", [
    ("tp2_fp16", "fp16", (1e-4, 1e-4)),
    ("tp2_fp8", "fp8", (1e-4, 1e-4)),
    # psum splits the contraction: accumulation order differs from one rank
    ("tp2_gf4", "gf4", (1e-2, 2e-3)),
    ("tp2_fp8e4", "fp8e4", (1e-4, 1e-4)),
    ("ep4_moe", "moe", (1e-4, 1e-4)),
    ("tp2_ep2_moe", "moe", (1e-4, 1e-4)),
    ("ep2_fp8e4_moe", "moe_fp8e4", (1e-4, 1e-4)),
])
def test_sharded_decode(ranks, case, model, tol):
    cfg, w = jax_weights(ranks, model)
    want = reference_logits(cfg, w, TOKENS)
    got = result(ranks, case)[:, 0]
    np.testing.assert_allclose(got, want, rtol=tol[0], atol=tol[1])


@pytest.mark.parametrize("case,model", [("rs_ag_dense", "fp16"), ("rs_ag_moe", "moe")])
def test_rs_ag_residual_close_parity(ranks, case, model):
    """The reduce-scatter + all-gather close of the residual (plan.rs_ag)
    is the same sum as the single psum."""
    cfg, w = jax_weights(ranks, model)
    want = reference_logits(cfg, w, TOKENS[:4])
    np.testing.assert_allclose(result(ranks, case)[:, 0], want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("fmt", ["fp16", "fp8", "gf4", "fp8e4"])
def test_shard_aware_loading(ranks, fmt):
    """load_weights_sharded reads each rank's slices from the memmap: its
    tensors equal the cut of the whole load, a rank holds half of wq's
    rows, and the loaded shards decode as the JAX package."""
    got = result(ranks, f"load_{fmt}")
    assert got["equal"]
    assert got["wq_rows"] * 2 == got["wq_rows_file"]
    cfg, w = jax_weights(ranks, fmt)
    tol = (1e-2, 2e-3) if fmt == "gf4" else (1e-4, 1e-4)
    np.testing.assert_allclose(got["logits"], reference_logits(cfg, w, TOKENS[:3]),
                               rtol=tol[0], atol=tol[1])


def test_tp2_prefill(ranks):
    cfg, w = jax_weights(ranks, "fp16")
    want = reference_logits(cfg, w, TOKENS)
    np.testing.assert_allclose(result(ranks, "tp2_prefill"), want, rtol=1e-4, atol=1e-4)


def test_dp2_prefill_slot(ranks):
    """Continuous-batching admission on a sharded model: the sequence lands
    in global slot 3 (the second dp shard's), right padding ignored, and
    every rank gets the logits after its last real token."""
    cfg, w = jax_weights(ranks, "fp16")
    want = reference_logits(cfg, w, TOKENS)[-1]
    logits, others_zero, slot_written = result(ranks, "dp2_prefill_slot")
    np.testing.assert_allclose(logits, want, rtol=1e-4, atol=1e-4)
    assert others_zero and slot_written


@pytest.mark.parametrize("tp,model", [(2, "fp16"), (4, "kv4")])
def test_sharded_tree_verify(ranks, tp, model):
    """sharded_tree_verify under tp: the unsharded port's tree_verify
    after the same prefill, and JAX's, within the sharded tests'
    tolerance (psum closes wo's and the FFN's partial sums)."""
    nodes, depth, mask = TREE
    cfg_t = TM.ModelConfig.from_metadata(TensorFile(ranks[0][model]).metadata)
    w = TM.load_weights(TensorFile(ranks[0][model]), cfg_t)
    cache = TM.KVCache.create(cfg_t, 1, torch.float16)
    TM.prefill(cfg_t, w, torch.tensor([TOKENS]), [0], cache, "none")
    want, _ = TM.tree_verify(cfg_t, w, torch.tensor([nodes]), [len(TOKENS)],
                             torch.tensor(depth, dtype=torch.int32), torch.from_numpy(mask),
                             cache)
    got = result(ranks, f"tree_tp{tp}")
    np.testing.assert_allclose(got, want[0].numpy(), rtol=1e-4, atol=1e-4)
    cfg, wj = jax_weights(ranks, model)
    jc = JM.KVCache.create(cfg, 1, jnp.float16)
    _, jc = JM.prefill(cfg, wj, jnp.array([TOKENS]), jnp.array([0]), jc, logits_mode="none")
    jl, _ = JM.tree_verify(cfg, wj, jnp.array([nodes]), jnp.array([len(TOKENS)]),
                           jnp.array(depth, jnp.int32), jnp.asarray(mask), jc)
    np.testing.assert_allclose(got, np.asarray(jl[0], np.float32), rtol=1e-4, atol=1e-4)


def test_plan_validation():
    cfg = tiny_config()
    with pytest.raises(AssertionError):
        ShardingPlan(tp="tp").validate(cfg, tp_size=3, ep_size=1)  # kv_heads=2


def test_dp2_decode(ranks):
    """Four slots, two per dp shard, tp2 inside: every slot matches the
    unsharded decode."""
    cfg, w = jax_weights(ranks, "fp16")
    want = reference_logits(cfg, w, TOKENS)
    got = result(ranks, "dp2_tp2")  # (T, B, V)
    for b in range(got.shape[1]):
        np.testing.assert_allclose(got[:, b], want, rtol=1e-4, atol=1e-4)


def test_sp_prefill_parity(ranks):
    """Sequence-parallel full-window prefill (tp2, the sp axis on dp)
    matches the plain prefill: logits and the cache rows it writes."""
    cfg, w = jax_weights(ranks, "sp")
    want, want_cache = JM.prefill(cfg, w, jnp.asarray([PROMPT], jnp.int32),
                                  jnp.zeros((1,), jnp.int32),
                                  JM.KVCache.create(cfg, 1, jnp.float16), logits_mode="all")
    logits, k, _ = result(ranks, "sp_prefill")
    np.testing.assert_allclose(logits, np.asarray(want)[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(k, np.asarray(want_cache.k, np.float32), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("case", ["sp_decode_tp1_sp4", "sp_decode_tp2_sp2"])
def test_sp_decode_parity(ranks, case):
    """sp decode: cache rows S-sharded, the exact softmax merged from each
    shard's partials (K12 partials mode's plain version), across the
    window wrap (row ownership, sink rotation on shard 0 only)."""
    cfg, w = jax_weights(ranks, "sp")
    want = reference_logits(cfg, w, SP_TOKS)
    np.testing.assert_allclose(result(ranks, case)[:, 0], want, rtol=1e-4, atol=1e-4)


def test_sp_prefill_then_sp_decode(ranks):
    """sp prefill ingests the whole window, then decode continues on the
    same S-sharded cache (and rolls at once)."""
    cfg, w = jax_weights(ranks, "sp")
    cache = JM.KVCache.create(cfg, 1, jnp.float16)
    _, cache = JM.prefill(cfg, w, jnp.asarray([PROMPT], jnp.int32),
                          jnp.zeros((1,), jnp.int32), cache)
    want = []
    for i, tok in enumerate([12, 3, 77, 5]):
        logits, cache = JM.decode_step(cfg, w, jnp.array([tok]), jnp.array([16 + i]), cache)
        want.append(np.asarray(logits[0]))
    _, _, got = result(ranks, "sp_prefill_decode")
    np.testing.assert_allclose(got, np.stack(want), rtol=1e-4, atol=1e-4)


def test_greedy_next_tp_tie(ranks):
    """The vocab-sharded argmax resolves ties across and within ranks to
    the first occurrence, as jnp.argmax and JAX's greedy_next."""
    want = np.asarray(JM.greedy_next(jnp.asarray(tie_logits()))).tolist()
    assert want == [50, 150, 3]
    assert result(ranks, "greedy_tie") == want


def test_health_check_and_ranks_import_no_jax(ranks):
    """health_check sums ones over a sub-mesh, the multihost grid and the
    world; a CPU rank sees a "cpu" topology and has imported no JAX and no
    module of the JAX package."""
    _, res = ranks
    for r, (reps, kind, jaxy) in enumerate(x["health"] for x in res):
        assert reps == [2 if r < 2 else None, WORLD, WORLD]
        assert kind == "cpu" and jaxy == []


@pytest.mark.parametrize("entry", ["make_mesh", "health_check", "spawn"])
def test_parallel_entry_points_default_to_the_gpu(entry):
    """Without ``device`` a mesh, a health check and a spawned run compute
    on the GPU: on a machine without one they refuse before touching the
    process group or starting a process, as the other entry points do."""
    from calm_tpu_torch import parallel as P
    from calm_tpu_torch.device import NoGPUError

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    call = {"make_mesh": lambda: P.make_mesh(tp=2),
            "health_check": lambda: P.health_check(None),
            "spawn": lambda: P.spawn(R.modules_case, 2, ("jax",))}[entry]
    with pytest.raises(NoGPUError):
        call()
    assert P.rank_device("cpu") == torch.device("cpu")
