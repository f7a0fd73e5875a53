"""Rank bodies of the port's sharded tests (``test_torch_parallel.py``).

Every rank of a spawned gloo world imports this module, so it imports
neither JAX nor the JAX package: a rank reads the containers the test
wrote and runs the port only. It defines no tests of its own.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from calm_tpu_torch import model as M
from calm_tpu_torch.config import ModelConfig
from calm_tpu_torch.container import TensorFile
from calm_tpu_torch.ops.qmm import QTensor
from calm_tpu_torch.parallel import (ShardingPlan, detect_topology, health_check,
                                     make_mesh, make_multihost_mesh,
                                     shard_cache, shard_weights,
                                     sharded_decode_step, sharded_prefill,
                                     sharded_prefill_slot, sharded_prefill_sp,
                                     sharded_tree_verify)
from calm_tpu_torch.parallel.sharding import load_weights_sharded

KV = torch.float16  # the JAX tests' cache dtype
CPU = "cpu"  # the ranks compute on the CPU (the mesh's default is the GPU)


def _load(path):
    tf = TensorFile(path)
    cfg = ModelConfig.from_metadata(tf.metadata)
    return tf, cfg, M.load_weights(tf, cfg)


def _plan(tp=1, ep=1, dp=1, sp=1, rs_ag=False, sp_axis="sp"):
    return ShardingPlan(tp="tp" if tp > 1 else None, ep="ep" if ep > 1 else None,
                        dp="dp" if dp > 1 else None, sp=sp_axis if sp > 1 else None,
                        rs_ag=rs_ag)


def _decode(cfg, w, mesh, plan, tokens, batch=1, sp=False, cache=None, pos0=0):
    ws = shard_weights(w, cfg, mesh, plan)
    if cache is None:
        cache = shard_cache(M.KVCache.create(cfg, batch, KV), mesh, plan, sp=sp)
    step = sharded_decode_step(cfg, mesh, plan)
    out = []
    for i, tok in enumerate(tokens):
        logits, cache = step(ws, torch.full((batch,), tok), pos0 + i, cache)
        out.append(logits.numpy())
    return np.stack(out), cache


def decode_case(rank, path, tokens, tp=1, ep=1, dp=1, sp=1, rs_ag=False, batch=1):
    """Greedy-forced decode of ``tokens`` on a (dp, sp, ep, tp) mesh:
    logits (T, B, V) on each rank of the mesh, None past it."""
    _, cfg, w = _load(path)
    mesh = make_mesh(tp=tp, ep=ep, dp=dp, sp=sp, device=CPU)
    if mesh is None:
        return None
    plan = _plan(tp, ep, dp, sp, rs_ag)
    return _decode(cfg, w, mesh, plan, tokens, batch, sp=sp > 1)[0]


def loading_case(rank, path, tokens):
    """tp2 shard-aware loading: whether each tensor equals the cut of the
    whole load, the largest weight tensor a rank holds against the file's,
    and 3 decoded steps of the loaded shards."""
    tf, cfg, w = _load(path)
    mesh = make_mesh(tp=2, device=CPU)
    if mesh is None:
        return None
    plan = _plan(tp=2)
    got = load_weights_sharded(tf, cfg, mesh, plan)
    want = shard_weights(w, cfg, mesh, plan)
    same = []
    for f in want.layers.__dataclass_fields__:
        a, b = getattr(want.layers, f), getattr(got.layers, f)
        if a is None:
            same.append(b is None)
            continue
        pairs = (((a.data, b.data), (a.scale, b.scale)) if isinstance(a, QTensor)
                 else ((a, b),))
        for x, y in pairs:
            same.append(x is None and y is None or torch.equal(x, y))
    for a, b in ((want.embed, got.embed), (want.output, got.output)):
        same.append(torch.equal(a.data, b.data))
    same.append(torch.equal(want.final_norm, got.final_norm))
    wq_full = tf.get("model.layers.%d.attn.wq.weight", 0)
    step = sharded_decode_step(cfg, mesh, plan)
    cache = shard_cache(M.KVCache.create(cfg, 1, KV), mesh, plan)
    out = []
    for pos, tok in enumerate(tokens):
        logits, cache = step(got, torch.tensor([tok]), pos, cache)
        out.append(logits[0].numpy())
    return dict(equal=all(same), wq_rows=got.layers.wq.data.shape[1],
                wq_rows_file=wq_full.shape[0], logits=np.stack(out))


def prefill_case(rank, path, tokens):
    """tp2 prefill of ``tokens`` from position 0: all logits (T, V)."""
    _, cfg, w = _load(path)
    mesh = make_mesh(tp=2, device=CPU)
    if mesh is None:
        return None
    plan = _plan(tp=2)
    ws = shard_weights(w, cfg, mesh, plan)
    cache = shard_cache(M.KVCache.create(cfg, 1, KV), mesh, plan)
    logits, _ = sharded_prefill(cfg, mesh, plan, "all")(ws, torch.tensor([tokens]),
                                                        [0], cache)
    return logits[0].numpy()


def prefill_slot_case(rank, path, tokens, n_valid, slot):
    """Admission of one sequence into global slot ``slot`` of a 4-slot
    cache on a dp2 x tp2 mesh (``tokens`` right-padded past ``n_valid``):
    the logits after its last real token (V,), and whether the other
    slots' rows stayed zero."""
    _, cfg, w = _load(path)
    mesh = make_mesh(tp=2, dp=2, device=CPU)
    plan = _plan(tp=2, dp=2)
    ws = shard_weights(w, cfg, mesh, plan)
    cache = shard_cache(M.KVCache.create(cfg, 4, KV), mesh, plan)
    logits, cache = sharded_prefill_slot(cfg, mesh, plan)(ws, torch.tensor([tokens]),
                                                          n_valid, slot, cache)
    k = mesh.all_gather(mesh.all_gather(cache.k, "tp", dim=2), "dp", dim=1)
    others = [b for b in range(4) if b != slot]
    return logits.numpy(), bool(k[:, others].eq(0).all()), bool(k[:, slot].ne(0).any())


def sp_prefill_case(rank, path, prompt, tp, sp, sp_axis, decode_tokens=()):
    """sp prefill of the whole window, then sp decode of ``decode_tokens``
    on the same S-sharded cache: (prefill logits (T, V), the gathered
    cache's K (L, 1, KVH, S, hd) as f32, decode logits (N, V))."""
    _, cfg, w = _load(path)
    kw = dict(tp=tp, sp=sp) if sp_axis == "sp" else dict(tp=tp, dp=sp)
    mesh = make_mesh(**kw, device=CPU)
    if mesh is None:
        return None
    plan = ShardingPlan(tp="tp" if tp > 1 else None, sp=sp_axis)
    ws = shard_weights(w, cfg, mesh, plan)
    cache = shard_cache(M.KVCache.create(cfg, 1, KV), mesh, plan, sp=True)
    logits, cache = sharded_prefill_sp(cfg, mesh, plan)(ws, torch.tensor([prompt]), cache)
    k = mesh.all_gather(mesh.all_gather(cache.k, plan.sp, dim=3), plan.tp, dim=2)
    steps = []
    if decode_tokens:
        step = sharded_decode_step(cfg, mesh, plan)
        for i, tok in enumerate(decode_tokens):
            lg, cache = step(ws, torch.tensor([tok]), len(prompt) + i, cache)
            steps.append(lg[0].numpy())
    return logits[0].numpy(), k.float().numpy(), np.array(steps)


def tree_verify_case(rank, path, prompt, nodes, depth, tree, tp):
    """A tp prefill of ``prompt``, then one speculation tree of ``nodes``
    (depth (N,), tree (N, N)) verified from the prompt's end on a tp mesh:
    the gathered logits (N, V)."""
    _, cfg, w = _load(path)
    mesh = make_mesh(tp=tp, device=CPU)
    if mesh is None:
        return None
    plan = _plan(tp=tp)
    ws = shard_weights(w, cfg, mesh, plan)
    cache = shard_cache(M.KVCache.create(cfg, 1, KV), mesh, plan)
    _, cache = sharded_prefill(cfg, mesh, plan, "none")(ws, torch.tensor([prompt]), [0],
                                                        cache)
    logits, _ = sharded_tree_verify(cfg, mesh, plan)(
        ws, torch.tensor([nodes]), [len(prompt)], torch.tensor(depth, dtype=torch.int32),
        torch.tensor(tree), cache)
    return logits[0].numpy()


def greedy_case(rank, logits):
    """``model.greedy_next`` of (B, V) logits cut into two vocab slices
    under tp2."""
    mesh = make_mesh(tp=2, device=CPU)
    if mesh is None:
        return None
    v = logits.shape[1] // 2
    i = mesh.axis_index("tp")
    local = torch.as_tensor(logits[:, i * v:(i + 1) * v])
    return M.greedy_next(local, _plan(tp=2), mesh).tolist()


def health_case(rank):
    """``health_check`` over a 2-rank mesh (the world's first two ranks),
    over the multihost grid of the world and over the world; the topology
    this rank sees; the JAX modules it has imported."""
    sub = make_mesh(tp=2, device=CPU)
    mesh = make_multihost_mesh(tp=2, dp_dcn=2, device=CPU)
    reps = [None if sub is None else health_check(sub, timeout_s=60)["ranks"],
            health_check(mesh, timeout_s=60)["ranks"],
            health_check(None, timeout_s=60, device=CPU)["ranks"]]
    jaxy = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "calm_tpu"))
    return reps, detect_topology().device_kind, jaxy


def modules_case(rank, forbidden):
    """The modules of ``forbidden`` packages that this rank has imported."""
    return sorted(m for m in sys.modules if m.split(".")[0] in forbidden)


def run(rank, cases):
    """Every (name, function name, args) of ``cases`` in order, on every
    rank: {name: result}."""
    torch.manual_seed(0)
    out = {}
    for name, fn, args in cases:
        out[name] = globals()[fn](rank, *args)
    return out
