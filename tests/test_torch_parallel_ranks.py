"""Rank bodies of the port's sharded tests (``test_torch_parallel.py``,
``test_torch_pipeline.py``).

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
                                     make_grid, make_mesh, make_multihost_mesh,
                                     make_pp_mesh, shard_cache, shard_weights,
                                     sharded_decode_scan, sharded_decode_step,
                                     sharded_decode_step_gpipe, sharded_decode_step_pp,
                                     sharded_prefill, sharded_prefill_slot,
                                     sharded_prefill_sp, sharded_tree_verify)
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


def pp_case(rank, path, tokens, pp, tp=1, ep=1):
    """Pipeline-parallel decode of ``tokens`` on a (pp, ep, tp) grid: the
    logits (T, V) on each rank of the mesh, None past it."""
    _, cfg, w = _load(path)
    mesh = make_grid(dict(pp=pp, ep=ep, tp=tp), device=CPU)
    if mesh is None:
        return None
    plan = ShardingPlan(tp="tp" if tp > 1 else None, ep="ep" if ep > 1 else None, pp="pp")
    ws = shard_weights(w, cfg, mesh, plan)
    cache = shard_cache(M.KVCache.create(cfg, 1, KV), mesh, plan)
    step = sharded_decode_step_pp(cfg, mesh, plan)
    out = []
    for pos, tok in enumerate(tokens):
        logits, cache = step(ws, torch.tensor([tok]), pos, cache)
        out.append(logits[0].numpy())
    return dict(logits=np.stack(out), layers=ws.layers.wq.data.shape[0],
                cache_layers=cache.k.shape[0])


def gpipe_case(rank, path, seqs, pp, tp, n_micro):
    """GPipe decode of B sequences ``seqs`` (B lists of equal length) on a
    (pp, tp) grid, all slots a step: logits (T, B, V)."""
    _, cfg, w = _load(path)
    mesh = make_pp_mesh(pp, tp, device=CPU)
    if mesh is None:
        return None
    plan = ShardingPlan(tp="tp" if tp > 1 else None, pp="pp")
    ws = shard_weights(w, cfg, mesh, plan)
    B = len(seqs)
    cache = shard_cache(M.KVCache.create(cfg, B, KV), mesh, plan)
    step = sharded_decode_step_gpipe(cfg, mesh, plan, n_micro)
    out = []
    for pos in range(len(seqs[0])):
        logits, cache = step(ws, torch.tensor([s[pos] for s in seqs]), pos, cache)
        out.append(logits.numpy())
    return np.stack(out)


def scan_case(rank, path, token, n_steps, tp=1, sp=1):
    """``sharded_decode_scan`` of n_steps greedy ids from ``token`` at
    position 0 on a (sp, tp) mesh, beside the sharded step loop teacher-fed
    its ids: (ids (n,), last logits (V,), the loop's ids, its last logits)."""
    _, cfg, w = _load(path)
    mesh = make_mesh(tp=tp, sp=sp, device=CPU)
    if mesh is None:
        return None
    plan = _plan(tp=tp, sp=sp)
    ws = shard_weights(w, cfg, mesh, plan)
    cache = shard_cache(M.KVCache.create(cfg, 1, KV), mesh, plan, sp=sp > 1)
    ids, _, last = sharded_decode_scan(cfg, mesh, plan, n_steps)(ws, [token], 0, cache)
    cache = shard_cache(M.KVCache.create(cfg, 1, KV), mesh, plan, sp=sp > 1)
    step = sharded_decode_step(cfg, mesh, plan)
    loop, tok = [], token
    for pos in range(n_steps):
        lg, cache = step(ws, torch.tensor([tok]), pos, cache)
        tok = int(lg[0].argmax())
        loop.append(tok)
    return ids[0].tolist(), last[0].numpy(), loop, lg[0].numpy()


def ring_case(rank, path, prompt, tp, sp, sp_axis, decode_tokens=()):
    """sp prefill of the whole window under ``plan.ring``, then sp decode of
    ``decode_tokens`` on the S-sharded cache it leaves: (prefill logits
    (T, V), the gathered cache's K (L, 1, KVH, S, hd) as f32, decode
    logits (N, V), the mesh's ppermute and all_gather calls inside
    ``model.prefill_sp``)."""
    _, cfg, w = _load(path)
    kw = dict(tp=tp, sp=sp) if sp_axis == "sp" else dict(tp=tp, dp=sp)
    mesh = make_mesh(**kw, device=CPU)
    if mesh is None:
        return None
    plan = ShardingPlan(tp="tp" if tp > 1 else None, sp=sp_axis, ring=True)
    ws = shard_weights(w, cfg, mesh, plan)
    cache = shard_cache(M.KVCache.create(cfg, 1, KV), mesh, plan, sp=True)
    calls = dict(ppermute=0, all_gather=0)
    for name in calls:
        def counted(*a, _f=getattr(mesh, name), _n=name, **k):
            calls[_n] += 1
            return _f(*a, **k)
        setattr(mesh, name, counted)
    T = len(prompt) // sp
    i = mesh.axis_index(plan.sp)
    logits, cache = M.prefill_sp(cfg, ws, torch.tensor([prompt[i * T:(i + 1) * T]]), cache,
                                 plan, mesh)
    for name in calls:
        delattr(mesh, name)
    logits = mesh.all_gather(mesh.all_gather(logits, plan.tp, dim=-1), plan.sp, dim=1)
    k = mesh.all_gather(mesh.all_gather(cache.k, plan.sp, dim=3), plan.tp, dim=2)
    steps = []
    if decode_tokens:
        step = sharded_decode_step(cfg, mesh, plan)
        for j, tok in enumerate(decode_tokens):
            lg, cache = step(ws, torch.tensor([tok]), len(prompt) + j, cache)
            steps.append(lg[0].numpy())
    return logits[0].numpy(), k.float().numpy(), np.array(steps), calls


def no_stages_case(rank, path):
    """The steps that run every layer on each rank, given a plan with two
    pp stages: the message of the ValueError each raises (None if one
    runs)."""
    _, cfg, w = _load(path)
    mesh = make_pp_mesh(2, 2, device=CPU)
    plan = ShardingPlan(tp="tp", pp="pp")
    out = {}
    for name, build in (("sharded_decode_step", sharded_decode_step),
                        ("sharded_prefill", sharded_prefill),
                        ("sharded_prefill_slot", sharded_prefill_slot),
                        ("sharded_decode_scan", lambda c, m, p: sharded_decode_scan(c, m, p, 2))):
        try:
            build(cfg, mesh, plan)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


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
