"""Per-rank slices of the weights and caches, and the sharded step
functions: the port of ``calm_tpu.parallel.sharding``.

The model (``calm_tpu_torch.model``) is written against local shapes with
explicit collectives on a :class:`~calm_tpu_torch.parallel.mesh.Mesh`;
these helpers cut the matching local tensors and wrap its functions so
that every rank of the mesh, running the same program, returns the global
result. The layout (``calm_tpu/parallel/plan.py``):

- wq/wk/wv, w1/w3: column-sharded over tp (the output axis);
- wo, w2: row-sharded over tp (the contraction axis; a psum closes);
- experts: sharded over ep;
- embed/output: vocab-sharded over tp;
- the KV cache: kv heads over tp, slots over dp, rows over sp (sp decode);
- every layer-stacked tensor and the cache: layers over pp (pipeline
  stages, ``parallel.pipeline``; the steps here refuse a pp axis).

A spec is a tuple of mesh axis names (or None) per tensor dim, the
counterpart of a PartitionSpec; :func:`weight_pspecs` gives the natural
layouts' (the port holds no fused gf4 layout). ``fuse_weights_sharded``
has no counterpart: the port's kernels read the container's natural gf4
words, so there is nothing to fuse per shard. Every step here runs
eagerly: its collectives go through ``torch.distributed``, which a CUDA
graph on one card cannot hold (that needs NCCL across two or more cards).
"""

from __future__ import annotations

import torch

from calm_tpu_torch import model as M
from calm_tpu_torch.config import ModelConfig
from calm_tpu_torch.container import TensorFile
from calm_tpu_torch.ops.qmm import QTensor
from calm_tpu_torch.parallel.mesh import Mesh
from calm_tpu_torch.parallel.plan import ShardingPlan

# per-layer matrices: container name -> field
_MATRICES = {"attn.wq": "wq", "attn.wk": "wk", "attn.wv": "wv", "attn.wo": "wo",
             "mlp.w1": "w1", "mlp.w2": "w2", "mlp.w3": "w3"}


def weight_pspecs(cfg: ModelConfig, plan: ShardingPlan) -> dict[str, tuple]:
    """Field path -> spec of the tensor's dims (layer-stacked fields lead
    with the layer axis, sharded over pp; a QTensor's fp8e4 scale takes the
    leading dims of its data's spec and None for its trailing 1)."""
    tp, ep, pp = plan.tp, plan.ep, plan.pp
    if cfg.n_experts:
        w13, w2 = (pp, ep, tp, None), (pp, ep, None, tp)
    else:
        w13, w2 = (pp, tp, None), (pp, None, tp)
    specs = {"embed": (tp, None), "output": (tp, None), "final_norm": (None,),
             "layers.attn_norm": (pp, None), "layers.ffn_norm": (pp, None),
             "layers.wq": (pp, tp, None), "layers.wk": (pp, tp, None),
             "layers.wv": (pp, tp, None), "layers.wo": (pp, None, tp),
             "layers.w1": w13, "layers.w3": w13, "layers.w2": w2,
             "layers.bq": (pp, tp), "layers.bk": (pp, tp), "layers.bv": (pp, tp)}
    if cfg.norm_qk:
        specs.update({"layers.q_norm": (pp, tp), "layers.k_norm": (pp, tp)})
    if cfg.n_experts:
        specs["layers.moegate"] = (pp, None, None)  # routing is replicated
    return specs


def _scale_spec(spec: tuple, ndim: int) -> tuple:
    return tuple(spec[:ndim - 1]) + (None,)


def _take(t: torch.Tensor, spec: tuple, mesh: Mesh):
    """This rank's block of ``t`` (a tensor or numpy array) under ``spec``."""
    idx = []
    for d, axis in enumerate(spec):
        n = mesh.axis_size(axis)
        if n == 1:
            idx.append(slice(None))
            continue
        if t.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not split over {axis}={n}")
        size = t.shape[d] // n
        i = mesh.axis_index(axis)
        idx.append(slice(i * size, (i + 1) * size))
    return t[tuple(idx)]


def _validate(cfg: ModelConfig, mesh: Mesh, plan: ShardingPlan) -> None:
    plan.validate(cfg, mesh.axis_size(plan.tp), mesh.axis_size(plan.ep))
    plan.validate_pp(cfg, mesh.axis_size(plan.pp))


def _no_stages(mesh: Mesh, plan: ShardingPlan, what: str) -> None:
    """Refuse a plan whose pp axis splits the layers: these steps run every
    layer on every rank."""
    if mesh.axis_size(plan.pp) > 1:
        raise ValueError(f"{what} runs every layer on each rank; a plan with pp="
                         f"{mesh.axis_size(plan.pp)} stages decodes through "
                         "parallel.pipeline.sharded_decode_step_pp (or _gpipe)")


def shard_weights(w: M.Weights, cfg: ModelConfig, mesh: Mesh,
                  plan: ShardingPlan) -> M.Weights:
    """This rank's local Weights, cut from whole ones, on the mesh's
    device. A tied output stays the embedding."""
    _validate(cfg, mesh, plan)
    specs = weight_pspecs(cfg, plan)

    def cut(x, key):
        if x is None:
            return None
        if isinstance(x, QTensor):
            spec = specs[key]
            scale = (None if x.scale is None else
                     _take(x.scale, _scale_spec(spec, x.scale.ndim), mesh))
            return QTensor(_take(x.data, spec, mesh).to(mesh.device).contiguous(), x.fmt,
                           None if scale is None else scale.to(mesh.device).contiguous())
        return _take(x, specs[key], mesh).to(mesh.device).contiguous()

    lw = w.layers
    layers = M.LayerWeights(**{f: cut(getattr(lw, f), "layers." + f)
                               for f in lw.__dataclass_fields__})
    embed = cut(w.embed, "embed")
    return M.Weights(embed=embed, layers=layers,
                     final_norm=cut(w.final_norm, "final_norm"),
                     output=embed if w.output is w.embed else cut(w.output, "output"))


class _RankFile:
    """A TensorFile whose weight matrices (and their fp8e4 scales) come back
    as this rank's slice: a view of the container's memmap, so that only
    the slice's pages are read and copied."""

    def __init__(self, tf: TensorFile, cfg: ModelConfig, mesh: Mesh,
                 plan: ShardingPlan):
        self._tf, self._mesh = tf, mesh
        specs = weight_pspecs(cfg, plan)
        self._specs = {"model.embed.weight": specs["embed"],
                       "model.output.weight": specs["output"]}
        for name, field in _MATRICES.items():
            self._specs[f"model.layers.%d.{name}.weight"] = specs["layers." + field][1:]

    def find(self, *a):
        return self._tf.find(*a)

    def get(self, name, layer=None, tag=None, shape=None):
        a = self._tf.get(name, layer, tag, shape)
        scale = name.endswith(".scale")
        spec = self._specs.get(name[:-len(".scale")] if scale else name)
        if spec is None:
            return a
        return _take(a, _scale_spec(spec, a.ndim) if scale else spec, self._mesh)


def load_weights_sharded(tf: TensorFile, cfg: ModelConfig, mesh: Mesh,
                         plan: ShardingPlan) -> M.Weights:
    """Shard-aware loading (``calm_tpu/parallel/sharding.py:123-162``):
    each rank reads only its slices of the weight matrices from the
    container's memmap (gf4 rows of words split on group boundaries, as
    ``plan.validate`` asserts), then cuts the small replicated-in-file
    vectors (biases, qk-norms). Equal to ``shard_weights`` of the whole
    load. It takes no pp axis: ``shard_weights`` cuts a stage's layers."""
    _validate(cfg, mesh, plan)
    _no_stages(mesh, plan, "load_weights_sharded")
    w = M.load_weights(_RankFile(tf, cfg, mesh, plan), cfg, mesh.device)
    specs = weight_pspecs(cfg, plan)
    for f in ("bq", "bk", "bv", "q_norm", "k_norm"):
        t = getattr(w.layers, f)
        if t is not None:
            setattr(w.layers, f, _take(t, specs["layers." + f], mesh).contiguous())
    return w


def cache_pspecs(plan: ShardingPlan, sp: bool = False) -> tuple:
    """The spec of the (L, B, KVH, S, hd) cache planes: layers over pp,
    slots over dp, kv heads over tp and, for sequence parallelism, rows
    over sp."""
    return (plan.pp, plan.dp, plan.tp, plan.sp if sp else None, None)


def shard_cache(cache: M.KVCache, mesh: Mesh, plan: ShardingPlan,
                sp: bool = False) -> M.KVCache:
    """This rank's block of a whole cache, on the mesh's device."""
    spec = cache_pspecs(plan, sp)
    return M.KVCache(_take(cache.k, spec, mesh).to(mesh.device).contiguous(),
                     _take(cache.v, spec, mesh).to(mesh.device).contiguous())


def local_cache(cfg: ModelConfig, batch: int, dtype, mesh: Mesh,
                plan: ShardingPlan) -> M.KVCache:
    """This rank's block of a zero cache of ``batch`` slots, made at its
    local shape on the mesh's device (``shard_cache`` of a whole zero
    cache, with no whole cache made)."""
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, cfg.seq_len, cfg.head_dim)
    local = []
    for n, axis in zip(shape, cache_pspecs(plan)):
        if n % mesh.axis_size(axis):
            raise ValueError(f"{n} does not split over {axis}={mesh.axis_size(axis)}")
        local.append(n // mesh.axis_size(axis))
    return M.KVCache(torch.zeros(local, dtype=dtype, device=mesh.device),
                     torch.zeros(local, dtype=dtype, device=mesh.device))


def _gather_logits(logits: torch.Tensor, mesh: Mesh, plan: ShardingPlan,
                   batch_dim: int | None = 0, seq_dim: int | None = None):
    """The global logits from every rank's block: vocab over tp, slots
    over dp, prompt chunks over sp."""
    out = mesh.all_gather(logits, plan.tp, dim=-1)
    if plan.dp is not None and batch_dim is not None:
        out = mesh.all_gather(out, plan.dp, dim=batch_dim)
    if plan.sp is not None and seq_dim is not None:
        out = mesh.all_gather(out, plan.sp, dim=seq_dim)
    return out


def _dp_slice(x, mesh: Mesh, plan: ShardingPlan):
    """This rank's slots of a (B, ...) batch under dp."""
    if plan.dp is None:
        return x
    return _take(x, (plan.dp,), mesh)


def sharded_decode_step(cfg: ModelConfig, mesh: Mesh, plan: ShardingPlan):
    """The sharded decode step: (local w, token (B,), pos (B,) host ints or
    an int, local cache) -> (logits (B, V) on every rank, cache). Under
    dp each rank steps its B/dp slots, with no collective; the logits are
    gathered. Under sp the cache is S-sharded (as sp prefill leaves it),
    and sp needs an axis of its own (``calm_tpu/parallel/sharding.py
    :646-650``). It runs eagerly, never as a captured graph: its
    collectives go through ``torch.distributed``. A pp axis is refused:
    pipeline stages decode through ``parallel.pipeline``."""
    if plan.sp is not None and plan.sp == plan.dp:
        raise ValueError("sp decode needs its own mesh axis")
    _no_stages(mesh, plan, "sharded_decode_step")

    def step(w, token, pos, cache):
        tok = _dp_slice(torch.as_tensor(token).reshape(-1), mesh, plan)
        p = pos if isinstance(pos, int) else [int(v) for v in _dp_slice(
            torch.as_tensor(pos).reshape(-1), mesh, plan)]
        logits, cache = M.decode_step(cfg, w, tok.to(cache.k.device), p, cache,
                                      plan, mesh)
        return _gather_logits(logits, mesh, plan), cache
    return step


def sharded_prefill(cfg: ModelConfig, mesh: Mesh, plan: ShardingPlan,
                    logits_mode: str = "last"):
    """The sharded prefill: (local w, tokens (B, T), pos0 (B,), local
    cache) -> (global logits per ``logits_mode``, cache). No pp axis."""
    _no_stages(mesh, plan, "sharded_prefill")

    def run(w, tokens, pos0, cache):
        tok = _dp_slice(tokens, mesh, plan)
        p0 = _dp_slice(torch.as_tensor(pos0).reshape(-1), mesh, plan)
        logits, cache = M.prefill(cfg, w, tok.to(cache.k.device), p0.tolist(), cache,
                                  logits_mode, plan=plan, mesh=mesh)
        if logits is None:
            return None, cache
        return _gather_logits(logits, mesh, plan), cache
    return run


def sharded_tree_verify(cfg: ModelConfig, mesh: Mesh, plan: ShardingPlan):
    """The sharded tree-verify forward (``calm_tpu/parallel/sharding.py
    :223-238``): (local w, tokens (1, N), pos0 (1,) host ints, depth (N,),
    tree (N, N) bool, local cache) -> (logits (1, N, V) on every rank,
    cache). The tree's nodes ride the T axis, tp shards the heads as in
    decode, the mask is replicated and the logits are gathered. It runs
    eagerly on the local weights, as the sharded step does. No pp axis."""
    _no_stages(mesh, plan, "sharded_tree_verify")

    def run(w, tokens, pos0, depth, tree, cache):
        logits, cache = M.tree_verify(cfg, w, tokens.to(cache.k.device), pos0,
                                      torch.as_tensor(depth), torch.as_tensor(tree),
                                      cache, plan, mesh)
        return _gather_logits(logits, mesh, plan), cache
    return run


def sharded_prefill_slot(cfg: ModelConfig, mesh: Mesh, plan: ShardingPlan):
    """Continuous-batching admission on a sharded model: (local w, tokens
    (1, T), n_valid, slot, local cache) -> (logits after token n_valid - 1
    (V,), cache). ``slot`` is the global slot; under dp the ranks that own
    it run the prefill and a psum over dp hands every rank the logits
    (``calm_tpu/model.py:1525-1570``). No pp axis."""
    _no_stages(mesh, plan, "sharded_prefill_slot")

    def run(w, tokens, n_valid, slot, cache):
        b_local = cache.k.shape[1]
        local = slot - mesh.axis_index(plan.dp) * b_local
        own = 0 <= local < b_local
        V = cfg.vocab_size // mesh.axis_size(plan.tp)
        last = torch.zeros(V, dtype=torch.float32, device=cache.k.device)
        if own:
            out, cache = M.prefill(cfg, w, tokens[:, :n_valid].to(cache.k.device), [0],
                                   cache, "last", batch_off=local, plan=plan, mesh=mesh)
            last = out[0]
        if plan.dp is not None:
            last = mesh.psum(last, plan.dp)
        return mesh.all_gather(last, plan.tp, dim=-1), cache
    return run


def sharded_decode_scan(cfg: ModelConfig, mesh: Mesh, plan: ShardingPlan, n_steps: int):
    """The sharded greedy decode of ``n_steps`` tokens
    (``calm_tpu/parallel/sharding.py:241-262``): (local w, token (B,),
    pos0 (an int, or B host ints), local cache) -> (tokens (B, n_steps),
    cache, the last step's logits (B, V)), tokens and logits global on
    every rank. Each step's id is ``model.greedy_next`` of its logits
    across the tp shards, fed to the next step on the device: no token
    comes to the host between steps. Under dp each rank steps its slots;
    under sp the cache is S-sharded (``cache_pspecs(plan, sp=True)``, as
    sp prefill leaves it) and sp needs an axis of its own. It runs
    eagerly: a captured step with its collectives inside needs NCCL
    across two or more cards."""
    if plan.sp is not None and plan.sp == plan.dp:
        raise ValueError("sp decode needs its own mesh axis")
    _no_stages(mesh, plan, "sharded_decode_scan")

    @torch.no_grad()
    def run(w, token, pos0, cache):
        dev = cache.k.device
        tok = _dp_slice(torch.as_tensor(token).reshape(-1), mesh, plan).to(dev)
        starts = ([int(pos0)] * tok.shape[0] if isinstance(pos0, int) else
                  [int(p) for p in _dp_slice(torch.as_tensor(pos0).reshape(-1), mesh, plan)])
        pos = M.upload(starts, dev)
        toks = []
        for _ in range(n_steps):
            logits = M._decode(cfg, w, tok, pos, cache, True, None, plan, mesh)
            tok = M.greedy_next(logits, plan, mesh)
            pos = pos + 1
            toks.append(tok)
        ids = torch.stack(toks, 1)
        if plan.dp is not None:
            ids = mesh.all_gather(ids, plan.dp, dim=0)
        return ids, cache, _gather_logits(logits, mesh, plan)
    return run


def sharded_prefill_sp(cfg: ModelConfig, mesh: Mesh, plan: ShardingPlan):
    """Sequence-parallel full-window prefill: (local w, tokens (B,
    seq_len), local S-shard of the cache) -> (logits (B, seq_len, V) on
    every rank, cache). Each rank takes its chunk of the prompt
    (``model.prefill_sp``); the cache rows stay S-sharded over sp."""
    if plan.sp is None:
        raise ValueError("sharded_prefill_sp needs plan.sp")
    _no_stages(mesh, plan, "sharded_prefill_sp")

    def run(w, tokens, cache):
        tok = _take(tokens, (None, plan.sp), mesh).to(cache.k.device)
        logits, cache = M.prefill_sp(cfg, w, tok, cache, plan, mesh)
        return _gather_logits(logits, mesh, plan, batch_dim=None, seq_dim=1), cache
    return run
