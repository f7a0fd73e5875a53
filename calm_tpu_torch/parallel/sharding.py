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
- the KV cache: kv heads over tp, slots over dp, rows over sp (sp decode).

A spec is a tuple of mesh axis names (or None) per tensor dim, the
counterpart of a PartitionSpec; :func:`weight_pspecs` gives the natural
layouts' (the port holds no fused gf4 layout). Not in this module yet:
``sharded_decode_scan`` (it needs the on-device decode loop),
``sharded_tree_verify`` (speculative decoding) and the pipeline stages.
``fuse_weights_sharded`` has no counterpart: the port's kernels read the
container's natural gf4 words, so there is nothing to fuse per shard.
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
    with the layer axis; a QTensor's fp8e4 scale takes the leading dims of
    its data's spec and None for its trailing 1)."""
    tp, ep = plan.tp, plan.ep
    if cfg.n_experts:
        w13, w2 = (None, ep, tp, None), (None, ep, None, tp)
    else:
        w13, w2 = (None, tp, None), (None, None, tp)
    specs = {"embed": (tp, None), "output": (tp, None), "final_norm": (None,),
             "layers.attn_norm": (None, None), "layers.ffn_norm": (None, None),
             "layers.wq": (None, tp, None), "layers.wk": (None, tp, None),
             "layers.wv": (None, tp, None), "layers.wo": (None, None, tp),
             "layers.w1": w13, "layers.w3": w13, "layers.w2": w2,
             "layers.bq": (None, tp), "layers.bk": (None, tp), "layers.bv": (None, tp)}
    if cfg.norm_qk:
        specs.update({"layers.q_norm": (None, tp), "layers.k_norm": (None, tp)})
    if cfg.n_experts:
        specs["layers.moegate"] = (None, None, None)  # routing is replicated
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
    load."""
    _validate(cfg, mesh, plan)
    w = M.load_weights(_RankFile(tf, cfg, mesh, plan), cfg, mesh.device)
    specs = weight_pspecs(cfg, plan)
    for f in ("bq", "bk", "bv", "q_norm", "k_norm"):
        t = getattr(w.layers, f)
        if t is not None:
            setattr(w.layers, f, _take(t, specs["layers." + f], mesh).contiguous())
    return w


def cache_pspecs(plan: ShardingPlan, sp: bool = False) -> tuple:
    """The spec of the (L, B, KVH, S, hd) cache planes: slots over dp, kv
    heads over tp and, for sequence parallelism, rows over sp."""
    return (None, plan.dp, plan.tp, plan.sp if sp else None, None)


def shard_cache(cache: M.KVCache, mesh: Mesh, plan: ShardingPlan,
                sp: bool = False) -> M.KVCache:
    """This rank's block of a whole cache, on the mesh's device."""
    spec = cache_pspecs(plan, sp)
    return M.KVCache(_take(cache.k, spec, mesh).to(mesh.device).contiguous(),
                     _take(cache.v, spec, mesh).to(mesh.device).contiguous())


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
    collectives go through ``torch.distributed`` (a replayed sharded step
    is ROADMAP §1.4.3)."""
    if plan.sp is not None and plan.sp == plan.dp:
        raise ValueError("sp decode needs its own mesh axis")

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
    cache) -> (global logits per ``logits_mode``, cache)."""
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
    eagerly on the local weights, as the sharded step does."""
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
    (``calm_tpu/model.py:1525-1570``)."""
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


def sharded_prefill_sp(cfg: ModelConfig, mesh: Mesh, plan: ShardingPlan):
    """Sequence-parallel full-window prefill: (local w, tokens (B,
    seq_len), local S-shard of the cache) -> (logits (B, seq_len, V) on
    every rank, cache). Each rank takes its chunk of the prompt
    (``model.prefill_sp``); the cache rows stay S-sharded over sp."""
    if plan.sp is None:
        raise ValueError("sharded_prefill_sp needs plan.sp")

    def run(w, tokens, cache):
        tok = _take(tokens, (None, plan.sp), mesh).to(cache.k.device)
        logits, cache = M.prefill_sp(cfg, w, tok, cache, plan, mesh)
        return _gather_logits(logits, mesh, plan, batch_dim=None, seq_dim=1), cache
    return run
