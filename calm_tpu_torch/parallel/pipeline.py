"""Pipeline parallelism: the layer stack split into stages over a mesh
axis (the port of ``calm_tpu.parallel.pipeline``).

A model whose layers do not fit one device splits them over the pp axis:
each stage holds, and reads a token, only its layer shard of the weights
and the matching layers of the KV cache (``sharding.weight_pspecs`` and
``cache_pspecs`` shard the layer axis over ``plan.pp``); the embedding,
final norm and lm-head stay on every stage. Each rank runs the same
program, as the JAX package's ``shard_map`` body:

- :func:`sharded_decode_step_pp` (``calm_tpu/parallel/pipeline.py:33-86``):
  every stage embeds the token; on superstep s only stage s runs its
  layers (a plain ``if`` on the rank's stage, where JAX takes a ``cond``),
  then the wave moves one stage on (``Mesh.ppermute``). After pp
  supersteps the finished wave is back on stage 0, whose logits a psum
  over pp hands to every stage. A stage's layers are the model's own step
  (``model._run_layers``) on its shard, layer indices local to it: on the
  card the rotated K9/K8 chain (tp = 1), K12 and the K2 lm-head. Latency
  is the sum of the stages': pp buys capacity, not speed, for one stream.
- :func:`sharded_decode_step_gpipe` (``:89-171``): the B slots split into
  n_micro microbatches; on superstep t stage s works microbatch t - s, so
  once the pipeline fills every stage streams its layers at once, the
  pp - 1 supersteps of ramp the only bubble. A stage addresses its
  microbatch's slice of the full-B cache through ``batch_off`` (K12 reads
  from a slot offset). The last stage's logits are the result.

Both run eagerly: their sends and psums go through ``torch.distributed``.
"""

from __future__ import annotations

import dataclasses

import torch

from calm_tpu_torch import model as M
from calm_tpu_torch.config import ModelConfig
from calm_tpu_torch.parallel.mesh import Mesh, make_grid
from calm_tpu_torch.parallel.plan import ShardingPlan
from calm_tpu_torch.parallel.sharding import _dp_slice, _gather_logits, _validate


def _stages(cfg: ModelConfig, mesh: Mesh, plan: ShardingPlan):
    """(pp, this rank's stage, the config of a stage's layer shard, the
    ring that moves a wave one stage on), the plan checked."""
    if plan.pp is None:
        raise ValueError("a pipeline step needs plan.pp")
    if plan.sp is not None:
        raise ValueError("the pipeline steps take no sp axis")
    _validate(cfg, mesh, plan)
    pp = mesh.axis_size(plan.pp)
    local = dataclasses.replace(cfg, n_layers=cfg.n_layers // pp)
    return pp, mesh.axis_index(plan.pp), local, [(i, (i + 1) % pp) for i in range(pp)]


def sharded_decode_step_pp(cfg: ModelConfig, mesh: Mesh, plan: ShardingPlan):
    """The pipeline-parallel decode step: (this stage's local w, token (B,),
    pos (an int, or B host ints), its local cache) -> (logits (B, V) on
    every rank, cache), with the sink rotation (``rolling``) as JAX's.
    Under dp each rank steps its slots, as ``sharding.sharded_decode_step``."""
    pp, stage, local, ring = _stages(cfg, mesh, plan)

    @torch.no_grad()
    def step(w, token, pos, cache):
        dev = cache.k.device
        tok = _dp_slice(torch.as_tensor(token).reshape(-1), mesh, plan)
        p = pos if isinstance(pos, int) else [int(v) for v in _dp_slice(
            torch.as_tensor(pos).reshape(-1), mesh, plan)]
        token_t, pos_t = M._on_device(tok.to(dev), p, dev)
        st = M._step_state(cfg, pos_t, True, None, plan, mesh)
        x = M._embed(w.embed, token_t, plan, mesh)
        for s in range(pp):
            if stage == s:
                x = M._run_layers(local, w, x, cache, st)
            x = mesh.ppermute(x, plan.pp, ring)
        # the finished wave is back on stage 0
        if stage == 0:
            logits = M._head(cfg, w, x)
        else:
            logits = torch.zeros((x.shape[0], w.output.data.shape[0]), device=dev)
        return _gather_logits(mesh.psum(logits, plan.pp), mesh, plan), cache
    return step


def sharded_decode_step_gpipe(cfg: ModelConfig, mesh: Mesh, plan: ShardingPlan,
                              n_micro: int):
    """The GPipe decode step: (this stage's local w, token (B,), pos (an
    int, or B host ints), its local cache of all B slots) -> (logits (B, V)
    on every rank, cache), the B slots pipelined as ``n_micro``
    microbatches; B % n_micro == 0. The slots are not split over dp."""
    pp, stage, local, ring = _stages(cfg, mesh, plan)
    if plan.dp is not None:
        raise ValueError("the GPipe step pipelines all B slots: no dp axis")

    @torch.no_grad()
    def step(w, token, pos, cache):
        dev = cache.k.device
        token_t, pos_t = M._on_device(torch.as_tensor(token).reshape(-1).to(dev), pos, dev)
        B = token_t.shape[0]
        if n_micro < 1 or B % n_micro:
            raise ValueError(f"{B} slots do not split into {n_micro} microbatches")
        Bm = B // n_micro
        x_full = M._embed(w.embed, token_t, plan, mesh)              # (B, D)
        out = torch.zeros((B, w.output.data.shape[0]), device=dev)
        x_buf = torch.zeros((Bm, cfg.dim), device=dev)
        for t in range(n_micro + pp - 1):
            m = t - stage  # this stage's microbatch
            x = x_full[t * Bm:(t + 1) * Bm] if stage == 0 and t < n_micro else x_buf
            if 0 <= m < n_micro:
                b0 = m * Bm
                st = M._step_state(cfg, pos_t[b0:b0 + Bm], True, None, plan, mesh,
                                   batch_off=b0)
                x = M._run_layers(local, w, x, cache, st)
                if stage == pp - 1:
                    out[b0:b0 + Bm] = M._head(cfg, w, x)
            x_buf = mesh.ppermute(x, plan.pp, ring)
        # only the last stage holds the logits
        if stage != pp - 1:
            out.zero_()
        return _gather_logits(mesh.psum(out, plan.pp), mesh, plan), cache
    return step


def make_pp_mesh(pp: int, tp: int = 1, device=None) -> Mesh | None:
    """The first pp * tp ranks on a (pp, tp) grid (``calm_tpu/parallel/
    pipeline.py:176-183``), by ``mesh.make_grid``: every rank of the world
    calls it; ``device`` as ``make_mesh``'s."""
    return make_grid(dict(pp=pp, tp=tp), device)
