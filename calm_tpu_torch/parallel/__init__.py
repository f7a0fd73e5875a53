"""Parallelism on ``torch.distributed``: sharding plans, meshes, the
sharded step functions and the pipeline stages (the port of
``calm_tpu.parallel``).

``calm_tpu_torch.model`` imports ShardingPlan from here and ``sharding``
and ``pipeline`` import the model, so only plan and mesh load eagerly; the
other names load on first access.
"""

from calm_tpu_torch.parallel.mesh import (Mesh, Topology, detect_topology,  # noqa: F401
                                          health_check, host_layout, init_multihost,
                                          make_grid,
                                          make_mesh, make_multihost_mesh, rank_device,
                                          spawn)
from calm_tpu_torch.parallel.plan import NO_SHARDING, ShardingPlan  # noqa: F401

_LAZY = ("weight_pspecs", "cache_pspecs", "shard_weights", "shard_cache", "local_cache",
         "load_weights_sharded", "sharded_decode_step", "sharded_decode_scan",
         "sharded_prefill", "sharded_prefill_slot", "sharded_prefill_sp",
         "sharded_tree_verify")
_LAZY_PIPE = ("sharded_decode_step_pp", "sharded_decode_step_gpipe", "make_pp_mesh")


def __getattr__(name):
    if name in _LAZY:
        from calm_tpu_torch.parallel import sharding
        return getattr(sharding, name)
    if name in _LAZY_PIPE:
        from calm_tpu_torch.parallel import pipeline
        return getattr(pipeline, name)
    raise AttributeError(name)
