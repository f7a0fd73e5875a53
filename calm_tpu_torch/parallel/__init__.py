"""Parallelism on ``torch.distributed``: sharding plans, meshes and the
sharded step functions (the port of ``calm_tpu.parallel``, pipeline stages
not yet).

``calm_tpu_torch.model`` imports ShardingPlan from here and ``sharding``
imports the model, so only plan and mesh load eagerly; the sharding names
load on first access.
"""

from calm_tpu_torch.parallel.mesh import (Mesh, Topology, detect_topology,  # noqa: F401
                                          health_check, init_multihost, make_mesh,
                                          make_multihost_mesh, rank_device, spawn)
from calm_tpu_torch.parallel.plan import NO_SHARDING, ShardingPlan  # noqa: F401

_LAZY = ("weight_pspecs", "cache_pspecs", "shard_weights", "shard_cache",
         "load_weights_sharded", "sharded_decode_step", "sharded_prefill",
         "sharded_prefill_slot", "sharded_prefill_sp", "sharded_tree_verify")


def __getattr__(name):
    if name in _LAZY:
        from calm_tpu_torch.parallel import sharding
        return getattr(sharding, name)
    raise AttributeError(name)
