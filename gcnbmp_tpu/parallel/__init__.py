"""Parallel layer: device meshes, sharded train steps, collectives.

The reference's entire distribution story is a 2-GPU ParallelUpdater
(SURVEY §2.9); everything here is new design: jax.sharding meshes with data-parallel batch sharding + tensor-sharded wide layers,
and (see ``edgeshard``) edge-partitioned graph sharding for multi-host
scaling.
"""

from gcnbmp_tpu.parallel.mesh import make_mesh, batch_sharding, replicated
from gcnbmp_tpu.parallel.dp import make_sharded_train_step, shard_params

__all__ = [
    "make_mesh",
    "batch_sharding",
    "replicated",
    "make_sharded_train_step",
    "shard_params",
]
