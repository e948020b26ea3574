"""Mesh and sharding policy (data parallel over ranks, optional model axis
for the embedding table)."""

from dl4ss_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh, batch_sharding, replicated, shard_batch, shard_state,
    param_sharding)
