"""Data and point parallelism over torch.distributed (counterpart of caspr_tpu/parallel)."""

from .mesh import (DCN_AXIS, DP_AXIS, SP_AXIS, Groups, Mesh, batch_group, collectives,
                   global_batch_points, init_distributed, make_mesh, mesh_groups, point_group,
                   replicate, reset_collectives, shard_batch, shard_batch_points, shard_points)

__all__ = ["DCN_AXIS", "DP_AXIS", "SP_AXIS", "Groups", "Mesh", "batch_group", "collectives",
           "global_batch_points", "init_distributed", "make_mesh", "mesh_groups", "point_group",
           "replicate", "reset_collectives", "shard_batch", "shard_batch_points", "shard_points"]
