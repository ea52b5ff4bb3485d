"""Data parallelism over torch.distributed (counterpart of caspr_tpu/parallel)."""

from .mesh import (DCN_AXIS, DP_AXIS, SP_AXIS, batch_group, collectives, global_batch_points,
                   init_distributed, make_mesh, replicate, reset_collectives, shard_batch,
                   shard_batch_points)

__all__ = ["DCN_AXIS", "DP_AXIS", "SP_AXIS", "batch_group", "collectives", "global_batch_points",
           "init_distributed", "make_mesh", "replicate", "reset_collectives", "shard_batch",
           "shard_batch_points"]
