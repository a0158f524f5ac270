"""Multi-device rendering over a (view, tile) grid of torch.distributed
ranks (counterpart of ``godotgaussiansplatting_tpu/parallel``)."""

from .sharded import (CloudShard, Mesh, exchange_shape, make_mesh,
                      render_frame_fast_sharded, render_frame_sharded,
                      shard_cloud, stack_uniforms)

__all__ = ["CloudShard", "Mesh", "exchange_shape", "make_mesh",
           "render_frame_fast_sharded", "render_frame_sharded", "shard_cloud",
           "stack_uniforms"]
