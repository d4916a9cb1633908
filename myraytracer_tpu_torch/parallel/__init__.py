from myraytracer_tpu_torch.parallel.sharding import (
    default_mesh,
    make_hybrid_sharded_renderer,
    make_sample_sharded_renderer,
    make_tile_sharded_renderer,
    shard_renderer_factory,
)

__all__ = [
    "default_mesh",
    "make_hybrid_sharded_renderer",
    "make_sample_sharded_renderer",
    "make_tile_sharded_renderer",
    "shard_renderer_factory",
]
