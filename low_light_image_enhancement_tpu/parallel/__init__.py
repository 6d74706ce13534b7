"""Multi-device execution: mesh construction, batch sharding, spatial
sharding with halo exchange (BASELINE.json config 5)."""

from low_light_image_enhancement_tpu.parallel.sharding import (
    make_mesh,
    shard_batch_fn,
    enhance_spatial_sharded,
)
from low_light_image_enhancement_tpu.parallel.halo import halo_pad_local
from low_light_image_enhancement_tpu.parallel.video_sharded import (
    SpatialShardedVideoEnhancer,
)

__all__ = [
    "make_mesh",
    "shard_batch_fn",
    "enhance_spatial_sharded",
    "halo_pad_local",
    "SpatialShardedVideoEnhancer",
]
