"""Multi-device execution (counterpart of `sgnerf_tpu/parallel/`): ray
data parallelism (--ray_shards, sharded.py) and slab-sharded scenes
(--scene_shards, spatial.py) over an explicit device list (mesh.py)."""
from .mesh import ShardGroup
from .sharded import render_rays_sharded, shard_batch
from .spatial import (ShardedScene, SpatialSpec, SpatialTrainState,
                      build_sharded_scene, create_spatial_train_state,
                      perspective_halo_voxels, plan_sharded_scene,
                      render_rays_spatial, render_rays_spatial_perspective,
                      spatial_train_step, spatial_train_step_multi)
