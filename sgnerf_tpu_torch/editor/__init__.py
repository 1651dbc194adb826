"""Neural point-cloud editing: the container with its ply and checkpoint
round trips, and crop / add / rigid transforms (the counterpart of
`sgnerf_tpu/editor/`)."""
from .pointcloud import NeuralPointCloudEdit  # noqa: F401
from .editor import (add_point_cloud, crop_point_cloud,  # noqa: F401
                     match_selection, transform_point_cloud_global,
                     transform_point_cloud_local)
