"""Point-cloud editing: crop, add, rigid transforms and the matching of a
meshlab selection (the port's copy of `sgnerf_tpu/editor/editor.py`;
reference Editor/pointcloud_editor.py:21-93 and Editor/test.py's KD-tree
selection). The reference's O(N*M) Python loops are scipy KD-tree queries
here, on every CPU core (the same neighbours as one core finds).
"""
from __future__ import annotations

import numpy as np

from .pointcloud import NeuralPointCloudEdit


def match_selection(cloud: NeuralPointCloudEdit, selected_xyz: np.ndarray,
                    tol: float = 1e-4) -> np.ndarray:
    """A meshlab-exported selection (bare xyz) -> the sorted neural-point
    rows within `tol` of a selected point (reference Editor/test.py:45-80,
    an open3d KD-tree)."""
    from scipy.spatial import cKDTree
    d, idx = cKDTree(cloud.xyz).query(selected_xyz, k=1, workers=-1)
    return np.unique(idx[d <= tol])


def crop_point_cloud(child: NeuralPointCloudEdit,
                     father: NeuralPointCloudEdit,
                     tol: float = 1e-7) -> NeuralPointCloudEdit:
    """`father` without `child`'s points (positions equal within `tol`,
    reference :21-59)."""
    from scipy.spatial import cKDTree
    d, _ = cKDTree(child.xyz).query(father.xyz, k=1, workers=-1)
    return father.select(d > tol)


def add_point_cloud(child: NeuralPointCloudEdit,
                    father: NeuralPointCloudEdit) -> NeuralPointCloudEdit:
    """`child`'s points first, then `father`'s; `father`'s weights."""
    return NeuralPointCloudEdit(
        xyz=np.concatenate([child.xyz, father.xyz]),
        embedding=np.concatenate([child.embedding, father.embedding]),
        conf=np.concatenate([child.conf, father.conf]),
        dir=np.concatenate([child.dir, father.dir]),
        color=np.concatenate([child.color, father.color]),
        label=np.concatenate([child.label, father.label]),
        params=father.params)


def transform_point_cloud_global(cloud: NeuralPointCloudEdit,
                                 T: np.ndarray) -> NeuralPointCloudEdit:
    """xyz @ R + t in the world frame (reference :59-68), with R = T[:3,:3]
    right-multiplied (not R^T), as the reference's transform files expect.
    The stored point dirs rotate WITH the part, a deliberate deviation from
    reference :67, which leaves them canonical: the aggregator rotates
    sampled dirs by Rw2c (point_aggregators.py:648), so they must be in the
    moved world frame for that rotation to restore the canonical one (the
    reference combination rotates twice, unnoticed because its shipped
    configs set shading_feature_mlp_layer3=0)."""
    R, t = T[:3, :3], T[:3, 3]
    out = cloud.select(np.ones(cloud.n, bool))
    out.xyz = cloud.xyz @ R + t
    out.dir = cloud.dir @ R
    return out


def transform_point_cloud_local(cloud: NeuralPointCloudEdit,
                                T: np.ndarray) -> NeuralPointCloudEdit:
    """The same about the cloud's centroid (reference :70-81); dirs rotate
    with the part."""
    R, t = T[:3, :3], T[:3, 3]
    center = cloud.xyz.mean(0)
    out = cloud.select(np.ones(cloud.n, bool))
    out.xyz = (cloud.xyz - center) @ R + t + center
    out.dir = cloud.dir @ R
    return out
