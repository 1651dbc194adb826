"""Voxel downsampling and segment reductions (counterpart of
`sgnerf_tpu/ops/scatter.py`; reference `construct_vox_points_*`,
models/mvs/mvs_utils.py:483-562).

The voxel routines run on the host at point-cloud initialisation, in
numpy: the cube of the points (edge x1.05) cut into `vox_res` voxels along
its longest edge, the centroid of each occupied voxel, and per voxel the
input point closest to its centroid. They are copies of the JAX package's
numpy code, so both give the same bits. `segment_mean` and `segment_min`
are the tensor versions, on any device.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _vox_space(xyz: np.ndarray, vox_res: int, space_min=None,
               space_max=None):
    if space_min is None:
        mn, mx = xyz.min(0), xyz.max(0)
        edge = (mx - mn).max() * 1.05
        mid = (mx + mn) / 2
        space_min = mid - edge / 2
    else:
        edge = np.asarray(space_max) - np.asarray(space_min)
    return np.asarray(space_min, np.float64), edge / vox_res


def _unique_voxels(xyz: np.ndarray, vox_res: int, space_min=None,
                   space_max=None):
    smin, vsz = _vox_space(xyz, vox_res, space_min, space_max)
    coords = np.floor((xyz - smin) / vsz).astype(np.int64)
    grid, inv = np.unique(coords, axis=0, return_inverse=True)
    return grid, inv.reshape(-1), smin, vsz


def construct_vox_points_xyz(xyz, vox_res: int, space_min=None,
                             space_max=None) -> np.ndarray:
    """Voxel centroids (reference :504-518), float32."""
    xyz = np.asarray(xyz, np.float64)
    _, inv, _, _ = _unique_voxels(xyz, vox_res, space_min, space_max)
    order = np.argsort(inv, kind="stable")
    sinv = inv[order]
    starts = np.flatnonzero(np.r_[True, sinv[1:] != sinv[:-1]])
    sums = np.add.reduceat(xyz[order], starts, axis=0)
    counts = np.diff(np.r_[starts, len(sinv)])
    return (sums / counts[:, None]).astype(np.float32)


def voxel_downsample_xyz(xyz, vox_res: int) -> np.ndarray:
    """The voxel centroids of a depth unprojection (ScanNet load_points 2)."""
    return construct_vox_points_xyz(np.asarray(xyz), vox_res)


def construct_vox_points_closest(xyz, vox_res: int, space_min=None,
                                 space_max=None
                                 ) -> Tuple[np.ndarray, np.ndarray,
                                            np.ndarray]:
    """(centroids, sparse_grid_idx, min_idx): min_idx[i] is the index of
    the input point closest to centroid i (reference :538-562)."""
    xyz = np.asarray(xyz, np.float64)
    grid, inv, _, _ = _unique_voxels(xyz, vox_res, space_min, space_max)
    order = np.argsort(inv, kind="stable")
    sinv = inv[order]
    starts = np.flatnonzero(np.r_[True, sinv[1:] != sinv[:-1]])
    sums = np.add.reduceat(xyz[order], starts, axis=0)
    counts = np.diff(np.r_[starts, len(sinv)])
    centroids = sums / counts[:, None]
    resid = np.linalg.norm(xyz - centroids[inv], axis=-1)
    # per-voxel argmin: sort by (voxel, residual); first row of each segment
    order2 = np.lexsort((resid, inv))
    sinv2 = inv[order2]
    starts2 = np.flatnonzero(np.r_[True, sinv2[1:] != sinv2[:-1]])
    min_idx = order2[starts2]
    return centroids.astype(np.float32), grid, min_idx


def segment_mean(values: torch.Tensor, seg_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Mean of `values` rows per segment id; empty segments give 0."""
    s = values.new_zeros((num_segments,) + values.shape[1:])
    s.index_add_(0, seg_ids.long(), values)
    c = torch.zeros(num_segments, dtype=values.dtype, device=values.device)
    c.index_add_(0, seg_ids.long(), torch.ones_like(seg_ids,
                                                    dtype=values.dtype))
    c = torch.clamp(c, min=1.0)
    return s / c.reshape((-1,) + (1,) * (values.dim() - 1))


def segment_min(values: torch.Tensor, seg_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Minimum per segment id; empty segments hold +inf (floats) or the
    dtype's largest value, as jax.ops.segment_min leaves them."""
    big = (float("inf") if values.dtype.is_floating_point
           else torch.iinfo(values.dtype).max)
    out = values.new_full((num_segments,) + values.shape[1:], big)
    idx = seg_ids.long().reshape((-1,) + (1,) * (values.dim() - 1))
    return out.scatter_reduce(0, idx.expand_as(values), values, "amin")
