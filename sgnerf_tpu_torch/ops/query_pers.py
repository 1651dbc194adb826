"""Perspective-space neighbour query (Point-NeRF's original querier,
`--wcoord_query 0`).

Counterpart of `sgnerf_tpu/ops/query_pers.py` (reference
query_point_indices.py, `lighting_fast_querier`): the cloud is voxelised in
the camera's perspective space (x/z, y/z, z) each frame, by the world
grid's own build (ops/grid.py `build_point_grid`, no neighbourhood cache:
it would not amortise over one frame), and the samples are masked,
compacted and their K nearest neighbours found there (ops/query.py
`query_neighbors`, its bucket path), distances measured in perspective
coordinates. The frustum's spec is static per scene
(`perspective_spec_from_camera`), so each frame builds a grid of one
shape.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .camera import w2pers
from .grid import GridSpec, PointGrid, build_point_grid
from .query import QueryResult, query_neighbors


def _spec(mn, mx, vsize, vscale, kernel_size, max_o, P) -> GridSpec:
    vsize = np.asarray(vsize, np.float64)
    vscale = np.asarray(vscale, np.float64)
    scaled = vsize * vscale
    ks = np.asarray(kernel_size, np.float64)
    mn = mn - scaled * ks / 2
    mx = mx + scaled * ks / 2
    vdim = np.ceil((mx - mn) / vsize / vscale).astype(np.int64)
    return GridSpec(
        min_corner=tuple(float(v) for v in mn),
        vsize=tuple(float(v) for v in scaled),
        vdim=tuple(int(v) for v in vdim),
        max_o=int(max_o), P=int(P),
        kernel_size=tuple(int(k) for k in np.asarray(kernel_size)),
        nbr_cache=0)


def perspective_grid_spec(pers_xyz: np.ndarray, vsize, vscale, kernel_size,
                          max_o, P, depth_limit_scale: float = 1.3,
                          near: float = 2.0, far: float = 6.0) -> GridSpec:
    """Spec over the bounds of perspective coords (x, y in tan-angle units,
    z in depth bounded by [near, far]; reference get_hyperparameters)."""
    pers_xyz = np.asarray(pers_xyz, np.float64)
    mn, mx = pers_xyz.min(0), pers_xyz.max(0)
    mn[2] = max(mn[2], near)
    mx[2] = min(mx[2], far)
    return _spec(mn, mx, vsize, vscale, kernel_size, max_o, P)


def perspective_spec_from_camera(intrinsic: np.ndarray, W: int, H: int,
                                 near: float, far: float, vsize, vscale,
                                 kernel_size, max_o, P,
                                 pad_frac: float = 0.1) -> GridSpec:
    """The scene's static frustum spec: x, y bounded by the image extent
    (padded by pad_frac) in tan-angle units, z by [near, far]."""
    fx, fy = float(intrinsic[0, 0]), float(intrinsic[1, 1])
    cx, cy = float(intrinsic[0, 2]), float(intrinsic[1, 2])
    mn = np.array([-(cx / fx) * (1 + pad_frac), -(cy / fy) * (1 + pad_frac),
                   near], np.float64)
    mx = np.array([((W - cx) / fx) * (1 + pad_frac),
                   ((H - cy) / fy) * (1 + pad_frac), far], np.float64)
    return _spec(mn, mx, vsize, vscale, kernel_size, max_o, P)


def perspective_grid(points_xyz: torch.Tensor, point_mask: torch.Tensor,
                     camrotc2w: torch.Tensor, campos: torch.Tensor,
                     spec: GridSpec) -> Tuple[PointGrid, torch.Tensor]:
    """The frame's grid over the cloud in the perspective space of camera
    (camrotc2w (3,3), campos (3,)) -> (grid, perspective cloud (N,3))."""
    pers = w2pers(points_xyz, camrotc2w, campos)
    return build_point_grid(pers, point_mask, spec), pers


def query_perspective_grid(grid: PointGrid, raypos_w: torch.Tensor,
                           camrotc2w: torch.Tensor, campos: torch.Tensor,
                           K: int, SR: int,
                           radius_limit: float) -> QueryResult:
    """Query a frame's perspective grid (camera (camrotc2w (3,3), campos
    (3,)), perspective_grid) with world samples raypos_w (B,R,D,3): their
    sample_loc_w holds PERSPECTIVE shading coords."""
    raypos_p = w2pers(raypos_w.reshape(-1, 3), camrotc2w,
                      campos).reshape(raypos_w.shape)
    return query_neighbors(grid, raypos_p, K=K, SR=SR,
                           radius_limit=radius_limit)


def query_neighbors_perspective(points_xyz: torch.Tensor,
                                point_mask: torch.Tensor,
                                raypos_w: torch.Tensor,
                                camrotc2w: torch.Tensor, campos: torch.Tensor,
                                spec: GridSpec, K: int, SR: int,
                                radius_limit: float
                                ) -> Tuple[QueryResult, torch.Tensor]:
    """Build the frame's perspective grid of camera 0 (camrotc2w (B,3,3),
    campos (B,3)) and query it. Returns the QueryResult and the
    perspective cloud."""
    grid, pers = perspective_grid(points_xyz, point_mask, camrotc2w[0],
                                  campos[0], spec)
    return query_perspective_grid(grid, raypos_w, camrotc2w[0], campos[0],
                                  K, SR, radius_limit), pers
