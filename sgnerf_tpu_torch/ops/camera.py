"""Camera math: world <-> perspective coords and per-pixel ray directions.

PyTorch counterpart of `sgnerf_tpu/ops/camera.py` (reference
neural_points.py:838-850 and data_utils.py:55-69).
"""
from __future__ import annotations

import torch


def w2pers(point_xyz_w: torch.Tensor, camrotc2w: torch.Tensor,
           campos: torch.Tensor) -> torch.Tensor:
    """(..., 3) world points -> (..., 3) [x/z, y/z, z] in the camera frame of
    camrotc2w (3,3) and campos (3,)."""
    xyz_c = (point_xyz_w - campos) @ camrotc2w        # == R^T shift per point
    z = xyz_c[..., 2]
    # masked inputs can sit exactly at the camera (z == 0): guard the divide
    zs = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    return torch.stack([xyz_c[..., 0] / zs, xyz_c[..., 1] / zs, z], dim=-1)


def pers2w(point_xyz_pers: torch.Tensor, camrotc2w: torch.Tensor,
           campos: torch.Tensor) -> torch.Tensor:
    """Inverse of `w2pers`: (..., 3) [x/z, y/z, z] -> world points."""
    z = point_xyz_pers[..., 2]
    xyz_c = torch.stack([point_xyz_pers[..., 0] * z,
                         point_xyz_pers[..., 1] * z, z], dim=-1)
    return xyz_c @ camrotc2w.T + campos


def get_dtu_raydir(pixelcoords: torch.Tensor, intrinsic: torch.Tensor,
                   rot: torch.Tensor, dir_norm: bool = True) -> torch.Tensor:
    """(..., 2) pixel (x, y) -> (..., 3) world ray directions for a
    (3,3) intrinsic and camera-to-world rotation."""
    x = (pixelcoords[..., 0] + 0.5 - intrinsic[0, 2]) / intrinsic[0, 0]
    y = (pixelcoords[..., 1] + 0.5 - intrinsic[1, 2]) / intrinsic[1, 1]
    dirs = torch.stack([x, y, torch.ones_like(x)], dim=-1) @ rot.T
    if dir_norm:
        dirs = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-5)
    return dirs


def get_blender_raydir(pixelcoords: torch.Tensor, height: float,
                       width: float, focal: float, rot: torch.Tensor,
                       dir_norm: bool = True) -> torch.Tensor:
    """Blender/NeRF-synthetic per-pixel ray directions (the camera looks
    down -z with y up; reference data_utils.py:40-52), for the raw
    spherical render poses."""
    x = (pixelcoords[..., 0] + 0.5 - width / 2.0) / focal
    y = (pixelcoords[..., 1] + 0.5 - height / 2.0) / focal
    dirs = torch.stack([x, -y, -torch.ones_like(x)], dim=-1)
    dirs = (dirs[..., None, :] * rot).sum(-1)
    if dir_norm:
        dirs = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-5)
    return dirs
