"""Neural point cloud: capacity-padded struct of tensors.

PyTorch counterpart of `sgnerf_tpu/models/point_cloud.py` (the eval slice:
construction, grid spec and grid build; grow/prune come with training).
Padding rows past the live points sit at 1e9 so they never enter the grid.
The reference cloud's semantic fields (feats, label, label_prob,
sem_embedding) come with the semantic slice (ROADMAP item 11) and its
per-part rotation index with editing (item 16); loading a reference
checkpoint ignores them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops.grid import GridSpec, PointGrid, build_point_grid, compute_grid_spec


@dataclasses.dataclass
class NeuralPointCloud:
    xyz: torch.Tensor            # (Nmax,3) f32
    embedding: torch.Tensor      # (Nmax,F) f32
    conf: torch.Tensor           # (Nmax,1) f32
    dir: torch.Tensor            # (Nmax,3) f32
    color: torch.Tensor          # (Nmax,3) f32
    Rw2c: torch.Tensor           # (3,3) world -> canonical rotation
    active: torch.Tensor         # (Nmax,) bool
    n_active: torch.Tensor       # () int32

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @classmethod
    def from_arrays(cls, arrays, device) -> "NeuralPointCloud":
        """Field dict of numpy arrays (a native checkpoint's "cloud") ->
        tensors on `device`."""
        return cls(**{f.name: torch.as_tensor(np.asarray(arrays[f.name]),
                                              device=device)
                      for f in dataclasses.fields(cls)})


def make_point_cloud(xyz: np.ndarray, embedding: np.ndarray,
                     conf: Optional[np.ndarray] = None,
                     dir: Optional[np.ndarray] = None,
                     color: Optional[np.ndarray] = None,
                     capacity: Optional[int] = None,
                     device="cpu") -> NeuralPointCloud:
    """Host-side constructor with capacity padding."""
    xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
    n = len(xyz)
    cap = int(capacity or n)
    if cap < n:
        raise ValueError(f"capacity {cap} < {n} points")

    def pad(a, width, fill=0.0):
        out = np.zeros((cap, width), np.float32)
        out[:n] = fill if a is None else np.asarray(a, np.float32).reshape(n, -1)
        return out

    pxyz = np.full((cap, 3), 1e9, np.float32)
    pxyz[:n] = xyz
    embedding = np.asarray(embedding, np.float32)
    active = np.zeros(cap, bool)
    active[:n] = True
    arrays = dict(
        xyz=pxyz, embedding=pad(embedding, embedding.shape[-1]),
        conf=pad(conf, 1, 1.0), dir=pad(dir, 3), color=pad(color, 3),
        Rw2c=np.eye(3, dtype=np.float32),
        active=active, n_active=np.asarray(n, np.int32))
    return NeuralPointCloud.from_arrays(arrays, device)


def build_grid(cloud: NeuralPointCloud, spec: GridSpec) -> PointGrid:
    return build_point_grid(cloud.xyz, cloud.active, spec)


def grid_spec_for_cloud(cloud: NeuralPointCloud, vsize, vscale, kernel_size,
                        max_o, P, ranges=None, **spec_kwargs) -> GridSpec:
    act = cloud.active.cpu().numpy()
    xyz = cloud.xyz.cpu().numpy()[act]
    return compute_grid_spec(xyz, vsize, vscale, kernel_size, max_o, P,
                             ranges=ranges, **spec_kwargs)
