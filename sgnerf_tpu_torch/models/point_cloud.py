"""Neural point cloud: capacity-padded struct of tensors.

PyTorch counterpart of `sgnerf_tpu/models/point_cloud.py`: construction,
grid spec and build, `prune` and `grow`. Every field of the JAX cloud is carried
(so either package loads the other's native checkpoints); the semantic
fields (feats, label, label_prob, sem_embedding) and the per-part rotation
index ride along unused until the semantic slice (ROADMAP item 11) and
editing (item 16). Padding rows past the live points sit at 1e9 so they
never enter the grid.
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
    feats: torch.Tensor          # (Nmax,3) f32 raw RGB (BPNet input)
    label: torch.Tensor          # (Nmax,) int32
    label_prob: torch.Tensor     # (Nmax,C) f32
    sem_embedding: torch.Tensor  # (Nmax,S) f32
    Rw2c: torch.Tensor           # (3,3) uniform, or (T,3,3) per-part table
    rot_idx: torch.Tensor        # (Nmax,) int32 row into Rw2c when (T,3,3)
    active: torch.Tensor         # (Nmax,) bool
    n_active: torch.Tensor       # () int32

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @classmethod
    def from_arrays(cls, arrays, device) -> "NeuralPointCloud":
        """Field dict of numpy arrays (a native checkpoint's "cloud") ->
        tensors on `device`. Fields a checkpoint lacks get make_point_cloud's
        defaults."""
        cap = len(arrays["xyz"])
        defaults = dict(
            feats=np.zeros((cap, 3), np.float32),
            label=np.zeros(cap, np.int32),
            label_prob=np.zeros((cap, 20), np.float32),
            sem_embedding=np.zeros((cap, 96), np.float32),
            rot_idx=np.zeros(cap, np.int32))
        # torch.tensor copies: training updates the tensors in place
        return cls(**{f.name: torch.tensor(
            np.asarray(arrays[f.name] if f.name in arrays
                       else defaults[f.name]), device=device)
            for f in dataclasses.fields(cls)})

    def to_arrays(self):
        """Field dict of numpy arrays (the native checkpoint's "cloud")."""
        return {f.name: getattr(self, f.name).detach().cpu().numpy()
                for f in dataclasses.fields(self)}


def make_point_cloud(xyz: np.ndarray, embedding: np.ndarray,
                     conf: Optional[np.ndarray] = None,
                     dir: Optional[np.ndarray] = None,
                     color: Optional[np.ndarray] = None,
                     feats: Optional[np.ndarray] = None,
                     label: Optional[np.ndarray] = None,
                     label_prob: Optional[np.ndarray] = None,
                     sem_embedding: Optional[np.ndarray] = None,
                     Rw2c: Optional[np.ndarray] = None,
                     rot_idx: Optional[np.ndarray] = None,
                     capacity: Optional[int] = None,
                     num_classes: int = 20, sem_dim: int = 96,
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

    def pad_int(a):
        out = np.zeros(cap, np.int32)
        if a is not None:
            out[:n] = np.asarray(a).reshape(-1).astype(np.int32)
        return out

    pxyz = np.full((cap, 3), 1e9, np.float32)
    pxyz[:n] = xyz
    embedding = np.asarray(embedding, np.float32)
    active = np.zeros(cap, bool)
    active[:n] = True
    arrays = dict(
        xyz=pxyz, embedding=pad(embedding, embedding.shape[-1]),
        conf=pad(conf, 1, 1.0), dir=pad(dir, 3), color=pad(color, 3),
        feats=pad(feats, 3), label=pad_int(label),
        label_prob=pad(label_prob, num_classes),
        sem_embedding=pad(sem_embedding, sem_dim),
        Rw2c=(np.asarray(Rw2c, np.float32) if Rw2c is not None
              else np.eye(3, dtype=np.float32)),
        rot_idx=pad_int(rot_idx),
        active=active, n_active=np.asarray(n, np.int32))
    return NeuralPointCloud.from_arrays(arrays, device)


@torch.no_grad()
def prune(cloud: NeuralPointCloud, thresh: float) -> NeuralPointCloud:
    """Deactivate points with conf below thresh (reference `prune`,
    neural_points.py:520-543). Shape-stable: only `active`, `n_active` and
    the pruned rows' xyz (sent to 1e9) change."""
    keep = cloud.active & (cloud.conf[:, 0] >= thresh)
    return dataclasses.replace(
        cloud,
        xyz=torch.where(keep[:, None], cloud.xyz,
                        torch.full_like(cloud.xyz, 1e9)),
        active=keep,
        n_active=keep.sum().to(torch.int32))


# per-point fields that grow does not write: reset to their padding
_UNGROWN_FIELDS = ("feats", "label", "label_prob", "sem_embedding", "rot_idx")


@torch.no_grad()
def grow(cloud: NeuralPointCloud, new_xyz, new_embedding, new_conf,
         new_color, new_dir) -> NeuralPointCloud:
    """Append G new points (host arrays) into free slots, in place on the
    device (reference `grow_points`, neural_points.py:546-572): the lowest
    inactive slots, which are n_active .. n_active+G-1 when the live points
    fill the front of the cloud, as the JAX `grow` writes them. After a
    prune the holes come first: the JAX `grow` writes at n_active whatever
    lives there (ROADMAP.md section 3, F7). The slots' other per-point
    fields go back to make_point_cloud's padding (zeros), so a pruned
    point's labels and features do not pass to the new one. Rows past the
    capacity are dropped, never written onto a live slot;
    SceneModel.grow_points re-allocates before that can happen."""
    g = int(np.asarray(new_xyz).shape[0])
    if g == 0:
        return cloud
    free = torch.nonzero(~cloud.active).reshape(-1)[:g]
    k = int(free.shape[0])
    for name, src in (("xyz", new_xyz), ("embedding", new_embedding),
                      ("conf", new_conf), ("color", new_color),
                      ("dir", new_dir)):
        dst = getattr(cloud, name)
        rows = np.asarray(src, np.float32).reshape(g, -1)
        if rows.shape[1] != dst.shape[1]:
            raise ValueError(f"grow: {name} rows have width {rows.shape[1]}, "
                             f"the cloud's {dst.shape[1]}")
        dst[free] = torch.as_tensor(rows[:k], device=dst.device)
    for name in _UNGROWN_FIELDS:
        getattr(cloud, name)[free] = 0
    cloud.active[free] = True
    cloud.n_active.add_(k)
    return cloud


def build_grid(cloud: NeuralPointCloud, spec: GridSpec) -> PointGrid:
    return build_point_grid(cloud.xyz, cloud.active, spec)


def grid_spec_for_cloud(cloud: NeuralPointCloud, vsize, vscale, kernel_size,
                        max_o, P, ranges=None, **spec_kwargs) -> GridSpec:
    act = cloud.active.cpu().numpy()
    xyz = cloud.xyz.cpu().numpy()[act]
    return compute_grid_spec(xyz, vsize, vscale, kernel_size, max_o, P,
                             ranges=ranges, **spec_kwargs)
