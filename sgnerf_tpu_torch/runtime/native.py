"""Host-side bootstrap helpers in numpy (counterpart of
`sgnerf_tpu/runtime/native.py`, whose C++ library is
native/sgnerf_native.cpp).

`vox_downsample_closest` returns the same indices as the C++ routine: the
bounding cube of the points (edge x1.05), voxel keys by floor((x - min) /
size) in float64, per-voxel centroids from float64 sums taken in index
order, and per voxel the point closest to its centroid (squared distance,
the lowest index on ties), sorted. `nearest_view` assigns each point the
camera that sees it most head-on (reference run/train_ft.py nearest_view).
"""
from __future__ import annotations

import numpy as np


def vox_downsample_closest(xyz: np.ndarray, vox_res: int) -> np.ndarray:
    """Indices of the kept (closest-to-centroid) points, ascending."""
    x = np.asarray(xyz, np.float32).astype(np.float64).reshape(-1, 3)
    if len(x) == 0:
        return np.zeros(0, np.int64)
    mn, mx = x.min(axis=0), x.max(axis=0)
    edge = float(np.max(mx - mn)) * 1.05
    smin = (mx + mn) / 2 - edge / 2
    vsz = edge / float(vox_res)
    k = np.floor((x - smin) / vsz).astype(np.int64)
    key = (k[:, 0] << 42) | (k[:, 1] << 21) | k[:, 2]
    uniq, inv = np.unique(key, return_inverse=True)
    cnt = np.bincount(inv, minlength=len(uniq)).astype(np.float64)
    # bincount adds the weights in index order, as the C++ loop does
    cen = np.stack([np.bincount(inv, weights=x[:, d], minlength=len(uniq))
                    / cnt for d in range(3)], axis=-1)
    diff = x - cen[inv]
    d2 = diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1] \
        + diff[:, 2] * diff[:, 2]
    order = np.lexsort((d2, inv))          # stable: lowest index on ties
    first = np.r_[True, inv[order][1:] != inv[order][:-1]]
    return np.sort(order[first])


def nearest_view(campos: np.ndarray, camdir: np.ndarray,
                 xyz: np.ndarray) -> np.ndarray:
    """Per point, the index of the camera maximising cos / sqrt(dist)."""
    out = np.zeros(len(xyz), np.int64)
    chunk = 200_000
    for s in range(0, len(xyz), chunk):
        pts = xyz[s:s + chunk]
        diff = pts[:, None, :] - campos[None, :, :]          # (n, V, 3)
        dist = np.linalg.norm(diff, axis=-1) + 1e-6
        cos = np.sum(diff / dist[..., None] * camdir[None], axis=-1)
        score = cos / np.sqrt(dist)
        out[s:s + chunk] = np.argmax(score, axis=-1)
    return out
