"""Synthetic scenes for smoke runs and benchmarks.

`room_scan` is the port's copy of bench.py's `_room_scan` (the same
numbers from the same generator state), so runs on the card use the scene
the JAX package's benchmark renders without importing bench.py.
"""
from __future__ import annotations

import numpy as np


def room_scan(rng: np.random.Generator, n_points: int) -> np.ndarray:
    """ScanNet-like synthetic scan: points on the surfaces of a 5x5x3 m room
    shell plus rotated furniture boxes, with 5 mm sensor noise (real scans
    put 2-3 voxel-layers of points on every surface at the canonical 16 mm
    scaled voxel). Returns (n_points, 3) float32."""
    def box_surface(rn, n, center, size, yaw=0.0):
        # sample the 6 faces with area weights
        sx, sy, sz = size
        areas = np.array([sy * sz, sy * sz, sx * sz, sx * sz, sx * sy,
                          sx * sy])
        face = rn.choice(6, size=n, p=areas / areas.sum())
        u = rn.uniform(-0.5, 0.5, size=(n, 3))
        p = u * np.asarray(size)
        axis = face // 2
        sign = np.where(face % 2 == 0, 0.5, -0.5)
        p[np.arange(n), axis] = sign * np.asarray(size)[axis]
        if yaw:
            c, s = np.cos(yaw), np.sin(yaw)
            p = p @ np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]).T
        return p + np.asarray(center)

    n_room = n_points // 2
    pts = [box_surface(rng, n_room, (0.0, 0.0, 0.0), (5.0, 5.0, 3.0))]
    # 12 furniture boxes on the floor, random footprint + yaw
    n_f = n_points - n_room
    per = np.full(12, n_f // 12)
    per[:n_f - per.sum()] += 1
    for i in range(12):
        size = rng.uniform([0.3, 0.3, 0.3], [1.6, 1.6, 1.2])
        center = np.array([rng.uniform(-2.0, 2.0), rng.uniform(-2.0, 2.0),
                           -1.5 + size[2] / 2])
        pts.append(box_surface(rng, per[i], center, size,
                               yaw=rng.uniform(0, np.pi)))
    xyz = np.concatenate(pts).astype(np.float32)
    xyz += rng.normal(scale=0.005, size=xyz.shape).astype(np.float32)
    return xyz
