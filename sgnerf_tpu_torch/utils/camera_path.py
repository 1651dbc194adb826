"""Camera-path interpolation for video rendering (the port's copy of
`sgnerf_tpu/utils/camera_path.py`, numpy only).

The reference's GUI moves its camera with mitsuba2's AnimatedTransform
(utils_mine/); here rotations are SLERPed and positions interpolated
linearly between consecutive key poses: a smooth novel camera path through
a sparse set of key poses, with no dependency.
"""
from __future__ import annotations

import numpy as np


def _quat_from_mat(R):
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([(R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
                         (R[1, 0] - R[0, 1]) / s, 0.25 * s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
    q = np.empty(4)
    q[i] = 0.25 * s
    q[j] = (R[j, i] + R[i, j]) / s
    q[k] = (R[k, i] + R[i, k]) / s
    q[3] = (R[k, j] - R[j, k]) / s
    return q


def _mat_from_quat(q):
    x, y, z, w = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


def _slerp(q0, q1, t):
    d = np.clip(np.dot(q0, q1), -1.0, 1.0)
    if d < 0:
        q1, d = -q1, -d
    if d > 0.9995:
        q = q0 + t * (q1 - q0)
        return q / np.linalg.norm(q)
    th = np.arccos(d)
    return (np.sin((1 - t) * th) * q0 + np.sin(t * th) * q1) / np.sin(th)


def interpolate_poses(key_poses: np.ndarray, n_out: int) -> np.ndarray:
    """key_poses: (M,4,4) c2w key frames -> (n_out,4,4) smooth path."""
    key_poses = np.asarray(key_poses, np.float64)
    M = len(key_poses)
    assert M >= 2
    quats = [_quat_from_mat(p[:3, :3]) for p in key_poses]
    ts = np.linspace(0, M - 1, n_out)
    out = []
    for t in ts:
        i = min(int(np.floor(t)), M - 2)
        f = t - i
        q = _slerp(quats[i], quats[i + 1], f)
        pos = (1 - f) * key_poses[i][:3, 3] + f * key_poses[i + 1][:3, 3]
        P = np.eye(4)
        P[:3, :3] = _mat_from_quat(q)
        P[:3, 3] = pos
        out.append(P)
    return np.stack(out).astype(np.float32)
