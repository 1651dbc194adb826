"""NeRF-synthetic (blender) scene loader.

Counterpart of `sgnerf_tpu/data/load_blender.py` (reference
data/load_blender.py): transforms_{split}.json frames, poses right-multiplied
by blender2opencv, the spherical render path (`render_poses`, 20 poses on
a circle at elevation -30 deg and radius 4, which run/render_vid.py
renders) and the pickled point cloud (`load_blender_cloud`). Images are
read with PIL.
"""
from __future__ import annotations

import json
import os
import pickle
import random

import numpy as np


def trans_t(t):
    m = np.eye(4, dtype=np.float32)
    m[2, 3] = t
    return m


def rot_phi(phi):
    m = np.eye(4, dtype=np.float32)
    m[1, 1] = m[2, 2] = np.cos(phi)
    m[1, 2] = -np.sin(phi)
    m[2, 1] = np.sin(phi)
    return m


def rot_theta(th):
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = m[2, 2] = np.cos(th)
    m[0, 2] = -np.sin(th)
    m[2, 0] = np.sin(th)
    return m


def pose_spherical(theta, phi, radius):
    """The blender c2w at azimuth theta and elevation phi (degrees), at
    `radius` from the origin."""
    c2w = trans_t(radius)
    c2w = rot_phi(phi / 180.0 * np.pi) @ c2w
    c2w = rot_theta(theta / 180.0 * np.pi) @ c2w
    c2w = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
                   dtype=np.float32) @ c2w
    return c2w


def render_poses(stride: int = 20) -> np.ndarray:
    """The spin path: `stride` poses over a full turn, (stride,4,4)."""
    return np.stack([pose_spherical(a, -30.0, 4.0)
                     for a in np.linspace(-180, 180, stride + 1)[:-1]], 0)


blender2opencv = np.array([[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0],
                           [0, 0, 0, 1]], dtype=np.float32)


def load_blender_data(basedir, splits=None, testskip=1):
    """-> (RGBA images (N,H,W,4) in [0,1], poses (N,4,4), [H, W, focal],
    per-split index arrays, intrinsic (3,3))."""
    from PIL import Image
    splits = ["train", "val", "test"] if splits is None else splits
    metas = {}
    for s in splits:
        with open(os.path.join(basedir, f"transforms_{s}.json")) as fp:
            metas[s] = json.load(fp)

    all_imgs, all_poses, counts = [], [], [0]
    for s in splits:
        meta = metas[s]
        skip = 1 if (s == "train" or testskip == 0) else testskip
        imgs, poses = [], []
        for frame in meta["frames"][::skip]:
            fname = os.path.join(basedir, frame["file_path"] + ".png")
            with Image.open(fname) as im:
                imgs.append(np.asarray(im))
            poses.append(np.array(frame["transform_matrix"]) @ blender2opencv)
        imgs = (np.array(imgs) / 255.0).astype(np.float32)   # RGBA kept
        poses = np.array(poses).astype(np.float32)
        counts.append(counts[-1] + imgs.shape[0])
        all_imgs.append(imgs)
        all_poses.append(poses)

    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(len(splits))]
    imgs = np.concatenate(all_imgs, 0)
    poses = np.concatenate(all_poses, 0)

    H, W = imgs[0].shape[:2]
    camera_angle_x = float(meta["camera_angle_x"])
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)

    intrinsic = np.asarray([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]])
    return imgs, poses, [H, W, focal], i_split, intrinsic


def load_blender_cloud(point_path, point_num):
    """The pickled {"point_xyz", ["point_face_normal"]} cloud; more points
    than point_num are subsampled with Python's `random.choices`, as the
    reference does."""
    point_norms = None
    with open(point_path, "rb") as f:
        all_infos = pickle.load(f)
        point_xyz = all_infos["point_xyz"]
        if "point_face_normal" in all_infos:
            point_norms = all_infos["point_face_normal"]
    if point_num < len(point_xyz):
        inds = np.asarray(random.choices(range(len(point_xyz)), k=point_num))
        point_norms = point_norms[inds, :] if point_norms is not None else None
        return point_xyz[inds, :], point_norms
    return point_xyz, point_norms
