"""The benchmark's inputs: the room scan (the configuration's), and from the
run's seed its per-point attributes and semantics and the cameras.

`room_scan` is a frozen copy of `sgnerf_tpu_torch/data/synthetic.py`'s
`room_scan` (itself a copy of the JAX package's benchmark scene: a 5x5x3 m
room shell plus 12 rotated furniture boxes on the floor, 5 mm sensor
noise), rewritten to draw its points on the device from a torch.Generator
in a few large calls. It also returns each point's surface, which the
semantic configuration turns into one class a surface, as `chip_smoke.py`
`room_surface_ids` does. The numbers differ from numpy's; the scene is the
same law.

Nothing here imports the program: both the program and the reference take
what these functions make.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

import numpy as np
import torch

ROOM = (5.0, 5.0, 3.0)
N_BOXES = 12
# class of each surface in the semantic configuration's 20 classes: the
# four walls, floor, ceiling (0: unlabelled), then one class a box
WALL, FLOOR, CEILING = 1, 2, 0
BOX_CLASSES = (3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16)


class Box(NamedTuple):
    center: np.ndarray    # (3,)
    size: np.ndarray      # (3,)
    yaw: float


class Scene(NamedTuple):
    xyz: torch.Tensor       # (N,3) f32 on the device
    surface: torch.Tensor   # (N,) int64: 0-5 the shell's faces, 6+ a box
    boxes: List[Box]


def seed_gen(seed: int, salt: int, device) -> torch.Generator:
    """A generator on `device` for one stream of the run's draws."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + salt) % (2 ** 63))
    return g


def _box_surface(gen, n: int, center, size, yaw: float, device):
    """n points on the 6 faces of a box, faces drawn by area."""
    sx, sy, sz = (float(v) for v in size)
    areas = torch.tensor([sy * sz, sy * sz, sx * sz, sx * sz, sx * sy,
                          sx * sy], dtype=torch.float64, device=device)
    face = torch.multinomial(areas / areas.sum(), n, replacement=True,
                             generator=gen)
    size_t = torch.tensor([sx, sy, sz], dtype=torch.float32, device=device)
    p = (torch.rand((n, 3), generator=gen, device=device) - 0.5) * size_t
    axis = face // 2
    sign = torch.where(face % 2 == 0, 0.5, -0.5).to(torch.float32)
    p[torch.arange(n, device=device), axis] = sign * size_t[axis]
    if yaw:
        c, s = math.cos(yaw), math.sin(yaw)
        rot = torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]],
                           dtype=torch.float32, device=device)
        p = p @ rot.T
    return p + torch.tensor(np.asarray(center, np.float32), device=device), face


def room_scan(layout: int, n_points: int, device) -> Scene:
    """The room scan: half the points on the shell, the rest over the 12
    boxes. The room (its layout and its points) comes from `layout`, the
    configuration's: every run's seed scans the same room, so every run
    sets up the same grid and the same memory, as a deployment holds one
    scan."""
    rng = np.random.default_rng([int(layout), 1])
    boxes = []
    for _ in range(N_BOXES):
        size = rng.uniform([0.3, 0.3, 0.3], [1.6, 1.6, 1.2])
        center = np.array([rng.uniform(-2.0, 2.0), rng.uniform(-2.0, 2.0),
                           -ROOM[2] / 2 + size[2] / 2])
        boxes.append(Box(center, size, float(rng.uniform(0, np.pi))))
    gen = seed_gen(layout, 1, device)
    n_room = n_points // 2
    pts, surf = [], []
    p, face = _box_surface(gen, n_room, (0.0, 0.0, 0.0), ROOM, 0.0, device)
    pts.append(p)
    surf.append(face)
    n_f = n_points - n_room
    per = np.full(N_BOXES, n_f // N_BOXES)
    per[:n_f - per.sum()] += 1
    for i, b in enumerate(boxes):
        p, _ = _box_surface(gen, int(per[i]), b.center, b.size, b.yaw, device)
        pts.append(p)
        surf.append(torch.full((int(per[i]),), 6 + i, dtype=torch.int64,
                               device=device))
    xyz = torch.cat(pts)
    xyz = xyz + torch.randn(xyz.shape, generator=gen, device=device) * 0.005
    return Scene(xyz.contiguous(), torch.cat(surf), boxes)


def point_attributes(scene: Scene, seed: int, feat_dim: int) -> Dict:
    """Per-point attributes as `chip_smoke.py` `build_scene` seeds them:
    embeddings N(0, 0.1), unit confidence, directions away from the
    room's centre, colours from the position."""
    xyz = scene.xyz
    gen = seed_gen(seed, 2, xyz.device)
    emb = torch.randn((xyz.shape[0], feat_dim), generator=gen,
                      device=xyz.device) * 0.1
    return {"xyz": xyz, "embedding": emb,
            "conf": torch.ones((xyz.shape[0], 1), device=xyz.device),
            "dir": xyz / torch.linalg.norm(xyz, dim=-1, keepdim=True),
            "color": torch.clamp(xyz * 0.2 + 0.5, 0, 1)}


def semantics(scene: Scene, seed: int, n_classes: int, sem_dim: int):
    """BPNet's per-point outputs, from the seed, one class a surface:
    (label_prob (N,C), label (N,), sem_embedding (N,S)). The class's
    probability is raised over seeded logits; the embedding is a seeded
    vector a class plus per-point noise."""
    dev = scene.xyz.device
    cls = torch.tensor([WALL] * 4 + [FLOOR, CEILING] + list(BOX_CLASSES),
                       dtype=torch.int64, device=dev)
    label = cls[scene.surface]
    gen = seed_gen(seed, 3, dev)
    n = label.shape[0]
    logits = torch.randn((n, n_classes), generator=gen, device=dev)
    logits[torch.arange(n, device=dev), label] += 4.0
    class_vec = torch.randn((n_classes, sem_dim), generator=gen, device=dev)
    emb = class_vec[label] + 0.1 * torch.randn((n, sem_dim), generator=gen,
                                               device=dev)
    return torch.softmax(logits, dim=-1), label, emb


# ------------------------------------------------------------------ cameras

def inside_box(p: np.ndarray, b: Box, margin: float) -> bool:
    c, s = math.cos(-b.yaw), math.sin(-b.yaw)
    d = p - b.center
    local = np.array([c * d[0] - s * d[1], s * d[0] + c * d[1], d[2]])
    return bool(np.all(np.abs(local) <= b.size / 2 + margin))


def camera_rotation(yaw: float, pitch: float) -> np.ndarray:
    """Camera-to-world rotation whose columns are the image's right, its
    down and the viewing direction (z up in the world)."""
    f = np.array([math.cos(pitch) * math.cos(yaw),
                  math.cos(pitch) * math.sin(yaw), math.sin(pitch)])
    r = np.cross(f, [0.0, 0.0, 1.0])
    r /= np.linalg.norm(r)
    d = np.cross(f, r)
    return np.stack([r, d, f], axis=1).astype(np.float32)


def draw_poses(seed: int, salt: int, n: int, boxes: List[Box],
               wall_margin: float, pitch: float):
    """n (campos, camrotc2w) drawn from the seed: the position uniform in
    the room's interior, `wall_margin` m from the shell and outside every
    box (and its margin); yaw uniform in [0, 2pi), pitch within +-pitch."""
    rng = np.random.default_rng([int(seed) % (2 ** 63), salt])
    lo = -np.asarray(ROOM) / 2 + wall_margin
    hi = np.asarray(ROOM) / 2 - wall_margin
    poses = []
    while len(poses) < n:
        p = rng.uniform(lo, hi)
        yaw = rng.uniform(0, 2 * np.pi)
        pt = rng.uniform(-pitch, pitch)
        if any(inside_box(p, b, 0.1) for b in boxes):
            continue
        poses.append((p.astype(np.float32), camera_rotation(yaw, pt)))
    return poses


def pixel_dirs(width: int, height: int, focal: float) -> np.ndarray:
    """(H*W, 3) camera-frame ray directions of the pixel centres, z = 1
    (unnormalised, as the ScanNet loader gives them with --dir_norm 0)."""
    px, py = np.meshgrid(np.arange(width, dtype=np.float32),
                         np.arange(height, dtype=np.float32))
    x = (px + 0.5 - width / 2) / focal
    y = (py + 0.5 - height / 2) / focal
    return np.stack([x, y, np.ones_like(x)], -1).reshape(-1, 3)


def frame_item(campos, rot, dirs_cam, near, far, bg) -> Dict:
    """A camera as the program's render_image takes it."""
    return {"raydir": (dirs_cam @ rot.T).astype(np.float32),
            "campos": campos, "camrotc2w": rot,
            "near": np.float32(near), "far": np.float32(far),
            "bg_color": np.asarray(bg, np.float32)}
