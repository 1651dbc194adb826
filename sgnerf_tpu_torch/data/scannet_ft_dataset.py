"""ScanNet per-scene dataset (counterpart of
`sgnerf_tpu/data/scannet_ft_dataset.py`; reference
data/scannet_ft_dataset.py).

  * the `exported/{color,pose,depth,label,intrinsic}` layout and the
    |c2w| < 30 pose filter;
  * train split = every `train_step`-th frame, test = the rest;
  * `get_item(idx, rng=)`: `random_sample_size`^2 pixels drawn by
    `--random_sample` (random / random2 / patch; any other value is the full
    frame over the `edge_filter` window), their ray directions and gt
    colours, per-ray gt depth when a depth loss asks for it, the
    background colour (`--bg_color random` draws black or white per item),
    and where `exported/label/<id>.png` exists the ScanNet ids remapped to
    the 20 classes (`label_remapper`): per-ray `pixel_label` and the
    frame's `gt_semantic_img`; the frame's colour path and the train
    split's colour paths ride along for BPNet's view selection;
  * `load_init_points`: exported/pcd.ply (+ exported/points.pth colours
    and labels) with the `ranges` crop; `load_init_depth_points`: the
    depth pngs unprojected (`--load_points 2`);
  * `get_campos_ray`: camera centres and centre-pixel directions.

The same numpy generator state draws the same pixels as the JAX dataset.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops.camera import get_dtu_raydir

SCANNET20_REMAP_IDS = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28,
                       33, 34, 36, 39]


def label_remapper() -> np.ndarray:
    """ScanNet ids 0..255 -> the 20 benchmark classes in order, 255 else."""
    remap = np.full(256, 255, dtype=np.int32)
    for i, x in enumerate(SCANNET20_REMAP_IDS):
        remap[x] = i
    return remap


class ScannetFtDataset:
    def __init__(self, opt):
        from PIL import Image
        self.opt = opt
        self.data_dir = opt.data_root
        self.scan = opt.scan
        self.split = opt.split
        self.img_wh = (int(opt.img_wh[0]), int(opt.img_wh[1]))
        self.width, self.height = self.img_wh
        self.near_far = [opt.near_plane, opt.far_plane]
        self.bg_color = self._parse_bg(opt.bg_color)
        self.remapper = label_remapper()
        self.build_init_metas()
        intr_path = os.path.join(self.data_dir, self.scan,
                                 "exported/intrinsic/intrinsic_color.txt")
        self.intrinsic = np.loadtxt(intr_path).astype(np.float32)[:3, :3]
        d_path = os.path.join(self.data_dir, self.scan,
                              "exported/intrinsic/intrinsic_depth.txt")
        # without a depth intrinsic, the colour one (the same array, so it
        # takes the img_wh scaling below, as in the JAX package)
        self.depth_intrinsic = (np.loadtxt(d_path).astype(np.float32)[:3, :3]
                                if os.path.exists(d_path) else self.intrinsic)
        with Image.open(self._color_path(0)) as im:
            ow, oh = im.size
        self.intrinsic[0, :] *= self.width / ow
        self.intrinsic[1, :] *= self.height / oh

    @staticmethod
    def _parse_bg(bg):
        if not bg or bg == "black":
            return (0.0, 0.0, 0.0)
        if bg == "white":
            return (1.0, 1.0, 1.0)
        if bg == "red":
            return (1.0, 0.0, 0.0)
        if bg == "random":
            return "random"
        return tuple(float(x) for x in bg.split(","))

    def _pose_path(self, vid):
        return os.path.join(self.data_dir, self.scan, "exported/pose",
                            f"{vid}.txt")

    def _color_path(self, vid):
        return os.path.join(self.data_dir, self.scan, "exported/color",
                            f"{vid}.jpg")

    def _label_path(self, vid):
        return os.path.join(self.data_dir, self.scan, "exported/label",
                            f"{vid}.png")

    def _depth_path(self, vid):
        return os.path.join(self.data_dir, self.scan, "exported/depth",
                            f"{vid}.png")

    def _needs_depth(self) -> bool:
        """Per-ray gt depth is sampled only for a depth loss or output."""
        o = self.opt
        return bool(getattr(o, "depth_loss_items", ()) or
                    getattr(o, "compute_depth", 0) or
                    any(n.startswith("ray_depth_masked")
                        for n in (getattr(o, "color_loss_items", ()) or ())))

    def filter_valid_id(self, id_list: List[int]) -> List[int]:
        return [vid for vid in id_list
                if np.max(np.abs(np.loadtxt(self._pose_path(vid)))) < 30]

    def build_init_metas(self):
        colordir = os.path.join(self.data_dir, self.scan, "exported/color")
        n = len([f for f in os.listdir(colordir)
                 if os.path.isfile(os.path.join(colordir, f))])
        self.all_id_list = self.filter_valid_id(list(range(n)))
        step = getattr(self.opt, "train_step", 5)
        self.train_id_list = self.all_id_list[::step]
        test_list = getattr(self.opt, "test_list", None)
        if test_list is not None:
            self.test_id_list = list(test_list)
        elif getattr(self.opt, "test_num_step", 1) != 1:
            self.test_id_list = [v for i, v in enumerate(self.all_id_list)
                                 if i % step != 0]
        else:
            self.test_id_list = self.all_id_list
        self.train_id_paths = [[self._color_path(i)
                                for i in self.train_id_list]]
        self.id_list = (self.train_id_list if self.split == "train"
                        else self.test_id_list)

    def __len__(self):
        max_len = getattr(self.opt, "max_len", -1)
        return len(self.id_list) if max_len <= 0 else max_len

    def _sample_pixels(self, rng: np.random.Generator):
        margin = getattr(self.opt, "edge_filter", 3)
        s = self.opt.random_sample_size
        mode = self.opt.random_sample
        if mode == "patch":
            ix = rng.integers(margin, self.width - margin - s + 1)
            iy = rng.integers(margin, self.height - margin - s + 1)
            px, py = np.meshgrid(np.arange(ix, ix + s, dtype=np.float32),
                                 np.arange(iy, iy + s, dtype=np.float32))
        elif mode == "random":
            px = rng.integers(margin, self.width - margin,
                              size=(s, s)).astype(np.float32)
            py = rng.integers(margin, self.height - margin,
                              size=(s, s)).astype(np.float32)
        elif mode == "random2":
            px = rng.uniform(margin, self.width - margin - 1e-5,
                             size=(s, s)).astype(np.float32)
            py = rng.uniform(margin, self.height - margin - 1e-5,
                             size=(s, s)).astype(np.float32)
        else:  # full frame
            px, py = np.meshgrid(
                np.arange(margin, self.width - margin, dtype=np.float32),
                np.arange(margin, self.height - margin, dtype=np.float32))
        return px, py

    def get_item(self, idx: int, full_img: bool = False,
                 rng: Optional[np.random.Generator] = None) -> Dict:
        from PIL import Image
        rng = rng or np.random.default_rng()
        vid = self.id_list[idx]
        with Image.open(self._color_path(vid)) as im:
            img = np.asarray(im.resize(self.img_wh, Image.NEAREST),
                             dtype=np.float32) / 255.0
        c2w = np.loadtxt(self._pose_path(vid)).astype(np.float32)
        sem = None
        lp = self._label_path(vid)
        if os.path.exists(lp):
            with Image.open(lp) as im:
                sem = np.asarray(im.convert(mode="I").resize(
                    self.img_wh, Image.NEAREST), dtype=np.int64)
            sem = self.remapper[np.clip(sem, 0, 255)]
        px, py = self._sample_pixels(rng)
        pix = np.stack([px, py], axis=-1)
        ipx, ipy = px.astype(np.int32), py.astype(np.int32)
        raydir = get_dtu_raydir(
            torch.from_numpy(pix), torch.from_numpy(self.intrinsic),
            torch.from_numpy(c2w[:3, :3]),
            getattr(self.opt, "dir_norm", 0) > 0).numpy().reshape(-1, 3)
        item = {
            "image_path": self._color_path(vid),
            "intrinsic": self.intrinsic,
            "campos": c2w[:3, 3],
            "c2w": c2w,
            "camrotc2w": c2w[:3, :3],
            "near": np.float32(self.near_far[0]),
            "far": np.float32(self.near_far[1]),
            "h": self.height, "w": self.width, "id": idx, "vid": vid,
            "pixel_idx": pix.reshape(-1, 2),
            "raydir": raydir.astype(np.float32),
            "gt_image": img[ipy, ipx].reshape(-1, 3).astype(np.float32),
            "train_id_paths": self.train_id_paths,
        }
        if sem is not None:
            item["pixel_label"] = sem[ipy, ipx].reshape(-1).astype(np.int32)
            item["gt_semantic_img"] = sem
        if self._needs_depth():
            dpath = self._depth_path(vid)
            if os.path.exists(dpath):
                with Image.open(dpath) as im:
                    dm = np.asarray(im.resize(self.img_wh, Image.NEAREST),
                                    dtype=np.float32) / 1000.0
                dm[(dm > 8.0) | (dm < 0.3)] = 0    # read_depth clipping
                item["gt_depth"] = dm[ipy, ipx].reshape(-1)
                item["gt_mask"] = (item["gt_depth"] > 0).astype(np.float32)
        if full_img:
            item["full_image"] = img
        if self.bg_color == "random":
            item["bg_color"] = (np.ones(3, np.float32) if rng.uniform() > 0.5
                                else np.zeros(3, np.float32))
        else:
            item["bg_color"] = np.asarray(self.bg_color, np.float32)
        return item

    __getitem__ = get_item

    def load_init_points(self):
        """Returns (xyz [N,3], feats [N,3] in 0..255 or None, labels [N] or
        None)."""
        from ..utils.ply import read_ply
        d = read_ply(os.path.join(self.data_dir, self.scan,
                                  "exported/pcd.ply"))
        xyz = np.stack([d["x"], d["y"], d["z"]], -1).astype(np.float32)
        pth = os.path.join(self.data_dir, self.scan, "exported/points.pth")
        feats, labels = None, None
        if os.path.exists(pth):
            data = torch.load(pth, map_location="cpu", weights_only=False)
            feats = (np.asarray(data[1]) + 1.0) * 127.5
            labels = np.asarray(data[2]) if len(data) > 2 else None
        if feats is None and "red" in d:
            feats = np.stack([d["red"], d["green"], d["blue"]],
                             -1).astype(np.float32)
        ranges = np.asarray(getattr(self.opt, "ranges",
                                    (-100.0,) * 3 + (100.0,) * 3))
        if ranges[0] > -99.0:
            mask = np.all((xyz >= ranges[:3]) & (xyz <= ranges[3:]), axis=-1)
            xyz = xyz[mask]
            if feats is not None and len(feats) == len(mask):
                feats = feats[mask]
            if labels is not None and len(labels) == len(mask):
                labels = labels[mask]
        return xyz, feats, labels

    def read_depth(self, path: str) -> np.ndarray:
        """A depth png in mm -> metres, 0 outside [0.3, 8]."""
        from PIL import Image
        with Image.open(path) as im:
            depth = np.asarray(im, dtype=np.float32) / 1000.0
        depth[depth > 8.0] = 0
        depth[depth < 0.3] = 0
        return depth

    def load_init_depth_points(self, vox_res: int = 0) -> np.ndarray:
        """Every view's depth map unprojected into one world cloud (the
        `--load_points 2` bootstrap), each view voxel-downsampled to its
        centroids when vox_res > 0, then the `ranges` crop."""
        from ..ops.scatter import voxel_downsample_xyz
        inv_k = np.linalg.inv(self.depth_intrinsic).T
        out = []
        for vid in self.all_id_list:
            dpath = self._depth_path(vid)
            if not os.path.exists(dpath):
                continue
            depth = self.read_depth(dpath)
            h, w = depth.shape
            py, px = np.mgrid[0:h, 0:w].astype(np.float32)
            cam = np.stack([px * depth, py * depth, depth], -1) @ inv_k
            cam = cam[cam[..., 2] > 0]
            c2w = np.loadtxt(self._pose_path(vid)).astype(np.float32)
            ones = np.ones_like(cam[..., :1])
            world = (np.concatenate([cam, ones], -1) @ c2w.T)[..., :3]
            if vox_res > 0:
                world = voxel_downsample_xyz(world, vox_res)
            out.append(world)
        pts = np.concatenate(out, axis=0) if out else np.zeros((0, 3))
        ranges = np.asarray(getattr(self.opt, "ranges",
                                    (-100.0,) * 3 + (100.0,) * 3))
        if ranges[0] > -99.0 and len(pts):
            mask = np.all((pts >= ranges[:3]) & (pts <= ranges[3:]), axis=-1)
            pts = pts[mask]
        return pts.astype(np.float32)

    def get_campos_ray(self):
        """(camera centres (V,3), unit centre-pixel directions (V,3)) of the
        split's views."""
        center = np.asarray(self.img_wh, np.float32)[None] // 2
        camposes, centerdirs = [], []
        for vid in self.id_list:
            c2w = np.loadtxt(self._pose_path(vid)).astype(np.float32)
            camposes.append(c2w[:3, 3])
            centerdirs.append(get_dtu_raydir(
                torch.from_numpy(center), torch.from_numpy(self.intrinsic),
                torch.from_numpy(c2w[:3, :3]), True).numpy())
        return (np.stack(camposes).astype(np.float32),
                np.concatenate(centerdirs).astype(np.float32))
