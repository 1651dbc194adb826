"""DTU (MVSNet-preprocessed) dataset (counterpart of
`sgnerf_tpu/data/dtu_dataset.py`): the standard MVSNet layout

    <data_root>/Cameras/pair.txt
    <data_root>/Cameras/train/{vid:08d}_cam.txt   (or Cameras/ directly)
    <data_root>/Rectified/{scan}_train/rect_{vid+1:03d}_{light}_r5000.png
    <data_root>/Depths/{scan}_train/depth_map_{vid:04d}.pfm   (optional)

cam.txt holds a 4x4 world-to-camera extrinsic, a 3x3 intrinsic (at 1/4 of
the rectified image resolution in the training set, `--dtu_cam_scale`),
and `depth_min depth_interval` for the 192-plane sweep.

Items follow ScannetFtDataset's contract (get_item / get_init_item /
get_campos_ray); `get_init_item` ranks source views by pair.txt scores.
A numpy copy of the JAX loader, ray directions from the port's
ops/camera.py, and one addition: a full-frame item carries `full_image`,
which the MVS bootstrap's embedding reads (the JAX loader omits it, and
its `--load_points 0` on DTU stops there with a KeyError).
"""
from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

import numpy as np
from PIL import Image

from .data_utils import get_dtu_raydir


def read_pfm(path: str) -> np.ndarray:
    """Minimal PFM reader (Pf = grayscale float map, MVSNet depth format)."""
    with open(path, "rb") as f:
        header = f.readline().decode().rstrip()
        if header not in ("Pf", "PF"):
            raise ValueError(f"not a PFM file: {path}")
        dims = f.readline().decode()
        while dims.startswith("#"):
            dims = f.readline().decode()
        w, h = map(int, dims.split())
        scale = float(f.readline().decode().rstrip())
        data = np.fromfile(f, "<f" if scale < 0 else ">f")
        c = 3 if header == "PF" else 1
        img = data.reshape(h, w, c)[..., 0]
        return np.flipud(img).astype(np.float32)  # PFM rows are bottom-up


def _read_cam(path: str):
    txt = open(path).read()
    nums = [float(x) for x in
            re.findall(r"[-+]?\d+\.?\d*(?:[eE][-+]?\d+)?", txt)]
    # layout: 'extrinsic' 16 floats, 'intrinsic' 9 floats, depth_min [interval]
    ext = np.asarray(nums[:16], np.float32).reshape(4, 4)
    intr = np.asarray(nums[16:25], np.float32).reshape(3, 3)
    depth_min = nums[25] if len(nums) > 25 else 0.0
    depth_iv = nums[26] if len(nums) > 26 else 0.0
    return ext, intr, depth_min, depth_iv


class DtuDataset:
    def __init__(self, opt):
        self.opt = opt
        self.data_dir = opt.data_root
        self.scan = opt.scan
        self.img_wh = tuple(opt.img_wh)
        self.width, self.height = self.img_wh
        self.cam_scale = float(getattr(opt, "dtu_cam_scale", 4.0))
        self.light = int(getattr(opt, "dtu_light_idx", 3))

        cam_dir = os.path.join(self.data_dir, "Cameras")
        self.cam_dir = (os.path.join(cam_dir, "train")
                        if os.path.isdir(os.path.join(cam_dir, "train"))
                        else cam_dir)
        pair_path = os.path.join(cam_dir, "pair.txt")
        self.pairs: Dict[int, List[int]] = {}
        ids: List[int] = []
        if os.path.exists(pair_path):
            tok = open(pair_path).read().split()
            n = int(tok[0])
            i = 1
            for _ in range(n):
                vid = int(tok[i]); i += 1
                m = int(tok[i]); i += 1
                srcs = [int(tok[i + 2 * k]) for k in range(m)]
                i += 2 * m
                self.pairs[vid] = srcs
                ids.append(vid)
        else:
            ids = sorted(
                int(m.group(1)) for f in os.listdir(self.cam_dir)
                if (m := re.match(r"(\d+)_cam\.txt", f)))

        # every train_step-th view is test (same convention as scannet_ft)
        step = max(1, int(getattr(opt, "train_step", 1)))
        if getattr(opt, "split", "train") == "train":
            self.id_list = [v for i, v in enumerate(ids) if i % step != 0] \
                or ids
        else:
            self.id_list = ids[::step]

        cams = {v: _read_cam(self._cam_path(v)) for v in ids}
        self.w2c = {v: cams[v][0] for v in ids}
        self.c2w = {v: np.linalg.inv(cams[v][0]).astype(np.float32)
                    for v in ids}
        self._raw_intr = {v: cams[v][1] for v in ids}

        dmins = [cams[v][2] for v in ids if cams[v][2] > 0]
        divs = [cams[v][3] for v in ids if cams[v][3] > 0]
        near = (min(dmins) if dmins else 0.1)
        far = (max(d + i * 192 for d, i in zip(dmins, divs))
               if dmins and divs else near + 1000.0)
        if getattr(opt, "near_plane", 0) and opt.near_plane > 0:
            near = opt.near_plane
        if getattr(opt, "far_plane", 0) and opt.far_plane > 0:
            far = opt.far_plane
        self.near_far = (float(near), float(far))

        # natural image size -> per-view intrinsics at img_wh
        with Image.open(self._color_path(self.id_list[0])) as im:
            self.native_wh = im.size
        self.intrinsics = {}
        for v in ids:
            k = self._raw_intr[v].copy()
            k[:2] *= self.cam_scale                     # cam-file -> native
            k[0] *= self.width / self.native_wh[0]      # native -> img_wh
            k[1] *= self.height / self.native_wh[1]
            self.intrinsics[v] = k.astype(np.float32)
        self.intrinsic = self.intrinsics[self.id_list[0]]
        self.bg_color = np.zeros(3, np.float32) \
            if getattr(opt, "bg_color", "black") in ("black", None) \
            else np.ones(3, np.float32)
        self.train_id_paths = [self._color_path(v) for v in self.id_list]

    # ------------------------------------------------------------------ paths

    def _cam_path(self, vid):
        return os.path.join(self.cam_dir, f"{vid:08d}_cam.txt")

    def _rect_dir(self):
        for suffix in (f"{self.scan}_train", self.scan):
            d = os.path.join(self.data_dir, "Rectified", suffix)
            if os.path.isdir(d):
                return d
        raise FileNotFoundError(
            f"no Rectified/{self.scan}[_train] under {self.data_dir}")

    def _color_path(self, vid):
        d = self._rect_dir()
        p = os.path.join(d, f"rect_{vid + 1:03d}_{self.light}_r5000.png")
        if os.path.exists(p):
            return p
        cands = sorted(f for f in os.listdir(d)
                       if f.startswith(f"rect_{vid + 1:03d}_"))
        if not cands:
            raise FileNotFoundError(f"no image for view {vid} in {d}")
        return os.path.join(d, cands[0])

    def _depth_path(self, vid):
        for suffix in (f"{self.scan}_train", self.scan):
            p = os.path.join(self.data_dir, "Depths", suffix,
                             f"depth_map_{vid:04d}.pfm")
            if os.path.exists(p):
                return p
        return None

    # ------------------------------------------------------------------- api

    def __len__(self):
        return len(self.id_list)

    def _load_img(self, vid):
        with Image.open(self._color_path(vid)) as im:
            return np.asarray(im.resize(self.img_wh, Image.BILINEAR),
                              np.float32) / 255.0

    def _sample_pixels(self, rng):
        n = int(getattr(self.opt, "random_sample_size", 32)) ** 2
        idx = rng.integers(0, self.width * self.height, n)
        return (idx % self.width).astype(np.float32), \
            (idx // self.width).astype(np.float32)

    def get_item(self, idx: int, full_img: bool = False,
                 rng: Optional[np.random.Generator] = None) -> Dict:
        rng = rng or np.random.default_rng()
        vid = self.id_list[idx]
        img = self._load_img(vid)
        c2w = self.c2w[vid]
        camrot, campos = c2w[:3, :3], c2w[:3, 3]
        if full_img:
            px, py = np.meshgrid(np.arange(self.width, dtype=np.float32),
                                 np.arange(self.height, dtype=np.float32))
            px, py = px.reshape(-1), py.reshape(-1)
        else:
            px, py = self._sample_pixels(rng)
        pix = np.stack([px, py], axis=-1)
        ipx, ipy = px.astype(np.int32), py.astype(np.int32)
        raydir = get_dtu_raydir(
            pix, self.intrinsics[vid], camrot,
            getattr(self.opt, "dir_norm", 0) > 0).reshape(-1, 3)
        item = {
            "image_path": self._color_path(vid),
            "intrinsic": self.intrinsics[vid],
            "campos": campos, "c2w": c2w, "camrotc2w": camrot,
            "near": np.float32(self.near_far[0]),
            "far": np.float32(self.near_far[1]),
            "h": self.height, "w": self.width,
            "id": idx, "vid": vid,
            "pixel_idx": pix.reshape(-1, 2).astype(np.int64),
            "raydir": raydir.astype(np.float32),
            "gt_image": img[ipy, ipx].reshape(-1, 3).astype(np.float32),
            "bg_color": self.bg_color,
            "train_id_paths": self.train_id_paths,
        }
        if full_img:
            item["full_image"] = img
        return item

    def get_init_item(self, idx: int) -> Dict:
        V = max(1, getattr(self.opt, "init_view_num", 3))
        vid = self.id_list[idx]
        srcs = [v for v in self.pairs.get(vid, [])
                if v in self.c2w][:V - 1]
        if len(srcs) < V - 1:  # no/short pair list: nearest by position
            ref = self.c2w[vid][:3, 3]
            others = sorted((v for v in self.id_list if v != vid),
                            key=lambda v: np.linalg.norm(
                                self.c2w[v][:3, 3] - ref))
            srcs = (srcs + [v for v in others if v not in srcs])[:V - 1]
        views = [vid] + srcs
        item = {
            "images": np.stack([self._load_img(v) for v in views]),
            "c2ws": np.stack([self.c2w[v] for v in views]),
            "w2cs": np.stack([self.w2c[v] for v in views]),
            "intrinsics": np.stack([self.intrinsics[v] for v in views]),
            "view_ids": views,
            "near": np.float32(self.near_far[0]),
            "far": np.float32(self.near_far[1]),
        }
        dp = self._depth_path(vid)
        if dp is not None:
            d = read_pfm(dp)
            item["gt_depth"] = np.asarray(
                Image.fromarray(d).resize(self.img_wh, Image.NEAREST),
                np.float32)
        return item

    def load_init_depth_points(self, vox_res: int = 100) -> np.ndarray:
        """Unproject every view's PFM depth to a world point cloud (the
        load_points==2 bootstrap; voxel downsample via vox_res like the
        ScanNet loader)."""
        pts = []
        for v in self.id_list:
            dp = self._depth_path(v)
            if dp is None:
                continue
            d = read_pfm(dp)
            h, w = d.shape
            k = self._raw_intr[v].copy()
            k[:2] *= self.cam_scale
            k[0] *= w / self.native_wh[0]
            k[1] *= h / self.native_wh[1]
            gy, gx = np.meshgrid(np.arange(h, dtype=np.float32),
                                 np.arange(w, dtype=np.float32),
                                 indexing="ij")
            ok = d > 0
            z = d[ok]
            x = (gx[ok] + 0.5 - k[0, 2]) / k[0, 0] * z
            y = (gy[ok] + 0.5 - k[1, 2]) / k[1, 1] * z
            cam = np.stack([x, y, z], -1)
            c2w = self.c2w[v]
            pts.append(cam @ c2w[:3, :3].T + c2w[:3, 3])
        if not pts:
            return np.zeros((0, 3), np.float32)
        xyz = np.concatenate(pts).astype(np.float32)
        if vox_res > 0 and len(xyz):
            span = xyz.max(0) - xyz.min(0) + 1e-6
            cell = (xyz - xyz.min(0)) / span * vox_res
            _, keep = np.unique(cell.astype(np.int64), axis=0,
                                return_index=True)
            xyz = xyz[np.sort(keep)]
        return xyz

    def get_campos_ray(self):
        campos = np.stack([self.c2w[v][:3, 3] for v in self.id_list])
        camdir = np.stack([self.c2w[v][:3, 2] for v in self.id_list])
        return campos.astype(np.float32), camdir.astype(np.float32)
