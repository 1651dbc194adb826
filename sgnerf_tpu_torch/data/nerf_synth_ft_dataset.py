"""NeRF-synthetic per-scene dataset (Lego etc.) over the blender loader.

Counterpart of `sgnerf_tpu/data/nerf_synth_ft_dataset.py`, with
ScannetFtDataset's item contract: per-view pixel batches, ray directions
(the poses are blender2opencv-converted, +z forward, so rays are
intrinsic-based as in the reference's nerf_synth_ft_dataset.py:540), gt
colours with the RGBA alpha composited over bg_color, the init cloud from
`--cloud_path` (`load_init_points`), the views' alpha masks, intrinsics
and world-to-camera poses for the MVS bootstrap's visual hull, and the
spin path's items (`get_dummyrot_item`, run/render_vid.py).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .data_utils import get_blender_raydir, get_dtu_raydir
from .load_blender import load_blender_data, render_poses


class NerfSynthFtDataset:
    def __init__(self, opt):
        self.opt = opt
        self.split = opt.split
        basedir = f"{opt.data_root}/{opt.scan}"
        imgs, poses, hwf, i_split, intrinsic = \
            load_blender_data(basedir, [self.split],
                              testskip=getattr(opt, "testskip", 8)
                              if self.split != "train" else 1)
        self.imgs = imgs
        self.poses = poses
        self.render_poses = render_poses()
        self.height, self.width, self.focal = hwf
        self.intrinsic = intrinsic.astype(np.float32)
        self.near_far = [opt.near_plane, opt.far_plane]
        self.bg_color = {"white": (1.0, 1.0, 1.0),
                         "black": (0.0, 0.0, 0.0)}.get(
            opt.bg_color, (1.0, 1.0, 1.0))
        self.id_list = list(range(len(imgs)))
        self.total = len(self.id_list)

    def __len__(self):
        return self.total

    # the views of the MVS bootstrap's visual-hull filter
    # (runtime/mvs_bootstrap.py alpha_masking; reference train_ft.py:134
    # reads dataset.alphas/intrinsics/world2cams): the RGBA alpha channel
    # is the mask of a NeRF-synthetic view
    @property
    def alphas(self):
        return [img[None, :, :, 3] for img in self.imgs]

    @property
    def view_intrinsics(self):
        return [self.intrinsic for _ in self.id_list]

    @property
    def world2cams(self):
        return [np.linalg.inv(
            np.asarray(self.poses[i], np.float64)).astype(np.float32)
            for i in self.id_list]

    def _sample_pixels(self, rng):
        s = self.opt.random_sample_size
        if self.opt.random_sample == "random":
            px = rng.integers(0, self.width, size=(s, s)).astype(np.float32)
            py = rng.integers(0, self.height, size=(s, s)).astype(np.float32)
        else:
            px, py = np.meshgrid(np.arange(self.width, dtype=np.float32),
                                 np.arange(self.height, dtype=np.float32))
        return px, py

    def get_item(self, idx: int, full_img: bool = False,
                 rng: Optional[np.random.Generator] = None) -> Dict:
        rng = rng or np.random.default_rng()
        img = self.imgs[idx]                       # (H,W,4) RGBA
        pose = self.poses[idx]
        bg = np.asarray(self.bg_color, np.float32)
        rgb = img[..., :3] * img[..., 3:4] + bg * (1 - img[..., 3:4])

        px, py = self._sample_pixels(rng)
        pix = np.stack([px, py], -1)
        ipx, ipy = px.astype(np.int32), py.astype(np.int32)
        raydir = get_dtu_raydir(pix, self.intrinsic, pose[:3, :3],
                                getattr(self.opt, "dir_norm", 0) > 0)
        item = {
            "intrinsic": self.intrinsic,
            "campos": pose[:3, 3].astype(np.float32),
            "c2w": pose.astype(np.float32),
            "camrotc2w": pose[:3, :3].astype(np.float32),
            "near": np.float32(self.near_far[0]),
            "far": np.float32(self.near_far[1]),
            "h": self.height, "w": self.width,
            "id": idx, "vid": idx,
            "pixel_idx": pix.reshape(-1, 2),
            "raydir": raydir.reshape(-1, 3).astype(np.float32),
            "gt_image": rgb[ipy, ipx].reshape(-1, 3).astype(np.float32),
            "bg_color": bg,
        }
        if full_img:
            item["full_image"] = rgb
        return item

    __getitem__ = get_item

    def get_dummyrot_item(self, idx: int) -> Dict:
        """A full-frame item on the spin path's pose idx (reference
        get_dummyrot_item, which render_vid renders): blender-convention
        rays, normalised."""
        pose = self.render_poses[idx % len(self.render_poses)]
        item = self.get_item(0, full_img=False)
        item["campos"] = pose[:3, 3].astype(np.float32)
        item["camrotc2w"] = pose[:3, :3].astype(np.float32)
        item["c2w"] = pose.astype(np.float32)
        px, py = np.meshgrid(np.arange(self.width, dtype=np.float32),
                             np.arange(self.height, dtype=np.float32))
        pix = np.stack([px, py], -1)
        item["pixel_idx"] = pix.reshape(-1, 2)
        item["raydir"] = get_blender_raydir(
            pix, self.height, self.width, self.focal, item["camrotc2w"],
            True).reshape(-1, 3)
        return item

    def get_campos_ray(self):
        """Each view's camera centre and centre-pixel direction (each
        point's nearest view for its direction init)."""
        center = np.array([[self.width // 2, self.height // 2]], np.float32)
        camposes, centerdirs = [], []
        for idx in self.id_list:
            pose = self.poses[idx]
            camposes.append(pose[:3, 3].astype(np.float32))
            centerdirs.append(get_dtu_raydir(center, self.intrinsic,
                                             pose[:3, :3], True))
        return (np.stack(camposes).astype(np.float32),
                np.concatenate(centerdirs).astype(np.float32))

    def load_init_points(self):
        """The pickled surface cloud of --cloud_path (--num_point points)."""
        from .load_blender import load_blender_cloud
        xyz, _ = load_blender_cloud(self.opt.cloud_path, self.opt.num_point)
        return np.asarray(xyz, np.float32), None, None
