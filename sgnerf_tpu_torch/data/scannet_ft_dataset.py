"""ScanNet per-scene dataset: full-image items for the eval render.

Counterpart of the eval half of `sgnerf_tpu/data/scannet_ft_dataset.py`
(reference data/scannet_ft_dataset.py): the `exported/{color,pose,
intrinsic}` layout, the |c2w| < 30 pose filter, the train/test split by
`train_step`, and full-frame items over the `edge_filter` window. Random
pixel sampling and point loading come with training (ROADMAP item 8).
"""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch

from ..ops.camera import get_dtu_raydir


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
        self.build_init_metas()
        intr_path = os.path.join(self.data_dir, self.scan,
                                 "exported/intrinsic/intrinsic_color.txt")
        self.intrinsic = np.loadtxt(intr_path).astype(np.float32)[:3, :3]
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
            raise NotImplementedError(
                "--bg_color random is a training option (ROADMAP item 8)")
        return tuple(float(x) for x in bg.split(","))

    def _pose_path(self, vid):
        return os.path.join(self.data_dir, self.scan, "exported/pose",
                            f"{vid}.txt")

    def _color_path(self, vid):
        return os.path.join(self.data_dir, self.scan, "exported/color",
                            f"{vid}.jpg")

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
        self.id_list = (self.train_id_list if self.split == "train"
                        else self.test_id_list)

    def __len__(self):
        return len(self.id_list)

    def get_item(self, idx: int) -> Dict:
        """Full-frame item of view `idx` over the edge_filter window."""
        from PIL import Image
        vid = self.id_list[idx]
        with Image.open(self._color_path(vid)) as im:
            img = np.asarray(im.resize(self.img_wh, Image.NEAREST),
                             dtype=np.float32) / 255.0
        c2w = np.loadtxt(self._pose_path(vid)).astype(np.float32)
        margin = getattr(self.opt, "edge_filter", 3)
        px, py = np.meshgrid(
            np.arange(margin, self.width - margin, dtype=np.float32),
            np.arange(margin, self.height - margin, dtype=np.float32))
        pix = np.stack([px, py], axis=-1).reshape(-1, 2)
        raydir = get_dtu_raydir(
            torch.from_numpy(pix), torch.from_numpy(self.intrinsic),
            torch.from_numpy(c2w[:3, :3]),
            getattr(self.opt, "dir_norm", 0) > 0).numpy()
        return {
            "intrinsic": self.intrinsic,
            "campos": c2w[:3, 3],
            "camrotc2w": c2w[:3, :3],
            "near": np.float32(self.near_far[0]),
            "far": np.float32(self.near_far[1]),
            "h": self.height, "w": self.width, "id": idx, "vid": vid,
            "pixel_idx": pix,
            "raydir": raydir.astype(np.float32),
            "gt_image": img[py.astype(np.int32),
                            px.astype(np.int32)].reshape(-1, 3),
            "bg_color": np.asarray(self.bg_color, np.float32),
        }
