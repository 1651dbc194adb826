"""Render a camera-path video from a trained checkpoint.

    python -m sgnerf_tpu_torch.run.render_vid <the flags of run/test_ft.py>
        [--render_stride N]

Counterpart of run/render_vid.py (reference run/render_vid.py:26-79). The
frames come from the dataset's spin path when it has one (NeRF-synthetic:
`get_dummyrot_item` over the 20 `render_poses`, max(test views,
render_stride) frames), else from a SLERP path through the test poses
(utils/camera_path.py, max(2 x test views, render_stride) frames, rays
from the first test view's intrinsics). Frames and the video go to
images/vid. Runs on cuda:<--gpu_ids>; `--gpu_ids -1` is the CPU.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..data import create_dataset
from ..ops.camera import get_dtu_raydir
from ..options.options import TestOptions, _check_slice
from ..runtime.scene_model import SceneModel
from ..utils.camera_path import interpolate_poses
from ..utils.visualizer import Visualizer
from .editing import frame_image


def path_frames(dataset, render_stride: int):
    """-> (n_frames, get(i) -> a full-frame item on the path)."""
    if hasattr(dataset, "get_dummyrot_item"):
        return max(len(dataset), render_stride), dataset.get_dummyrot_item
    keys = np.stack([dataset.get_item(i)["c2w"] for i in range(len(dataset))])
    n_frames = max(2 * len(keys), render_stride)
    path = interpolate_poses(keys, n_frames)

    def get(i):
        item = dataset.get_item(0, full_img=False)
        item["campos"] = path[i][:3, 3]
        item["camrotc2w"] = path[i][:3, :3]
        item["raydir"] = get_dtu_raydir(
            torch.from_numpy(np.asarray(item["pixel_idx"], np.float32)),
            torch.from_numpy(np.asarray(item["intrinsic"], np.float32)),
            torch.from_numpy(item["camrotc2w"]), True).numpy()
        return item
    return n_frames, get


def main(args=None):
    opt = TestOptions().parse(args)
    opt.split = "test"
    opt.random_sample = "no_crop"
    _check_slice(opt)          # refuse unported flags before any work
    visualizer = Visualizer(opt)
    dataset = create_dataset(opt)
    model = SceneModel(opt)
    ckpt = model.resolve_resume()
    if ckpt is None:
        raise SystemExit("no checkpoint found to render")
    model.load_checkpoint(ckpt)

    subdir = "vid"
    out_dir = os.path.join(visualizer.image_dir, subdir)
    n_frames, get = path_frames(dataset, opt.render_stride)
    for i in range(n_frames):
        item = get(i)
        t0 = time.time()
        img = frame_image(item, model.render_image(item))
        print(f"frame {i}: render time: {time.time() - t0:.3f} s", flush=True)
        visualizer.display_current_results({"coarse_raycolor": img}, i,
                                           subdir=subdir)
    visualizer.gen_video(out_dir, r"step-\d+-coarse_raycolor\.png",
                         os.path.join(out_dir, "video.mp4"))
    return n_frames


if __name__ == "__main__":
    main()
