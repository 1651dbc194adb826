"""Test-split evaluation on the port: full renders + PSNR/SSIM/RMSE report.

    python -m sgnerf_tpu_torch.run.test_ft <the flags of run/test_ft.py>

Counterpart of run/test_ft.py (reference run/test_ft.py): resumes the
checkpoint, renders every `test_num_step`-th test view, prints per-image
PSNR lines, saves the images and writes scores.txt; `--bgmodel plane`
puts each frame's plane background behind the render. Runs on
cuda:<--gpu_ids>; `--gpu_ids -1` runs on the CPU with the kernels' plain
versions.
"""
from __future__ import annotations

import os
import time

import numpy as np

from ..data import create_dataset
from ..models.background import plane_bg_ray
from ..options.options import TestOptions, _check_slice
from ..runtime.scene_model import SceneModel
from ..utils.metrics import psnr
from ..utils.visualizer import Visualizer
from .evaluate import report_metrics


def main(args=None):
    opt = TestOptions().parse(args)
    opt.split = "train" if opt.test_train else "test"
    opt.random_sample = "no_crop"
    _check_slice(opt)          # refuse unported flags before any work
    visualizer = Visualizer(opt)
    dataset = create_dataset(opt)
    model = SceneModel(opt)
    ckpt = model.resolve_resume()
    if ckpt is None:
        raise SystemExit("no checkpoint found to evaluate")
    model.load_checkpoint(ckpt)

    subdir = f"test_{model.step}"
    out_dir = os.path.join(visualizer.image_dir, subdir)
    # --bgmodel *plane: each frame's plane background from the MVS source
    # views (reference test_ft.py:340-344)
    init_views = cloud_xyz = None
    if str(opt.bgmodel).endswith("plane") and hasattr(dataset,
                                                      "get_init_item"):
        init_views = dataset.get_init_item(0)
        cloud_xyz = model.cloud.xyz[model.cloud.active].cpu().numpy()
    psnrs = []
    for i in list(range(len(dataset)))[::max(opt.test_num_step, 1)]:
        item = dataset.get_item(i, full_img=True)
        bg_image = (plane_bg_ray(item, init_views, cloud_xyz,
                                 device=model.device)
                    if init_views is not None else None)
        t0 = time.time()
        col = model.render_image(item, bg_image=bg_image)
        pix = item["pixel_idx"]
        W = int(pix[:, 0].max() - pix[:, 0].min() + 1)
        Hh = len(col) // W
        img = col[:Hh * W].reshape(Hh, W, 3)
        gt = item["gt_image"][:Hh * W].reshape(Hh, W, 3)
        p = psnr(img, gt)
        psnrs.append(p)
        print(f"num.{i} psnr: {p:.4f}  time used: {time.time() - t0:.3f} s",
              flush=True)
        visualizer.display_current_results(
            {"coarse_raycolor": img, "gt_image": gt}, i, subdir=subdir)
    print(f"mean psnr: {np.mean(psnrs):.4f} over {len(psnrs)} images")
    report_metrics(out_dir, out_dir, out_dir, device=model.device)
    if opt.vid > 0:
        visualizer.gen_video(out_dir, r"step-\d+-coarse_raycolor\.png",
                             os.path.join(out_dir, "video.mp4"))


if __name__ == "__main__":
    main()
