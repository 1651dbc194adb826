"""Test-split evaluation with the predicted-label point cloud.

    python -m sgnerf_tpu_torch.run.test_edit <the flags of run/test_ft.py>
        [--save_predict_label 1]

Counterpart of run/test_edit.py (reference run/test_edit.py): test_ft's
evaluation (per-image PSNR lines, the images under images/test_edit, the
plane background of `--bgmodel plane`) that with `--save_predict_label 1`
first writes the live points and their labels, `x;y;z;label` a line, to
images/pred_label_cloud.txt; run/result.py scores that file against the
labelled mesh. Runs on cuda:<--gpu_ids>; `--gpu_ids -1` is the CPU.
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
from .editing import frame_image


def save_label_cloud(path, xyz, labels):
    data = np.concatenate([xyz, labels.reshape(-1, 1)], axis=-1)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savetxt(path, data, delimiter=";")


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
        raise SystemExit("no checkpoint found to evaluate")
    model.load_checkpoint(ckpt)

    act = model.cloud.active
    if opt.save_predict_label:
        save_label_cloud(
            os.path.join(visualizer.image_dir, "pred_label_cloud.txt"),
            model.cloud.xyz[act].cpu().numpy(),
            model.cloud.label[act].cpu().numpy())
        print("saved predicted label cloud")

    # --bgmodel *plane: each frame's plane background from the MVS source
    # views (reference run/test_edit.py:75-87)
    init_views = cloud_xyz = None
    if str(opt.bgmodel).endswith("plane") and hasattr(dataset,
                                                      "get_init_item"):
        init_views = dataset.get_init_item(0)
        cloud_xyz = model.cloud.xyz[act].cpu().numpy()
    psnrs = []
    subdir = "test_edit"
    for i in list(range(len(dataset)))[::max(opt.test_num_step, 1)]:
        item = dataset.get_item(i, full_img=True)
        bg_image = (plane_bg_ray(item, init_views, cloud_xyz,
                                 device=model.device)
                    if init_views is not None else None)
        t0 = time.time()
        img = frame_image(item, model.render_image(item, bg_image=bg_image))
        H, W = img.shape[:2]
        gt = item["gt_image"][:H * W].reshape(H, W, 3)
        p = psnr(img, gt)
        psnrs.append(p)
        print(f"num.{i} psnr: {p:.4f}  time used: {time.time() - t0:.3f} s",
              flush=True)
        visualizer.display_current_results(
            {"coarse_raycolor": img, "gt_image": gt}, i, subdir=subdir)
    print(f"mean psnr: {np.mean(psnrs):.4f}")
    return psnrs


if __name__ == "__main__":
    main()
