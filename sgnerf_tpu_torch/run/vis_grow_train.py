"""Visualise point growing: run the hole probe on a trained checkpoint and
dump the candidate points, without changing the model.

    python -m sgnerf_tpu_torch.run.vis_grow_train <the flags of
        run/train_ft.py> [--test_num N] [--prob_thresh t]

Counterpart of run/vis_grow_train.py (reference run/vis_grow_train.py):
for the first --test_num train views, the probe render
(runtime/growing.render_probe_maps: 2304-ray chunks through the eval
render's kernels) and its rays that hit the scan with a largest shading
opacity above --prob_thresh; their sample positions go to
`<name>/grow_vis/probe_<i>.txt`. Runs on cuda:<--gpu_ids>; `--gpu_ids -1`
is the CPU.
"""
from __future__ import annotations

import os

import numpy as np

from ..data import create_dataset
from ..options.options import TestOptions, _check_slice
from ..runtime.growing import render_probe_maps
from ..runtime.scene_model import SceneModel


def main(args=None):
    opt = TestOptions().parse(args)
    opt.split = "train"
    _check_slice(opt)          # refuse unported flags before any work
    dataset = create_dataset(opt)
    model = SceneModel(opt)
    ckpt = model.resolve_resume()
    if ckpt is None:
        raise SystemExit("no checkpoint to probe")
    model.load_checkpoint(ckpt)

    out_dir = os.path.join(model.expr_dir, "grow_vis")
    os.makedirs(out_dir, exist_ok=True)
    counts = []
    for i in range(min(len(dataset), max(1, opt.test_num))):
        item = dataset.get_item(i, full_img=True)
        maps = render_probe_maps(model, item)
        mask = (maps["ray_mask"][..., 0] > 0) & (
            maps["ray_max_shading_opacity"][..., 0] > opt.prob_thresh)
        pts = maps["ray_max_sample_loc_w"][mask]
        np.savetxt(os.path.join(out_dir, f"probe_{i}.txt"), pts,
                   delimiter=";")
        print(f"frame {i}: {len(pts)} probe points", flush=True)
        counts.append(len(pts))
    return counts


if __name__ == "__main__":
    main()
