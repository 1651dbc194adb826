"""Metric report over rendered-vs-GT images: per-metric files and an
aggregate scores.txt (counterpart of run/evaluate.py:report_metrics;
reference run/evaluate.py:34-97)."""
from __future__ import annotations

import os

import numpy as np

from ..utils.metrics import lpips, psnr, rmse, ssim

DEFAULT_METRICS = ("psnr", "ssim", "lpips", "vgglpips", "rmse")


def load_image(path):
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im, dtype=np.float32)[..., :3] / 255.0


def report_metrics(gt_dir, img_dir, out_dir, metrics=DEFAULT_METRICS,
                   gt_suffix="-gt_image.png", img_suffix="-coarse_raycolor.png"):
    names = sorted(f[: -len(img_suffix)] for f in os.listdir(img_dir)
                   if f.endswith(img_suffix))
    results = {m: [] for m in metrics}
    for name in names:
        img = load_image(os.path.join(img_dir, name + img_suffix))
        gt = load_image(os.path.join(gt_dir, name + gt_suffix))
        for m in metrics:
            fn = {"psnr": psnr, "ssim": ssim, "rmse": rmse}.get(m)
            if fn is None:
                # LPIPS needs weight files on disk; without them it is nan
                v = lpips(img, gt, net=m.replace("lpips", "") or "alex")
                results[m].append(float("nan") if v is None else v)
            else:
                results[m].append(fn(img, gt))
    os.makedirs(out_dir, exist_ok=True)
    lines = []
    for m in metrics:
        vals = np.asarray(results[m], dtype=np.float64)
        with open(os.path.join(out_dir, f"{m}.txt"), "w") as f:
            for n, v in zip(names, vals):
                f.write(f"{n} {v:.6f}\n")
        mean = float(np.nanmean(vals)) if np.isfinite(vals).any() \
            else float("nan")
        lines.append(f"{m}: {mean:.6f}")
        print(f"{m}: {mean:.6f}")
    with open(os.path.join(out_dir, "scores.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
