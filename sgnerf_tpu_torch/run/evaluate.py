"""Metric report over rendered-vs-GT images: per-metric files and an
aggregate scores.txt (counterpart of run/evaluate.py; reference
run/evaluate.py:34-97).

    python -m sgnerf_tpu_torch.run.evaluate --gt_dir <dir> --img_dir <dir>
        [--out_dir <dir>] [--metrics psnr ssim lpips vgglpips rmse]
        [--gpu_ids 0]

LPIPS runs on cuda:<--gpu_ids> (`--gpu_ids -1`: the CPU) on the weight
files utils/lpips.py finds ($SGNERF_LPIPS or the torch hub cache); without
them its columns are nan.
"""
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
                   gt_suffix="-gt_image.png", img_suffix="-coarse_raycolor.png",
                   device="cpu"):
    """Score every `*{img_suffix}` of img_dir against its `*{gt_suffix}` in
    gt_dir; write `{metric}.txt` and scores.txt into out_dir and return
    each metric's mean (nan-skipping). LPIPS runs on `device`."""
    names = sorted(f[: -len(img_suffix)] for f in os.listdir(img_dir)
                   if f.endswith(img_suffix))
    results = {m: [] for m in metrics}
    lpips_warned = False
    for name in names:
        img = load_image(os.path.join(img_dir, name + img_suffix))
        gt = load_image(os.path.join(gt_dir, name + gt_suffix))
        if img.shape != gt.shape:
            print(f"skip {name}: shape mismatch {img.shape} vs {gt.shape}")
            continue
        for m in metrics:
            fn = {"psnr": psnr, "ssim": ssim, "rmse": rmse}.get(m)
            if fn is None:
                v = lpips(img, gt, net=m.replace("lpips", "") or "alex",
                          device=device)
                if v is None and not lpips_warned:
                    lpips_warned = True
                    print("[evaluate] LPIPS weights not found: reporting "
                          "nan. Put the backbone and calibration weights "
                          "in $SGNERF_LPIPS or ~/.cache/torch/hub/"
                          "checkpoints (README, 'LPIPS weights').")
                results[m].append(float("nan") if v is None else v)
            else:
                results[m].append(fn(img, gt))
    os.makedirs(out_dir, exist_ok=True)
    lines = []
    means = {}
    for m in metrics:
        vals = np.asarray(results[m], dtype=np.float64)
        with open(os.path.join(out_dir, f"{m}.txt"), "w") as f:
            for n, v in zip(names, vals):
                f.write(f"{n} {v:.6f}\n")
        means[m] = (float(np.nanmean(vals)) if np.isfinite(vals).any()
                    else float("nan"))
        lines.append(f"{m}: {means[m]:.6f}")
        print(f"{m}: {means[m]:.6f}")
    with open(os.path.join(out_dir, "scores.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return means


def main(args=None):
    import argparse

    from ..options.options import device_from_opt
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gt_dir", required=True)
    ap.add_argument("--img_dir", required=True)
    ap.add_argument("--out_dir", default=None)
    ap.add_argument("--metrics", nargs="+", default=list(DEFAULT_METRICS))
    ap.add_argument("--gpu_ids", default="0",
                    help="LPIPS on cuda:<id>; -1 is the CPU")
    a = ap.parse_args(args)
    return report_metrics(a.gt_dir, a.img_dir, a.out_dir or a.img_dir,
                          tuple(a.metrics), device=device_from_opt(a))


if __name__ == "__main__":
    main()
