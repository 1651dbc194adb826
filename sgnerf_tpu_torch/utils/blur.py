"""Blur detection by Laplacian variance, without cv2 (the port's copy of
`sgnerf_tpu/utils/blur.py`).

Reference: the blur detector of utils_mine/: per-frame variance of
the Laplacian of the grayscale image; the lowest-variance frames go to
exported/blur_list.txt which the dataset's blur filter consumes
(scannet_ft_dataset.py:305-318).
"""
from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np


def variance_of_laplacian(gray: np.ndarray) -> float:
    """3x3 Laplacian [[0,1,0],[1,-4,1],[0,1,0]] variance (cv2.Laplacian)."""
    g = np.asarray(gray, np.float64)
    lap = (-4 * g[1:-1, 1:-1] + g[:-2, 1:-1] + g[2:, 1:-1]
           + g[1:-1, :-2] + g[1:-1, 2:])
    return float(lap.var())


def detect_blurry(image_paths: Sequence[str], worst_n: int = 150) -> List[int]:
    """Returns indices of the `worst_n` blurriest frames."""
    from PIL import Image
    scores = []
    for p in image_paths:
        with Image.open(p) as im:
            g = np.asarray(im.convert("L"), np.float64)
        scores.append(variance_of_laplacian(g))
    order = np.argsort(scores)
    return order[:worst_n].tolist()


def write_blur_list(scene_dir: str, ids: Sequence[int]):
    path = os.path.join(scene_dir, "exported", "blur_list.txt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for i in ids:
            f.write(f"{i}\n")
    return path
