"""Semantic-segmentation IoU (the port's copy of the IoU half of
`sgnerf_tpu/utils/util.py`; reference utils/util.py:15-61,
intersectionAndUnionGPU), which run/result.py scores predicted label
clouds with.
"""
from __future__ import annotations

import numpy as np


def intersection_and_union(output: np.ndarray, target: np.ndarray, K: int,
                           ignore_index: int = 255):
    """Per-class intersection, union and target counts (reference
    intersectionAndUnionGPU semantics)."""
    output = np.asarray(output).reshape(-1).copy()
    target = np.asarray(target).reshape(-1).copy()
    output[target == ignore_index] = ignore_index
    inter = output[output == target]
    area_inter = np.histogram(inter, bins=K, range=(0, K - 1))[0]
    area_out = np.histogram(output, bins=K, range=(0, K - 1))[0]
    area_tgt = np.histogram(target, bins=K, range=(0, K - 1))[0]
    return area_inter, area_out + area_tgt - area_inter, area_tgt


def miou(output, target, K: int, ignore_index: int = 255):
    """(mean IoU over the classes present, per-class IoU with nan where a
    class has no union)."""
    i, u, t = intersection_and_union(output, target, K, ignore_index)
    valid = u > 0
    iou = np.where(valid, i / np.maximum(u, 1), np.nan)
    return float(np.nanmean(iou)), iou
