"""IoU scoring of a saved label point cloud against the labelled mesh.

    python -m sgnerf_tpu_torch.run.result --pred <pred_label_cloud.txt>
        --gt_labels_ply <scene_vh_clean_2.labels.ply> [--classes 20]

Counterpart of the repo root's result.py (reference result.py:66): each
predicted point (run/test_edit.py --save_predict_label 1) takes the label
of its nearest mesh vertex, mapped from the 150 ScanNet ids to the 20
benchmark classes, and the 20-class IoU is printed. Host only (a scipy
KD-tree queried on every CPU core, numpy).
"""
from __future__ import annotations

import argparse

import numpy as np

from ..data.prepare_scannet import label_remapper_150
from ..utils.ply import read_ply
from ..utils.util import miou


def load_label_cloud(path):
    data = np.loadtxt(path, delimiter=";")
    return data[:, :3], data[:, 3].astype(np.int64)


def score(pred_path: str, gt_labels_ply: str, classes: int = 20):
    from scipy.spatial import cKDTree
    xyz, labels = load_label_cloud(pred_path)
    d = read_ply(gt_labels_ply)
    gt_xyz = np.stack([d["x"], d["y"], d["z"]], -1)
    gt_label = np.asarray(d["label"], np.int64)
    gt20 = label_remapper_150()[np.clip(gt_label, 0, 149)].astype(np.int64)
    _, idx = cKDTree(gt_xyz).query(xyz, k=1, workers=-1)
    m, per_class = miou(labels, gt20[idx], classes)
    print(f"mIoU: {m:.4f}")
    for c, v in enumerate(per_class):
        print(f"  class {c}: {v:.4f}")
    return m


def main(args=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pred", required=True)
    ap.add_argument("--gt_labels_ply", required=True)
    ap.add_argument("--classes", type=int, default=20)
    a = ap.parse_args(args)
    return score(a.pred, a.gt_labels_ply, a.classes)


if __name__ == "__main__":
    main()
