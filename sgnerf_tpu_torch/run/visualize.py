"""Dump a checkpoint's neural point cloud for external viewers.

    python -m sgnerf_tpu_torch.run.visualize --checkpoints_dir <dir>
        --name <run> [--resume_iter latest|N]

Counterpart of run/visualize.py (reference run/visualize.py): writes
`<checkpoints_dir>/<name>/visual/cloud.txt` (x;y;z;r;g;b;label a line)
and `cloud_neuralpcd.ply` (the editor's ply schema, every neural
attribute a vertex property). Host only: no device is touched.
"""
from __future__ import annotations

import os

import numpy as np

from ..editor import NeuralPointCloudEdit
from ..options.options import TestOptions
from ..runtime.scene_model import get_latest_epoch


def main(args=None):
    opt = TestOptions().parse(args)
    base = os.path.join(opt.checkpoints_dir, opt.name or "default")
    it = (get_latest_epoch(base) if opt.resume_iter == "latest"
          else opt.resume_iter)
    path = None
    for ext in (".npz", ".pth"):
        p = os.path.join(base, f"{it}_net_ray_marching{ext}")
        if os.path.exists(p):
            path = p
            break
    if path is None:
        raise SystemExit(f"no checkpoint found under {base}")
    cloud = NeuralPointCloudEdit.from_checkpoint(path)
    out_dir = os.path.join(base, "visual")
    os.makedirs(out_dir, exist_ok=True)
    data = np.concatenate(
        [cloud.xyz, cloud.color, cloud.label.reshape(-1, 1)], axis=-1)
    np.savetxt(os.path.join(out_dir, "cloud.txt"), data, delimiter=";")
    cloud.save_as_ply(os.path.join(out_dir, "cloud_neuralpcd.ply"))
    print(f"wrote {cloud.n} points to {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
