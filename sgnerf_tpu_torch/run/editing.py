"""Object editing: compose edited neural point clouds and render the test
views as frames and a video.

    python -m sgnerf_tpu_torch.run.editing <geometry flags>
        --resume_dir <dir> --neural_points_names A.pth [B.pth ...]
        [--parts_index_names all idx.txt ...]
        [--Transformation_names identity T.txt ...] [--render_name edit]

Counterpart of run/editing.py (reference run/editing.py:123-237). For
each (neural_points_name, parts_index_name, Transformation_name) triple
the part's points are loaded (a .pth or .npz under --resume_dir),
selected by the index file and moved by the 4x4 transform; the parts are
composed, each new part first, into one cloud that the model renders with
the first part's weights and no optimizer. Each rotated part adds a row
to a (T,3,3) rotation table and its points carry that row's index
(rot_idx): the renderer rotates view directions, neighbour offsets and
stored dirs into the part's canonical frame per neighbour (the reference
expands a dense per-point (N,3,3) Rw2c, editing.py:201-205). Runs on
cuda:<--gpu_ids>; `--gpu_ids -1` is the CPU.
"""
from __future__ import annotations

import os
import time

import numpy as np

from ..data import create_dataset
from ..editor import (NeuralPointCloudEdit, add_point_cloud,
                      transform_point_cloud_global)
from ..models.point_cloud import make_point_cloud
from ..options.options import EditOptions, _check_slice
from ..runtime.scene_model import SceneModel
from ..utils.visualizer import Visualizer


def load_parts(opt):
    """Load and transform each named part -> (composed cloud, rotation
    table (3,3) or (T,3,3), per-point rot_idx (N,) int32). A rotated
    part's table row is its right-multiplied R (reference editing.py:201:
    "w2c is reversed against movement"); identity rotations (within 1e-7)
    take row 0."""
    base_dir = opt.resume_dir or os.path.join(opt.checkpoints_dir,
                                              opt.name or "default")
    composed = None
    rot_rows = [np.eye(3, dtype=np.float32)]
    rot_idx = np.zeros(0, np.int32)
    names = opt.neural_points_names or []
    parts = opt.parts_index_names or []
    transforms = opt.Transformation_names or []
    for i, name in enumerate(names):
        path = name if os.path.isabs(name) else os.path.join(base_dir, name)
        part = NeuralPointCloudEdit.from_checkpoint(path)
        if i < len(parts) and parts[i] not in ("all", "None"):
            idx = np.loadtxt(os.path.join(base_dir, parts[i])).astype(
                np.int64)
            part = part.select(idx.reshape(-1))
        row = 0
        if i < len(transforms) and transforms[i] not in ("identity", "None"):
            T = np.loadtxt(os.path.join(base_dir, transforms[i])).reshape(
                4, 4)
            part = transform_point_cloud_global(part, T)
            R = np.asarray(T[:3, :3], np.float32)
            if not np.allclose(R, np.eye(3), atol=1e-7):
                rot_rows.append(R)
                row = len(rot_rows) - 1
        # add_point_cloud puts the new part first (child, father)
        rot_idx = np.concatenate([np.full(part.n, row, np.int32), rot_idx])
        composed = part if composed is None else add_point_cloud(part,
                                                                 composed)
    assert composed is not None, "no --neural_points_names given"
    table = np.stack(rot_rows) if len(rot_rows) > 1 else rot_rows[0]
    return composed, table, rot_idx


def frame_image(item, col):
    """(R,3) colours of a full-frame item -> (H,W,3)."""
    pix = item["pixel_idx"]
    W = int(pix[:, 0].max() - pix[:, 0].min() + 1)
    H = len(col) // W
    return col[:H * W].reshape(H, W, 3)


def main(args=None):
    opt = EditOptions().parse(args)
    opt.split = "test"
    opt.random_sample = "no_crop"
    _check_slice(opt)          # refuse unported flags before any work
    visualizer = Visualizer(opt)
    dataset = create_dataset(opt)
    composed, rot_table, rot_idx = load_parts(opt)
    model = SceneModel(opt)
    model._finish_setup(composed.params, make_point_cloud(
        composed.xyz, composed.embedding, conf=composed.conf.reshape(-1, 1),
        dir=composed.dir, color=composed.color, label=composed.label,
        Rw2c=rot_table, rot_idx=rot_idx, device=model.device))
    print(f"edited scene: {int(model.cloud.n_active)} points, "
          f"{1 if model.cloud.Rw2c.dim() == 2 else model.cloud.Rw2c.shape[0]}"
          " rotation(s)", flush=True)

    subdir = opt.render_name or "edit"
    out_dir = os.path.join(visualizer.image_dir, subdir)
    for i in range(len(dataset)):
        item = dataset.get_item(i, full_img=True)
        t0 = time.time()
        img = frame_image(item, model.render_image(item))
        print(f"edit frame {i}: render time: {time.time() - t0:.3f} s",
              flush=True)
        visualizer.display_current_results({"coarse_raycolor": img}, i,
                                           subdir=subdir)
    visualizer.gen_video(out_dir, r"step-\d+-coarse_raycolor\.png",
                         os.path.join(out_dir, "video.mp4"))
    return model


if __name__ == "__main__":
    main()
