"""Feed-forward (cross-scene) training on the port: MVS nets and
aggregator trained together.

    python -m sgnerf_tpu_torch.run.train <the flags of run/train.py>

Counterpart of run/train.py (reference run/train.py with feedforward=1):
each step takes a dataset item's init views (the reference view and its
pair.txt sources) and a random ray batch of that view, makes the cloud
from the reference view's depth map inside the autograd graph
(models/feedforward.py), renders the rays and steps both Adams. The voxel
grid's spec comes from `--ranges`, which is required. Runs on
cuda:<--gpu_ids>; `--gpu_ids -1` is the CPU.

Checkpoints are the JAX package's files, so a run of either package
resumes in the other: `{step}_feedforward.pkl`, a pickle of
{"agg": aggregator tree, "mvs": MVS tree} as numpy arrays in JAX's
layout, and `{step}_feedforward.npz`, the aggregator's leaves in JAX's
tree order as `agg.<i>`. `--resume_iter latest|best|N` picks up a .pkl
from the run's checkpoint directory.

The ray batch carries `ray_depth_mask`, the reference view's depth > 0 at
its pixels (reference mvs_points_volumetric_model.py:152), which the ete
scripts' ray_depth_masked_coarse_raycolor loss reads (the JAX trainer
does not pass it, and stops there with a KeyError).
"""
from __future__ import annotations

import glob
import os
import pickle
import time

import numpy as np
import torch

from ..data import create_dataset
from ..models.aggregator import init_aggregator_params
from ..models.feedforward import (init_opt_states, make_feedforward_step,
                                  tree_leaves)
from ..models.mvs import MVSConfig, init_mvs_params
from ..models.params import (mvs_params_from_jax, mvs_params_to_jax,
                             params_from_jax, params_to_jax)
from ..ops.grid import compute_grid_spec
from ..options.options import (TrainOptions, _check_slice, configs_from_opt,
                               device_from_opt)
from ..utils.visualizer import Visualizer


def check_flags(opt):
    """Refuse, before any work, what this trainer cannot run."""
    _check_slice(opt)
    if not opt.feedforward:
        raise ValueError("run/train.py is the feed-forward trainer: "
                         "pass --feedforward 1")
    if opt.ranges[0] <= -99.0:
        raise ValueError("--ranges is required for feed-forward training "
                         "(the voxel grid's spec is static)")
    if opt.gather_dtype != "float32":
        raise NotImplementedError(
            f"training through --gather_dtype {opt.gather_dtype} is not "
            "ported yet (ROADMAP.md, queue 1 item 17); train with float32")


def _downsample_depth(depth, max_hw=(48, 64)):
    """Cap the point count: every depth pixel is a point slot, so the depth
    map is strided down to at most max_hw."""
    H, W = depth.shape
    sy = max(1, (H + max_hw[0] - 1) // max_hw[0])
    sx = max(1, (W + max_hw[1] - 1) // max_hw[1])
    return depth[::sy, ::sx], sy, sx


def make_ff_batch(dataset, idx, opt, rng, device="cpu"):
    """A feed-forward batch on `device`: item idx's init views, its depth
    map strided down with the intrinsic to match, and a random ray batch
    of the same view with its ray_depth_mask."""
    init = dataset.get_init_item(idx % len(dataset))
    item = dataset.get_item(idx % len(dataset), rng=rng)
    intr = np.asarray(init["intrinsics"][0], np.float32)
    w2cs = np.asarray(init["w2cs"], np.float32)
    c2ws = np.stack([np.linalg.inv(m) for m in w2cs]).astype(np.float32)
    full_depth = np.asarray(init["gt_depth"], np.float32)
    depth, sy, sx = _downsample_depth(full_depth)
    dintr = intr.copy()
    dintr[0] /= sx
    dintr[1] /= sy
    px = np.asarray(item["pixel_idx"]).astype(np.int64)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)
    return {
        "images": t(init["images"]), "c2ws": t(c2ws), "w2cs": t(w2cs),
        "intrinsics": t(init["intrinsics"]), "depth_intr": t(dintr),
        "near_far": t([float(init["near"]), float(init["far"])]),
        "gt_depth": t(depth),
        "campos": t(item["campos"])[None], "raydir": t(item["raydir"])[None],
        "camrotc2w": t(item["camrotc2w"])[None],
        "near": float(item["near"]), "far": float(item["far"]),
        "bg_color": t(item["bg_color"]),
        "gt_image": t(item["gt_image"])[None],
        "ray_depth_mask": t(full_depth[px[:, 1], px[:, 0]] > 0)[None],
    }


def _ckpt_path(out_dir, tag):
    return os.path.join(out_dir, f"{tag}_feedforward.pkl")


def find_resume(opt, out_dir):
    """The .pkl that --resume_iter names in out_dir, or None."""
    if opt.resume_iter in ("", "0", None):
        return None
    if opt.resume_iter in ("latest", "best"):
        cands = sorted(glob.glob(_ckpt_path(out_dir, "*")),
                       key=lambda p: int(os.path.basename(p).split("_")[0]))
        return cands[-1] if cands else None
    p = _ckpt_path(out_dir, opt.resume_iter)
    return p if os.path.exists(p) else None


def load_feedforward(path, device):
    """A {step}_feedforward.pkl of either package -> the port's params."""
    with open(path, "rb") as f:
        tree = pickle.load(f)
    return {"agg": params_from_jax(tree["agg"], device),
            "mvs": mvs_params_from_jax(tree["mvs"], device)}


def save_feedforward(params, out_dir, step):
    """{step}_feedforward.pkl (JAX layout) and .npz (aggregator leaves in
    JAX's tree order), as the JAX trainer writes them."""
    os.makedirs(out_dir, exist_ok=True)
    tree = {"agg": params_to_jax(params["agg"]),
            "mvs": mvs_params_to_jax(params["mvs"])}
    np.savez(os.path.join(out_dir, f"{step}_feedforward.npz"),
             **{f"agg.{i}": x for i, x in enumerate(tree_leaves(tree["agg"]))})
    with open(_ckpt_path(out_dir, step), "wb") as f:
        pickle.dump(tree, f)


def main(args=None):
    opt = TrainOptions().parse(args)
    opt.split = "train"
    check_flags(opt)
    device = device_from_opt(opt)
    visualizer = Visualizer(opt)
    dataset = create_dataset(opt)
    cfg, tcfg, grid_kwargs = configs_from_opt(opt, device)
    ranges = np.asarray(opt.ranges, np.float32)
    spec = compute_grid_spec(ranges.reshape(2, 3), **grid_kwargs)
    mvs_cfg = MVSConfig(depth_grid=opt.depth_grid,
                        point_features_dim=opt.point_features_dim,
                        init_view_num=opt.init_view_num)

    params = {"agg": init_aggregator_params(1, cfg.agg, device),
              "mvs": init_mvs_params(0, mvs_cfg, device)}
    start_step = 0
    out_dir = os.path.join(opt.checkpoints_dir, opt.name or "default")
    resume = find_resume(opt, out_dir)
    if resume is not None:
        params = load_feedforward(resume, device)
        start_step = int(os.path.basename(resume).split("_")[0])
        print(f"resumed feedforward params from {resume} "
              f"(step {start_step})")
    opt_states = init_opt_states(params)
    step_fn = make_feedforward_step(
        mvs_cfg, cfg, spec, opt.lr, opt.mvs_lr if opt.mvs_lr else opt.lr,
        alter_step=opt.alter_step,
        color_loss_items=tuple(tcfg.color_loss_items),
        color_loss_weights=tuple(tcfg.color_loss_weights))

    generator = torch.Generator(device=device)
    generator.manual_seed(2)
    rng = np.random.default_rng(0)
    maximum_step = (10000 if opt.maximum_step is None
                    else int(opt.maximum_step))
    print(f"feedforward training from step {start_step} to {maximum_step} "
          f"on {device}; grid vdim {spec.vdim} max_o {spec.max_o} "
          f"P {spec.P}")
    t0 = time.time()
    for step in range(start_step, maximum_step):
        batch = make_ff_batch(dataset, int(rng.integers(len(dataset))), opt,
                              rng, device)
        params, opt_states, losses = step_fn(params, opt_states, batch,
                                             step, generator=generator)
        visualizer.accumulate_losses(losses)
        if (step + 1) % opt.print_freq == 0:
            visualizer.print_losses(step + 1)
            visualizer.reset()
        if opt.save_iter_freq > 0 and (step + 1) % opt.save_iter_freq == 0:
            save_feedforward(params, out_dir, step + 1)
    print(f"feedforward training done in {time.time() - t0:.1f}s")
    return params


if __name__ == "__main__":
    main()
