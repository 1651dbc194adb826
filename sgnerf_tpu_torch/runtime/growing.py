"""Point growing ("probe holes"), in process.

Counterpart of `sgnerf_tpu/runtime/growing.py` for one device (reference
probe_hole, run/train_ft.py:425-540): probe frames are rendered with the
renderer's prob outputs, pixels that see the scan next to pixels that miss
it harvest a new point at their sample of largest opacity, and the cloud
grows into its free slots (SceneModel.grow_points rebuilds the grid).
The probe render runs the eval render's kernels (K2 under `--fused_mlp
auto` on the card); under --ray_shards each probe chunk's rays are split
over the shards (parallel/sharded.py). Under --scene_shards the probes
render the world grid of the cloud, which reading `model.cloud` first
brings up to the slabs' trained attributes, as the JAX package does.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..models.point_cloud import build_grid, grid_spec_for_cloud
from ..models.renderer import render_rays

PROBE_KEYS = ("coarse_raycolor", "ray_mask", "ray_max_sample_loc_w",
              "ray_max_shading_opacity", "ray_max_far_dist",
              "shading_avg_color", "shading_avg_dir", "shading_avg_conf",
              "shading_avg_embedding")


def probe_grid_for_step(model, opt, step):
    """Tier-based probe-query widening (reference probe_hole,
    run/train_ft.py:434-438): past each `prob_tiers` threshold the probe
    uses the next kernel_size triple of `prob_kernel_size`; once the tiers
    are exhausted probing stops (:891). A widened tier builds a temporary
    probe grid. Returns (grid, exhausted)."""
    if getattr(opt, "prob_kernel_size", None) is None:
        return model.grid, False
    tier = int(np.sum(np.asarray(opt.prob_tiers) < step))
    if tier >= len(opt.prob_kernel_size) // 3:
        return None, True
    ks = [int(k) for k in
          np.asarray(opt.prob_kernel_size)[tier * 3:tier * 3 + 3]]
    if tuple(ks) == tuple(model.spec.kernel_size):
        return model.grid, False
    kw = dict(model.grid_kwargs, kernel_size=ks)
    spec = grid_spec_for_cloud(model.state.cloud, **kw)
    print(f"probe tier {tier}: query kernel {ks}, building probe grid")
    return build_grid(model.state.cloud, spec), False


@torch.inference_mode()
def render_probe_maps(model, item, chunk_rays: int = 2304,
                      grid=None) -> Dict[str, np.ndarray]:
    """Full-frame prob-mode render scattered into H x W maps (numpy, the
    JAX package's dtypes: bool ray_mask, float32 the rest)."""
    dev = model.device
    raydir = torch.as_tensor(np.asarray(item["raydir"], np.float32),
                             device=dev)
    pix = np.asarray(item["pixel_idx"]).astype(np.int64)
    H, W = item["h"], item["w"]
    R = raydir.shape[0]
    pad = (-R) % chunk_rays
    if pad:
        raydir = torch.cat([raydir, raydir.new_zeros((pad, 3))])
    grid = model.grid if grid is None else grid

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)
    cam = dict(campos=t(item["campos"])[None],
               camrotc2w=t(item["camrotc2w"])[None],
               near=float(item["near"]), far=float(item["far"]),
               bg_color=t(item["bg_color"]))
    parts = {k: [] for k in PROBE_KEYS}
    render = render_rays
    if model.ray_mesh is not None:
        from ..parallel.sharded import render_rays_sharded

        def render(params, cloud, grid, cfg, **kw):
            return render_rays_sharded(params, cloud, grid, cfg,
                                       model.ray_mesh, **kw)
    for s in range(0, raydir.shape[0], chunk_rays):
        out = render(model.params, model.cloud, grid, model.cfg,
                     raydir=raydir[None, s:s + chunk_rays],
                     table=model.table, prob=True, **cam)
        for k in PROBE_KEYS:
            parts[k].append(out[k][0])
    maps: Dict[str, np.ndarray] = {}
    for k in PROBE_KEYS:
        v = torch.cat(parts[k])[:R].cpu().numpy()
        if v.ndim == 1:
            v = v[:, None]
        maps[k] = np.zeros((H, W, v.shape[-1]), v.dtype)
        maps[k][pix[:, 1], pix[:, 0]] = v
    return maps


def probe_and_grow(model, dataset, opt, seed,
                   opacity_thresh: float = 0.7) -> int:
    """Select probe frames (`seed`: an int or a numpy Generator), harvest
    hole points, grow the cloud. Returns the number of points grown.

    The JAX package seeds numpy with the last word of its key's data
    (`jax.random.key_data(key).ravel()[-1]`); the same integer here picks
    the same frames."""
    from scipy.ndimage import binary_dilation

    rng = np.random.default_rng(seed)
    grid, exhausted = probe_grid_for_step(model, opt, int(model.step))
    if exhausted:
        print("probe_and_grow: prob tiers exhausted, skipping")
        return 0
    max_num = max(1, len(dataset) // max(opt.prob_num_step, 1))
    frame_ids = rng.permutation(len(dataset))[:max_num]

    add = {k: [] for k in ("xyz", "embedding", "conf", "color", "dir")}
    H, W = dataset.height, dataset.width
    for i in frame_ids:
        item = dataset.get_item(int(i), full_img=True)
        maps = render_probe_maps(model, item, grid=grid)
        pix = np.asarray(item["pixel_idx"]).astype(np.int64)
        gt_map = np.zeros((H, W, 3), np.float32)
        gt_map[pix[:, 1], pix[:, 0]] = item["gt_image"]
        edge_mask = np.zeros((H, W), bool)
        edge_mask[pix[:, 1], pix[:, 0]] = True
        bg = np.asarray(item["bg_color"], np.float32)

        ray_mask = maps["ray_mask"][..., 0]
        miss = (ray_mask < 1) & (
            np.linalg.norm(gt_map - bg, axis=-1) > 0.002) & edge_mask
        # miss pixels dilated by one (3x3): hit pixels next to a hole
        near_miss = binary_dilation(miss, np.ones((3, 3), bool))
        grow_mask = (ray_mask > 0) & near_miss & (
            maps["ray_max_shading_opacity"][..., 0] > opacity_thresh)
        if opt.far_thresh > 0:
            far = (ray_mask > 0) & (
                maps["ray_max_far_dist"][..., 0] > opt.far_thresh) & (
                np.linalg.norm(gt_map - maps["coarse_raycolor"], axis=-1)
                < 0.1)
            grow_mask |= far
        if not grow_mask.any():
            continue
        add["xyz"].append(maps["ray_max_sample_loc_w"][grow_mask])
        add["embedding"].append(maps["shading_avg_embedding"][grow_mask])
        add["conf"].append(maps["shading_avg_conf"][grow_mask] * opt.prob_mul)
        add["color"].append(maps["shading_avg_color"][grow_mask])
        add["dir"].append(maps["shading_avg_dir"][grow_mask])

    del grid           # a tier's probe grid goes before the rebuild
    if not add["xyz"]:
        print("probe_and_grow: no holes found")
        return 0
    new = {k: np.concatenate(v) for k, v in add.items()}
    model.grow_points(new["xyz"], new["embedding"], new["conf"],
                      new["color"], new["dir"])
    return len(new["xyz"])
