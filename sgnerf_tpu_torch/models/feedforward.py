"""The feed-forward (cross-scene) training step: MVS nets and aggregator
trained together (counterpart of `sgnerf_tpu/models/feedforward.py`;
reference MvsPointsVolumetricModel.forward with feedforward=1,
mvs_points_volumetric_model.py:144-155).

Each step the MVS nets make the reference view's point cloud inside the
autograd graph, so the render loss trains FeatureNet and premlp (and
MVSNet's cost volume when depth is inferred) through the rendered pixels.

  * every depth pixel is a point slot; masked points sit at 1e9 with
    `active` False, so the grid build drops them (no slot, no cache row),
    and are embedded at a finite stand-in (a pixel without depth would
    put inf and NaN into the table and the gradients; the JAX step
    embeds it where it lies);
  * the voxel grid is built from detached positions, on the run's static
    spec (from --ranges); positions and attributes stay differentiable
    through the renderer's gather;
  * one backward, then two Adams (optax's update order, models/train.py
    adam_step) at constant rates: the aggregator's and the MVS nets'.
    `alter_step` > 0 steps only the active group's Adam, phase
    (step // alter_step) % 2 (0: aggregator, 1: MVS nets); the other's
    parameters, moments and count stay, which is the JAX step's gate
    (a zero update and the old state).
The MVS nets run in IEEE float32 (models/mvs.py `ieee_f32`), their
backward too.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

from ..ops.grid import GridSpec, build_point_grid
from .losses import compute_losses
from .mvs import MVSConfig, MvsPointsModel, ieee_f32
from .point_cloud import NeuralPointCloud
from .renderer import RenderConfig, render_rays
from .train import adam_init, adam_step


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a nested dict/list, dict keys in sorted order (JAX's
    tree order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def cloud_from_mvs(mvs_params, mvs_cfg: MVSConfig, batch: Dict):
    """The reference view's differentiable cloud. batch: images (V,H,W,3),
    c2ws / w2cs (V,4,4), intrinsics (V,3,3), depth_intr (3,3) at the depth
    map's scale, near_far (2,), gt_depth (h,w) or proj_mats (V,3,4).
    Returns (cloud, positions for the grid)."""
    images = batch["images"]
    mvs = MvsPointsModel(mvs_cfg, params=mvs_params, device=images.device)
    cam_xyz, mask, conf = mvs.gen_points(
        images, batch.get("proj_mats"), batch["depth_intr"],
        batch["near_far"], gt_depth=batch.get("gt_depth"))
    xyz_cam = cam_xyz.reshape(-1, 3)
    active = mask.reshape(-1)
    # a pixel without depth (0 in a dataset's map) unprojects onto the
    # camera centre, whose projection divides by zero; the inf and NaN
    # would reach the table through masked gathers (NaN * 0) and the
    # gradients. Inactive points are embedded at a finite stand-in
    # instead: they never enter the grid, so nothing else changes
    xyz_q = torch.where(active[:, None], xyz_cam,
                        xyz_cam.new_tensor([0.0, 0.0, 1.0]))
    emb, color, dirs, pconf = mvs.query_embedding(
        (int(images.shape[1]), int(images.shape[2])), xyz_q,
        conf.reshape(-1), images, batch["c2ws"], batch["w2cs"],
        batch["intrinsics"], cam_vid=0)
    c2w = batch["c2ws"][0]
    xyz_w = xyz_cam @ c2w[:3, :3].T + c2w[:3, 3]
    xyz_for_grid = torch.where(active[:, None], xyz_w,
                               torch.full_like(xyz_w, 1e9))
    M = xyz_w.shape[0]
    dev = xyz_w.device
    cloud = NeuralPointCloud(
        xyz=xyz_for_grid, embedding=emb, conf=pconf, dir=dirs, color=color,
        feats=color, label=torch.zeros(M, dtype=torch.int32, device=dev),
        label_prob=torch.zeros((M, 1), device=dev),
        sem_embedding=torch.zeros((M, 1), device=dev),
        Rw2c=torch.eye(3, device=dev),
        rot_idx=torch.zeros(M, dtype=torch.int32, device=dev),
        active=active, n_active=active.sum().to(torch.int32))
    return cloud, xyz_for_grid


def feedforward_loss(params: Dict, mvs_cfg: MVSConfig, cfg: RenderConfig,
                     spec: GridSpec, batch: Dict,
                     color_loss_items: Sequence[str],
                     color_loss_weights: Sequence[float],
                     generator: Optional[torch.Generator] = None):
    """The step's forward: (total, losses); losses holds each colour item
    and n_points. The render noise is drawn from `generator`."""
    cloud, xyz_grid = cloud_from_mvs(params["mvs"], mvs_cfg, batch)
    with torch.no_grad():
        grid = build_point_grid(xyz_grid.detach(), cloud.active, spec)
    out = render_rays(
        params["agg"], cloud, grid, cfg, campos=batch["campos"],
        raydir=batch["raydir"], camrotc2w=batch["camrotc2w"],
        near=batch["near"], far=batch["far"], bg_color=batch["bg_color"],
        generator=generator, is_train=True)
    if "ray_depth_mask" in batch:
        out["ray_depth_mask"] = batch["ray_depth_mask"]
    total, losses = compute_losses(
        out, batch["gt_image"], color_loss_items=tuple(color_loss_items),
        color_loss_weights=tuple(color_loss_weights))
    losses["n_points"] = cloud.n_active.to(torch.float32)
    return total, losses


def init_opt_states(params: Dict) -> Dict[str, Any]:
    return {g: adam_init(tree_leaves(params[g])) for g in ("agg", "mvs")}


def make_feedforward_step(mvs_cfg: MVSConfig, cfg: RenderConfig,
                          spec: GridSpec, lr_agg: float, lr_mvs: float,
                          alter_step: int = 0,
                          color_loss_items=("coarse_raycolor",),
                          color_loss_weights=(1.0,)):
    """step_fn(params, opt_states, batch, step, generator=None) ->
    (params, opt_states, losses): one joint step,
    params = {"agg": aggregator tree, "mvs": MVS tree} and opt_states
    (init_opt_states) updated in place; losses are detached device
    scalars with "total"."""

    def step_fn(params, opt_states, batch, step: int, generator=None):
        groups = {g: tree_leaves(params[g]) for g in ("agg", "mvs")}
        leaves = groups["agg"] + groups["mvs"]
        for t in leaves:
            t.requires_grad_(True)
        try:
            with ieee_f32():
                total, losses = feedforward_loss(
                    params, mvs_cfg, cfg, spec, batch, color_loss_items,
                    color_loss_weights, generator=generator)
                grads = torch.autograd.grad(total, leaves, allow_unused=True)
        finally:
            for t in leaves:
                t.requires_grad_(False)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves, grads)]
        n_agg = len(groups["agg"])
        active = {"agg": True, "mvs": True}
        if alter_step > 0:
            phase = (int(step) // alter_step) % 2
            active = {"agg": phase == 0, "mvs": phase == 1}
        for g, gr, lr in (("agg", grads[:n_agg], lr_agg),
                          ("mvs", grads[n_agg:], lr_mvs)):
            if active[g]:
                adam_step(groups[g], gr, opt_states[g], lr)
        losses = {k: v.detach() for k, v in losses.items()}
        losses["total"] = total.detach()
        return params, opt_states, losses

    return step_fn
