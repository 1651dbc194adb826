"""Training state and the training step (counterpart of
`sgnerf_tpu/models/train.py`; reference MvsPointsVolumetricModel's
optimizer stack, mvs_points_volumetric_model.py:47-141).

  * two Adams: the shading MLPs at `lr`, the per-point tensors at `plr`,
    each on its schedule (iter_exponential_decay, lambda, step, constant);
  * per-field gradient switches (feat/conf/color/dir/xyz_grad): a frozen
    field gets no gradient and no update; the semantic fields (label,
    label_prob, sem_embedding: BPNet's outputs) are in neither Adam;
  * `alter_step`: phase (step // alter_step) % 3 steps the MLPs in phase 0
    and the points in phase 1.

Adam is a plain function on tensors rather than torch.optim.Adam, because
the reference's optax Adam differs from it twice: a gated-off phase still
advances its moments and count (the update is computed, then scaled by 0),
and the schedule is evaluated at the pre-increment count. The update
follows optax's order of operations: m = (1-b1) g + b1 m,
v = (1-b2) g^2 + b2 v, m / (1 - b1^n) / (sqrt(v / (1 - b2^n)) + eps),
times -lr(n - 1).

The step updates the state in place (the JAX step donates it): parameters
and point tensors are rewritten under no_grad, so the tensors a caller
holds stay the live ones.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .losses import compute_losses
from .point_cloud import NeuralPointCloud
from .renderer import RenderConfig, render_rays, render_rays_perspective

POINT_FIELDS = ("embedding", "conf", "color", "dir", "xyz")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 5e-4
    plr: float = 2e-3
    lr_policy: str = "iter_exponential_decay"
    lr_decay_iters: int = 1000000
    lr_decay_exp: float = 0.1
    niter: int = 100            # lr_policy=lambda: flat until niter...
    niter_decay: int = 100      # ...then linear to 0 over niter_decay
    alter_step: int = 0
    # per-tensor grad switches (reference flags feat_grad etc.)
    feat_grad: int = 1
    conf_grad: int = 1
    color_grad: int = 1
    dir_grad: int = 0
    xyz_grad: int = 0
    # loss config
    color_loss_items: Tuple[str, ...] = (
        "ray_masked_coarse_raycolor", "ray_miss_coarse_raycolor",
        "coarse_raycolor")
    color_loss_weights: Tuple[float, ...] = (1.0, 0.0, 0.0)
    zero_one_loss_items: Tuple[str, ...] = ("conf_coefficient",)
    zero_one_loss_weights: Tuple[float, ...] = (0.0001,)
    depth_loss_items: Tuple[str, ...] = ()
    depth_loss_weights: Tuple[float, ...] = ()
    bg_loss_items: Tuple[str, ...] = ()
    bg_loss_weights: Tuple[float, ...] = ()
    l2_size_loss_items: Tuple[str, ...] = ()
    l2_size_loss_weights: Tuple[float, ...] = ()
    sparse_loss_weight: float = 0.0
    zero_epsilon: float = 1e-3

    def grad_switch(self, field: str) -> bool:
        return bool({
            "embedding": self.feat_grad, "conf": self.conf_grad,
            "color": self.color_grad, "dir": self.dir_grad,
            "xyz": self.xyz_grad}[field])


def schedule(tcfg: TrainConfig, base_lr: float, count: int) -> float:
    """Learning rate at optimizer count `count` (reference
    helpers/networks.py:41-66), in float32 as the JAX schedules compute it.
    'plateau' and 'cosine_annealing' fall through to constant, as there."""
    f32 = np.float32
    if tcfg.lr_policy == "iter_exponential_decay":
        e = f32(count) / f32(tcfg.lr_decay_iters)
        return float(f32(base_lr) * np.power(f32(tcfg.lr_decay_exp), e))
    if tcfg.lr_policy == "lambda":
        frac = f32(1.0) - f32(max(0, count - tcfg.niter)) \
            / f32(tcfg.niter_decay + 1)
        return float(f32(base_lr) * frac)
    if tcfg.lr_policy == "step":
        return float(f32(base_lr) * np.power(
            f32(0.1), f32(count // tcfg.lr_decay_iters)))
    return float(f32(base_lr))


def adam_init(tensors: List[torch.Tensor]) -> Dict[str, Any]:
    return {"count": 0, "m": [torch.zeros_like(t) for t in tensors],
            "v": [torch.zeros_like(t) for t in tensors]}


@torch.no_grad()
def adam_step(tensors: List[torch.Tensor], grads: List[torch.Tensor],
              state: Dict[str, Any], lr: float, scale: float = 1.0,
              b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """One optax.adam step on `tensors` in place, its update scaled by
    `scale` (0 for a gated-off alter_step phase: moments and count advance
    all the same). `lr` is the schedule at the pre-increment count."""
    n = state["count"] + 1
    f32 = np.float32
    c1 = float(f32(1) - np.power(f32(b1), f32(n)))
    c2 = float(f32(1) - np.power(f32(b2), f32(n)))
    for p, g, m, v in zip(tensors, grads, state["m"], state["v"]):
        m.copy_((1 - b1) * g + b1 * m)
        v.copy_((1 - b2) * (g * g) + b2 * v)
        upd = (m / c1) / (torch.sqrt(v / c2) + eps)
        upd = upd * (-lr)
        if scale != 1.0:
            upd = upd * scale
        p.add_(upd)
    state["count"] = n


@dataclasses.dataclass
class TrainState:
    params: Dict[str, Any]          # shading MLP params (layer lists)
    cloud: NeuralPointCloud
    opt_net: Dict[str, Any]         # adam_init over the param leaves
    opt_pts: Dict[str, Any]         # adam_init over the trained point fields
    step: int = 0


def param_leaves(params: Dict[str, Any]) -> List[torch.Tensor]:
    """The parameter tensors in a fixed order (block, layer, w then b)."""
    return [layer[k] for block in sorted(params) for layer in params[block]
            for k in ("w", "b")]


def trained_fields(tcfg: TrainConfig) -> List[str]:
    return [f for f in POINT_FIELDS if tcfg.grad_switch(f)]


def create_train_state(params, cloud: NeuralPointCloud,
                       tcfg: TrainConfig) -> TrainState:
    return TrainState(
        params=params, cloud=cloud,
        opt_net=adam_init(param_leaves(params)),
        opt_pts=adam_init([getattr(cloud, f) for f in trained_fields(tcfg)]))


def phase_scales(tcfg: TrainConfig, step: int) -> Tuple[float, float]:
    if tcfg.alter_step > 0:
        phase = (step // tcfg.alter_step) % 3
        return float(phase == 0), float(phase == 1)
    return 1.0, 1.0


def step_losses(out: Dict[str, torch.Tensor], batch: Dict[str, Any],
                tcfg: TrainConfig):
    """A train step's render output -> (total, losses): --bgmodel plane's
    per-ray background, the depth mask and every loss item of tcfg; the
    gather transposes' overflow count rides the losses."""
    if "bg_ray" in batch:
        # --bgmodel plane (reference fill_invalid,
        # neural_points_volumetric_model.py:175-177): the per-ray plane
        # background replaces the constant one through the background
        # transmission
        bgc = batch.get("bg_color")
        bgc = 0.0 if bgc is None else bgc
        out = dict(out, coarse_raycolor=(
            out["coarse_raycolor"]
            + out["coarse_is_background"] * (batch["bg_ray"] - bgc)))
    if "ray_depth_mask" in batch:
        out = dict(out, ray_depth_mask=batch["ray_depth_mask"])
    total, losses = compute_losses(
        out, batch["gt_image"],
        color_loss_items=tcfg.color_loss_items,
        color_loss_weights=tcfg.color_loss_weights,
        zero_one_loss_items=tcfg.zero_one_loss_items,
        zero_one_loss_weights=tcfg.zero_one_loss_weights,
        depth_loss_items=tcfg.depth_loss_items,
        depth_loss_weights=tcfg.depth_loss_weights,
        bg_loss_items=tcfg.bg_loss_items,
        bg_loss_weights=tcfg.bg_loss_weights,
        l2_size_loss_items=tcfg.l2_size_loss_items,
        l2_size_loss_weights=tcfg.l2_size_loss_weights,
        gt_depth=batch.get("gt_depth"), gt_mask=batch.get("gt_mask"),
        sparse_loss_weight=tcfg.sparse_loss_weight,
        zero_epsilon=tcfg.zero_epsilon)
    if "gvjp_overflow" in out:
        # gather_vjp raydedup/batchdedup: the rows the transpose drops,
        # in the losses so the periodic prints show a lossy config
        losses = dict(losses, gvjp_overflow=out["gvjp_overflow"].detach()
                      .to(torch.float32))
    return total, losses


def grads_of(total, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """d total / d tensors; zeros for a tensor the loss does not reach."""
    grads = torch.autograd.grad(total, tensors, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g
            for t, g in zip(tensors, grads)]


def loss_and_grads(state: TrainState, grid, cfg: RenderConfig,
                   tcfg: TrainConfig, batch: Dict[str, torch.Tensor],
                   noise: Optional[Dict[str, torch.Tensor]] = None,
                   generator: Optional[torch.Generator] = None, pspec=None,
                   ray_mesh=None):
    """Forward, losses and backward of one step, without the update.
    Returns (losses, param grads, point grads) in the orders of
    param_leaves and trained_fields; a field the loss does not reach gets
    zeros. With `pspec` (a frustum GridSpec) the forward is the
    perspective-space path and `grid` goes unused. With `ray_mesh` (a
    ShardGroup, --ray_shards) the rays are split over its devices
    (parallel/sharded.py); the losses are computed once, on the master,
    from the joined outputs."""
    params, cloud = state.params, state.cloud
    leaves = param_leaves(params)
    fields = trained_fields(tcfg)
    pts = [getattr(cloud, f) for f in fields]
    for t in leaves + pts:
        t.requires_grad_(True)
    try:
        cam = dict(campos=batch["campos"], raydir=batch["raydir"],
                   camrotc2w=batch["camrotc2w"], near=batch["near"],
                   far=batch["far"], bg_color=batch.get("bg_color"),
                   noise=noise, generator=generator, is_train=True)
        if ray_mesh is not None:
            from ..parallel.sharded import render_rays_sharded
            out = render_rays_sharded(
                params, cloud, grid, cfg, ray_mesh, pspec=pspec,
                pixel_label=(None if pspec is not None
                             else batch.get("pixel_label")), **cam)
        elif pspec is not None:
            # --wcoord_query 0: no semantic guidance, as the reference
            # added it to the world-coordinate querier only
            out = render_rays_perspective(params, cloud, pspec, cfg, **cam)
        else:
            out = render_rays(params, cloud, grid, cfg,
                              pixel_label=batch.get("pixel_label"), **cam)
        total, losses = step_losses(out, batch, tcfg)
        grads = grads_of(total, leaves + pts)
    finally:
        for t in leaves + pts:
            t.requires_grad_(False)
    return ({k: v.detach() for k, v in losses.items()},
            grads[:len(leaves)], grads[len(leaves):])


def train_step(state: TrainState, grid, cfg: RenderConfig, tcfg: TrainConfig,
               batch: Dict[str, torch.Tensor],
               noise: Optional[Dict[str, torch.Tensor]] = None,
               generator: Optional[torch.Generator] = None, pspec=None,
               ray_mesh=None) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimization step, in place. batch: campos (B,3), raydir (B,R,3),
    camrotc2w (B,3,3), gt_image (B,R,3), near/far, bg_color (3,), optional
    gt_depth/gt_mask/ray_depth_mask (B,R) and pixel_label (B,R) int (the
    semantic-guided query's ray labels). The render noise comes from
    `noise` (render_rays' argument) or is drawn from `generator`; `pspec`
    routes the forward through the perspective-space path; `ray_mesh` (a
    ShardGroup) splits the rays over its devices. A batch's
    `bg_ray` (B,R,3), --bgmodel plane's per-ray background, replaces
    bg_color through the background transmission. Returns
    (state, losses): detached 0-d tensors, not synchronised."""
    losses, g_net, g_pts = loss_and_grads(state, grid, cfg, tcfg, batch,
                                          noise=noise, generator=generator,
                                          pspec=pspec, ray_mesh=ray_mesh)
    net_scale, pts_scale = phase_scales(tcfg, state.step)
    adam_step(param_leaves(state.params), g_net, state.opt_net,
              schedule(tcfg, tcfg.lr, state.opt_net["count"]), net_scale)
    fields = trained_fields(tcfg)
    if fields:
        adam_step([getattr(state.cloud, f) for f in fields], g_pts,
                  state.opt_pts,
                  schedule(tcfg, tcfg.plr, state.opt_pts["count"]),
                  pts_scale)
    state.step += 1
    return state, losses


def train_step_multi(state: TrainState, grid, cfg: RenderConfig,
                     tcfg: TrainConfig, batches: List[Dict[str, torch.Tensor]],
                     noises: Optional[List[Dict[str, torch.Tensor]]] = None,
                     generator: Optional[torch.Generator] = None,
                     pspec=None, ray_mesh=None):
    """G sequential train_steps (the JAX package scans them in one
    dispatch; here they are plain calls). Returns (state, [losses] * G)."""
    out = []
    for i, batch in enumerate(batches):
        state, losses = train_step(
            state, grid, cfg, tcfg, batch,
            noise=None if noises is None else noises[i], generator=generator,
            pspec=pspec, ray_mesh=ray_mesh)
        out.append(losses)
    return state, out
