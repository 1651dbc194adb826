"""Ray data parallelism, `--ray_shards` (counterpart of
`sgnerf_tpu/parallel/sharded.py`).

Rays are independent in this workload: each shading point reads only its
own neighbours. The batch's ray axis is cut into one contiguous block per
shard; the point cloud, the grid and the MLP parameters are replicated
(`ShardGroup`, parallel/mesh.py), and each shard runs the whole
single-device render (kernels K1 and K2 on the card, K3 in the backward)
on its block, on its own device. The forward needs no exchange between
shards; the merged per-ray outputs come back to the master device, where
the losses are computed once, and autograd's transpose of the replication
sums the parameter and point gradients over the shards (the psum).

What is drawn at random is drawn once, at global shape, on the master
(`renderer.draw_render_noise`), then cut by rays like the batch: a sharded
render equals the unsharded one. The attribute table is built once, on the
master (stochastically rounded there with --gather_round stochastic), and
replicated: the gradient of every shard's gather reaches the one table.
Scalar outputs (the gather transposes' overflow counts) are summed over
the shards, as JAX's psum sums them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from ..models.renderer import (draw_render_noise, render_rays,
                               render_rays_perspective, step_table,
                               table_shape_of)
from ..ops.query_pers import perspective_grid
from .mesh import ShardGroup

# the render's per-ray inputs: (B,R,...) tensors cut along R
RAY_KEYS = ("raydir", "pixel_label")
# the noise's per-ray draws; sr_bits (table-shaped) is spent on the master
NOISE_RAY_KEYS = ("raygen_u", "shade_u", "guide_u")
# cloud fields a shard's render reads besides the attribute table: the
# per-neighbour rotation rows, the int8 gather's active rows and the
# guided query's labels
SHARD_CLOUD_FIELDS = ("Rw2c", "rot_idx", "active", "label", "label_prob")


def shard_batch(batch: Dict[str, Any], group: ShardGroup
                ) -> List[Dict[str, Any]]:
    """The render's inputs, one dict a shard: the per-ray ones cut along
    the ray axis, the other tensors copied, each onto its shard's device
    (differentiable)."""
    out = [dict() for _ in range(group.size)]
    for k, v in batch.items():
        if v is None or not torch.is_tensor(v):
            parts = [v] * group.size
        elif k in RAY_KEYS:
            parts = group.split_rays(v)
        else:
            parts = group.replicate(v)
        for o, p in zip(out, parts):
            o[k] = p
    return out


def shard_noise(noise: Dict[str, torch.Tensor], group: ShardGroup
                ) -> List[Dict[str, torch.Tensor]]:
    """The per-ray draws cut like the rays; the table-shaped sr_bits stay
    behind (the master's table is built from them)."""
    out = [dict() for _ in range(group.size)]
    for k, v in noise.items():
        if k in NOISE_RAY_KEYS:
            for o, p in zip(out, group.split_rays(v)):
                o[k] = p
    return out


def shard_cloud(cloud, group: ShardGroup) -> list:
    """The cloud as a shard's render reads it when it is given the table
    (and, on the perspective path, the frame grid): SHARD_CLOUD_FIELDS on
    the shard's device; the attribute fields stay on the master unread."""
    parts = {f: group.copies(getattr(cloud, f)) for f in SHARD_CLOUD_FIELDS}
    return [dataclasses.replace(cloud, **{f: p[i] for f, p in parts.items()})
            for i in range(group.size)]


def render_rays_sharded(params, cloud, grid, cfg, group: ShardGroup, *,
                        campos, raydir, camrotc2w, near, far, bg_color=None,
                        table: Optional[torch.Tensor] = None,
                        pixel_label=None,
                        noise: Optional[Dict[str, torch.Tensor]] = None,
                        generator: Optional[torch.Generator] = None,
                        pspec=None, pgrid=None, is_train: bool = False,
                        prob: bool = False) -> Dict[str, torch.Tensor]:
    """`render_rays` (or, with `pspec`, `render_rays_perspective` on the
    frame grid `pgrid`, built here when not given) with the ray axis split
    over `group`. Inputs and outputs lie on the master device: per-ray
    outputs are joined along the rays, 0-d ones summed. `noise` (drawn at
    global shape) or `generator` as for render_rays."""
    B, R, _ = raydir.shape
    use_sem = (bool(cfg.semantic_guidance) and is_train and pspec is None
               and pixel_label is not None)
    if noise is None and generator is not None:
        noise = draw_render_noise(generator, cfg, B, R, is_train=is_train,
                                  grid=grid, guidance=use_sem,
                                  perspective=pspec is not None,
                                  table_shape=table_shape_of(cloud, cfg))
    noise = noise or {}
    if table is None:
        table = step_table(cloud, cfg, noise, is_train)
    if pspec is not None and pgrid is None:
        pgrid = perspective_grid(cloud.xyz, cloud.active, camrotc2w[0],
                                 campos[0], pspec)[0]
    inputs = {"campos": campos, "raydir": raydir, "camrotc2w": camrotc2w,
              "bg_color": bg_color,
              "pixel_label": pixel_label if use_sem else None}
    shards = zip(shard_batch(inputs, group), shard_noise(noise, group),
                 group.replicate_tree(params), group.replicate(table),
                 shard_cloud(cloud, group),
                 group.replicate_tree(pgrid if pspec is not None else grid,
                                      grad=False))
    outs = []
    for kw, nz, p, tab, c, g in shards:
        if pspec is not None:
            kw.pop("pixel_label")
            outs.append(render_rays_perspective(
                p, c, pspec, cfg, near=near, far=far, table=tab, noise=nz,
                is_train=is_train, pgrid=g, **kw))
        else:
            outs.append(render_rays(p, c, g, cfg, near=near, far=far,
                                    table=tab, noise=nz, is_train=is_train,
                                    prob=prob, **kw))
    return merge_ray_outputs(outs, group)


def merge_ray_outputs(outs: List[Dict[str, torch.Tensor]],
                      group: ShardGroup) -> Dict[str, torch.Tensor]:
    """Per-shard output dicts -> one on the master: 0-d entries summed in
    shard order, the rest joined along the ray axis."""
    return {k: (group.psum([o[k] for o in outs]) if v.dim() == 0
                else group.cat_rays([o[k] for o in outs]))
            for k, v in outs[0].items()}
