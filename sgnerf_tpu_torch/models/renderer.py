"""The render: rays -> query -> gather -> aggregate -> volume march.

Counterpart of `sgnerf_tpu/models/renderer.py` (`render_rays`,
`draw_render_noise`, `gather_and_aggregate`, `_shade_and_march`; reference
NeuralPointsRayMarching.forward, neural_points_volumetric_model.py:435-668).
Rays are never compacted: a ray whose samples hit no occupied voxel gets
sigma 0 everywhere and renders to bg_color.

Training (`is_train=True`) jitters the sample depths with uniforms drawn
by `draw_render_noise` (or passed in as `noise`, so tests can feed the
noise JAX drew) and rebuilds the attribute table from the cloud's live
tensors each call: the gather's transpose is a scatter-add (`index_add_`)
into that table (the JAX package's `gather_vjp="scatter"`), or with
`gather_vjp="sorted"` a sort and segment sum in float32 (`gather_rows`).
Only a float32 table trains.

`prob=True` (the growing probes, runtime/growing.py) adds per-ray stats at
the sample of largest opacity: its opacity and position, the distance to
its nearest neighbour, and the neighbours' colour, direction, confidence
and embedding averaged with weight * conf_coefficient.

`--attr_dedup` is served by the plain row gather. The reference's
`dedup_tile_gather` is a TPU one-hot-matmul way to gather each tile's
distinct rows once; below its cap it returns exactly the rows of the plain
gather, and the plain gather has no cap to overflow.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..ops.camera import w2pers
from ..ops.grid import PointGrid
from ..ops.pallas_gather import sorted_segment_sum
from ..ops.march import (BLEND_FUNCS, RENDER_FUNCS, TONE_MAPS, ray_march,
                         ray_dist_from_z)
from ..ops.query import query_neighbors
from ..ops.raygen import near_far_linear_ray_generation
from .aggregator import AggregatorConfig, aggregate
from .point_cloud import NeuralPointCloud


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render/query configuration of the eval slice (the reference
    RenderConfig's fields that the eval render reads, same defaults)."""
    agg: AggregatorConfig = AggregatorConfig()
    z_depth_dim: int = 400           # raw samples per ray (D)
    SR: int = 24                     # shading points per ray
    K: int = 8                       # neighbours per shading point
    vsize: Tuple[float, float, float] = (0.008, 0.008, 0.008)
    radius_limit_scale: float = 4.0
    which_render_func: str = "radiance"
    which_blend_func: str = "alpha"
    which_tonemap_func: str = "off"
    raydist_mode_unit: int = 1
    knn_mode: str = "exact"          # "fused": kernel K1 (bf16 cache only);
    #                                  "dedup": kernel K6 over per-tile
    #                                  distinct cache rows (raster rays)
    dedup_tile: int = 64             # rays per dedup tile (consecutive)
    dedup_cap: int = 160             # distinct cache rows per tile
    gather_dtype: str = "float32"    # "bfloat16" attribute table
    gather_vjp: str = "scatter"      # attribute-gather transpose: "scatter"
    #                                  (index_add_) or "sorted" (gather_rows)
    compute_depth: int = 0           # emit coarse_depth
    jitter: float = 0.3              # train-time sample jitter fraction

    @property
    def radius_limit(self) -> float:
        return self.radius_limit_scale * max(self.vsize[0], self.vsize[1])


def attribute_table(cloud: NeuralPointCloud, gather_dtype: str) -> torch.Tensor:
    """Per-point attributes packed into one (N, 10+F) row table
    [xyz | embedding | color | dir | conf], in bf16 when asked: one gather
    serves every attribute."""
    packed = torch.cat([cloud.xyz, cloud.embedding, cloud.color, cloud.dir,
                        cloud.conf], dim=-1)
    return packed.to(torch.bfloat16) if gather_dtype == "bfloat16" else packed


def draw_render_noise(generator: torch.Generator, cfg: RenderConfig, B: int,
                      R: int, is_train: bool = True) -> Dict[str, torch.Tensor]:
    """Every random tensor the render forward draws, from `generator` (on
    its device): raygen_u (B,R,D) sample-depth jitter uniforms when
    training with jitter > 0. Counterpart of the JAX draw_render_noise for
    the world-coordinate, guidance-free path; the numbers differ from JAX's
    (the generators differ), so parity tests pass JAX's noise in."""
    noise: Dict[str, torch.Tensor] = {}
    if is_train and cfg.jitter > 0:
        noise["raygen_u"] = torch.rand((B, R, cfg.z_depth_dim),
                                       generator=generator,
                                       device=generator.device)
    return noise


class _GatherRows(torch.autograd.Function):
    """table[idx] whose transpose is a scatter-add, `index_add_` (the JAX
    package's default gather_vjp="scatter"). Autograd's own transpose of
    advanced indexing sorts the indices and walks each run of duplicates
    in one thread; every masked neighbour slot reads row 0, so that run
    holds most of a training batch's rows and the sort-based transpose
    took ~0.1 s a step at 1024 rays on the card. index_add_ sums the
    duplicates with atomics on CUDA (in no fixed order) and in index order
    on the CPU."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        flat = idx.reshape(-1)
        return table.index_select(0, flat).reshape(
            idx.shape + table.shape[1:])

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        flat = idx.reshape(-1)
        gt = g.new_zeros((ctx.n_rows,) + g.shape[idx.dim():])
        gt.index_add_(0, flat, g.reshape((flat.shape[0],) + gt.shape[1:]))
        return gt, None


class _GatherRowsSorted(_GatherRows):
    """table[idx] whose transpose is a sort and a float32 segment sum."""

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        flat = idx.reshape(-1)
        rows = g.reshape((flat.shape[0], -1)).to(torch.float32)
        gt = sorted_segment_sum(flat, rows, ctx.n_rows)
        return gt.reshape((ctx.n_rows,) + g.shape[idx.dim():]).to(g.dtype), \
            None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] whose transpose sorts the cotangent rows by index and sums
    each run in float32, then casts to the cotangent's dtype (the JAX
    package's `gather_rows`, `--gather_vjp sorted`): a bf16 table's
    duplicate ids are summed without bf16 rounding between terms. Unlike
    K7's transpose (`ops/pallas_gather.py`), which sums in the cotangent's
    own dtype; the two share the sort and segment step."""
    return _GatherRowsSorted.apply(table, idx)


def render_rays(params: Dict, cloud: NeuralPointCloud, grid: PointGrid,
                cfg: RenderConfig, *, campos: torch.Tensor,
                raydir: torch.Tensor, camrotc2w: torch.Tensor, near, far,
                bg_color: Optional[torch.Tensor] = None,
                table: Optional[torch.Tensor] = None,
                noise: Optional[Dict[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                is_train: bool = False,
                prob: bool = False) -> Dict[str, torch.Tensor]:
    """campos (B,3), raydir (B,R,3), camrotc2w (B,3,3) -> output dict with
    coarse_raycolor (B,R,3) and the per-sample march terms. `table` is the
    packed attribute table (eval only; built from the cloud when not given,
    and always when training). `noise` (or draws from `generator`) jitters
    the samples when `is_train`. `prob` adds the growing probes' outputs."""
    B, R, _ = raydir.shape
    if is_train and cfg.gather_dtype != "float32":
        raise NotImplementedError(
            f"training through --gather_dtype {cfg.gather_dtype} is not "
            "ported yet (ROADMAP.md, queue 1 item 17); train with float32")
    if noise is None and generator is not None:
        noise = draw_render_noise(generator, cfg, B, R, is_train=is_train)
    noise = noise or {}
    raypos, _, _, ray_ts = near_far_linear_ray_generation(
        campos, raydir, cfg.z_depth_dim, near=near, far=far,
        jitter=cfg.jitter if is_train else 0.0, u=noise.get("raygen_u"))
    # with the two-level compaction on, positions are recomputed from
    # (campos, dir, t) for the selected samples only
    q = query_neighbors(grid, raypos, K=cfg.K,
                        SR=cfg.SR, radius_limit=cfg.radius_limit,
                        knn_mode=cfg.knn_mode, campos=campos, raydir=raydir,
                        tvals=ray_ts, dedup_tile=cfg.dedup_tile,
                        dedup_cap=cfg.dedup_cap)
    if table is None or is_train:
        table = attribute_table(cloud, cfg.gather_dtype)
    return _shade_and_march(params, cloud, cfg, table, q.sample_pidx,
                            q.sample_loc_w, q.ray_mask, campos, raydir,
                            camrotc2w, bg_color, is_train, prob)


def gather_and_aggregate(params, cloud, cfg: RenderConfig, table, sample_pidx,
                         sample_loc_w, campos, raydir, camrotc2w,
                         fuse_march=False):
    """Neighbour-attribute gather + per-neighbour aggregation. Returns
    (decoded (B,R,SR,4), ray_valid, weight, conf_coefficient, sample_loc
    (perspective coords), sampled: the gathered xyz, embedding, color, dir
    and conf (B,R,SR,K,.) for the growing probes); with `fuse_march` the
    aggregation marches in kernel K5 and decoded is {"march": (B,R,4)}."""
    B, R, _ = raydir.shape
    agg = cfg.agg
    mask = sample_pidx >= 0
    pid = sample_pidx.clamp(0, cloud.capacity - 1).long()
    take = gather_rows if cfg.gather_vjp == "sorted" else _GatherRows.apply
    g = take(table, pid).to(torch.float32)
    F = cloud.embedding.shape[-1]
    # zero the padding gathers so masked rows stay finite
    sampled_xyz = g[..., 0:3] * mask[..., None]
    sampled_embedding = g[..., 3:3 + F] * mask[..., None]
    sampled_conf = g[..., 9 + F:10 + F]

    pers = torch.stack([w2pers(sampled_xyz[b].reshape(-1, 3), camrotc2w[b],
                               campos[b]) for b in range(B)]).reshape(
        sampled_xyz.shape)
    sample_loc = torch.stack([w2pers(sample_loc_w[b].reshape(-1, 3),
                                     camrotc2w[b], campos[b])
                              for b in range(B)]).reshape(sample_loc_w.shape)
    march = None
    if fuse_march:
        # the march's per-sample distances are known before aggregation
        march = {"ray_dist": ray_dist_from_z(
            sample_loc[..., 2], mask.any(dim=-1), cfg.vsize[2],
            cfg.raydist_mode_unit)}
    decoded, ray_valid, weight, conf_coefficient = aggregate(
        params, agg,
        sampled_embedding=sampled_embedding,
        sampled_conf=sampled_conf,
        sampled_xyz=sampled_xyz,
        sampled_xyz_pers=pers,
        sample_pnt_mask=mask,
        sample_loc=sample_loc,
        sample_loc_w=sample_loc_w,
        sample_ray_dirs=raydir[:, :, None, :].expand(B, R, cfg.SR, 3),
        Rw2c=cloud.Rw2c, vsize=cfg.vsize, march=march)
    sampled = {"xyz": sampled_xyz, "embedding": sampled_embedding,
               "color": g[..., 3 + F:6 + F], "dir": g[..., 6 + F:9 + F],
               "conf": sampled_conf}
    return decoded, ray_valid, weight, conf_coefficient, sample_loc, sampled


def _shade_and_march(params, cloud, cfg: RenderConfig, table, sample_pidx,
                     sample_loc_w, ray_mask, campos, raydir, camrotc2w,
                     bg_color, is_train=False, prob=False):
    """Everything downstream of the neighbour query."""
    B, R, _ = raydir.shape
    # --fused_march: shading and march in kernel K5, for eval renders of the
    # radiance/alpha/off tail the kernel implements (training and the probes
    # need the per-sample outputs)
    fuse_march = (cfg.agg.fused_march and not is_train and not prob
                  and cfg.which_render_func == "radiance"
                  and cfg.which_blend_func == "alpha"
                  and cfg.which_tonemap_func == "off"
                  and cfg.agg.act_super > 0)
    decoded, ray_valid, weight, conf_coefficient, sample_loc, sampled = \
        gather_and_aggregate(params, cloud, cfg, table, sample_pidx,
                             sample_loc_w, campos, raydir, camrotc2w,
                             fuse_march=fuse_march)
    queried_shading = (~ray_valid.any(dim=-1, keepdim=True)).to(
        torch.float32).expand(B, R, 3)
    if isinstance(decoded, dict):                 # K5 marched in-kernel
        out4 = decoded["march"]                   # (B,R,4) [colour | bgT]
        color = out4[..., :3]
        if bg_color is not None:
            color = color + torch.as_tensor(
                bg_color, dtype=out4.dtype,
                device=out4.device).reshape(-1, 1, 3) * out4[..., 3:]
        return {"coarse_raycolor": color,
                "coarse_is_background": out4[..., 3:],
                "queried_shading": queried_shading,
                "ray_mask": ray_mask, "ray_valid": ray_valid}
    ray_dist = ray_dist_from_z(sample_loc[..., 2], ray_valid, cfg.vsize[2],
                               cfg.raydist_mode_unit)
    (ray_color, _, opacity, acc_transmission, blend_weight,
     background_transmission, _) = ray_march(
        ray_dist, ray_valid, decoded, RENDER_FUNCS[cfg.which_render_func],
        BLEND_FUNCS[cfg.which_blend_func], bg_color)
    output = {
        "coarse_raycolor": TONE_MAPS[cfg.which_tonemap_func](ray_color),
        "coarse_point_opacity": opacity,                    # (B,R,SR)
        "coarse_is_background": background_transmission,    # (B,R,1)
        "queried_shading": queried_shading,
        "ray_mask": ray_mask,                               # (B,R) bool
        "ray_valid": ray_valid,
        "weight": weight.detach(),
        "blend_weight": blend_weight.detach(),
        "conf_coefficient": conf_coefficient,
    }
    if cfg.compute_depth:
        # alpha-blend-weighted mean camera-space depth (reference
        # return_depth, neural_points_volumetric_model.py:620-624)
        w = opacity * acc_transmission
        output["coarse_depth"] = ((w * sample_loc[..., 2]).sum(-1)
                                  / (w.sum(-1) + 1e-6))
    if prob:
        output.update(_probe_outputs(opacity, sample_loc_w, weight,
                                     conf_coefficient, sampled))
    return output


def _probe_outputs(opacity, sample_loc_w, weight, conf_coefficient,
                   sampled) -> Dict[str, torch.Tensor]:
    """Per ray, the growing probes' stats at its sample of largest opacity
    (reference neural_points_volumetric_model.py:633-668). The first such
    sample, as jnp.argmax picks it: torch.argmax does not promise the
    first of equal maxima on CUDA."""
    B, R, SR = opacity.shape
    max_op = opacity.max(dim=-1, keepdim=True).values       # (B,R,1)
    pos = torch.arange(SR, device=opacity.device)
    ind = torch.where(opacity == max_op, pos,
                      torch.full_like(pos, SR)).min(dim=-1).values

    def take(a):             # a (B,R,SR,...) -> (B,R,...) at sample ind
        idx = ind.reshape(B, R, 1, *([1] * (a.dim() - 3))).expand(
            B, R, 1, *a.shape[3:])
        return torch.gather(a, 2, idx)[:, :, 0]

    loc = take(sample_loc_w)                                 # (B,R,3)
    wsel = take(weight * conf_coefficient)[..., None]        # (B,R,K,1)
    far = torch.linalg.norm(take(sampled["xyz"]) - loc[:, :, None, :],
                            dim=-1).min(dim=-1, keepdim=True).values
    out = {"ray_max_shading_opacity": max_op, "ray_max_sample_loc_w": loc,
           "ray_max_far_dist": far}
    for k in ("color", "dir", "conf", "embedding"):
        out[f"shading_avg_{k}"] = (take(sampled[k]) * wsel).sum(-2)
    return out
