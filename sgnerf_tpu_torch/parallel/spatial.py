"""Slab-sharded scenes, `--scene_shards` (counterpart of
`sgnerf_tpu/parallel/spatial.py`).

The scene (point attributes, voxel grid, neighbourhood cache) is cut into
slabs of voxels along x, one a shard, each widened by a halo that covers
the query kernel, and each shard's part lives on its own device
(`ShardGroup`, parallel/mesh.py). A slab's grid is a window of the global
grid: its points are binned in the global voxels, so over the voxels it
owns its tables and cache rows are the global grid's (the JAX package
bins them shifted by x_off * vsize in float32, which rounds the cache
offsets otherwise). A render then:

  1. unites the shards' hit masks of the ray samples (each tests its own
     dilated occupancy) on the master, so every shard compacts the same
     shading points;
  2. each shard queries, gathers and shades only the shading points whose
     voxel it owns (the slab interval along x: disjoint), through the
     kernels the one-device path runs (K1 on a bf16 cache, K2, and K3 in
     the backward), zeros elsewhere;
  3. sums the shards' decoded features and weights onto the master in
     shard order (`ShardGroup.psum`: ownership is disjoint, so the sum is
     the gather) and marches once, there.

The march and the losses run once, on the master; autograd's transpose of
the `.to()` copies hands each shard the cotangent once, which is what the
JAX package's identity-transpose `_merge` exists to get (a march on every
shard, summed, would scale every gradient by the shard count).

Training adds the halo gradient sync: a point in a halo lives on two
shards, and its gradient is the sum over its copies, scatter-added at
global ids into an (n_global, C) buffer, summed over the shards and
gathered back, so both copies take the same Adam step. Each shard keeps its
own point Adam; the MLP parameters and their Adam live on the master and
are replicated into each step. xyz must stay frozen (moving points would
invalidate the slabs), and frozen fields carry no gradient.

The perspective path (`--wcoord_query 0`) rebuilds each shard's frame
grid from its slab's points, over a halo wide enough for the perspective
kernel (`perspective_halo_voxels`). It queries at the shading points
before their train-time depth jitter and shades at the jittered ones, as
the one-device path does (the JAX package's sharded path queries at the
jittered points).

Randomness is drawn once at global shape on the master
(renderer.draw_render_noise): a sharded render equals the unsharded one.
--gather_round stochastic is not applied here (the shards' tables round to
nearest), as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..models.aggregator import gradient_clamp
from ..models.point_cloud import NeuralPointCloud
from ..models.renderer import (RenderConfig, attribute_table,
                               draw_render_noise, gather_and_aggregate,
                               ray_samples)
from ..models.train import (TrainConfig, adam_init, adam_step, grads_of,
                            param_leaves, phase_scales, schedule,
                            step_losses, trained_fields)
from ..ops.camera import pers2w, w2pers
from ..ops.fused_knn import fused_knn_select
from ..ops.grid import (GridSpec, build_grid_core, build_nbr_cache,
                        build_point_grid, clip_coords, coarse_occupancy,
                        const, in_bounds, kept_points, take3d,
                        voxel_coords)
from ..ops.march import (BLEND_FUNCS, RENDER_FUNCS, TONE_MAPS,
                         ray_dist_from_z, ray_march)
from ..ops.query import (bucket_candidates, cache_candidates, compact_hits,
                         guide_accept, radius2, select_k, two_level_compact)
from .mesh import ShardGroup


@dataclasses.dataclass(frozen=True)
class SpatialSpec:
    """The decomposition's static geometry."""
    gspec: GridSpec          # the global grid's spec
    n_shards: int
    slab_w: int              # owned voxels along x a shard (the last may
    #                          own fewer)
    halo: int                # extra voxels on each side of the slab
    cap_pts: int             # rows a shard (halo included, bucketed)
    max_o_s: int             # occupied voxels a shard's grid tracks
    max_d_s: int             # cache rows a shard
    n_global: int = 0        # the cloud's capacity (halo gradient sync)

    @property
    def Lx(self) -> int:
        return self.slab_w + 2 * self.halo

    @property
    def lspec(self) -> GridSpec:
        """A shard's build and query spec: the global spec windowed to Lx
        voxels along x (its voxels are the global grid's moved by -x_off,
        `build_grid_core`'s x_off, so one spec serves every shard)."""
        return dataclasses.replace(
            self.gspec, vdim=(self.Lx, self.gspec.vdim[1],
                              self.gspec.vdim[2]),
            max_o=self.max_o_s, coarse_factor=0)


@dataclasses.dataclass
class SceneShard:
    """One slab on its device."""
    cloud: NeuralPointCloud    # cap_pts rows: the slab's points, halo too
    occ_mask: torch.Tensor     # (Lx,Y,Z) uint8 dilated occupancy
    dil_slot: torch.Tensor     # (Lx,Y,Z) int32 cache slot or -1
    nbr_packed: torch.Tensor   # (max_d_s, C*W) int16 cache rows
    gid: torch.Tensor          # (cap_pts,) int64 row -> global point id
    #                            (padding rows: n_global)
    n_rows: int                # the slab's points (rows past are padding)
    x_off: int                 # global x voxel of local x = 0
    own_lo: int                # ownership interval [own_lo, own_hi)
    own_hi: int
    holds_point0: bool = False  # local row 0 is global point 0


@dataclasses.dataclass
class ShardedScene:
    shards: List[SceneShard]
    group: ShardGroup
    conf0: float = 1.0         # global point 0's conf (no shard holds it)
    # world scenes with the two-level compaction (gspec.coarse_factor > 1):
    # the global supervoxel table, on the master
    coarse_occ: Optional[torch.Tensor] = None
    # perspective scenes: the whole cloud's xyz and active (the cloud's
    # own tensors), to keep the points the unsharded frame grid keeps
    points: Optional[tuple] = None


def _round_up(v: int, b: int) -> int:
    return max(b, ((v + b - 1) // b) * b)


def plan_sharded_scene(xyz: np.ndarray, active: np.ndarray,
                       gspec: GridSpec, n_shards: int, capacity: int, *,
                       pts_bucket: int = 4096, vox_bucket: int = 8192,
                       halo_override: Optional[int] = None,
                       need_tables: bool = True):
    """Host-side (numpy) slab planning: each shard's point selection and
    the capacities, without building a table. Returns (SpatialSpec, sels),
    sels[i] the global ids of shard i's points (halo included), ascending.

    The cache rows a shard needs are its dilated voxels inside its local
    window (Lx, Y, Z), cells outside the global grid included: the shard's
    build dilates over the whole window (the JAX package's round-5 sizing).
    They are counted as a dense window's box dilation (the JAX package
    enumerates and np.unique's the dilated cells: the same count).
    need_tables=False (perspective-only scenes) sizes no world table: the
    window is not counted at all."""
    from scipy.ndimage import maximum_filter
    if need_tables:
        assert gspec.nbr_cache > 0, "sharded rendering requires the nbr cache"
    xyz = np.asarray(xyz)
    active = np.asarray(active)
    X, Y, Z = gspec.vdim
    vsx = gspec.vsize[0]
    minx = gspec.min_corner[0]
    gx = np.floor((xyz[:, 0] - minx) / vsx).astype(np.int64)

    halo = max(max(gspec.kernel_size), max(gspec.dilate)) // 2 + 1
    if halo_override is not None:
        # the perspective querier needs a wider halo than the world kernel
        halo = max(halo, int(halo_override))
    slab_w = (X + n_shards - 1) // n_shards
    Lx = slab_w + 2 * halo

    voxel = np.stack([gx, np.floor((xyz[:, 1] - gspec.min_corner[1])
                                   / gspec.vsize[1]).astype(np.int64),
                      np.floor((xyz[:, 2] - gspec.min_corner[2])
                               / gspec.vsize[2]).astype(np.int64)], -1)
    inb = active & (gx >= 0) & (gx < X) \
        & (voxel[:, 1] >= 0) & (voxel[:, 1] < Y) \
        & (voxel[:, 2] >= 0) & (voxel[:, 2] < Z)
    box = tuple(2 * (np.asarray(gspec.dilate) // 2) + 1)
    sels, occ_counts, dil_counts = [], [], []
    for i in range(n_shards):
        lo = i * slab_w
        sel = np.nonzero(inb & (gx >= lo - halo)
                         & (gx < lo + slab_w + halo))[0]
        sels.append(sel)
        if len(sel) and need_tables:
            v = voxel[sel]
            occ = np.zeros((Lx, Y, Z), np.uint8)
            occ[v[:, 0] - (lo - halo), v[:, 1], v[:, 2]] = 1
            occ_counts.append(int(occ.sum()))
            dil_counts.append(int(np.count_nonzero(maximum_filter(
                occ, size=box, mode="constant", cval=0))))
        else:
            occ_counts.append(1)
            dil_counts.append(1)

    cap_pts = _round_up(max(len(s) for s in sels), pts_bucket)
    return SpatialSpec(gspec=gspec, n_shards=n_shards, slab_w=slab_w,
                       halo=halo, cap_pts=cap_pts,
                       max_o_s=_round_up(max(occ_counts), vox_bucket),
                       max_d_s=_round_up(max(dil_counts), vox_bucket),
                       n_global=capacity), sels


def _slab_cloud(cloud: NeuralPointCloud, sel: torch.Tensor, cap_pts: int,
                dev) -> NeuralPointCloud:
    """The cloud's rows `sel`, padded to cap_pts rows (xyz 1e9, inactive),
    on `dev`."""
    n = sel.shape[0]

    def take(a, fill=0):
        out = torch.full((cap_pts,) + tuple(a.shape[1:]), fill,
                         dtype=a.dtype, device=a.device)
        out[:n] = a[sel]
        return out.to(dev)
    fields = {f.name: take(getattr(cloud, f.name))
              for f in dataclasses.fields(cloud)
              if f.name not in ("xyz", "active", "n_active", "Rw2c")}
    return NeuralPointCloud(
        xyz=take(cloud.xyz, 1e9), active=take(cloud.active, False),
        n_active=torch.tensor(n, dtype=torch.int32, device=dev),
        Rw2c=cloud.Rw2c.detach().to(dev, copy=True), **fields)


@torch.no_grad()
def build_sharded_scene(cloud: NeuralPointCloud, gspec: GridSpec,
                        n_shards: int, *, devices=None,
                        pts_bucket: int = 4096, vox_bucket: int = 8192,
                        halo_override: Optional[int] = None,
                        build_tables: bool = True):
    """Cut `cloud` into n_shards x-slabs (plan_sharded_scene) and build each
    slab's grid and cache on its device (`devices`, default the cloud's,
    n_shards times) with the one-device build (ops/grid.py) on the shared
    local spec. build_tables=False (perspective-only scenes) builds no world
    table: each frame builds a shard's frame grid. Returns (ShardedScene,
    SpatialSpec)."""
    src = cloud.xyz.device
    group = ShardGroup(devices if devices is not None else [src] * n_shards)
    if group.size != n_shards:
        raise ValueError(f"{n_shards} shards on {group.size} devices")
    active = cloud.active
    if build_tables:
        # the points of occupied voxels past the global grid's max_o stay
        # out of the slabs, as they stay out of the unsharded grid (a slab
        # grid, sized to all its own voxels, would keep them)
        active = active & kept_points(cloud.xyz, active, gspec)
    sspec, sels = plan_sharded_scene(
        cloud.xyz.cpu().numpy(), active.cpu().numpy(), gspec,
        n_shards, cloud.capacity, pts_bucket=pts_bucket,
        vox_bucket=vox_bucket, halo_override=halo_override,
        need_tables=build_tables)
    X = gspec.vdim[0]
    lspec = sspec.lspec
    shards = []
    for i, dev in enumerate(group.devices):
        lo = i * sspec.slab_w
        x_off = lo - sspec.halo
        sel = torch.as_tensor(sels[i], dtype=torch.int64, device=src)
        lcloud = _slab_cloud(cloud, sel, sspec.cap_pts, dev)
        if build_tables:
            # binned in the global grid's voxels, moved by -x_off voxels:
            # the rows of the voxels a slab owns are the global grid's
            lgrid = build_grid_core(lcloud.xyz, lcloud.active, lspec,
                                    x_off=x_off)
            dil_slot, nbr_packed = build_nbr_cache(lgrid, lspec,
                                                   sspec.max_d_s, x_off)
            occ_mask = lgrid.occ_mask
            del lgrid
        else:
            occ_mask = torch.zeros((0, 0, 0), dtype=torch.uint8, device=dev)
            dil_slot = torch.zeros((0, 0, 0), dtype=torch.int32, device=dev)
            nbr_packed = torch.zeros((0, 0), dtype=torch.int16, device=dev)
        gid = torch.full((sspec.cap_pts,), sspec.n_global,
                         dtype=torch.int64, device=dev)
        gid[:len(sels[i])] = sel.to(dev)
        shards.append(SceneShard(
            cloud=lcloud, occ_mask=occ_mask, dil_slot=dil_slot,
            nbr_packed=nbr_packed, gid=gid, n_rows=len(sels[i]),
            x_off=x_off, own_lo=lo, own_hi=min(lo + sspec.slab_w, X),
            holds_point0=bool(len(sels[i]) and sels[i][0] == 0)))
    coarse = None
    if build_tables and gspec.coarse_factor > 1:
        # the global dilated occupancy is the shards' owned slices of
        # theirs (a halo covers the dilation), pooled as the grid pools it
        occ = torch.cat([s.occ_mask[max(0, s.own_lo - s.x_off):
                                    max(0, s.own_hi - s.x_off)]
                         .to(group.master) for s in shards])
        coarse = coarse_occupancy(occ, gspec.coarse_factor)
    return ShardedScene(
        shards=shards, group=group, conf0=float(cloud.conf[0, 0]),
        coarse_occ=coarse,
        points=None if build_tables else (cloud.xyz.detach(),
                                          cloud.active)), sspec


def draw_spatial_noise(generator: torch.Generator, cfg: RenderConfig,
                       gspec: GridSpec, B: int, R: int, is_train: bool,
                       guidance: bool = False, perspective: bool = False):
    """draw_render_noise's draws for a sharded render, in its order: the
    guided query's uniforms over the cache path's C candidates; no sr_bits
    (the shards' tables round to nearest)."""
    noise = draw_render_noise(generator, cfg, B, R, is_train=is_train,
                              perspective=perspective)
    if guidance and not perspective:
        noise["guide_u"] = torch.rand((B, R, cfg.SR, gspec.nbr_cache),
                                      generator=generator,
                                      device=generator.device)
    return noise


def _local_hits(shard: SceneShard, sspec: SpatialSpec, raypos):
    """A shard's dilated occupancy at the samples (B,R,D,3)."""
    gspec, lspec = sspec.gspec, sspec.lspec
    c = voxel_coords(raypos, gspec)
    lc = c - const((shard.x_off, 0, 0), torch.int64, c.device)
    occ = take3d(shard.occ_mask, clip_coords(lc, lspec.vdim), lspec.vdim) > 0
    return in_bounds(c, gspec) & in_bounds(lc, lspec) & occ


def _local_query(shard: SceneShard, sspec: SpatialSpec, cfg: RenderConfig,
                 sample_loc_w, smask, sample_label=None, guide_u=None):
    """A shard's cache query, restricted to the shading points it owns
    (ops/query.query_neighbors' cache path on the slab's tables, the
    semantic-guidance predicate over its local candidates included).
    Returns (local ids (B,R,SR,K) int32, own (B,R,SR))."""
    gspec, lspec = sspec.gspec, sspec.lspec
    B, R, SR, _ = sample_loc_w.shape
    dev = sample_loc_w.device
    c = voxel_coords(sample_loc_w, gspec)                  # global
    own = (smask & (c[..., 0] >= shard.own_lo) & (c[..., 0] < shard.own_hi)
           & in_bounds(c, gspec))
    lc = c - const((shard.x_off, 0, 0), torch.int64, dev)
    slot = take3d(shard.dil_slot, clip_coords(lc, lspec.vdim), lspec.vdim)
    slot_ok = own & (slot >= 0)
    rows = shard.nbr_packed[slot.clamp(0, sspec.max_d_s - 1).long()]
    center = ((c.to(torch.float32) + 0.5) * gspec.vsize_t(dev)
              + gspec.min_corner_t(dev))
    r2 = radius2(cfg.radius_limit)
    guided = sample_label is not None
    if (cfg.knn_mode == "fused" and not guided
            and lspec.cache_dtype == "bfloat16"):
        Mq = B * R * SR
        sel = fused_knn_select(
            rows.reshape(Mq, -1), (sample_loc_w - center).reshape(Mq, 3),
            slot_ok.reshape(Mq), r2, C=rows.shape[-1] // 5, K=cfg.K)
        return sel.reshape(B, R, SR, cfg.K), own
    cand, cand_ok, d2, flat_shape = cache_candidates(
        rows, center, sample_loc_w, slot_ok, lspec)
    if guided:
        cand_ok = cand_ok & guide_accept(cand, sample_label,
                                         shard.cloud.label,
                                         shard.cloud.label_prob, guide_u)
    return select_k(cand, cand_ok, d2, flat_shape, cfg.K, r2), own


def _shard_table(shard: SceneShard, cfg: RenderConfig, is_train: bool):
    return attribute_table(shard.cloud, cfg.gather_dtype,
                           bool(cfg.semantic_guidance), is_train)


def _shade_owned(params_r, scene: ShardedScene, cfg: RenderConfig, tables,
                 pidx_own, loc_w, campos, raydir, camrotc2w, is_train):
    """Each shard shades its owned shading points; the decoded features,
    weights and confidences summed onto the master in shard order. Returns
    (decoded, ray_valid, weight, conf_coefficient, sample_loc, overflow
    or None).

    A neighbour slot that holds no point gathers row 0 on the one-device
    path, so its conf_coefficient (which the zero-one loss reads) is global
    point 0's conf; a shard's row 0 is another point. Such slots, and the
    slots no shard owns, take point 0's conf here, from the first shard
    holding it (its gradient then reaches every copy through the halo
    sync), so the merged confidences are the unsharded ones. The JAX
    package's sharded forward leaves the unowned slots at 0 and the owned
    empty ones at its shards' row 0."""
    group = scene.group
    dec, wts, confs, valids, slots, overs = [], [], [], [], [], []
    sample_loc = conf0 = None
    for i, (shard, dev) in enumerate(zip(scene.shards, group.devices)):
        pidx, own = pidx_own[i]
        table = (tables[i] if tables is not None
                 else _shard_table(shard, cfg, is_train))
        decoded, ray_valid, weight, conf, sloc, sampled = \
            gather_and_aggregate(params_r[i], shard.cloud, cfg, table, pidx,
                                 loc_w[i], campos[i], raydir[i],
                                 camrotc2w[i], is_train=is_train)
        ownf = own.to(decoded.dtype)
        dec.append(decoded * ownf[..., None])
        wts.append(weight * ownf[..., None])
        slot = own[..., None] & (pidx >= 0)
        confs.append(torch.where(slot, conf, torch.zeros_like(conf)))
        slots.append(slot.to(conf.dtype))
        valids.append((ray_valid & own).to(torch.int32))
        if "gvjp_overflow" in sampled:
            overs.append(sampled["gvjp_overflow"])
        if i == 0:
            sample_loc = sloc.to(group.master)
        if conf0 is None and shard.holds_point0:
            F = shard.cloud.embedding.shape[-1]
            conf0 = table[0, 9 + F].to(torch.float32).to(group.master)
    if conf0 is None:           # no shard holds point 0: its conf as is
        dt = (tables[0].dtype if tables is not None else
              torch.bfloat16 if cfg.gather_dtype == "bfloat16"
              else torch.float32)
        conf0 = const((scene.conf0,), torch.float32, group.master).to(
            dt).to(torch.float32)[0]
    conf = group.psum(confs) + (1.0 - group.psum(slots)) * \
        gradient_clamp(conf0)
    return (group.psum(dec), group.psum(valids) > 0, group.psum(wts),
            conf, sample_loc, group.psum(overs) if overs else None)


def _march(cfg: RenderConfig, decoded, ray_valid, weight, conf, sample_loc,
           bg_color, overflow) -> Dict[str, torch.Tensor]:
    """The volume march once, on the master, over the merged shards."""
    B, R = ray_valid.shape[:2]
    ray_dist = ray_dist_from_z(sample_loc[..., 2], ray_valid, cfg.vsize[2],
                               cfg.raydist_mode_unit)
    (ray_color, _, opacity, acc_transmission, blend_weight,
     background_transmission, _) = ray_march(
        ray_dist, ray_valid, decoded, RENDER_FUNCS[cfg.which_render_func],
        BLEND_FUNCS[cfg.which_blend_func], bg_color)
    out = {
        "coarse_raycolor": TONE_MAPS[cfg.which_tonemap_func](ray_color),
        "coarse_point_opacity": opacity,
        "coarse_is_background": background_transmission,
        "queried_shading": (~ray_valid.any(dim=-1, keepdim=True)).to(
            torch.float32).expand(B, R, 3),
        "ray_mask": ray_valid.any(dim=-1),
        "ray_valid": ray_valid,
        "weight": weight.detach(),
        "blend_weight": blend_weight.detach(),
        "conf_coefficient": conf,
    }
    if overflow is not None:
        out["gvjp_overflow"] = overflow
    if cfg.compute_depth:
        w = opacity * acc_transmission
        out["coarse_depth"] = ((w * sample_loc[..., 2]).sum(-1)
                               / (w.sum(-1) + 1e-6))
    return out


def _inputs(group: ShardGroup, campos, raydir, camrotc2w):
    return (group.copies(campos), group.copies(raydir),
            group.copies(camrotc2w))


def render_rays_spatial(params: Dict[str, Any], scene: ShardedScene,
                        sspec: SpatialSpec, cfg: RenderConfig, *,
                        campos, raydir, camrotc2w, near, far,
                        bg_color: Optional[torch.Tensor] = None,
                        pixel_label: Optional[torch.Tensor] = None,
                        noise: Optional[Dict[str, torch.Tensor]] = None,
                        generator: Optional[torch.Generator] = None,
                        is_train: bool = False,
                        tables: Optional[List[torch.Tensor]] = None
                        ) -> Dict[str, torch.Tensor]:
    """The world-grid render over the slab-sharded scene: render_rays' output
    on the equivalent unsharded scene, on the master device (semantic
    guidance included when training with `pixel_label` and cfg asks for
    it). `noise` (global shape) or `generator` as for render_rays; `tables`
    the shards' eval attribute tables (built from the shards' clouds when
    not given)."""
    group = scene.group
    gspec = sspec.gspec
    B, R, _ = raydir.shape
    use_sem = (bool(cfg.semantic_guidance) and is_train
               and pixel_label is not None)
    if noise is None and generator is not None:
        noise = draw_spatial_noise(generator, cfg, gspec, B, R, is_train,
                                   guidance=use_sem)
    noise = noise or {}
    raypos, _ = ray_samples(cfg, campos, raydir, near, far, noise, is_train)

    # (1) the shards' hit masks united -> one compaction (two-level with
    # the global supervoxel table when the grid has one, as unsharded)
    hits = [_local_hits(s, sspec, rp).to(torch.int32)
            for s, rp in zip(scene.shards, group.copies(raypos))]
    hit = group.psum(hits) > 0
    if scene.coarse_occ is not None:
        smask, gather_d = two_level_compact(hit, raypos, gspec,
                                            scene.coarse_occ, cfg.SR)
    else:
        smask, gather_d = compact_hits(hit, cfg.SR)
    loc = torch.gather(raypos, 2, gather_d[..., None].expand(-1, -1, -1, 3))
    loc_w = torch.where(smask[..., None], loc, torch.zeros_like(loc))

    # (2) each shard queries its owned shading points
    label = guide = [None] * group.size
    if use_sem:
        label = group.copies(torch.where(
            smask, pixel_label[..., None].to(torch.int32),
            torch.zeros((), dtype=torch.int32, device=smask.device)))
        guide = group.copies(noise["guide_u"])
    loc_r, smask_r = group.copies(loc_w), group.copies(smask)
    pidx_own = [_local_query(s, sspec, cfg, loc_r[i], smask_r[i], label[i],
                             guide[i])
                for i, s in enumerate(scene.shards)]

    # (3) shade, merge, march
    merged = _shade_owned(group.replicate_tree(params), scene, cfg, tables,
                          pidx_own, loc_r,
                          *_inputs(group, campos, raydir, camrotc2w),
                          is_train)
    return _march(cfg, *merged[:5], bg_color, merged[5])


def perspective_halo_voxels(gspec: GridSpec, pspec: GridSpec) -> int:
    """World voxels of halo that make the slabs enough for the perspective
    querier: its kernel accepts neighbours within (kernel_size // 2 + 1)
    perspective voxels a axis; a perspective displacement (dpx, dpy, dpz)
    bounds the camera-space one by |dX| <= dpx * far + |x/z|max * dpz
    (likewise Y; |dZ| = dpz), with far and the tan-angle extents read off
    the frustum spec; rotation keeps lengths, so ceil(|d| / vsize) + 1
    world voxels cover every owned shading point's neighbours."""
    vs = np.asarray(pspec.vsize, np.float64)
    ks = np.asarray(pspec.kernel_size, np.int64)
    d = (ks // 2 + 1) * vs
    mn = np.asarray(pspec.min_corner, np.float64)
    mx = mn + np.asarray(pspec.vdim, np.float64) * vs
    far = mx[2]
    tanx = max(abs(mn[0]), abs(mx[0]))
    tany = max(abs(mn[1]), abs(mx[1]))
    dx = d[0] * far + tanx * d[2]
    dy = d[1] * far + tany * d[2]
    dw = float(np.sqrt(dx * dx + dy * dy + d[2] * d[2]))
    return int(np.ceil(dw / gspec.vsize[0])) + 1


def render_rays_spatial_perspective(
        params: Dict[str, Any], scene: ShardedScene, sspec: SpatialSpec,
        pspec: GridSpec, cfg: RenderConfig, *, campos, raydir, camrotc2w,
        near, far, bg_color: Optional[torch.Tensor] = None,
        noise: Optional[Dict[str, torch.Tensor]] = None,
        generator: Optional[torch.Generator] = None, is_train: bool = False,
        tables: Optional[List[torch.Tensor]] = None,
        pgrids: Optional[list] = None) -> Dict[str, torch.Tensor]:
    """The perspective-space render (--wcoord_query 0) over the slab-sharded
    scene (built with halo_override=perspective_halo_voxels(...)): each
    shard builds the frame grid of its slab's points in camera 0's
    perspective space (`pgrids`: those grids, built once for a frame's
    chunks), the hit masks are united, each shard queries its owned
    shading points (the owner of a shading point's world x voxel, clamped
    to the grid) and shades them; the merged features march on the
    master."""
    group = scene.group
    gspec = sspec.gspec
    B, R, _ = raydir.shape
    if noise is None and generator is not None:
        noise = draw_spatial_noise(generator, cfg, gspec, B, R, is_train,
                                   perspective=True)
    noise = noise or {}
    if pgrids is None:
        pgrids = frame_grids(scene, pspec, campos, camrotc2w)
    raypos, _ = ray_samples(cfg, campos, raydir, near, far, noise, is_train)
    raypos_p = w2pers(raypos.reshape(-1, 3), camrotc2w[0],
                      campos[0]).reshape(raypos.shape)

    # (1) hit masks united -> one compaction
    hits = []
    for g, rp in zip(pgrids, group.copies(raypos_p)):
        c = voxel_coords(rp, pspec)
        occ = take3d(g.occ_mask, clip_coords(c, pspec.vdim), pspec.vdim) > 0
        hits.append((in_bounds(c, pspec) & occ).to(torch.int32))
    smask, gather_d = compact_hits(group.psum(hits) > 0, cfg.SR)
    loc_p = torch.gather(raypos_p, 2,
                         gather_d[..., None].expand(-1, -1, -1, 3))
    loc_p = torch.where(smask[..., None], loc_p, torch.zeros_like(loc_p))

    def to_world(p):
        w = pers2w(p.reshape(-1, 3), camrotc2w[0], campos[0]).reshape(p.shape)
        return torch.where(smask[..., None], w, torch.zeros_like(w))

    # (2) owner: the shading point's world x voxel, clamped to the grid
    X = gspec.vdim[0]
    gx = torch.floor((to_world(loc_p)[..., 0] - gspec.min_corner[0])
                     / gspec.vsize[0]).to(torch.int64).clamp(0, X - 1)
    r2 = radius2(cfg.radius_limit)
    pidx_own = []
    for s, g, lp, sm, x in zip(scene.shards, pgrids, group.copies(loc_p),
                               group.copies(smask), group.copies(gx)):
        own = sm & (x >= s.own_lo) & (x < s.own_hi)
        cand, cand_ok, d2, flat_shape = bucket_candidates(g, lp, sm)
        cand_ok = cand_ok & own[..., None, None]
        pidx_own.append((select_k(cand, cand_ok, d2, flat_shape, cfg.K, r2),
                         own))

    # the train-time shading-point depth jitter, after the query
    shade_u = noise.get("shade_u")
    if is_train and shade_u is not None and cfg.shpnt_jitter in (
            "uniform", "gaussian"):
        vz = pspec.vsize[2]
        j = ((shade_u - 0.5) * vz if cfg.shpnt_jitter == "uniform"
             else torch.clamp(shade_u * (vz / 4), -vz / 2, vz / 2))
        j = torch.where(smask, j, torch.zeros_like(j))
        loc_p = torch.cat([loc_p[..., :2], loc_p[..., 2:] + j[..., None]],
                          dim=-1)

    # (3) shade, merge, march
    merged = _shade_owned(group.replicate_tree(params), scene, cfg, tables,
                          pidx_own, group.copies(to_world(loc_p)),
                          *_inputs(group, campos, raydir, camrotc2w),
                          is_train)
    return _march(cfg, *merged[:5], bg_color, merged[5])


def frame_grids(scene: ShardedScene, pspec: GridSpec, campos, camrotc2w):
    """Each shard's frame grid: its slab's points in camera 0's perspective
    space, those of them the whole cloud's frame grid keeps (the first
    max_o occupied frustum voxels in voxel order, the first P points of
    each): a slab's grid over all its points would count only its own
    voxels against max_o and keep others than the unsharded grid."""
    group = scene.group
    keep = None
    if scene.points is not None:
        xyz, active = scene.points
        keep = kept_points(w2pers(xyz, camrotc2w[0].to(xyz.device),
                                  campos[0].to(xyz.device)), active, pspec)
    out = []
    for s, cp, rot, dev in zip(scene.shards, group.copies(campos),
                               group.copies(camrotc2w), group.devices):
        act = s.cloud.active
        if keep is not None:
            n = keep.shape[0]
            act = act & keep[s.gid.clamp(max=n - 1).to(keep.device)].to(dev)
        out.append(build_point_grid(w2pers(s.cloud.xyz, rot[0], cp[0]), act,
                                    pspec))
    return out


# --------------------------------------------------------------- training

@dataclasses.dataclass
class SpatialTrainState:
    """Training state of a slab-sharded scene: the MLP parameters and their
    Adam on the master (shared with the caller's TrainState, updated in
    place), the scene whose shard clouds train in place, one point Adam a
    shard."""
    params: Dict[str, Any]
    scene: ShardedScene
    opt_net: Dict[str, Any]
    opt_pts: List[Dict[str, Any]]
    step: int = 0


def create_spatial_train_state(params, scene: ShardedScene,
                               tcfg: TrainConfig, opt_net=None,
                               step: int = 0) -> SpatialTrainState:
    fields = trained_fields(tcfg)
    return SpatialTrainState(
        params=params, scene=scene,
        opt_net=(opt_net if opt_net is not None
                 else adam_init(param_leaves(params))),
        opt_pts=[adam_init([getattr(s.cloud, f) for f in fields])
                 for s in scene.shards],
        step=step)


def _halo_sync(scene: ShardedScene, n_global: int, grads):
    """Per-shard gradients of one field -> each row the sum over every
    shard's copy of its point: scatter-add at global ids into an
    (n_global, C) buffer on the master, summed over the shards in order,
    gathered back."""
    group = scene.group
    buf = None
    for s, g in zip(scene.shards, grads):
        flat = g.reshape(g.shape[0], -1)
        part = flat.new_zeros((n_global + 1, flat.shape[1]))
        part.index_add_(0, s.gid, flat)          # ids unique a shard
        part = part[:n_global].to(group.master)
        buf = part if buf is None else buf + part
    return [buf[s.gid.to(group.master).clamp(max=n_global - 1)]
            .to(d).reshape(g.shape)
            for s, g, d in zip(scene.shards, grads, group.devices)]


def spatial_train_step(st: SpatialTrainState, sspec: SpatialSpec,
                       cfg: RenderConfig, tcfg: TrainConfig,
                       batch: Dict[str, Any],
                       noise: Optional[Dict[str, torch.Tensor]] = None,
                       generator: Optional[torch.Generator] = None,
                       pspec=None, return_grads: bool = False):
    """One train step on a slab-sharded scene, in place: the forward of
    render_rays_spatial (or, with `pspec`, the perspective one), the
    losses once on the master (models/train.step_losses), the parameter
    gradient summed over the shards by autograd, the halo gradient sync of
    each trained field, both Adams and alter_step as train_step. Matches
    train_step on the equivalent unsharded scene. Returns (st, losses)
    and, with return_grads, (param grads, [per-shard point grads])."""
    assert not tcfg.xyz_grad, "sharded training requires frozen xyz"
    assert pspec is None or not cfg.semantic_guidance, \
        "perspective sharded training has no semantic guidance"
    scene = st.scene
    leaves = param_leaves(st.params)
    fields = trained_fields(tcfg)
    pts = [[getattr(s.cloud, f) for f in fields] for s in scene.shards]
    flat_pts = [t for p in pts for t in p]
    pixel_label = batch.get("pixel_label")
    if cfg.semantic_guidance and pspec is None and pixel_label is None:
        raise ValueError("semantic_guidance training needs pixel_label")
    for t in leaves + flat_pts:
        t.requires_grad_(True)
    try:
        cam = dict(campos=batch["campos"], raydir=batch["raydir"],
                   camrotc2w=batch["camrotc2w"], near=batch["near"],
                   far=batch["far"], bg_color=batch.get("bg_color"),
                   noise=noise, generator=generator, is_train=True)
        if pspec is not None:
            out = render_rays_spatial_perspective(st.params, scene, sspec,
                                                  pspec, cfg, **cam)
        else:
            out = render_rays_spatial(st.params, scene, sspec, cfg,
                                      pixel_label=pixel_label, **cam)
        total, losses = step_losses(out, batch, tcfg)
        grads = grads_of(total, leaves + flat_pts)
    finally:
        for t in leaves + flat_pts:
            t.requires_grad_(False)
    g_net = grads[:len(leaves)]
    per = [grads[len(leaves) + i * len(fields):
                 len(leaves) + (i + 1) * len(fields)]
           for i in range(len(scene.shards))]
    for k in range(len(fields)):
        synced = _halo_sync(scene, sspec.n_global, [p[k] for p in per])
        for p, g in zip(per, synced):
            p[k] = g
    net_scale, pts_scale = phase_scales(tcfg, st.step)
    adam_step(leaves, g_net, st.opt_net,
              schedule(tcfg, tcfg.lr, st.opt_net["count"]), net_scale)
    if fields:
        for p, g, opt in zip(pts, per, st.opt_pts):
            adam_step(p, g, opt, schedule(tcfg, tcfg.plr, opt["count"]),
                      pts_scale)
    st.step += 1
    losses = {k: v.detach() for k, v in losses.items()}
    if return_grads:
        return st, losses, (g_net, per)
    return st, losses


def spatial_train_step_multi(st: SpatialTrainState, sspec: SpatialSpec,
                             cfg: RenderConfig, tcfg: TrainConfig,
                             batches: List[Dict[str, Any]],
                             noises: Optional[List[Dict]] = None,
                             generator: Optional[torch.Generator] = None,
                             pspec=None):
    """G spatial_train_steps in a row (the JAX package scans them in one
    dispatch). Returns (st, [losses] * G)."""
    out = []
    for i, batch in enumerate(batches):
        st, losses = spatial_train_step(
            st, sspec, cfg, tcfg, batch,
            noise=None if noises is None else noises[i],
            generator=generator, pspec=pspec)
        out.append(losses)
    return st, out
