"""Shading-point selection and K-nearest neural-point query.

Counterpart of `sgnerf_tpu/ops/query.py` (reference mask_raypos,
get_shadingloc and query_neigh_along_ray_layered,
query_point_indices_worldcoords.py:413-681). Shapes are static: rays are
never compacted, invalid slots carry masks.

XLA's top_k returns ties in index order and the outputs depend on it;
`torch.topk` makes no such promise, so every top-k here is a stable sort.
Semantic guidance (a train-time sampler) keeps the exact path: a candidate
whose label differs from the ray's is accepted at random, with pre-drawn
uniforms `guide_u` (renderer.draw_render_noise).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .fused_knn import (fused_knn_select, fused_knn_select_tiled,
                        tile_unique)
from .grid import (PointGrid, clip_coords, in_bounds, neighbor_offsets,
                   take3d, unpack_cache, voxel_coords)


class QueryResult(NamedTuple):
    sample_pidx: torch.Tensor      # (B,R,SR,K) int32 point ids, -1 invalid
    sample_loc_w: torch.Tensor     # (B,R,SR,3) world-space shading points
    sample_loc_mask: torch.Tensor  # (B,R,SR) bool: slot holds a shading point
    ray_mask: torch.Tensor         # (B,R) bool: ray has >= 1 neighbour
    sample_label: Optional[torch.Tensor] = None  # (B,R,SR) int32 (guided)


def topk_stable(score: torch.Tensor, k: int, largest: bool = True):
    """The k largest (or smallest) entries along the last axis, ties in
    index order (XLA top_k semantics). Returns (values, indices)."""
    v, i = torch.sort(score, dim=-1, descending=largest, stable=True)
    return v[..., :k], i[..., :k]


def sqnorm3(v: torch.Tensor) -> torch.Tensor:
    """|v|^2 over a last axis of 3, summed left to right."""
    return v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]


def compact_hits(hit: torch.Tensor, SR: int):
    """First SR True entries along the last axis of `hit` (..., D) ->
    (smask (..., SR), gather_d (..., SR) source indices, ascending)."""
    D = hit.shape[-1]
    d_rng = torch.arange(D, device=hit.device)
    top, top_d = topk_stable(torch.where(hit, D - d_rng, -1), SR)
    return top > 0, top_d.clamp(0, D - 1)


def mask_and_compact_samples(raypos: torch.Tensor, grid: PointGrid, SR: int,
                             ray_label: Optional[torch.Tensor] = None,
                             campos=None, raydir=None, tvals=None):
    """Mask ray samples by dilated occupancy and keep the first SR hits.
    raypos (B,R,D,3) -> (sample_loc_w (B,R,SR,3), sample_mask (B,R,SR),
    sample_label (B,R,SR) int32: the ray's label on its shading points, 0
    elsewhere, or None without ray_label (B,R)). With campos/raydir/tvals
    and the two-level path active, positions are recomputed from the
    selected depths (campos + t*dir)."""
    spec = grid.spec
    B, R, D, _ = raypos.shape
    two_level = spec.coarse_factor > 1 and grid.coarse_occ.numel() > 0
    if (two_level and campos is not None and raydir is not None
            and tvals is not None and D % spec.seg_len == 0):
        loc, smask = _two_level_hits_lazy(campos, raydir, tvals, grid, SR)
    else:
        if two_level:
            smask, gather_d = _two_level_hits(raypos, grid, SR)
        else:
            coords = voxel_coords(raypos, spec)
            occ = take3d(grid.occ_mask, clip_coords(coords, spec.vdim),
                         spec.vdim) > 0
            smask, gather_d = compact_hits(in_bounds(coords, spec) & occ, SR)
        loc = torch.gather(raypos, 2,
                           gather_d[..., None].expand(-1, -1, -1, 3))
        loc = torch.where(smask[..., None], loc, torch.zeros_like(loc))
    lbl = None
    if ray_label is not None:
        # the ray's label on each of its samples (reference :110)
        lbl = torch.where(smask, ray_label[..., None].to(torch.int32),
                          torch.zeros((), dtype=torch.int32,
                                      device=smask.device))
    return loc, smask, lbl


def _coarse_segment_hits(mpos, grid: PointGrid, C: int):
    """Coarse test at segment midpoints (B,R,G,3) -> (seg_ok, seg_idx) of
    the first C hit segments, ascending."""
    spec = grid.spec
    G = mpos.shape[2]
    cshape = tuple(grid.coarse_occ.shape)
    ccoord = torch.div(voxel_coords(mpos, spec), spec.coarse_factor,
                       rounding_mode="floor")
    cdim = torch.tensor(cshape, device=mpos.device)
    cin = ((ccoord >= 0) & (ccoord < cdim)).all(dim=-1)
    cocc = take3d(grid.coarse_occ, clip_coords(ccoord, cshape), cshape) > 0
    g_rng = torch.arange(G, device=mpos.device)
    top, top_g = topk_stable(torch.where(cin & cocc, G - g_rng, -1), C)
    return top > 0, top_g.clamp(0, G - 1)


def _fine_hits(fpos, fine_ok, grid: PointGrid):
    spec = grid.spec
    coords = voxel_coords(fpos, spec)
    occ = take3d(grid.occ_mask, clip_coords(coords, spec.vdim),
                 spec.vdim) > 0
    return in_bounds(coords, spec) & occ & fine_ok


def _two_level_hits(raypos, grid: PointGrid, SR: int):
    """Two-level compaction over materialized raypos: coarse-test segment
    midpoints, keep the first seg_cap hit segments, fine-test only their
    samples. Returns (smask (B,R,SR), gather_d (B,R,SR))."""
    spec = grid.spec
    B, R, D, _ = raypos.shape
    L = spec.seg_len
    G = (D + L - 1) // L
    C = min(spec.seg_cap, G)
    dev = raypos.device
    mid = torch.clamp(torch.arange(G, device=dev) * L + L // 2, max=D - 1)
    seg_ok, seg_idx = _coarse_segment_hits(raypos[:, :, mid, :], grid, C)
    fine_d = seg_idx[..., None] * L + torch.arange(L, device=dev)
    fine_ok = (seg_ok[..., None] & (fine_d < D)).reshape(B, R, C * L)
    fine_d = fine_d.clamp(max=D - 1).reshape(B, R, C * L)
    fpos = torch.gather(raypos, 2, fine_d[..., None].expand(-1, -1, -1, 3))
    hit = _fine_hits(fpos, fine_ok, grid)
    top2, top2_i = topk_stable(torch.where(hit, D - fine_d, -1), SR)
    gather_d = torch.gather(fine_d, 2, top2_i)
    return top2 > 0, gather_d.clamp(0, D - 1)


def _two_level_hits_lazy(campos, raydir, tvals, grid: PointGrid, SR: int):
    """`_two_level_hits` with positions computed from per-sample depths.
    Returns (loc (B,R,SR,3), smask (B,R,SR))."""
    spec = grid.spec
    B, R, D = tvals.shape
    L = spec.seg_len
    G = D // L
    C = min(spec.seg_cap, G)
    dev = tvals.device
    ts4 = tvals.reshape(B, R, G, L)

    def pos(t):                                     # (B,R,n) -> (B,R,n,3)
        return campos[:, None, None, :] + raydir[:, :, None, :] * t[..., None]

    seg_ok, seg_idx = _coarse_segment_hits(pos(ts4[..., min(L // 2, L - 1)]),
                                           grid, C)
    t_fine = torch.gather(ts4, 2, seg_idx[..., None].expand(-1, -1, -1, L))
    fine_d = seg_idx[..., None] * L + torch.arange(L, device=dev)
    fine_ok = (seg_ok[..., None] & (fine_d < D)).reshape(B, R, C * L)
    fine_d = fine_d.clamp(max=D - 1).reshape(B, R, C * L)
    t_fine = t_fine.reshape(B, R, C * L)
    hit = _fine_hits(pos(t_fine), fine_ok, grid)
    top2, top2_i = topk_stable(torch.where(hit, D - fine_d, -1), SR)
    smask = top2 > 0
    loc = pos(torch.gather(t_fine, 2, top2_i))
    return torch.where(smask[..., None], loc, torch.zeros_like(loc)), smask


def bucket_candidates(grid: PointGrid, sample_loc_w: torch.Tensor,
                      smask: torch.Tensor):
    """KNN candidates from the bucket tables (the nbr_cache = 0 path): the
    kernel_size^3 voxel neighbourhood of each shading point. Returns
    (cand (B,R,SR,Kv,P) int32, cand_ok bool, d2, flat_shape)."""
    spec = grid.spec
    B, R, SR, _ = sample_loc_w.shape
    offsets = neighbor_offsets(spec.kernel_size, sample_loc_w.device)
    nbr = voxel_coords(sample_loc_w, spec)[..., None, :] + offsets
    slot = take3d(grid.vox_slot, clip_coords(nbr, spec.vdim), spec.vdim)
    slot_ok = in_bounds(nbr, spec) & (slot >= 0)
    slot_c = slot.clamp(0, spec.max_o - 1).long()
    cand = grid.bucket_pnts[slot_c]                          # (B,R,SR,Kv,P)
    cnt = grid.bucket_cnt[slot_c]
    rank_ok = torch.arange(spec.P, device=cand.device) < cnt[..., None]
    cand_ok = (slot_ok[..., None] & rank_ok & (cand >= 0)
               & smask[..., None, None])
    cxyz = grid.bucket_xyz[slot_c]                           # (...,P,3)
    d2 = sqnorm3(cxyz - sample_loc_w[..., None, None, :])
    return cand, cand_ok, d2, (B, R, SR, offsets.shape[0] * spec.P)


def query_neighbors(grid: PointGrid, raypos: torch.Tensor, K: int, SR: int,
                    radius_limit: float, knn_mode: str = "exact",
                    campos=None, raydir=None, tvals=None,
                    dedup_tile: int = 64, dedup_cap: int = 160,
                    ray_label: Optional[torch.Tensor] = None,
                    points_label: Optional[torch.Tensor] = None,
                    points_label_prob: Optional[torch.Tensor] = None,
                    guide_u: Optional[torch.Tensor] = None) -> QueryResult:
    """Sample masking -> SR compaction -> KNN. raypos (B,R,D,3); radius
    0 disables the radius test. knn_mode "fused" (bf16 cache) runs kernel
    K1 on the gathered cache rows; "dedup" (bf16 cache, raster rays) gathers
    each distinct cache row once per tile of `dedup_tile` consecutive rays
    (at most `dedup_cap` rows a tile) and runs kernel K6 on them: the same
    ids as "fused" wherever a tile holds no more than dedup_cap distinct
    rows, no neighbours for the shading points past the cap; "exact" is
    the XLA-path statement.

    Semantic guidance (ray_label (B,R), the points' label (N,) and
    label_prob (N,C), guide_u of the candidates' shape) takes the exact
    path whatever knn_mode says, as the JAX package does: a candidate is
    accepted when its label matches the ray's or either is 0 (void), else
    with probability clip(2 - int(10 prob), 0, 10) / 10 of its own label's
    probability, as guide_u < that."""
    spec = grid.spec
    B, R, D, _ = raypos.shape
    guided = ray_label is not None
    sample_loc_w, smask, sample_label = mask_and_compact_samples(
        raypos, grid, SR, ray_label, campos=campos, raydir=raydir,
        tvals=tvals)
    # the radius test runs in f32, like jnp.asarray(radius, f32) ** 2
    r2 = float(np.float32(radius_limit) * np.float32(radius_limit))

    if spec.nbr_cache > 0 and grid.nbr_packed.shape[0] > 0:
        # one gather of a packed cache row per shading point
        c = voxel_coords(sample_loc_w, spec)
        cc = clip_coords(c, spec.vdim)
        slot = take3d(grid.dil_slot, cc, spec.vdim)
        slot_ok = in_bounds(c, spec) & (slot >= 0) & smask
        dev = raypos.device
        center = ((cc.to(torch.float32) + 0.5) * spec.vsize_t(dev)
                  + spec.min_corner_t(dev))
        if (knn_mode == "dedup" and spec.cache_dtype == "bfloat16"
                and not guided):
            sample_pidx = _dedup_select(
                grid, slot, slot_ok, (sample_loc_w - center), r2, K, SR,
                dedup_tile * SR, dedup_cap)
            return QueryResult(
                sample_pidx, sample_loc_w, smask,
                (sample_pidx.reshape(B, R, -1) >= 0).any(dim=-1))
        max_d = grid.nbr_packed.shape[0]
        rows = grid.nbr_packed[slot.clamp(0, max_d - 1).long()]
        if (knn_mode == "fused" and spec.cache_dtype == "bfloat16"
                and not guided):
            Mq = B * R * SR
            sel = fused_knn_select(
                rows.reshape(Mq, -1), (sample_loc_w - center).reshape(Mq, 3),
                slot_ok.reshape(Mq), r2, C=rows.shape[-1] // 5, K=K)
            sample_pidx = sel.reshape(B, R, SR, K)
            return QueryResult(
                sample_pidx, sample_loc_w, smask,
                (sample_pidx.reshape(B, R, -1) >= 0).any(dim=-1))
        off, cand = unpack_cache(rows, spec)
        # cache rows hold offsets from the voxel centre
        cxyz = center[..., None, :] + off.to(torch.float32)
        cand_ok = slot_ok[..., None] & (cand >= 0)
        d2 = sqnorm3(cxyz - sample_loc_w[..., None, :])
        flat_shape = (B, R, SR, cand.shape[-1])
    else:
        cand, cand_ok, d2, flat_shape = bucket_candidates(
            grid, sample_loc_w, smask)

    in_radius = (d2 <= r2) if r2 > 0 else torch.ones_like(cand_ok)
    ok = cand_ok & in_radius
    if guided:
        ok = ok & _guide_accept(cand, sample_label, points_label,
                                points_label_prob, guide_u)
    big = torch.finfo(torch.float32).max
    d2m = torch.where(ok, d2, torch.full_like(d2, big)).reshape(flat_shape)
    top_d2, top_idx = topk_stable(d2m, K, largest=False)
    sel = torch.gather(cand.reshape(flat_shape), -1, top_idx)
    sample_pidx = torch.where(top_d2 < big, sel, torch.full_like(sel, -1))
    return QueryResult(sample_pidx.to(torch.int32), sample_loc_w, smask,
                       (sample_pidx.reshape(B, R, -1) >= 0).any(dim=-1),
                       sample_label)


def _guide_accept(cand, sample_label, points_label, points_label_prob,
                  guide_u):
    """The semantic-guidance predicate over the candidates (reference
    query_point_indices_worldcoords.py:548-556, JAX ops/query.py:386-412):
    cand (B,R,SR,C) or (B,R,SR,Kv,P) point ids, -1 empty."""
    N = points_label.shape[0]
    c = cand.clamp(0, N - 1).long()
    center = sample_label.reshape(sample_label.shape
                                  + (1,) * (cand.dim() - sample_label.dim()))
    label_v = points_label[c].to(torch.int32)
    C = points_label_prob.shape[-1]
    prob_v = torch.gather(points_label_prob[c], -1,
                          label_v.clamp(0, C - 1).long()[..., None])[..., 0]
    label_prob_i = (prob_v * 10.0).to(torch.int32)   # truncation, as int()
    p_acc = torch.clamp(2 - label_prob_i, 0, 10).to(torch.float32) / 10.0
    return ((center == label_v) | (label_v == 0) | (center == 0)
            | (guide_u < p_acc))


def _dedup_select(grid: PointGrid, slot, slot_ok, delta, r2, K: int, SR: int,
                  T: int, U: int) -> torch.Tensor:
    """The tile-dedup select: the shading points padded to a multiple of T,
    each tile's distinct slots (`tile_unique`), one cache-row gather per
    distinct slot, then K6. Returns (B,R,SR,K) int32 ids."""
    B, R = slot.shape[:2]
    Mq = B * R * SR
    pad = (-Mq) % T
    slot_f = torch.nn.functional.pad(slot.reshape(Mq), (0, pad), value=-1)
    ok_f = torch.nn.functional.pad(slot_ok.reshape(Mq), (0, pad))
    delta_f = torch.nn.functional.pad(delta.reshape(Mq, 3), (0, 0, 0, pad))
    uniq, inv = tile_unique(slot_f, ok_f, T, U)
    max_d = grid.nbr_packed.shape[0]
    rows = grid.nbr_packed[uniq.clamp(0, max_d - 1).reshape(-1).long()]
    sel = fused_knn_select_tiled(rows, inv, delta_f, ok_f, r2,
                                 C=rows.shape[-1] // 5, K=K, T=T, U=U)
    return sel[:Mq].reshape(B, R, SR, K)
