"""Shading-point selection and K-nearest neural-point query.

Counterpart of `sgnerf_tpu/ops/query.py` (reference mask_raypos,
get_shadingloc and query_neigh_along_ray_layered,
query_point_indices_worldcoords.py:413-681). Shapes are static: rays are
never compacted, invalid slots carry masks.

XLA's top_k returns ties in index order and the outputs depend on it;
`torch.topk` makes no such promise, so every top-k here is a stable sort.
Semantic guidance is a train-time sampler and comes with ROADMAP item 11.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .fused_knn import fused_knn_select
from .grid import (PointGrid, clip_coords, in_bounds, neighbor_offsets,
                   take3d, unpack_cache, voxel_coords)


class QueryResult(NamedTuple):
    sample_pidx: torch.Tensor      # (B,R,SR,K) int32 point ids, -1 invalid
    sample_loc_w: torch.Tensor     # (B,R,SR,3) world-space shading points
    sample_loc_mask: torch.Tensor  # (B,R,SR) bool: slot holds a shading point
    ray_mask: torch.Tensor         # (B,R) bool: ray has >= 1 neighbour


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
                             campos=None, raydir=None, tvals=None):
    """Mask ray samples by dilated occupancy and keep the first SR hits.
    raypos (B,R,D,3) -> (sample_loc_w (B,R,SR,3), sample_mask (B,R,SR)).
    With campos/raydir/tvals and the two-level path active, positions are
    recomputed from the selected depths (campos + t*dir)."""
    spec = grid.spec
    B, R, D, _ = raypos.shape
    two_level = spec.coarse_factor > 1 and grid.coarse_occ.numel() > 0
    if (two_level and campos is not None and raydir is not None
            and tvals is not None and D % spec.seg_len == 0):
        return _two_level_hits_lazy(campos, raydir, tvals, grid, SR)
    if two_level:
        smask, gather_d = _two_level_hits(raypos, grid, SR)
    else:
        coords = voxel_coords(raypos, spec)
        occ = take3d(grid.occ_mask, clip_coords(coords, spec.vdim),
                     spec.vdim) > 0
        smask, gather_d = compact_hits(in_bounds(coords, spec) & occ, SR)
    loc = torch.gather(raypos, 2, gather_d[..., None].expand(-1, -1, -1, 3))
    return torch.where(smask[..., None], loc, torch.zeros_like(loc)), smask


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
                    campos=None, raydir=None, tvals=None) -> QueryResult:
    """Sample masking -> SR compaction -> KNN. raypos (B,R,D,3); radius
    0 disables the radius test. knn_mode "fused" (bf16 cache) runs kernel
    K1 on the gathered cache rows; "exact" is the XLA-path statement."""
    spec = grid.spec
    B, R, D, _ = raypos.shape
    sample_loc_w, smask = mask_and_compact_samples(
        raypos, grid, SR, campos=campos, raydir=raydir, tvals=tvals)
    # the radius test runs in f32, like jnp.asarray(radius, f32) ** 2
    r2 = float(np.float32(radius_limit) * np.float32(radius_limit))

    if spec.nbr_cache > 0 and grid.nbr_packed.shape[0] > 0:
        # one gather of a packed cache row per shading point
        c = voxel_coords(sample_loc_w, spec)
        cc = clip_coords(c, spec.vdim)
        slot = take3d(grid.dil_slot, cc, spec.vdim)
        slot_ok = in_bounds(c, spec) & (slot >= 0) & smask
        max_d = grid.nbr_packed.shape[0]
        rows = grid.nbr_packed[slot.clamp(0, max_d - 1).long()]
        dev = raypos.device
        center = ((cc.to(torch.float32) + 0.5) * spec.vsize_t(dev)
                  + spec.min_corner_t(dev))
        if knn_mode == "fused" and spec.cache_dtype == "bfloat16":
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
    big = torch.finfo(torch.float32).max
    d2m = torch.where(cand_ok & in_radius, d2,
                      torch.full_like(d2, big)).reshape(flat_shape)
    top_d2, top_idx = topk_stable(d2m, K, largest=False)
    sel = torch.gather(cand.reshape(flat_shape), -1, top_idx)
    sample_pidx = torch.where(top_d2 < big, sel, torch.full_like(sel, -1))
    return QueryResult(sample_pidx.to(torch.int32), sample_loc_w, smask,
                       (sample_pidx.reshape(B, R, -1) >= 0).any(dim=-1))
