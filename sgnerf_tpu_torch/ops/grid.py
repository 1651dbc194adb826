"""Persistent voxel grid over a neural point cloud.

PyTorch counterpart of `sgnerf_tpu/ops/grid.py`. The build is the same
deterministic sort-based program (argsort by voxel id + segment ranks), so
every table is bit-equal to the reference:
  * `occ_mask`    (X,Y,Z) uint8, occupancy dilated by the query size;
  * `vox_slot`    (X,Y,Z) int32, occupied-voxel slot or -1;
  * `bucket_pnts` (max_o, P) int32 point ids, -1 padded;
  * `bucket_cnt`  (max_o,) int32;
  * `bucket_xyz`  (max_o, P, 3) f32 point coords, 1e9 padded;
  * `dil_slot`    (X,Y,Z) int32 dilated-voxel slot or -1;
  * `nbr_packed`  (max_d, C*W) int16 merged-neighbourhood cache in the planar
                  layout of `pack_cache`;
  * `coarse_occ`  (Xc,Yc,Zc) uint8 3^3-dilated supervoxel occupancy.

The reference builds the cache in a one-shot, a blocked and a row-major
variant to fit TPU memory and layouts; here one chunked loop fills a
preallocated table. Ties in the candidate sort go by candidate index, the
order of XLA's top_k, through a stable sort.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static grid geometry (field for field the reference's GridSpec)."""
    min_corner: Tuple[float, float, float]   # world coords of voxel (0,0,0)
    vsize: Tuple[float, float, float]        # SCALED voxel size (vsize*vscale)
    vdim: Tuple[int, int, int]               # grid dims
    max_o: int                               # max occupied voxels tracked
    P: int                                   # max points kept per voxel
    kernel_size: Tuple[int, int, int]        # neighbour-search extent
    dilate_size: Optional[Tuple[int, int, int]] = None  # occupancy dilation
    nbr_cache: int = 64                      # merged-neighbourhood cache C
    coarse_factor: int = 0                   # supervoxel pooling factor F
    seg_len: int = 4                         # samples per ray segment L
    seg_cap: int = 32                        # hit segments kept per ray
    cache_dtype: str = "float32"             # cache offset storage

    @property
    def dilate(self) -> Tuple[int, int, int]:
        return self.dilate_size or self.kernel_size

    def min_corner_t(self, device) -> torch.Tensor:
        return const(self.min_corner, torch.float32, device)

    def vsize_t(self, device) -> torch.Tensor:
        return const(self.vsize, torch.float32, device)


@functools.lru_cache(maxsize=None)
def const(values: tuple, dtype: torch.dtype, device) -> torch.Tensor:
    """A small constant tensor on `device`, copied from the host once:
    a blocking host-to-device copy waits for the device's queue, so a
    render that made its constants anew every chunk would hold the host
    (and shards on other cards) back. Made outside inference mode so
    autograd may save it. Callers never write to it."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)


def auto_grid_caps(xyz: np.ndarray, min_corner, scaled_vsize,
                   scaled_vdim) -> Tuple[int, int]:
    """Size (max_o, P) from the actual per-voxel occupancy so no in-range
    point is unreachable by the query (numpy; same buckets as the
    reference: max_o in 64k steps, P padded +4 to a multiple of 4)."""
    xyz = np.asarray(xyz, dtype=np.float64)
    c = np.floor((xyz - np.asarray(min_corner)) /
                 np.asarray(scaled_vsize)).astype(np.int64)
    vdim = np.asarray(scaled_vdim, dtype=np.int64)
    inb = np.all((c >= 0) & (c < vdim), axis=1)
    vid = (c[inb, 0] * vdim[1] + c[inb, 1]) * vdim[2] + c[inb, 2]
    if vid.size == 0:
        return 65536, 8
    uniq, cnt = np.unique(vid, return_counts=True)
    bucket = 65536
    max_o = int(-(-(len(uniq) + 1) // bucket) * bucket)
    P = int(cnt.max()) + 4
    P = -(-P // 4) * 4
    if P > 128:
        lost = int(np.maximum(cnt - 128, 0).sum())
        print(f"[grid] auto-P clamped at 128 (max per-voxel count "
              f"{int(cnt.max())}): {lost} points "
              f"({100.0 * lost / max(vid.size, 1):.2f}%) stay unreachable; "
              f"coarsen --vsize to recover them", flush=True)
        P = 128
    return max_o, P


def compute_grid_spec(xyz: np.ndarray, vsize, vscale, kernel_size,
                      max_o=None, P=None, ranges=None, nbr_cache: int = 64,
                      coarse_factor: int = 0, seg_len: int = 4,
                      seg_cap: int = 32, cache_dtype: str = "float32",
                      dilate_size=None) -> GridSpec:
    """Host-side spec: point bbox intersected with `ranges`, padded by
    scaled_vsize*kernel/2, voxelized at vsize*vscale. max_o / P of None (or
    0) auto-size from the occupancy."""
    xyz = np.asarray(xyz, dtype=np.float64)
    vsize = np.asarray(vsize, dtype=np.float64)
    vscale = np.asarray(vscale, dtype=np.float64)
    scaled_vsize = vsize * vscale
    min_xyz = xyz.min(axis=0)
    max_xyz = xyz.max(axis=0)
    if ranges is not None:
        ranges = np.asarray(ranges, dtype=np.float64)
        min_xyz = np.maximum(min_xyz, ranges[:3])
        max_xyz = np.minimum(max_xyz, ranges[3:])
    ks = np.asarray(kernel_size, dtype=np.float64)
    min_xyz = min_xyz - scaled_vsize * ks / 2
    max_xyz = max_xyz + scaled_vsize * ks / 2
    vdim = (max_xyz - min_xyz) / vsize
    scaled_vdim = np.ceil(vdim / vscale).astype(np.int64)
    if not max_o or not P:
        auto_o, auto_p = auto_grid_caps(xyz, min_xyz, scaled_vsize,
                                        scaled_vdim)
        max_o = max_o or auto_o
        P = P or auto_p
    return GridSpec(
        min_corner=tuple(float(v) for v in min_xyz),
        vsize=tuple(float(v) for v in scaled_vsize),
        vdim=tuple(int(v) for v in scaled_vdim),
        max_o=int(max_o),
        P=int(P),
        kernel_size=tuple(int(k) for k in np.asarray(kernel_size)),
        dilate_size=(tuple(int(k) for k in np.asarray(dilate_size))
                     if dilate_size is not None else None),
        nbr_cache=int(nbr_cache),
        coarse_factor=int(coarse_factor),
        seg_len=int(seg_len),
        seg_cap=int(seg_cap),
        cache_dtype=str(cache_dtype),
    )


@dataclasses.dataclass
class PointGrid:
    occ_mask: torch.Tensor     # (X,Y,Z) uint8 dilated occupancy
    vox_slot: torch.Tensor     # (X,Y,Z) int32 slot or -1 (undilated)
    bucket_pnts: torch.Tensor  # (max_o, P) int32 point ids, -1 padded
    bucket_cnt: torch.Tensor   # (max_o,) int32
    bucket_xyz: torch.Tensor   # (max_o, P, 3) f32 point coords
    dil_slot: torch.Tensor     # (X,Y,Z) int32 dilated-voxel slot or -1
    nbr_packed: torch.Tensor   # (max_d, C*W) int16 packed cache rows
    coarse_occ: torch.Tensor   # (Xc,Yc,Zc) uint8 (empty when F == 0)
    spec: GridSpec


def _cache_width(cache_dtype: str) -> int:
    """int16 halves per cache candidate: xyz (3 bf16 or 3 f32) + int32 id."""
    return 5 if cache_dtype == "bfloat16" else 8


def pack_cache(xyz: torch.Tensor, pidx: torch.Tensor,
               cache_dtype: str) -> torch.Tensor:
    """(S,C,3) offsets + (S,C) int32 ids -> (S, C*W) int16 planar rows:
    bf16 [x(C) | y(C) | z(C) | id_lo(C) | id_hi(C)]; f32 six xyz half-planes
    then lo/hi. The bf16 cast rounds to nearest even, like XLA's."""
    lead = xyz.shape[:-2]
    if cache_dtype == "bfloat16":
        xi = xyz.to(torch.bfloat16).view(torch.int16)             # (S,C,3)
        xi = xi.movedim(-1, -2).reshape(*lead, -1)
    else:
        xi = xyz.to(torch.float32).contiguous().view(torch.int16)  # (S,C,6)
        xi = xi.movedim(-1, -2).reshape(*lead, -1)
    pi = pidx.to(torch.int32).contiguous().view(torch.int16).reshape(
        pidx.shape + (2,))                                         # (S,C,2)
    pi = pi.movedim(-1, -2).reshape(*lead, -1)
    return torch.cat([xi, pi], dim=-1)


def unpack_cache(packed: torch.Tensor, spec: GridSpec):
    """(..., C*W) int16 -> ((..., C, 3) offsets in the cache dtype,
    (..., C) int32 ids). Inverse of pack_cache."""
    W = _cache_width(spec.cache_dtype)
    bf16 = spec.cache_dtype == "bfloat16"
    C = packed.shape[-1] // W
    lead = packed.shape[:-1]
    split = C * (3 if bf16 else 6)
    if bf16:
        planes = packed[..., :split].reshape(lead + (3, C))
        xyz = planes.movedim(-2, -1).contiguous().view(torch.bfloat16)
    else:
        planes = packed[..., :split].reshape(lead + (6, C))
        xyz = planes.movedim(-2, -1).contiguous().view(torch.float32)
    pl_ = packed[..., split:].reshape(lead + (2, C))
    pidx = pl_.movedim(-2, -1).contiguous().view(torch.int32)[..., 0]
    return xyz, pidx


def voxel_coords(xyz: torch.Tensor, spec: GridSpec) -> torch.Tensor:
    """World position -> int64 voxel coords (may be out of bounds; clamped
    to +-2^30 so far padding points stay out of bounds after the cast)."""
    v = torch.floor((xyz - spec.min_corner_t(xyz.device))
                    / spec.vsize_t(xyz.device))
    return v.clamp(-2.0 ** 30, 2.0 ** 30).to(torch.int64)


def in_bounds(coords: torch.Tensor, spec: GridSpec) -> torch.Tensor:
    vdim = const(spec.vdim, coords.dtype, coords.device)
    return ((coords >= 0) & (coords < vdim)).all(dim=-1)


def clip_coords(coords: torch.Tensor, dims) -> torch.Tensor:
    hi = const(tuple(d - 1 for d in dims), coords.dtype, coords.device)
    return torch.minimum(coords.clamp_min(0), hi)


def linear_vid(coords: torch.Tensor, spec: GridSpec) -> torch.Tensor:
    X, Y, Z = spec.vdim
    return coords[..., 0] * (Y * Z) + coords[..., 1] * Z + coords[..., 2]


def take3d(table: torch.Tensor, coords: torch.Tensor, dims) -> torch.Tensor:
    """Dense (X,Y,Z) lookup through one flattened gather. coords must be
    pre-clipped."""
    X, Y, Z = dims
    lin = coords[..., 0] * (Y * Z) + coords[..., 1] * Z + coords[..., 2]
    return table.reshape(-1)[lin]


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c with one rounding to float32 (the product is exact in
    float64). XLA compiles multiply-adds as fused multiply-adds, so the
    voxel centres here are the reference's to the bit."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def _max_pool(x: torch.Tensor, k, stride, pad) -> torch.Tensor:
    """3-D max over windows of a non-negative (X,Y,Z) tensor, with explicit
    (lo, hi) zero padding per axis, like lax.reduce_window(max) with init
    0. Pools in float32 (max_pool3d takes no integer input)."""
    v = x.to(torch.float32)[None, None]
    v = F.pad(v, (pad[2][0], pad[2][1], pad[1][0], pad[1][1],
                  pad[0][0], pad[0][1]))
    return F.max_pool3d(v, kernel_size=tuple(k), stride=stride)[0, 0]


def build_point_grid(xyz: torch.Tensor, point_mask: torch.Tensor,
                     spec: GridSpec) -> PointGrid:
    """Build the grid from (N,3) world points; point_mask (N,) bool marks
    live points. The cache capacity max_d is sized from the actual dilated
    voxel count (bucketed to 262144 rows), as in the reference."""
    grid = build_grid_core(xyz, point_mask, spec)
    if spec.nbr_cache <= 0:
        return grid
    nvox = spec.vdim[0] * spec.vdim[1] * spec.vdim[2]
    n_occ = int((grid.vox_slot >= 0).sum())
    if n_occ >= spec.max_o:
        print(f"[grid] WARNING: occupied voxels hit max_o={spec.max_o} — "
              f"points in voxels past the cap are dropped from the query; "
              f"raise --max_o (or coarsen --vsize) to cover the scene",
              flush=True)
    n_inb = int((point_mask & in_bounds(voxel_coords(xyz, spec),
                                        spec)).sum())
    n_kept = int(grid.bucket_cnt.sum())
    if n_kept < n_inb:
        frac = 100.0 * (n_inb - n_kept) / max(n_inb, 1)
        print(f"[grid] {n_inb - n_kept} of {n_inb} in-range points "
              f"({frac:.1f}%) are unreachable by the query "
              f"(per-voxel P={spec.P} / max_o caps)", flush=True)
    n_dil = int((grid.occ_mask > 0).sum())
    bucket = 262144
    max_d = min(((n_dil + bucket - 1) // bucket) * bucket, nvox)
    max_d = max(max_d, min(bucket, nvox))
    dil_slot, nbr_packed = build_nbr_cache(grid, spec, max_d)
    return dataclasses.replace(grid, dil_slot=dil_slot, nbr_packed=nbr_packed)


def _slots(xyz: torch.Tensor, point_mask: torch.Tensor, spec: GridSpec,
           x_off: int = 0):
    """The build's point order: (svid, order, slot, rank, is_first) of the
    points sorted by voxel id (ties by point index): the occupied-voxel
    slot (-1 past max_o or out of range) and the rank within the voxel.
    x_off: the grid is a window of a larger one starting at its x voxel
    x_off (a slab, parallel/spatial.py): the points are binned in the
    larger grid's voxels, then moved by -x_off voxels."""
    N = xyz.shape[0]
    X, Y, Z = spec.vdim
    nvox = X * Y * Z
    coords = voxel_coords(xyz, spec)
    if x_off:
        coords = coords - const((x_off, 0, 0), coords.dtype, coords.device)
    valid = point_mask & in_bounds(coords, spec)
    vid = torch.where(valid, linear_vid(coords, spec),
                      torch.full_like(coords[:, 0], nvox))
    svid, order = torch.sort(vid, stable=True)     # ties by point index
    pvalid = svid < nvox

    is_first = torch.cat([pvalid[:1], (svid[1:] != svid[:-1]) & pvalid[1:]])
    occ_rank = torch.cumsum(is_first, 0) - 1      # slot per sorted point
    slot = torch.where(pvalid & (occ_rank < spec.max_o), occ_rank,
                       torch.full_like(occ_rank, -1))

    arange = torch.arange(N, device=xyz.device)
    seg_start = torch.cummax(torch.where(is_first, arange, 0), 0).values
    rank = arange - seg_start                     # rank within the voxel
    return svid, order, slot, rank, is_first


def kept_points(xyz: torch.Tensor, point_mask: torch.Tensor,
                spec: GridSpec) -> torch.Tensor:
    """(N,) bool: the points in range in one of the first max_o occupied
    voxels, the voxels the grid build gives a slot (its per-voxel cap of P
    points then applies within each)."""
    _, order, slot, _, _ = _slots(xyz, point_mask, spec)
    kept = torch.zeros(xyz.shape[0], dtype=torch.bool, device=xyz.device)
    kept[order] = slot >= 0
    return kept


def coarse_occupancy(occ_mask: torch.Tensor, F: int) -> torch.Tensor:
    """The two-level compaction's supervoxel table: occ_mask max-pooled by
    F, then dilated by one supervoxel (3^3)."""
    X, Y, Z = occ_mask.shape
    Xc, Yc, Zc = (X + F - 1) // F, (Y + F - 1) // F, (Z + F - 1) // F
    pooled = _max_pool(occ_mask, (F, F, F), F,
                       ((0, Xc * F - X), (0, Yc * F - Y), (0, Zc * F - Z)))
    return _max_pool(pooled, (3, 3, 3), 1, ((1, 1),) * 3).to(torch.uint8)


def build_grid_core(xyz: torch.Tensor, point_mask: torch.Tensor,
                    spec: GridSpec, x_off: int = 0) -> PointGrid:
    """The grid's tables but the cache (x_off: a window's, `_slots`)."""
    dev = xyz.device
    N = xyz.shape[0]
    X, Y, Z = spec.vdim
    nvox = X * Y * Z
    max_o, P = spec.max_o, spec.P
    svid, order, slot, rank, is_first = _slots(xyz, point_mask, spec, x_off)

    # dense voxel -> slot map; rows past the end catch the dropped writes
    scatter_vid = torch.where(is_first & (slot >= 0), svid,
                              torch.full_like(svid, nvox))
    vox_slot = torch.full((nvox + 1,), -1, dtype=torch.int32, device=dev)
    vox_slot[scatter_vid] = slot.to(torch.int32)
    vox_slot = vox_slot[:nvox].reshape(X, Y, Z)

    bslot = torch.where((slot >= 0) & (rank < P), slot,
                        torch.full_like(slot, max_o))
    bp = torch.full((max_o + 1, P), -1, dtype=torch.int32, device=dev)
    bp[bslot, rank.clamp(0, P - 1)] = order.to(torch.int32)
    bucket_pnts = bp[:max_o]

    cnt = torch.bincount(torch.where(slot >= 0, slot,
                                     torch.full_like(slot, max_o)),
                         minlength=max_o + 1)
    bucket_cnt = cnt[:max_o].clamp(max=P).to(torch.int32)

    kx, ky, kz = spec.dilate
    occ_mask = _max_pool(
        vox_slot >= 0, (kx, ky, kz), 1,
        ((kx // 2, (kx - 1) // 2), (ky // 2, (ky - 1) // 2),
         (kz // 2, (kz - 1) // 2))).to(torch.uint8)

    bucket_xyz = torch.where(
        (bucket_pnts >= 0)[..., None],
        xyz[bucket_pnts.clamp(0, N - 1).long()],
        torch.tensor(1e9, device=dev)).to(torch.float32)

    coarse = (coarse_occupancy(occ_mask, spec.coarse_factor)
              if spec.coarse_factor > 1
              else torch.zeros((0, 0, 0), dtype=torch.uint8, device=dev))
    return PointGrid(
        occ_mask=occ_mask, vox_slot=vox_slot, bucket_pnts=bucket_pnts,
        bucket_cnt=bucket_cnt, bucket_xyz=bucket_xyz,
        dil_slot=torch.zeros((0, 0, 0), dtype=torch.int32, device=dev),
        nbr_packed=torch.zeros((0, 0), dtype=torch.int16, device=dev),
        coarse_occ=coarse, spec=spec)


def _dilated_enumeration(grid: PointGrid, spec: GridSpec, max_d: int):
    """Dilated voxels in ascending linear id -> (dil_slot (X,Y,Z),
    dcoords (max_d,3) int64 with -1 padding)."""
    X, Y, Z = spec.vdim
    nvox = X * Y * Z
    dev = grid.occ_mask.device
    dil_lin = torch.nonzero(grid.occ_mask.reshape(-1) > 0)[:, 0][:max_d]
    n = dil_lin.shape[0]
    dil_slot = torch.full((nvox,), -1, dtype=torch.int32, device=dev)
    dil_slot[dil_lin] = torch.arange(n, dtype=torch.int32, device=dev)
    dcoords = torch.full((max_d, 3), -1, dtype=torch.int64, device=dev)
    dcoords[:n] = torch.stack([dil_lin // (Y * Z), (dil_lin // Z) % Y,
                               dil_lin % Z], dim=-1)
    return dil_slot.reshape(X, Y, Z), dcoords


def neighbor_offsets(kernel_size, device) -> torch.Tensor:
    """(Kv,3) int64 voxel offsets of a kernel, x-major (meshgrid 'ij')."""
    kx, ky, kz = kernel_size
    offs = np.stack(np.meshgrid(
        np.arange(kx) - kx // 2, np.arange(ky) - ky // 2,
        np.arange(kz) - kz // 2, indexing="ij"), -1).reshape(-1, 3)
    return const(tuple(map(tuple, offs.tolist())), torch.int64, device)


def _cache_one_chunk(grid: PointGrid, spec: GridSpec,
                     sl_coords: torch.Tensor, x_off: int = 0) -> torch.Tensor:
    """(S,3) dilated-voxel coords (-1 = pad) -> (S, C*W) packed cache rows:
    per voxel, the C candidates of its kernel neighbourhood nearest its
    centre, stored as offsets from that centre (of the larger grid's
    voxel, for a window at x_off)."""
    C = spec.nbr_cache
    dev = sl_coords.device
    offs = neighbor_offsets(spec.kernel_size, dev)
    valid = sl_coords[:, 0] >= 0
    nbr = sl_coords[:, None, :] + offs                      # (S,Kv,3)
    ok = in_bounds(nbr, spec)
    s = take3d(grid.vox_slot, clip_coords(nbr, spec.vdim), spec.vdim)
    s_ok = ok & (s >= 0)
    sc = s.clamp(0, spec.max_o - 1).long()
    cxyz = grid.bucket_xyz[sc]                              # (S,Kv,P,3)
    cpid = torch.where(s_ok[..., None], grid.bucket_pnts[sc],
                       torch.full_like(grid.bucket_pnts[sc], -1))
    gl = (sl_coords + const((x_off, 0, 0), sl_coords.dtype, dev)
          if x_off else sl_coords)
    center = fma((gl.to(torch.float32) + 0.5), spec.vsize_t(dev),
                 spec.min_corner_t(dev))
    diff = cxyz - center[:, None, None, :]
    d2 = fma(diff[..., 2], diff[..., 2],
             fma(diff[..., 1], diff[..., 1], diff[..., 0] * diff[..., 0]))
    d2 = torch.where((cpid >= 0) & s_ok[..., None], d2,
                     torch.tensor(float("inf"), device=dev))
    S = sl_coords.shape[0]
    d2s, idx = torch.sort(d2.reshape(S, -1), dim=-1, stable=True)
    d2s, idx = d2s[:, :C], idx[:, :C]
    sel_ok = torch.isfinite(d2s) & valid[:, None]
    pidx = torch.where(sel_ok, torch.gather(cpid.reshape(S, -1), 1, idx),
                       torch.full_like(idx, -1, dtype=torch.int32))
    xyzs = torch.gather(cxyz.reshape(S, -1, 3), 1,
                        idx[..., None].expand(-1, -1, 3))
    # offsets from the voxel centre stay small, so a bf16 cache keeps them
    # accurate; padding parks at 1e9, past any radius limit
    xyzs = torch.where(sel_ok[..., None], xyzs - center[:, None, :],
                       torch.tensor(1e9, device=dev))
    dt = torch.bfloat16 if spec.cache_dtype == "bfloat16" else torch.float32
    return pack_cache(xyzs.to(dt), pidx, spec.cache_dtype)


def _chunk_for(spec: GridSpec, base: int = 65536) -> int:
    """Cache-build chunk bounding the (chunk, Kv, P, 3) transients: keeps
    chunk*P roughly constant, floor 4096."""
    c = base
    while c > 4096 and c * spec.P > base * 28:
        c //= 2
    return c


def build_nbr_cache(grid: PointGrid, spec: GridSpec, max_d: int,
                    x_off: int = 0):
    """Merged-neighbourhood cache over the dilated voxel set, one chunk of
    voxels at a time into a preallocated table (x_off: a window's, its
    rows those of the larger grid's voxels)."""
    dil_slot, dcoords = _dilated_enumeration(grid, spec, max_d)
    W = _cache_width(spec.cache_dtype)
    table = torch.empty((max_d, spec.nbr_cache * W), dtype=torch.int16,
                        device=dcoords.device)
    chunk = max(1, min(_chunk_for(spec), max_d))
    for s in range(0, max_d, chunk):
        table[s:s + chunk] = _cache_one_chunk(grid, spec,
                                              dcoords[s:s + chunk], x_off)
    return dil_slot, table
