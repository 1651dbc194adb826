"""Plain PyTorch reference of the point-based render that the benchmark's
cells drive: rays -> samples -> the first SR samples in occupied space ->
the K nearest neural points of each -> the shading MLPs -> the march.

It imports nothing of the program. It takes only what the benchmark made
(the points and their attributes, the weights, the cameras, the batches,
the render noise) and works out again everything the program derives from
them: the grid spec, the voxel bins, the dilated occupancy, each voxel's
neighbour cache, the neighbour ids, the attribute table. Each step follows
the configuration as stated (`ref` block of the configuration file):

  * samples: D midpoints of linear bins over [near, far] (jittered in
    training by the noise's uniforms); a sample is a hit when its voxel at
    the scaled size lies within `dilate` voxels of an occupied one; the
    first SR hits along the ray are its shading points;
  * neighbours: each voxel keeps the `nbr_cache` points of its kernel
    neighbourhood nearest its centre, stored as offsets from the centre in
    the cache's precision; a shading point takes the K of its voxel's
    candidates nearest it within the radius limit, ties in cache order;
    an empty slot reads point 0's row, masked;
  * attributes are gathered from [xyz | embedding | colour | dir | conf
    (| semantic embedding)] rounded to the gather precision;
  * shading: linear distance weights normalised over K and scaled by the
    clamped confidence; per neighbour PE(feature) ++ PE(distance) through
    block1 (++ the semantic embedding through block2_bpnet), a softplus
    alpha a neighbour; alpha and features weighted over K; the colour MLP on
    the features ++ PE(view direction);
  * march: distances from the shading points' camera depth, alpha
    compositing, the background colour through the remaining transmission.

Two pieces are frozen copies of the program's arithmetic, so that sample
depths and transmittance are the same numbers and no sample moves across
a voxel boundary by a rounding: `ordered_scan` (the XLA block-of-16 scan
order, `sgnerf_tpu_torch/ops/scan.py`) and `linspace01`
(`sgnerf_tpu_torch/ops/raygen.py` `_linspace01`). The voxel centres
round as the program's grid build and query round them (an f64 multiply-add
for the cache, two f32 operations for the query).

Products go through `mm`, so that the same code computes at the stated
precision ("f32": IEEE float32, TF32 off; "bf16": operands rounded to
bfloat16, float32 sums) or below it for the benchmark's controls ("tf32":
operands rounded to TF32's 10-bit mantissa; "fp8": operands scaled per
tensor and rounded to float8 e4m3).
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

_BLOCK = 16


# ---------------------------------------------------------------- precision

def round_bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def round_tf32(x):
    """Round float32 to TF32 (10 explicit mantissa bits), to nearest even."""
    i = x.contiguous().view(torch.int32).to(torch.int64)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    i = torch.where(i >= 2 ** 31, i - 2 ** 32, i)
    return i.to(torch.int32).view(torch.float32)


def round_fp8(x):
    """Per-tensor scaled float8 e4m3 (the usual fp8 recipe: amax to 448)."""
    amax = x.abs().max().clamp(min=1e-30)
    s = 448.0 / amax
    return (x * s).to(torch.float8_e4m3fn).to(torch.float32) / s


ROUNDERS = {"f32": None, "bf16": round_bf16, "tf32": round_tf32,
            "fp8": round_fp8}


class _RoundedMatmul(torch.autograd.Function):
    """x @ w with both operands rounded and float32 sums; the backward's two
    products round their operands the same way (as a lower-precision mode
    runs all three products of a layer)."""

    @staticmethod
    def forward(ctx, x, w, rnd):
        xr, wr = rnd(x), rnd(w)
        ctx.save_for_backward(xr, wr)
        ctx.rnd = rnd
        return xr @ wr

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        gr = ctx.rnd(g)
        return gr @ ctx.rnd(wr).T, ctx.rnd(xr).T @ gr, None


def make_mm(precision: str) -> Callable:
    """x @ w with both operands rounded to `precision`, float32 sums."""
    rnd = ROUNDERS[precision]
    if rnd is None:
        return lambda x, w: x @ w
    return lambda x, w: _RoundedMatmul.apply(x, w, rnd)


def no_tf32():
    """IEEE float32 products for the reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ------------------------------------------------------ frozen arithmetic

def fma(a, b, c):
    """a * b + c rounded once to float32 (the grid build's multiply-add,
    sgnerf_tpu_torch/ops/grid.py `fma`)."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def ordered_scan(x: torch.Tensor, op) -> torch.Tensor:
    """Inclusive scan over the last axis in blocks of 16 (frozen copy of
    sgnerf_tpu_torch/ops/scan.py `ordered_scan`)."""
    n = x.shape[-1]
    if n <= _BLOCK:
        outs = [x[..., 0]]
        for i in range(1, n):
            outs.append(op(outs[-1], x[..., i]))
        return torch.stack(outs, dim=-1)
    ident = 0.0 if op is torch.add else 1.0
    nb = -(-n // _BLOCK)
    xp = F.pad(x, (0, nb * _BLOCK - n), value=ident)
    inner = ordered_scan(xp.reshape(*x.shape[:-1], nb, _BLOCK), op)
    outer = ordered_scan(inner[..., -1], op)
    excl = F.pad(outer[..., :-1], (1, 0), value=ident)
    out = op(excl[..., None], inner)
    return out.reshape(*x.shape[:-1], nb * _BLOCK)[..., :n]


def linspace01(n: int, device) -> torch.Tensor:
    """i * (1/(n-1)) for i < n-1, then 1 (frozen copy of raygen.py)."""
    return torch.cat([torch.arange(n - 1, dtype=torch.float32, device=device)
                      * (1.0 / (n - 1)), torch.ones(1, device=device)])


# --------------------------------------------------------------------- grid

class Grid:
    """The points binned into voxels of the scaled size: the spec (the
    points' box padded by half the kernel), each occupied voxel's points in
    index order, the dense occupied-voxel map and the dilated occupancy."""

    def __init__(self, xyz: torch.Tensor, ref: Dict):
        dev = xyz.device
        vs = np.asarray(ref["vsize"], np.float64) * np.asarray(
            ref["vscale"], np.float64)
        ks = np.asarray(ref["kernel"], np.float64)
        p = xyz.detach().cpu().numpy().astype(np.float64)
        lo = np.maximum(p.min(0), np.asarray(ref["ranges"][:3], np.float64))
        hi = np.minimum(p.max(0), np.asarray(ref["ranges"][3:], np.float64))
        lo = lo - vs * ks / 2
        hi = hi + vs * ks / 2
        vdim = np.ceil((hi - lo) / np.asarray(ref["vsize"], np.float64)
                       / np.asarray(ref["vscale"], np.float64)).astype(
            np.int64)
        self.lo64, self.vs64 = lo, vs
        self.lo = torch.tensor(lo, dtype=torch.float32, device=dev)
        self.vs = torch.tensor(vs, dtype=torch.float32, device=dev)
        self.vdim = tuple(int(v) for v in vdim)
        self.kernel = tuple(int(k) for k in ref["kernel"])
        self.dilate = tuple(int(k) for k in ref.get("dilate", ref["kernel"]))
        self.C = int(ref["nbr_cache"])
        self.cache_dtype = ref["cache_dtype"]
        self.xyz = xyz
        X, Y, Z = self.vdim
        c = self.coords(xyz)
        ok = self.inside(c)
        vid = torch.where(ok, self.lin(c), torch.full_like(c[:, 0], X * Y * Z))
        svid, order = torch.sort(vid, stable=True)
        keep = svid < X * Y * Z
        svid, order = svid[keep], order[keep]
        uniq, counts = torch.unique_consecutive(svid, return_counts=True)
        self.order = order                       # point ids by voxel
        self.start = torch.cumsum(counts, 0) - counts
        self.count = counts
        self.pmax = int(counts.max())
        self.vox = torch.full((X * Y * Z,), -1, dtype=torch.int64, device=dev)
        self.vox[uniq] = torch.arange(uniq.numel(), device=dev)
        occ = (self.vox >= 0).reshape(X, Y, Z)
        self.dil = self._dilated(occ)

    def _dilated(self, occ):
        out = torch.zeros_like(occ)
        X, Y, Z = self.vdim
        for dx in self._span(self.dilate[0]):
            for dy in self._span(self.dilate[1]):
                for dz in self._span(self.dilate[2]):
                    src = occ[max(dx, 0):X + min(dx, 0),
                              max(dy, 0):Y + min(dy, 0),
                              max(dz, 0):Z + min(dz, 0)]
                    out[max(-dx, 0):X + min(-dx, 0),
                        max(-dy, 0):Y + min(-dy, 0),
                        max(-dz, 0):Z + min(-dz, 0)] |= src
        return out.reshape(-1)

    @staticmethod
    def _span(k):
        return range(-(k // 2), (k - 1) // 2 + 1)

    def offsets(self, device):
        return torch.tensor([(a, b, c) for a in self._span(self.kernel[0])
                             for b in self._span(self.kernel[1])
                             for c in self._span(self.kernel[2])],
                            dtype=torch.int64, device=device)

    def coords(self, p):
        v = torch.floor((p - self.lo) / self.vs)
        return v.clamp(-2.0 ** 30, 2.0 ** 30).to(torch.int64)

    def inside(self, c):
        vd = torch.tensor(self.vdim, device=c.device)
        return ((c >= 0) & (c < vd)).all(-1)

    def lin(self, c):
        X, Y, Z = self.vdim
        return (c[..., 0] * Y + c[..., 1]) * Z + c[..., 2]

    def hit(self, p):
        """Samples whose voxel is in the dilated occupancy."""
        c = self.coords(p)
        ok = self.inside(c)
        lin = torch.where(ok, self.lin(c), torch.zeros_like(c[..., 0]))
        return ok & self.dil[lin]

    def cache_centre(self, c):
        """Voxel centres as the cache build rounds them (f64 multiply-add,
        one rounding to f32)."""
        lo = torch.tensor(self.lo64, dtype=torch.float64, device=c.device)
        vs = torch.tensor(self.vs64, dtype=torch.float32,
                          device=c.device).double()
        return ((c.to(torch.float32).double() + 0.5) * vs + lo.to(
            torch.float32).double()).to(torch.float32)

    def query_centre(self, c):
        """Voxel centres as the query rounds them (f32 multiply, f32 add)."""
        return (c.to(torch.float32) + 0.5) * self.vs + self.lo

    def cache(self, vids: torch.Tensor):
        """The neighbour cache of voxels `vids` (U,) (linear ids): per
        voxel its C kernel-neighbourhood candidates nearest its centre
        (squared distance rounded as the cache build rounds it, ties in
        candidate order: kernel
        offsets x-major, then point index), as (ids (U,C) with -1 empty,
        offsets (U,C,3) from the cache centre in the cache precision)."""
        dev = vids.device
        X, Y, Z = self.vdim
        c = torch.stack([vids // (Y * Z), (vids // Z) % Y, vids % Z], -1)
        nb = c[:, None, :] + self.offsets(dev)                 # (U,Kv,3)
        ok = self.inside(nb)
        slot = torch.where(ok, self.vox[torch.where(ok, self.lin(nb), 0)], -1)
        cnt = torch.where(slot >= 0, self.count[slot.clamp(min=0)], 0)
        st = self.start[slot.clamp(min=0)]
        r = torch.arange(self.pmax, device=dev)
        valid = r < cnt[..., None]                             # (U,Kv,P)
        pid = torch.where(valid, self.order[
            (st[..., None] + r).clamp(max=self.order.numel() - 1)], -1)
        U = vids.shape[0]
        pid = pid.reshape(U, -1)
        valid = valid.reshape(U, -1)
        centre = self.cache_centre(c)                           # (U,3) f32
        pos = self.xyz[pid.clamp(min=0)]                        # (U,n,3)
        d = pos - centre[:, None]
        d2 = fma(d[..., 2], d[..., 2],
                 fma(d[..., 1], d[..., 1], d[..., 0] * d[..., 0]))
        d2 = torch.where(valid, d2, torch.full_like(d2, math.inf))
        d2s, idx = torch.sort(d2, dim=-1, stable=True)
        n = min(self.C, idx.shape[1])
        idx, ok = idx[:, :n], torch.isfinite(d2s[:, :n])
        ids = torch.where(ok, torch.gather(pid, 1, idx), -1)
        off = torch.gather(pos, 1, idx[..., None].expand(-1, -1, 3)) \
            - centre[:, None]
        if self.cache_dtype == "bfloat16":
            off = round_bf16(off)
        off = torch.where(ok[..., None], off, torch.full_like(off, 1e9))
        if n < self.C:
            ids = F.pad(ids, (0, self.C - n), value=-1)
            off = F.pad(off, (0, 0, 0, self.C - n), value=1e9)
        return ids, off


# ------------------------------------------------------------ samples, kNN

def radius_limit(ref: Dict) -> float:
    return float(ref["radius_limit_scale"]) * max(float(ref["vsize"][0]),
                                                  float(ref["vsize"][1]))


def sample_depths(ref: Dict, n_rays: int, device, u=None):
    """(n_rays, D) sample depths: midpoints of D linear bins on [near,
    far], their lengths jittered by `u` (n_rays, D) when given."""
    D, near, far = int(ref["D"]), float(ref["near"]), float(ref["far"])
    t = linspace01(D + 1, device)
    tv = near * (1.0 - t) + far * t
    seg = (tv[1:] - tv[:-1])[None, :]
    if u is not None:
        seg = seg * (1.0 + float(ref["jitter"]) * (u - 0.5))
    seg = seg.expand(n_rays, D)
    end = near + torch.cat([torch.zeros((n_rays, 1), device=device),
                            ordered_scan(seg, torch.add)], dim=-1)
    return 0.5 * (end[:, :-1] + end[:, 1:])


def shading_points(grid: Grid, campos, raydir, ts, SR: int):
    """The first SR hit samples of each ray: (loc (n,SR,3) with 0 where a
    slot has none, smask (n,SR))."""
    pos = campos[None, None, :] + raydir[:, None, :] * ts[..., None]
    hit = grid.hit(pos)
    rank = torch.cumsum(hit.to(torch.int64), -1) - 1
    take = hit & (rank < SR)
    n = raydir.shape[0]
    loc = torch.zeros((n, SR + 1, 3), device=raydir.device)
    smask = torch.zeros((n, SR + 1), dtype=torch.bool, device=raydir.device)
    slot = torch.where(take, rank, SR)
    rows = torch.arange(n, device=raydir.device)[:, None].expand_as(slot)
    loc[rows[take], slot[take]] = pos[take]
    smask[rows[take], slot[take]] = True
    return loc[:, :SR], smask[:, :SR]


def neighbours(grid: Grid, loc, smask, K: int, radius: float,
               relative: bool):
    """(n,SR,K) point ids of each shading point's K nearest candidates of
    its voxel's cache within `radius` (-1 where fewer), ties in cache
    order. A candidate's offset from the shading point is its cache offset
    less the point's offset from the voxel centre (`relative`, the bf16
    cache's select) or the centre plus its cache offset less the point."""
    n, SR, _ = loc.shape
    flat = loc.reshape(-1, 3)
    m = smask.reshape(-1)
    c = grid.coords(flat)
    vid = grid.lin(c)
    out = torch.full((flat.shape[0], K), -1, dtype=torch.int64,
                     device=loc.device)
    if m.any():
        uv, inv = torch.unique(vid[m], return_inverse=True)
        ids, off = grid.cache(uv)
        centre = grid.query_centre(c[m])
        if relative:
            d = off[inv] - (flat[m] - centre)[:, None, :]
        else:
            d = (centre[:, None, :] + off[inv]) - flat[m][:, None, :]
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        r2 = float(np.float32(radius) * np.float32(radius))
        ok = (ids[inv] >= 0) & (d2 <= r2)
        big = torch.finfo(torch.float32).max
        d2m = torch.where(ok, d2, torch.full_like(d2, big))
        top, idx = torch.sort(d2m, dim=-1, stable=True)
        sel = torch.gather(ids[inv], 1, idx[:, :K])
        out[m] = torch.where(top[:, :K] < big, sel, -1)
    return out.reshape(n, SR, K)


# ------------------------------------------------------------------ shading

def attribute_table(attrs: Dict, semantic: bool, gather_dtype: str):
    cols = [attrs["xyz"], attrs["embedding"], attrs["color"], attrs["dir"],
            attrs["conf"]] + ([attrs["sem_embedding"]] if semantic else [])
    t = torch.cat(cols, dim=-1)
    return round_bf16(t) if gather_dtype == "bfloat16" else t


def pe(x, freqs: int, ori: bool = False):
    """Positional encoding, frequencies innermost per channel, sin/cos
    interleaved ([x | sin | cos] with ori)."""
    bands = 2.0 ** torch.arange(freqs, dtype=x.dtype, device=x.device)
    a = (x[..., None] * bands).reshape(x.shape[:-1] + (freqs * x.shape[-1],))
    if ori:
        return torch.cat([x, torch.sin(a), torch.cos(a)], dim=-1)
    return torch.stack([torch.sin(a), torch.cos(a)], -1).reshape(
        x.shape[:-1] + (2 * a.shape[-1],))


def leaky(x):
    return torch.where(x >= 0, x, 0.01 * x)


def softplus(x):
    return torch.logaddexp(x, x.new_zeros(()))


def to_camera(p, rot, campos):
    """World points -> [x/z, y/z, z] in the camera frame (float32: the
    configuration's product precision is its MLPs')."""
    c = ((p - campos).reshape(-1, 3) @ rot).reshape(p.shape)
    z = c[..., 2]
    zs = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    return torch.stack([c[..., 0] / zs, c[..., 1] / zs, z], -1)


def mlp(x, layers, mm, act_last=True):
    for i, layer in enumerate(layers):
        x = mm(x.reshape(-1, x.shape[-1]), layer["w"]).reshape(
            x.shape[:-1] + (layer["w"].shape[1],)) + layer["b"]
        if act_last or i < len(layers) - 1:
            x = leaky(x)
    return x


def shade(params, ref: Dict, table, pid, loc, raydir, campos, rot, mm):
    """Shading of shading points loc (n,SR,3) with neighbour ids pid
    (n,SR,K): (decoded (n,SR,4) [alpha | rgb], ray_valid (n,SR),
    conf_coefficient (n,SR,K), camera depth of each shading point)."""
    F_ = int(ref["point_features_dim"])
    mask = pid >= 0
    g = table[pid.clamp(min=0)]
    mk = mask[..., None].to(g.dtype)
    xyz = g[..., 0:3] * mk
    emb = g[..., 3:3 + F_] * mk
    conf = g[..., 9 + F_:10 + F_]
    sem = g[..., 10 + F_:] if ref["semantic"] else None
    pers = to_camera(xyz, rot, campos)
    sl = to_camera(loc, rot, campos)
    world = xyz - loc[..., None, :]
    slk = sl[..., None, :]
    d = torch.cat([world, torch.stack([
        pers[..., 0] * pers[..., 2] - slk[..., 0] * slk[..., 2],
        pers[..., 1] * pers[..., 2] - slk[..., 1] * slk[..., 2],
        pers[..., 2] - slk[..., 2]], -1)], -1)
    m = mask.to(d.dtype)
    nrm = torch.sqrt(torch.clamp((d[..., :3] * d[..., :3]).sum(-1),
                                 min=1e-12))
    w = m * (1.0 / torch.clamp(nrm, min=1e-6))
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-8)
    cc = conf[..., 0]
    cc = cc - (cc - torch.clamp(cc, 1e-4, 1.0)).detach()
    w = w * cc * m
    ray_valid = mask.any(-1)
    vd = raydir[:, None, :].expand(loc.shape)
    vdp = pe(vd, int(ref["viewdir_freqs"]), ori=True)[..., 3:]
    x = torch.cat([emb, pe(emb, int(ref["feat_freqs"])),
                   pe(d, int(ref["dist_freqs"]))], -1)
    h = mlp(x, params["block1"], mm)
    if "block2_bpnet" in params:
        h = mlp(torch.cat([h, sem], -1), params["block2_bpnet"], mm)
    raw = mlp(h, params["alpha_branch"], mm, act_last=False)
    alpha_nb = softplus(raw - 1.0) * m[..., None]
    alpha = (alpha_nb * w[..., None]).sum(-2)
    feat = (h * m[..., None] * w[..., None]).sum(-2)
    rgb = torch.sigmoid(mlp(torch.cat([feat, vdp], -1),
                            params["color_branch"], mm, act_last=False))
    rgb = rgb * (1 + 2 * 0.001) - 0.001
    decoded = torch.cat([alpha, rgb], -1) * ray_valid[..., None].to(
        alpha.dtype)
    return decoded, ray_valid, cc, sl[..., 2]


def march(decoded, ray_valid, z, vsize_z: float, bg):
    """Alpha compositing of the shading points: (colour (n,3),
    background transmission (n,1))."""
    zc = torch.cummax(z, dim=-1).values
    dist = torch.cat([zc[..., 1:] - zc[..., :-1],
                      torch.full_like(zc[..., :1], vsize_z)], -1)
    bad = (dist < 1e-8) | (dist > 2 * vsize_z)
    dist = torch.where(bad, torch.full_like(dist, vsize_z), dist)
    dist = dist * ray_valid.to(dist.dtype)
    sigma = decoded[..., 0] * ray_valid.to(decoded.dtype)
    opacity = 1.0 - torch.exp(-sigma * dist)
    acc = ordered_scan(1.0 - opacity + 1e-10, torch.mul)
    trans = torch.cat([torch.ones_like(acc[..., :1]), acc[..., :-1]], -1)
    col = (decoded[..., 1:4] * (opacity * trans)[..., None]).sum(-2)
    return col + bg[None, :] * acc[..., -1:], acc[..., -1:]


def render_rays(grid: Grid, params, ref: Dict, table, campos, rot, raydir,
                mm, u=None):
    """Colours of rays `raydir` (n,3) from camera (campos (3,), rot (3,3)):
    (colour (n,3), ray_mask (n,), conf_coefficient (n,SR,K), decoded ...)."""
    ts = sample_depths(ref, raydir.shape[0], raydir.device, u)
    loc, smask = shading_points(grid, campos, raydir, ts, int(ref["SR"]))
    pid = neighbours(grid, loc, smask, int(ref["K"]), radius_limit(ref),
                     bool(ref["knn_relative"]))
    decoded, ray_valid, cc, z = shade(params, ref, table, pid, loc, raydir,
                                      campos, rot, mm)
    bg = torch.tensor(ref["bg_color"], dtype=torch.float32,
                      device=raydir.device)
    col, _ = march(decoded, ray_valid, z, float(ref["vsize"][2]), bg)
    ray_mask = (pid >= 0).reshape(pid.shape[0], -1).any(-1)
    return col, ray_mask, cc


@torch.no_grad()
def render_frame(grid: Grid, params, ref: Dict, table, campos, rot, raydir,
                 mm, block: int = 4096) -> torch.Tensor:
    """A frame's colours (n,3), in blocks of `block` rays."""
    out = []
    for s in range(0, raydir.shape[0], block):
        out.append(render_rays(grid, params, ref, table, campos, rot,
                               raydir[s:s + block], mm)[0])
    return torch.cat(out)
