"""Ray sample generation (PyTorch counterpart of `sgnerf_tpu/ops/raygen.py`,
reference models/rendering/diff_ray_marching.py).

  * near_far_linear (:349, the ScanNet default): D+1 linear bin edges in
    [near, far], jitter of the segment lengths, midpoints as sample depths;
  * near_far_disparity_linear (:201): the same with edges linear in
    disparity (its segment lengths are not scaled by |raydir|);
  * nerf_near_far_(disparity_)linear (:252/:302): NeRF's stratified jitter
    of the sample positions, a trailing 1e10 segment;
  * cube: linear samples on the ray's span inside [-domain_size,
    domain_size]^3 (the reference registers it but never defines it; the
    JAX package's definition).

The jitter is drawn outside, as uniforms `u` (B,R,D)
(renderer.draw_render_noise): in [0, 1), or in [-1, 1) for `cube`.
`sample_pdf`, `near_middle_far` and the `refine_*` generators of the JAX
module are reached by no render path there and are not ported.

Shapes: campos (B,3), raydir (B,R,3) ->
  raypos (B,R,D,3), segment_length (B,R,D), valid (B,R,D), ts (B,R,D)
"""
from __future__ import annotations

from typing import Optional

import torch

from .scan import ordered_scan


def _linspace01(n: int, device) -> torch.Tensor:
    """jnp.linspace(0, 1, n) as XLA evaluates it: i * (1/(n-1)), then 1."""
    return torch.cat([torch.arange(n - 1, dtype=torch.float32, device=device)
                      * (1.0 / (n - 1)), torch.ones(1, device=device)])


def _midpoints(start, seg, B, R, D, dev):
    """Sample depths at the midpoints of consecutive segments from start."""
    end_ts = start + torch.cat([torch.zeros((B, R, 1), device=dev),
                                ordered_scan(seg, torch.add)], dim=-1)
    return 0.5 * (end_ts[..., :-1] + end_ts[..., 1:])


def _positions(campos, raydir, ts):
    return campos[:, None, None, :] + raydir[:, :, None, :] * ts[..., None]


def near_far_linear_ray_generation(campos: torch.Tensor, raydir: torch.Tensor,
                                   point_count: int, near=0.1, far=10.0,
                                   jitter: float = 0.0,
                                   u: Optional[torch.Tensor] = None, **_):
    """D+1 linear bin edges in [near, far], optional jitter of the segment
    lengths by pre-drawn uniforms `u` (B,R,D), midpoints as sample depths."""
    B, R = raydir.shape[0], raydir.shape[1]
    D = point_count
    dev = raydir.device
    t = _linspace01(D + 1, dev)
    tvals = near * (1.0 - t) + far * t
    seg = (tvals[1:] - tvals[:-1])[None, None, :]
    if jitter > 0.0 and u is not None:
        seg = seg * (1.0 + jitter * (u - 0.5))
    seg = seg.expand(B, R, D)
    ts = _midpoints(near, seg, B, R, D, dev)
    raypos = _positions(campos, raydir, ts)
    valid = torch.ones_like(ts)
    seg = seg * torch.linalg.norm(raydir, dim=-1, keepdim=True)
    return raypos, seg, valid, ts


def near_far_disparity_linear_ray_generation(campos, raydir, point_count,
                                             near=0.1, far=10.0, jitter=0.0,
                                             u=None, **_):
    """Bin edges linear in disparity between near and far."""
    B, R = raydir.shape[0], raydir.shape[1]
    D = point_count
    dev = raydir.device
    t = _linspace01(D + 1, dev)
    tvals = 1.0 / (1.0 / near * (1.0 - t) + 1.0 / far * t)
    seg = (tvals[1:] - tvals[:-1])[None, None, :]
    if jitter > 0.0 and u is not None:
        seg = seg * (1.0 + jitter * (u - 0.5))
    seg = seg.expand(B, R, D)
    ts = _midpoints(near, seg, B, R, D, dev)
    # the reference does not scale seg by |raydir| in this variant
    return _positions(campos, raydir, ts), seg, torch.ones_like(ts), ts


def _nerf_stratified(tvals, B, R, D, jitter, u):
    """NeRF's stratified resampling: each depth drawn in its bin."""
    if jitter <= 0.0 or u is None:
        return tvals[None, None, :].expand(B, R, D)
    mids = 0.5 * (tvals[1:] + tvals[:-1])
    upper = torch.cat([mids, tvals[-1:]])
    lower = torch.cat([tvals[:1], mids])
    return lower[None, None, :] + (upper - lower)[None, None, :] * u


def _nerf_tail(campos, raydir, ts, B, R):
    seg = torch.cat([ts[..., 1:] - ts[..., :-1],
                     torch.full((B, R, 1), 1e10, device=ts.device)], dim=-1)
    seg = seg * torch.linalg.norm(raydir, dim=-1, keepdim=True)
    return _positions(campos, raydir, ts), seg, torch.ones_like(ts), ts


def nerf_near_far_linear_ray_generation(campos, raydir, point_count,
                                        near=0.1, far=10.0, jitter=1.0,
                                        u=None, **_):
    B, R = raydir.shape[0], raydir.shape[1]
    D = point_count
    t = _linspace01(D, raydir.device)
    tvals = near * (1.0 - t) + far * t
    ts = _nerf_stratified(tvals, B, R, D, jitter, u)
    return _nerf_tail(campos, raydir, ts, B, R)


def nerf_near_far_disparity_linear_ray_generation(campos, raydir,
                                                  point_count, near=0.1,
                                                  far=10.0, jitter=1.0,
                                                  u=None, **_):
    B, R = raydir.shape[0], raydir.shape[1]
    D = point_count
    t = _linspace01(D, raydir.device)
    tvals = 1.0 / (1.0 / near * (1.0 - t) + 1.0 / far * t)
    ts = _nerf_stratified(tvals, B, R, D, jitter, u)
    return _nerf_tail(campos, raydir, ts, B, R)


def cube_ray_generation(campos, raydir, point_count, near=0.1, far=10.0,
                        jitter=0.0, domain_size=1.0, u=None, **_):
    """Linear samples on the ray's span clipped to [-domain_size,
    domain_size]^3 (slab intersection, then [near, far]); samples outside
    the cube, and rays that miss it, are invalid. `u` in [-1, 1)."""
    B, R = raydir.shape[0], raydir.shape[1]
    D = point_count
    dev = raydir.device
    tiny = torch.where(raydir < 0, torch.full_like(raydir, -1e-9),
                       torch.full_like(raydir, 1e-9))
    inv = 1.0 / torch.where(raydir.abs() < 1e-9, tiny, raydir)
    t0 = (-domain_size - campos[:, None, :]) * inv            # (B,R,3)
    t1 = (domain_size - campos[:, None, :]) * inv
    tn = torch.minimum(t0, t1).max(dim=-1).values
    tf = torch.maximum(t0, t1).min(dim=-1).values
    tn = torch.clamp(tn, min=near)
    tf = torch.clamp(tf, max=far)
    hit = tf > tn
    tn = torch.where(hit, tn, torch.full_like(tn, near))
    tf = torch.where(hit, tf, torch.full_like(tf, far))
    t = _linspace01(D + 1, dev)
    tvals = tn[..., None] * (1.0 - t) + tf[..., None] * t      # (B,R,D+1)
    seg = tvals[..., 1:] - tvals[..., :-1]
    if jitter > 0 and u is not None:
        seg = seg * (1.0 + jitter * u)
    ts = _midpoints(tn[..., None], seg, B, R, D, dev)
    raypos = _positions(campos, raydir, ts)
    valid = (((raypos > -domain_size) & (raypos < domain_size)).all(dim=-1)
             & hit[..., None]).to(raydir.dtype)
    seg = seg * torch.linalg.norm(raydir, dim=-1, keepdim=True)
    return raypos, seg, valid, ts


_RAYGEN = {
    "cube": cube_ray_generation,
    "near_far_linear": near_far_linear_ray_generation,
    "near_far_disparity_linear": near_far_disparity_linear_ray_generation,
    "nerf_near_far_linear": nerf_near_far_linear_ray_generation,
    "nerf_near_far_disparity_linear":
        nerf_near_far_disparity_linear_ray_generation,
}

# generators whose positions are campos + t * dir: the query may recompute
# a shading point from its depth (the cube clips to its box instead)
LAZY_RAYGENS = ("near_far_linear", "near_far_disparity_linear",
                "nerf_near_far_linear", "nerf_near_far_disparity_linear")


def find_ray_generation_method(name: str):
    if name not in _RAYGEN:
        raise RuntimeError(f"No such ray generation method: {name}")
    return _RAYGEN[name]
