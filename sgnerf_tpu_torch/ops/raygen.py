"""Ray sample generation (PyTorch counterpart of `sgnerf_tpu/ops/raygen.py`).

Only `near_far_linear` (reference diff_ray_marching.py:349, the ScanNet
default) is in this slice; the other generators come with ROADMAP item 12.

Shapes: campos (B,3), raydir (B,R,3) ->
  raypos (B,R,D,3), segment_length (B,R,D), valid (B,R,D), ts (B,R,D)
"""
from __future__ import annotations

from typing import Optional

import torch

from .scan import ordered_scan


def near_far_linear_ray_generation(campos: torch.Tensor, raydir: torch.Tensor,
                                   point_count: int, near=0.1, far=10.0,
                                   jitter: float = 0.0,
                                   u: Optional[torch.Tensor] = None):
    """D+1 linear bin edges in [near, far], optional jitter of the segment
    lengths by pre-drawn uniforms `u` (B,R,D), midpoints as sample depths."""
    B, R = raydir.shape[0], raydir.shape[1]
    D = point_count
    dev = raydir.device
    # jnp.linspace(0, 1, D+1) as XLA evaluates it: i * (1/D), then 1
    t = torch.cat([torch.arange(D, dtype=torch.float32, device=dev)
                   * (1.0 / D), torch.ones(1, device=dev)])
    tvals = near * (1.0 - t) + far * t
    seg = (tvals[1:] - tvals[:-1])[None, None, :]
    if jitter > 0.0 and u is not None:
        seg = seg * (1.0 + jitter * (u - 0.5))
    seg = seg.expand(B, R, D)
    end_ts = near + torch.cat([torch.zeros((B, R, 1), device=dev),
                               ordered_scan(seg, torch.add)], dim=-1)
    ts = 0.5 * (end_ts[..., :-1] + end_ts[..., 1:])
    raypos = campos[:, None, None, :] + raydir[:, :, None, :] * ts[..., None]
    valid = torch.ones_like(ts)
    seg = seg * torch.linalg.norm(raydir, dim=-1, keepdim=True)
    return raypos, seg, valid, ts
