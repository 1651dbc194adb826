"""Volume rendering math (counterpart of `sgnerf_tpu/ops/march.py`;
reference diff_ray_marching.py:509-573, diff_render_func.py:8-67,
neural_points_volumetric_model.py:569-578)."""
from __future__ import annotations

import torch

from .scan import ordered_scan


def radiance_render(ray_feature):
    return ray_feature[..., 1:4]


def white_color(ray_feature):
    return torch.ones_like(ray_feature[..., 1:4])


def alpha_blend(opacity, acc_transmission):
    return opacity * acc_transmission


def alpha2_blend(opacity, acc_transmission):
    return opacity * acc_transmission * acc_transmission


def simple_tone_map(color, gamma=2.2, exposure=1.0):
    return torch.clamp((color * exposure + 1e-5) ** (1.0 / gamma), 0.0, 1.0)


def no_tone_map(color):
    return color


def normalize_tone_map(color):
    color = color / (torch.linalg.norm(color, dim=-1, keepdim=True) + 1e-12)
    return color * 0.5 + 0.5


RENDER_FUNCS = {"radiance": radiance_render, "white": white_color}
BLEND_FUNCS = {"alpha": alpha_blend, "alpha2": alpha2_blend}
TONE_MAPS = {"gamma": simple_tone_map, "off": no_tone_map,
             "normalize": normalize_tone_map}


def ray_march(ray_dist, ray_valid, ray_features, render_func, blend_func,
              bg_color=None):
    """Alpha-composite per-sample features along each ray.

    ray_dist (B,R,S); ray_valid (B,R,S) bool; ray_features (B,R,S,C) with
    [..., 0] = sigma and [..., 1:4] = raw colour. Returns (ray_color (B,R,3),
    point_color, opacity, acc_transmission, blend_weight (B,R,S,1),
    background_transmission (B,R,1), background_blend_weight)."""
    point_color = render_func(ray_features)
    sigma = ray_features[..., 0] * ray_valid.to(ray_features.dtype)
    opacity = 1.0 - torch.exp(-sigma * ray_dist)
    acc = ordered_scan(1.0 - opacity + 1e-10, torch.mul)
    background_transmission = acc[..., -1:]
    acc_transmission = torch.cat([torch.ones_like(acc[..., :1]),
                                  acc[..., :-1]], dim=-1)   # exclusive
    blend_weight = blend_func(opacity, acc_transmission)[..., None]
    ray_color = (point_color * blend_weight).sum(-2)
    if bg_color is not None:
        bg = torch.as_tensor(bg_color, dtype=ray_color.dtype,
                             device=ray_color.device).reshape(-1, 1, 3)
        ray_color = ray_color + bg * background_transmission
    background_blend_weight = blend_func(1.0, background_transmission)
    return (ray_color, point_color, opacity, acc_transmission, blend_weight,
            background_transmission, background_blend_weight)


def ray_dist_from_z(sample_loc_z, ray_valid, vsize_z, raydist_mode_unit=1):
    """Per-sample marching distance from monotonized camera-space z:
    cummax -> adjacent diffs -> trailing vsize_z -> degenerate (tiny, or
    > 2*vsize with raydist_mode_unit) diffs replaced by vsize_z -> zeroed
    on invalid samples."""
    z = torch.cummax(sample_loc_z, dim=-1).values
    dist = torch.cat([z[..., 1:] - z[..., :-1],
                      torch.full_like(z[..., :1], vsize_z)], dim=-1)
    mask = dist < 1e-8
    if raydist_mode_unit > 0:
        mask = mask | (dist > 2 * vsize_z)
    dist = torch.where(mask, torch.full_like(dist, vsize_z), dist)
    return dist * ray_valid.to(dist.dtype)
