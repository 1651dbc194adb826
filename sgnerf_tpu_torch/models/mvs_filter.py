"""Cross-view geometric-consistency filtering of MVS depth maps
(counterpart of `sgnerf_tpu/models/mvs_filter.py`; reference
models/mvs/filter_utils.py:140-295).

A depth pixel survives when, reprojected into at least `geo_cnsst_num`
source views and back, it lands within 1 px and 1% relative depth of
itself, and its confidence passes the threshold; the surviving depth is
the mean over the agreeing views. The per-view work runs on the depth
maps' device; only the surviving points go to the host.
`alpha_masking`, the visual-hull filter, is a numpy copy of the JAX
package's.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .mvs import bilinear_interpolate


def _pixel_grid(H, W, like):
    y, x = torch.meshgrid(
        torch.arange(H, dtype=like.dtype, device=like.device),
        torch.arange(W, dtype=like.dtype, device=like.device), indexing="ij")
    return x, y


def reproject_with_depth(depth_ref, intr_ref, extr_ref, depth_src, intr_src,
                         extr_src):
    """Depths (H,W); intrinsics (3,3); extrinsics (4,4) world->cam.
    Returns (depth_reprojected, x2d, y2d, out-of-range mask) in the ref
    view."""
    H, W = depth_ref.shape
    x, y = _pixel_grid(H, W, depth_ref)
    # ref pixel -> ref cam -> world
    pix = torch.stack([x, y, torch.ones_like(x)], dim=-1)     # (H,W,3)
    cam_ref = (pix @ torch.linalg.inv(intr_ref).T) * depth_ref[..., None]
    ones = torch.ones_like(cam_ref[..., :1])
    world = (torch.cat([cam_ref, ones], -1)
             @ torch.linalg.inv(extr_ref).T)[..., :3]
    # world -> src cam -> src pixel
    cam_src = (torch.cat([world, ones], -1) @ extr_src.T)[..., :3]
    z_src = torch.clamp(cam_src[..., 2], min=1e-6)
    pix_src = (cam_src / z_src[..., None]) @ intr_src.T
    xs, ys = pix_src[..., 0], pix_src[..., 1]
    oor = (xs < 0) | (xs > W - 1) | (ys < 0) | (ys > H - 1)
    # sample the src depth, lift to world, project back to ref
    d_src = bilinear_interpolate(depth_src[..., None], xs, ys)[..., 0]
    cam_src2 = (torch.stack([xs, ys, torch.ones_like(xs)], -1)
                @ torch.linalg.inv(intr_src).T) * d_src[..., None]
    world2 = (torch.cat([cam_src2, ones], -1)
              @ torch.linalg.inv(extr_src).T)[..., :3]
    cam_ref2 = (torch.cat([world2, ones], -1) @ extr_ref.T)[..., :3]
    depth_re = cam_ref2[..., 2]
    z2 = torch.clamp(depth_re, min=1e-6)
    pix_re = (cam_ref2 / z2[..., None]) @ intr_ref.T
    return depth_re, pix_re[..., 0], pix_re[..., 1], oor


def consistency_terms(depth_ref, intr_ref, extr_ref, depth_src, intr_src,
                      extr_src):
    """(pixel distance, relative depth error, reprojected depth, in-range)
    of the ref view's pixels through one source view: the quantities the
    consistency test thresholds at 1 and 0.01."""
    H, W = depth_ref.shape
    x, y = _pixel_grid(H, W, depth_ref)
    depth_re, x2, y2, oor = reproject_with_depth(
        depth_ref, intr_ref, extr_ref, depth_src, intr_src, extr_src)
    dist = torch.sqrt((x2 - x) ** 2 + (y2 - y) ** 2)
    rel = (depth_re - depth_ref).abs() / torch.clamp(depth_ref, min=1e-6)
    return dist, rel, depth_re, ~oor


def check_geometric_consistency(depth_ref, intr_ref, extr_ref, depth_src,
                                intr_src, extr_src):
    dist, rel, depth_re, inr = consistency_terms(
        depth_ref, intr_ref, extr_ref, depth_src, intr_src, extr_src)
    mask = (dist < 1) & (rel < 0.01)
    return mask, inr, torch.where(mask, depth_re, torch.zeros_like(depth_re))


def filter_depths(depths: Sequence[torch.Tensor],
                  intrinsics: Sequence[torch.Tensor],
                  extrinsics: Sequence[torch.Tensor],
                  confidences: Sequence[torch.Tensor],
                  depth_conf_thresh: float = 0.8,
                  geo_cnsst_num: int = 2
                  ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Per view, the (world xyz (M,3), confidence (M,)) of its surviving
    pixels, as host arrays."""
    V = len(depths)
    out = []
    for ref in range(V):
        H, W = depths[ref].shape
        geo_sum = torch.zeros((H, W), dtype=torch.int32,
                              device=depths[ref].device)
        depth_sum = torch.zeros_like(depths[ref])
        for src in range(V):
            if src == ref:
                continue
            m, _, d = check_geometric_consistency(
                depths[ref], intrinsics[ref], extrinsics[ref],
                depths[src], intrinsics[src], extrinsics[src])
            geo_sum = geo_sum + m.to(torch.int32)
            depth_sum = depth_sum + d
        depth_avg = (depth_sum + depths[ref]) / (geo_sum + 1)
        final = confidences[ref] > depth_conf_thresh
        if V > 1:
            final = final & (geo_sum >= geo_cnsst_num)
        x, y = _pixel_grid(H, W, depths[ref])
        pix = torch.stack([x, y, torch.ones_like(x)], -1)
        cam = (pix @ torch.linalg.inv(intrinsics[ref]).T) \
            * depth_avg[..., None]
        ones = torch.ones_like(cam[..., :1])
        world = (torch.cat([cam, ones], -1)
                 @ torch.linalg.inv(extrinsics[ref]).T)[..., :3]
        out.append((world[final].cpu().numpy(),
                    confidences[ref][final].cpu().numpy()))
    return out


def alpha_masking(xyz, alphas, intrinsics, w2cs, near_far,
                  alpha_range: int = 0, inall_img: int = 1):
    """Visual-hull mask over the bootstrap's points (reference
    mvs_utils.py:572-607, called from run/train_ft.py:132-137 when the
    dataset has per-view alpha masks): a point survives when every view's
    alpha is > 0.1 at its floor-pixel projection (out-of-frame pixels pass
    unless alpha_range > 0 or inall_img == 0 adds the in-frame test), and
    it lies in each view's near/far window when near_far is given.
    xyz (N,3); alphas: (1,H,W) or (H,W) per view; intrinsics (3,3) or
    (4,4) per view; w2cs (4,4) per view. Returns (N,) bool."""
    xyz = np.asarray(xyz, np.float32)
    w1 = np.concatenate([xyz[:, :3], np.ones_like(xyz[:, :1])], axis=-1)
    vishull = None
    for i in range(len(alphas)):
        alpha = np.asarray(alphas[i], np.float32)
        alpha = alpha[0] if alpha.ndim == 3 else alpha
        H, W = alpha.shape
        intr = np.asarray(intrinsics[i], np.float32)[:3, :3]
        w2c = np.asarray(w2cs[i], np.float32)
        cam = w1 @ w2c.T
        nf_mask = None
        if near_far is not None:
            nf_mask = (cam[:, 2] >= near_far[0] - 1.0) \
                & (cam[:, 2] <= near_far[1])
        pix = cam[:, :3] @ intr.T
        img_xy = np.floor(pix[:, :2] / pix[:, 2:3]).astype(np.int64)
        range_mask = None
        if alpha_range > 0 or inall_img == 0:
            range_mask = np.all(
                (img_xy >= 0) & (img_xy < np.asarray([[W, H]])), axis=-1)
        x = np.clip(img_xy[:, 0], 0, W - 1)
        y = np.clip(img_xy[:, 1], 0, H - 1)
        mask = alpha[y, x]
        if range_mask is not None:
            # reference :597: out-of-frame pixels pass the alpha test
            mask = mask + (~range_mask).astype(np.float32)
        mask = mask > 0.1
        m = (mask & nf_mask) if nf_mask is not None else mask
        vishull = m if vishull is None else (vishull & m)
    return vishull
