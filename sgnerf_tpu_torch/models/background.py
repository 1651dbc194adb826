"""Plane background (`--bgmodel *plane`; counterpart of
`sgnerf_tpu/models/background.py`).

The DTU inference configs (dev_scripts/dtu_test_inf/*.sh) render the
table under the object by intersecting each ray with the scan's ground
plane and sampling the plane point's colour from the MVS source views:

  * ray-plane intersection: reference mvs_utils.py:379-407;
  * per-view colour, the cloud's own pixels suppressed, the plane-colour
    fit filter, the maximum over views: reference
    mvs_points_volumetric_model.py:305-343 (`set_bg`);
  * blending `colour + bgT * (bg_ray - bg_color)` outside the render
    (SceneModel.render_image(bg_image=), the train step's `bg_ray`), exact
    for the shipped black-background configs (reference
    neural_points_volumetric_model.py:175-177).

Plain tensor code on the run's device; the backgrounds come back as host
arrays, one (R,3) per frame or batch.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .mvs import grid_sample_norm, homo_warp_nongrid


def _t(a, device):
    return torch.tensor(np.asarray(a, np.float32), device=device)


def rayplane_cross(campos, raydir, plane_pnt, plane_normal, epsilon=1e-3):
    """campos (3,), raydir (R,3), plane point and normal (3,) -> (R,3)
    intersections, zeros where the ray is (near-)parallel to the plane or
    leaves it (`dot < epsilon`, the reference's one-sided test)."""
    campos, p_co, p_no = (t.reshape(3) for t in (campos, plane_pnt,
                                                 plane_normal))
    dot = (p_no * raydir).sum(-1)                              # (R,)
    ok = dot >= epsilon
    fac = -(p_no * (campos - p_co)).sum() / torch.where(
        ok, dot, torch.ones_like(dot))
    cross = campos + raydir * fac[..., None]
    return torch.where(ok[..., None], cross, torch.zeros_like(cross))


def _pixel_coords(xyz, w2c, intrinsic, HD, WD):
    """Raw pixel xy of world points in a source view and the in-frame mask,
    without the [-1,1] round trip (the reference takes ceil of the raw
    pixel coords, mvs_utils.py:311, which the round trip would move off
    exact integers)."""
    ones = torch.ones_like(xyz[:, :1])
    src = (torch.cat([xyz, ones], -1) @ w2c.T)[:, :3]
    pix = (src / src[:, 2:3]) @ intrinsic.T
    gxy = pix[:, :2]
    lim = torch.tensor([WD - 1.0, HD - 1.0], device=xyz.device)
    mask = ((gxy >= 0) & (gxy <= lim)).all(dim=-1)
    return gxy, mask


def _ceil_pixels(gxy, HD, WD):
    px = torch.ceil(gxy[:, 0]).to(torch.int64)
    py = torch.ceil(gxy[:, 1]).to(torch.int64)
    return px.clamp(0, WD - 1), py.clamp(0, HD - 1)


def foreground_mask_image(xyz, w2c, intrinsic, HD, WD):
    """(HD, WD) bool image of the pixels the cloud covers in a source view
    (reference homo_warp_fg_mask + id2mask, mvs_utils.py:317-330): points
    land on ceil(pixel); those inside the frame mark their pixel."""
    gxy, mask = _pixel_coords(xyz, w2c, intrinsic, HD, WD)
    px, py = _ceil_pixels(gxy, HD, WD)
    img = torch.zeros((HD, WD), dtype=torch.bool, device=xyz.device)
    img[py[mask], px[mask]] = True
    return img


def foreground_images(xyz, images, w2cs, intrinsics):
    """(V,H,W) bool: the cloud's pixels in each source view."""
    H, W = images.shape[1:3]
    return torch.stack([foreground_mask_image(xyz, w2cs[v], intrinsics[v],
                                              H, W)
                        for v in range(images.shape[0])])


def plane_bg_colors(xyz_world, images, w2cs, intrinsics, plane_color,
                    fg_images=None, thresh=0.03):
    """Per-ray plane colours (reference set_bg). xyz_world (R,3) ray/plane
    intersections (zeros: no hit), images (V,H,W,3) in [0,1], w2cs
    (V,4,4), intrinsics (V,3,3), plane_color (3,), fg_images (V,H,W) the
    cloud's pixels (foreground_images). A view's sample counts where it is
    in frame, off the cloud's pixels and within +-thresh of the plane
    colour; the result is the maximum over views, zeros elsewhere. All
    tensors on one device."""
    hit = (xyz_world != 0.0).any(dim=-1)                        # (R,)
    eye = torch.eye(4, device=xyz_world.device)
    per_view = []
    for v in range(images.shape[0]):
        img = images[v]
        H, W = img.shape[:2]
        grid, mask = homo_warp_nongrid(eye, w2cs[v], intrinsics[v],
                                       xyz_world, H, W)
        if fg_images is not None:
            gxy, _ = _pixel_coords(xyz_world, w2cs[v], intrinsics[v], H, W)
            px, py = _ceil_pixels(gxy, H, W)
            mask = mask & ~fg_images[v][py, px]
        col = grid_sample_norm(img.permute(2, 0, 1), grid)     # (R,3)
        fit = ((col >= plane_color - thresh)
               & (col <= plane_color + thresh)).all(dim=-1)
        keep = (mask & fit & hit)[..., None]
        per_view.append(torch.where(keep, col, torch.zeros_like(col)))
    return torch.stack(per_view).max(dim=0).values


def _init_views(init_views: Dict, device):
    return (_t(init_views["images"], device), _t(init_views["w2cs"], device),
            _t(init_views["intrinsics"], device))


def plane_bg_ray(item: Dict, init_views: Dict, cloud_xyz=None,
                 thresh: float = 0.03, device="cpu",
                 fg_images=None) -> Optional[np.ndarray]:
    """One frame's or batch's per-ray background: item has campos (3,),
    raydir (R,3) and the plane (plane_pnt, plane_normal, plane_color, as
    the dtu_ft dataset gives them); init_views the source views
    (dataset.get_init_item: images, w2cs, intrinsics); cloud_xyz (N,3) the
    live points, or fg_images their pixels made once. Returns (R,3)
    float32, or None when the item has no plane."""
    if item.get("plane_pnt") is None:
        return None
    imgs, w2cs, intrs = _init_views(init_views, device)
    cross = rayplane_cross(
        _t(item["campos"], device), _t(item["raydir"], device),
        _t(item["plane_pnt"], device), _t(item["plane_normal"], device))
    if fg_images is None and cloud_xyz is not None:
        fg_images = foreground_images(_t(cloud_xyz, device), imgs, w2cs,
                                      intrs)
    bg = plane_bg_colors(cross, imgs, w2cs, intrs,
                         _t(item["plane_color"], device),
                         fg_images=fg_images, thresh=thresh)
    return bg.cpu().numpy()


def create_all_bg(dataset, cloud_xyz=None, thresh: float = 0.03,
                  device="cpu"):
    """A full-frame plane background per dataset frame (reference
    run/train_ft.py:559-586): a training batch indexes its pixels in its
    frame's image instead of warping again. The cloud's pixel masks in the
    source views are made once. Returns {frame index: (H,W,3)}, or None
    when the dataset has no plane."""
    if not hasattr(dataset, "get_init_item"):
        return None
    init_views = dataset.get_init_item(0)
    fg = None
    if cloud_xyz is not None:
        imgs, w2cs, intrs = _init_views(init_views, device)
        fg = foreground_images(_t(cloud_xyz, device), imgs, w2cs, intrs)
    bgs = {}
    for i in range(len(dataset)):
        item = dataset.get_item(i, full_img=True)
        if item.get("plane_pnt") is None:
            return None
        bg = plane_bg_ray(item, init_views, None, thresh, device,
                          fg_images=fg)
        bgs[i] = bg.reshape(int(item["h"]), int(item["w"]), 3)
    return bgs
