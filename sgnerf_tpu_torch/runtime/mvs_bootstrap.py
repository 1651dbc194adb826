"""The MVS point-cloud bootstrap (`--load_points 0`; counterpart of
`sgnerf_tpu/runtime/mvs_bootstrap.py`, the reference's
gen_points_filter_embeddings, run/train_ft.py:101-170).

Per init view: the dataset's depth (manual_depth_view 0) or MVSNet's at
1/4 scale (1), on the device; cross-view geometric-consistency filtering
there, only the surviving points to the host; the `ranges` crop, the
visual hull of alpha-mask datasets, voxel downsampling; then each point's
embedding, colour and direction from FeatureNet and premlp in its most
head-on camera.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..models.mvs import MVSConfig, MvsPointsModel, init_mvs_params
from ..models.mvs_filter import alpha_masking, filter_depths
from .native import nearest_view, vox_downsample_closest


def mvs_model(opt, device) -> MvsPointsModel:
    """Seeded MVS nets, the official MVSNet from `--pre_d_est` when that
    file exists."""
    cfg = MVSConfig(depth_grid=opt.depth_grid, dprob_thresh=opt.dprob_thresh,
                    point_features_dim=opt.point_features_dim,
                    init_view_num=opt.init_view_num)
    params = init_mvs_params(0, cfg, device)
    if getattr(opt, "pre_d_est", None) and os.path.exists(opt.pre_d_est):
        from ..models.checkpoint_io import convert_official_mvsnet_checkpoint
        params["official"] = convert_official_mvsnet_checkpoint(
            opt.pre_d_est, device)
    return MvsPointsModel(cfg, params=params, device=device)


def mvsnet_inputs(item, depth_grid: int, device):
    """An init item's MVSNet inputs on `device`: the views (V,H,W,3), their
    projections relative to the reference view at feature scale (1/4)
    (V,3,4), the depth planes (D,), and the reference intrinsic at that
    scale."""
    intr = np.asarray(item["intrinsics"][0], np.float32)
    w2c = np.asarray(item["w2cs"][0], np.float32)
    s = np.diag([0.25, 0.25, 1.0]).astype(np.float32)
    ref_proj = np.eye(4, dtype=np.float32)
    ref_proj[:3, :4] = (s @ intr) @ w2c[:3, :4]
    projs = []
    for v in range(len(item["images"])):
        pv = np.eye(4, dtype=np.float32)
        pv[:3, :4] = (s @ np.asarray(item["intrinsics"][v])) @ \
            np.asarray(item["w2cs"][v])[:3, :4]
        projs.append((pv @ np.linalg.inv(ref_proj))[:3, :4])
    dvals = torch.linspace(float(item["near"]), float(item["far"]),
                           depth_grid, device=device)
    return (_t(item["images"], device), _t(np.stack(projs), device), dvals,
            _t((s @ intr).astype(np.float32), device))


def _t(a, device):
    return torch.tensor(np.asarray(a, np.float32), device=device)


def init_view_depth(mvs: MvsPointsModel, item, use_gt: bool, device):
    """One init item's (depth, confidence, intrinsic at the depth's scale,
    w2c) as tensors on `device`: the dataset's depth when use_gt and the
    item has one, else MVSNet's at feature scale (1/4)."""
    w2c = _t(item["w2cs"][0], device)
    if use_gt and "gt_depth" in item:
        depth = _t(item["gt_depth"], device)
        return (depth, torch.ones_like(depth),
                _t(item["intrinsics"][0], device), w2c)
    imgs, projs, dvals, intr = mvsnet_inputs(item, mvs.cfg.depth_grid, device)
    with torch.no_grad():
        depth, conf, _ = mvs.predict_depth(imgs, projs, dvals)
    return depth, conf, intr, w2c


def gen_points_filter_embeddings(dataset, opt, device="cpu", mvs=None):
    """Returns host arrays (xyz (N,3), embedding, colour, dir, conf (N,1)).
    `mvs`: the MvsPointsModel to use (default: mvs_model(opt, device))."""
    mvs = mvs if mvs is not None else mvs_model(opt, device)
    n_views = min(len(dataset), max(1, getattr(opt, "init_view_num", 3) * 8))
    use_gt = opt.manual_depth_view == 0
    views = [init_view_depth(mvs, dataset.get_init_item(i), use_gt, device)
             for i in range(n_views)]
    depths, confs, intrs, extrs = (list(z) for z in zip(*views))
    thr = opt.depth_conf_thresh if opt.depth_conf_thresh is not None else 0.8
    results = filter_depths(depths, intrs, extrs, confs,
                            depth_conf_thresh=thr,
                            geo_cnsst_num=max(opt.geo_cnsst_num, 0))
    del views, depths, confs
    xyz = np.concatenate([r[0] for r in results]) if results else \
        np.zeros((0, 3), np.float32)
    conf_all = np.concatenate([r[1] for r in results]) if results else \
        np.zeros((0,), np.float32)

    ranges = np.asarray(opt.ranges)
    if len(xyz) and ranges[0] > -99.0:
        m = np.all((xyz >= ranges[:3]) & (xyz <= ranges[3:]), axis=-1)
        xyz, conf_all = xyz[m], conf_all[m]
    if len(xyz) and getattr(dataset, "alphas", None) is not None:
        # the visual hull of alpha-mask datasets (reference
        # run/train_ft.py:132-137; the near/far window only with open
        # ranges, the reference's `opt.ranges[0] < -90.0`)
        nf = dataset.near_far if ranges[0] < -90.0 else None
        m = alpha_masking(
            xyz, dataset.alphas, dataset.view_intrinsics,
            dataset.world2cams, nf,
            alpha_range=getattr(opt, "alpha_range", 0),
            inall_img=getattr(opt, "inall_img", 1))
        xyz, conf_all = xyz[m], conf_all[m]
    if len(xyz) and opt.vox_res > 0:
        keep = vox_downsample_closest(xyz, opt.vox_res)
        xyz, conf_all = xyz[keep], conf_all[keep]

    if len(xyz) == 0:
        raise RuntimeError(
            "MVS bootstrap produced 0 points: check depth_conf_thresh/"
            "geo_cnsst_num (cross-view consistency removed everything)")
    emb, color, dirs, _ = mvs.embed_points(xyz.astype(np.float32), dataset,
                                           nearest_view)
    return (xyz.astype(np.float32), emb, color, dirs,
            conf_all.reshape(-1, 1).astype(np.float32))
