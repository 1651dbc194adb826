"""Bidirectional projection module (BPM, `Linking`).

Counterpart of `sgnerf_tpu/models/bpnet/linking.py` (reference
models/bpneter/bpm.py:21-98), at one pyramid level:
  * 3D -> 2D: a sparse conv maps the 3D features to the 2D width and
    scatters them into each view at the voxel's linked pixel; a Conv2d +
    BN + ReLU fuses them with the 2D map;
  * 2D -> 3D: each view's 2D features gathered at the linked pixels,
    concatenated (V*C2d), through two sparse convs (view_fusion), then
    concatenated with the 3D features and fused by a sparse conv (fuseTo3d).

Links: (M, 4, V) int per voxel row = [batch, row (y), col (x), valid],
already mapped to the level's rows and scaled to its resolution.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.sparse import SparseGrid, sparse_batch_norm, sparse_conv
from ..mvs import batch_norm, conv2d
from .unet3d import bn_params, he_conv


def _conv2(gen, ci, co):
    return torch.randn((co, ci, 3, 3), generator=gen) * float(
        np.sqrt(2.0 / (9 * ci)))


def init_linking_params(gen: torch.Generator, fea2d_dim: int, fea3d_dim: int,
                        view_num: int):
    return {
        "view_fusion": {
            "conv1": he_conv(gen, 27, fea2d_dim * view_num, fea2d_dim),
            "bn1": bn_params(fea2d_dim),
            "conv2": he_conv(gen, 27, fea2d_dim, fea3d_dim),
            "bn2": bn_params(fea3d_dim)},
        "fuseTo3d": {"conv": he_conv(gen, 27, fea3d_dim * 2, fea3d_dim),
                     "bn": bn_params(fea3d_dim)},
        "view_sep": {"conv": he_conv(gen, 27, fea3d_dim, fea2d_dim),
                     "bn": bn_params(fea2d_dim)},
        "fuseTo2d": {"conv": _conv2(gen, fea2d_dim * 2, fea2d_dim),
                     "bn": bn_params(fea2d_dim)},
    }


def scatter_last_writer(upd: torch.Tensor, pix: torch.Tensor,
                        n_pix: int) -> torch.Tensor:
    """(n_pix, C) plane: each pixel takes the row of `upd` with the largest
    row index among those written to it (rows write in order, the last one
    stays: the JAX scatter's order on the CPU), zeros where none writes.
    A max over row indices, so the same on any device and thread count."""
    M = upd.shape[0]
    rows = torch.arange(M, device=upd.device)
    winner = torch.full((n_pix,), -1, dtype=torch.long, device=upd.device)
    winner.scatter_reduce_(0, pix, rows, reduce="amax")
    return torch.where((winner >= 0)[:, None], upd[winner.clamp(min=0)],
                       torch.zeros((), dtype=upd.dtype, device=upd.device))


def apply_linking(p, feat_2d_all: torch.Tensor, grid3d: SparseGrid,
                  links: torch.Tensor, view_num: int
                  ) -> Tuple[SparseGrid, torch.Tensor]:
    """feat_2d_all (V,C2d,H,W) [batch 1]; grid3d the level's sparse grid;
    links (M,4,V). Returns (fused 3D grid, fused 2D maps (V,C2d,H,W))."""
    V, C2, H, W = feat_2d_all.shape
    f3_for_2d = sparse_conv(grid3d, p["view_sep"]["conv"], kernel_size=3)
    f3_for_2d = sparse_batch_norm(f3_for_2d, grid3d.mask, p["view_sep"]["bn"],
                                  act=F.relu)
    planes, gathers = [], []
    for v in range(view_num):
        valid = (links[:, 3, v] > 0) & grid3d.mask
        yc = links[:, 1, v].clamp(0, H - 1).long()
        xc = links[:, 2, v].clamp(0, W - 1).long()
        # 2D -> 3D gather
        g = feat_2d_all[v][:, yc, xc].t()
        gathers.append(g * valid[:, None].to(g.dtype))
        # 3D -> 2D scatter, every row writing (invalid ones zeros)
        upd = torch.where(valid[:, None], f3_for_2d,
                          torch.zeros((), dtype=f3_for_2d.dtype,
                                      device=f3_for_2d.device))
        plane = scatter_last_writer(upd, yc * W + xc, H * W)
        planes.append(plane.t().reshape(C2, H, W).to(feat_2d_all.dtype))
    feat_3d_to_2d = torch.stack(planes)
    fused_2d = conv2d(torch.cat([feat_2d_all, feat_3d_to_2d], dim=1),
                      p["fuseTo2d"]["conv"])
    fused_2d = batch_norm(fused_2d, p["fuseTo2d"]["bn"], slope=0.0)

    g = dataclasses.replace(grid3d, feats=torch.cat(gathers, dim=-1))
    f = sparse_conv(g, p["view_fusion"]["conv1"], kernel_size=3)
    f = sparse_batch_norm(f, g.mask, p["view_fusion"]["bn1"], act=F.relu)
    g = dataclasses.replace(g, feats=f)
    f = sparse_conv(g, p["view_fusion"]["conv2"], kernel_size=3)
    f = sparse_batch_norm(f, g.mask, p["view_fusion"]["bn2"], act=F.relu)

    g = dataclasses.replace(grid3d, feats=torch.cat([grid3d.feats, f], -1))
    f = sparse_conv(g, p["fuseTo3d"]["conv"], kernel_size=3)
    f = sparse_batch_norm(f, g.mask, p["fuseTo3d"]["bn"], act=F.relu)
    return dataclasses.replace(grid3d, feats=f), fused_2d
