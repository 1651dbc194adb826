"""Sparse 3D UNet (MinkUNet18A) in BPNet's stage decomposition.

Counterpart of `sgnerf_tpu/models/bpnet/unet3d.py` (reference
models/bpneter/unet_3d.py: BasicBlocks, LAYERS=(2,)*8,
PLANES=(32,64,128,256,128,128,96,96), INIT_DIM=32; conv0 kernel 5,
down/up kernel 2 stride 2, blocks kernel 3):
  layer0 = conv0+bn+relu                       (p1 coords)
  layer1..4 = down-conv+bn+relu+block_i        (p2, p4, p8, p16)
  layer5 = convtr4+bn+relu                     (-> p8)
  layer6..8 = block5..7 on [cat skip]; convtr5..7+bn+relu
  layer9 = block8 on [cat]                     (96-d point feature)
  cls = final 1x1 conv -> classes
Sparse weights are (K^3, ci, co); ops/sparse.py runs them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.sparse import (SparseGrid, sparse_batch_norm, sparse_conv,
                           sparse_conv_down, sparse_conv_up)

PLANES_18A = (32, 64, 128, 256, 128, 128, 96, 96)
LAYERS_18 = (2, 2, 2, 2, 2, 2, 2, 2)
INIT_DIM = 32


def he_conv(gen, k3, ci, co):
    return torch.randn((k3, ci, co), generator=gen) * float(
        np.sqrt(2.0 / (k3 * ci)))


def bn_params(c):
    return {"weight": torch.ones(c), "bias": torch.zeros(c),
            "running_mean": torch.zeros(c), "running_var": torch.ones(c)}


def init_basic_block(gen, ci, co):
    p = {"conv1": he_conv(gen, 27, ci, co), "bn1": bn_params(co),
         "conv2": he_conv(gen, 27, co, co), "bn2": bn_params(co)}
    if ci != co:
        p["downsample"] = {"conv": he_conv(gen, 1, ci, co),
                           "bn": bn_params(co)}
    return p


def apply_basic_block(p, grid: SparseGrid) -> torch.Tensor:
    x = grid.feats
    y = sparse_conv(grid, p["conv1"], kernel_size=3)
    y = sparse_batch_norm(y, grid.mask, p["bn1"], act=F.relu)
    y = sparse_conv(dataclasses.replace(grid, feats=y), p["conv2"],
                    kernel_size=3)
    y = sparse_batch_norm(y, grid.mask, p["bn2"])
    if "downsample" in p:
        x = sparse_conv(grid, p["downsample"]["conv"], kernel_size=1)
        x = sparse_batch_norm(x, grid.mask, p["downsample"]["bn"])
    y = F.relu(y + x)
    return y * grid.mask[:, None].to(y.dtype)


def _apply_blocks(blocks, grid):
    for bp in blocks:
        grid = dataclasses.replace(grid, feats=apply_basic_block(bp, grid))
    return grid


def _blocks(gen, ci, co, n):
    return [init_basic_block(gen, ci if i == 0 else co, co)
            for i in range(n)]


def init_unet3d_params(gen: torch.Generator, in_channels: int,
                       out_channels: int, planes=PLANES_18A,
                       layers=LAYERS_18) -> Dict[str, Any]:
    p: Dict[str, Any] = {"conv0p1s1": he_conv(gen, 125, in_channels,
                                              INIT_DIM),
                         "bn0": bn_params(INIT_DIM)}
    inp = INIT_DIM
    for i in range(4):
        p[f"conv{i + 1}"] = he_conv(gen, 8, inp, inp)
        p[f"bn{i + 1}"] = bn_params(inp)
        p[f"block{i + 1}"] = _blocks(gen, inp, planes[i], layers[i])
        inp = planes[i]
    p["convtr4"] = he_conv(gen, 8, planes[3], planes[4])
    p["bntr4"] = bn_params(planes[4])
    for bname, cin, cout, tname, tco in (
            ("block5", planes[4] + planes[2], planes[4], "convtr5", planes[5]),
            ("block6", planes[5] + planes[1], planes[5], "convtr6", planes[6]),
            ("block7", planes[6] + planes[0], planes[6], "convtr7",
             planes[7])):
        p[bname] = _blocks(gen, cin, cout, 2)
        p[tname] = he_conv(gen, 8, cout, tco)
        p[f"bntr{tname[-1]}"] = bn_params(tco)
    p["block8"] = _blocks(gen, planes[7] + INIT_DIM, planes[7], 2)
    p["final"] = {"kernel": he_conv(gen, 1, planes[7], out_channels),
                  "bias": torch.zeros(out_channels)}
    return p


# ------------------------------------------------------------ staged forward

def layer0(p, grid: SparseGrid) -> SparseGrid:
    f = sparse_conv(grid, p["conv0p1s1"], kernel_size=5)
    f = sparse_batch_norm(f, grid.mask, p["bn0"], act=F.relu)
    return dataclasses.replace(grid, feats=f)


def down_stage(p, i: int, grid: SparseGrid, cap: int) -> SparseGrid:
    g, f = sparse_conv_down(grid, p[f"conv{i}"], cap)
    f = sparse_batch_norm(f, g.mask, p[f"bn{i}"], act=F.relu)
    return _apply_blocks(p[f"block{i}"], dataclasses.replace(g, feats=f))


def up_stage(p, tr: str, coarse: SparseGrid, fine: SparseGrid) -> SparseGrid:
    up = sparse_conv_up(coarse, fine.coords, fine.mask, p[tr])
    up = sparse_batch_norm(up, fine.mask, p[f"bntr{tr[-1]}"], act=F.relu)
    return dataclasses.replace(fine, feats=up)


def blocks_on_cat(p, bname: str, grid: SparseGrid,
                  skip_feats: torch.Tensor) -> SparseGrid:
    g = dataclasses.replace(grid, feats=torch.cat([grid.feats, skip_feats],
                                                  dim=-1))
    return _apply_blocks(p[bname], g)


def cls_head(p, grid: SparseGrid) -> torch.Tensor:
    w = p["final"]["kernel"]                           # (1, c, classes)
    out = grid.feats.to(w.dtype) @ w[0] + p["final"]["bias"]
    return out * grid.mask[:, None].to(out.dtype)
