"""2D ResUNet (ResNet-34 encoder + FPN decoder), BPNet's 2D branch.

Counterpart of `sgnerf_tpu/models/bpnet/unet2d.py` (reference
models/bpneter/unet_2d.py): layer0 = conv7x7 s2 + BN + ReLU + maxpool s2,
layer1..4 BasicBlocks, decoder up4/3/2 = 3x3 conv on the bilinearly
upsampled map concatenated with the encoder skip, then BasicBlock stacks;
cls head 96 -> 256 -> classes. NCHW, conv weights (co, ci, kh, kw).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..mvs import batch_norm, conv2d, resize_bilinear_align_corners


def _conv(gen, kh, kw, ci, co):
    return torch.randn((co, ci, kh, kw), generator=gen) * float(
        np.sqrt(2.0 / (kh * kw * ci)))


def _bn(c):
    return {"weight": torch.ones(c), "bias": torch.zeros(c),
            "running_mean": torch.zeros(c), "running_var": torch.ones(c)}


def bn_act(x, p, act=True):
    return batch_norm(x, p, slope=0.0, act=act)


def init_basic_block2d(gen, ci, co, stride=1):
    p = {"conv1": _conv(gen, 3, 3, ci, co), "bn1": _bn(co),
         "conv2": _conv(gen, 3, 3, co, co), "bn2": _bn(co)}
    if stride != 1 or ci != co:
        p["downsample"] = {"conv": _conv(gen, 1, 1, ci, co), "bn": _bn(co)}
    return p


def apply_basic_block2d(p, x, stride=1):
    y = bn_act(conv2d(x, p["conv1"], stride=stride), p["bn1"])
    y = batch_norm(conv2d(y, p["conv2"]), p["bn2"], act=False)
    if "downsample" in p:
        x = batch_norm(conv2d(x, p["downsample"]["conv"], stride=stride),
                       p["downsample"]["bn"], act=False)
    return F.relu(y + x)


def _layer(gen, ci, co, n, stride):
    return [init_basic_block2d(gen, ci if i == 0 else co, co,
                               stride if i == 0 else 1) for i in range(n)]


# encoder layer index -> first-block stride
LAYER_STRIDES = {1: 1, 2: 2, 3: 2, 4: 2}


def init_unet2d_params(gen: torch.Generator, classes: int = 20,
                       layers34=(3, 4, 6, 3)) -> Dict[str, Any]:
    p: Dict[str, Any] = {"conv1": _conv(gen, 7, 7, 3, 64), "bn1": _bn(64)}
    p["layer1"] = _layer(gen, 64, 64, layers34[0], 1)
    p["layer2"] = _layer(gen, 64, 128, layers34[1], 2)
    p["layer3"] = _layer(gen, 128, 256, layers34[2], 2)
    p["layer4"] = _layer(gen, 256, 512, layers34[3], 2)
    p["up4"] = {"conv": _conv(gen, 3, 3, 512, 256), "bn": _bn(256)}
    p["delayer4"] = _layer(gen, 512, 256, layers34[3], 1)
    p["up3"] = {"conv": _conv(gen, 3, 3, 256, 128), "bn": _bn(128)}
    p["delayer3"] = _layer(gen, 256, 128, layers34[2], 1)
    p["up2"] = {"conv": _conv(gen, 3, 3, 128, 96), "bn": _bn(96)}
    p["delayer2"] = _layer(gen, 96 + 64, 96, layers34[1], 1)
    p["cls"] = {"conv1": _conv(gen, 3, 3, 96, 256), "bn": _bn(256),
                "conv2": _conv(gen, 1, 1, 256, classes),
                "bias2": torch.zeros(classes)}
    return p


def max_pool_3x3_s2(x):
    """torch MaxPool2d(kernel=3, stride=2, padding=1): -inf padding."""
    return F.max_pool2d(x, 3, 2, 1)


def resize_to(x, hw):
    """align_corners=True bilinear (the reference decoder's F.interpolate)."""
    return resize_bilinear_align_corners(x, hw)


def encoder_apply(p, imgs):
    """imgs (N,3,H,W) -> x (1/4), x2 (1/4), x3 (1/8), x4 (1/16), x5 (1/32)."""
    x = max_pool_3x3_s2(bn_act(conv2d(imgs, p["conv1"], stride=2), p["bn1"]))
    outs = [x]
    cur = x
    for li in (1, 2, 3, 4):
        for bi, b in enumerate(p[f"layer{li}"]):
            cur = apply_basic_block2d(
                b, cur, stride=LAYER_STRIDES[li] if bi == 0 else 1)
        outs.append(cur)
    return tuple(outs)


def up_block(p, up_name, de_name, x_coarse, x_skip):
    y = resize_to(x_coarse, x_skip.shape[2:4])
    y = bn_act(conv2d(y, p[up_name]["conv"]), p[up_name]["bn"])
    y = torch.cat([y, x_skip], dim=1)
    for b in p[de_name]:
        y = apply_basic_block2d(b, y)
    return y


def cls_apply(p, x, out_hw):
    y = bn_act(conv2d(x, p["cls"]["conv1"]), p["cls"]["bn"])
    y = conv2d(y, p["cls"]["conv2"]) + p["cls"]["bias2"].reshape(1, -1, 1, 1)
    return resize_to(y, out_hw)
