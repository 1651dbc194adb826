"""LPIPS perceptual distance (Zhang et al. 2018) in plain torch (the port's
copy of `sgnerf_tpu/utils/lpips.py`, on a device of the caller's choice).

The reference scores renders with the `lpips` pip package (alex and vgg
nets, reference run/evaluate.py:49-56), which downloads a torchvision
backbone and the LPIPS calibration weights at import time. Here the exact
computation runs in plain torch (no torchvision) on weights from files the
user supplies; nothing is downloaded:

  - backbone: a torchvision state dict (`alexnet-*.pth` / `vgg16-*.pth`;
    classifier.* keys ignored), the files torchvision caches under
    ~/.cache/torch/hub/checkpoints;
  - linear heads: the lpips package's calibration checkpoint
    (`lpips/weights/v0.1/{alex,vgg}.pth`; keys `lin{i}.model.1.weight`).

Weight discovery order: the `weights_dir` argument, `$SGNERF_LPIPS`,
`~/.cache/torch/hub/checkpoints`, `~/.cache/lpips`. When either file is
missing, `lpips_distance` returns None and callers omit the metric, as the
reference does when the lpips package is not installed.

Computation (lpips.LPIPS(net=...) at eval): inputs in [-1,1] -> per-channel
shift and scale -> backbone taps (alex: relu1..5; vgg16: relu1_2, 2_2,
3_3, 4_3, 5_3) -> unit norm over channels -> squared difference -> 1x1
calibration weights -> spatial mean -> sum over the five taps. On a CUDA
device the convolutions run in IEEE float32 (TF32 off).
"""
from __future__ import annotations

import functools
import os
from typing import Optional, Sequence

import numpy as np

# (tap channel widths, conv specs) for the two backbones we support.
# Conv spec: (out_ch, in_ch, kernel, stride, padding, tap_after_relu)
_ALEX_CONVS = [
    (64, 3, 11, 4, 2, True),
    (192, 64, 5, 1, 2, True),
    (384, 192, 3, 1, 1, True),
    (256, 384, 3, 1, 1, True),
    (256, 256, 3, 1, 1, True),
]
# torchvision alexnet.features conv indices (maxpools at 2, 5, 12)
_ALEX_IDX = [0, 3, 6, 8, 10]
_ALEX_POOL_AFTER = {0, 1}          # maxpool(3,2) after taps 0 and 1

_VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
            512, 512, 512, "M", 512, 512, 512]
_VGG_TAPS = {2, 4, 7, 10, 13}      # 1-based conv count to tap (after relu):
#                                    relu1_2, 2_2, 3_3, 4_3, 5_3

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def _find(fname_candidates: Sequence[str], dirs: Sequence[str]):
    for d in dirs:
        if not d:
            continue
        d = os.path.expanduser(d)
        if not os.path.isdir(d):
            continue
        for f in sorted(os.listdir(d)):
            for c in fname_candidates:
                if f.startswith(c) and f.endswith((".pth", ".pt")):
                    return os.path.join(d, f)
    return None


def _search_dirs(weights_dir: Optional[str]):
    return [weights_dir, os.environ.get("SGNERF_LPIPS"),
            "~/.cache/torch/hub/checkpoints", "~/.cache/lpips"]


class _Backbone:
    """AlexNet/VGG16 feature trunk with LPIPS taps, built from conv specs so
    a torchvision state dict loads by position (features.{i}.weight)."""

    def __init__(self, net: str, state: dict):
        import torch.nn as nn
        self.net = net
        layers = []
        self.taps = []                       # indices into `layers` to tap
        if net == "alex":
            for t, (o, i, k, s, p, _) in enumerate(_ALEX_CONVS):
                layers += [nn.Conv2d(i, o, k, s, p), nn.ReLU()]
                self.taps.append(len(layers) - 1)
                if t in _ALEX_POOL_AFTER:
                    layers.append(nn.MaxPool2d(3, 2))
        elif net == "vgg":
            ci, cin = 0, 3
            for v in _VGG_CFG:
                if v == "M":
                    layers.append(nn.MaxPool2d(2, 2))
                    continue
                layers += [nn.Conv2d(cin, v, 3, 1, 1), nn.ReLU()]
                ci, cin = ci + 1, v
                if ci in _VGG_TAPS:
                    self.taps.append(len(layers) - 1)
        else:
            raise ValueError(f"net must be alex or vgg, got {net!r}")
        self.model = nn.Sequential(*layers).eval()
        # remap torchvision "features.{idx}." onto our positional indices
        conv_positions = [i for i, m in enumerate(self.model)
                          if isinstance(m, nn.Conv2d)]
        src_idx = (_ALEX_IDX if net == "alex"
                   else _tv_vgg_conv_indices())
        remapped = {}
        for ours, theirs in zip(conv_positions, src_idx):
            for kind in ("weight", "bias"):
                k = f"features.{theirs}.{kind}"
                if k not in state:                  # bare features dict?
                    k2 = f"{theirs}.{kind}"
                    k = k2 if k2 in state else k
                remapped[f"{ours}.{kind}"] = state[k]
        self.model.load_state_dict(remapped)

    def features(self, x):
        out = []
        for i, m in enumerate(self.model):
            x = m(x)
            if i in self.taps:
                out.append(x)
        return out


def _tv_vgg_conv_indices():
    idx, i = [], 0
    for v in _VGG_CFG:
        if v == "M":
            i += 1
        else:
            idx.append(i)
            i += 2
    return idx


class _LPIPS:
    def __init__(self, net: str, backbone_state: dict, lin_state: dict):
        import torch
        self.torch = torch
        self.backbone = _Backbone(net, backbone_state)
        self.lins = []
        for i in range(5):
            w = lin_state[f"lin{i}.model.1.weight"]        # (1, C, 1, 1)
            # used as-is, like lpips.LPIPS at eval (the package only projects
            # weights to >=0 during calibration training)
            self.lins.append(torch.as_tensor(np.asarray(w, np.float32)))
        self.shift = torch.as_tensor(_SHIFT).view(1, 3, 1, 1)
        self.scale = torch.as_tensor(_SCALE).view(1, 3, 1, 1)
        self.device = torch.device("cpu")

    def to(self, device) -> "_LPIPS":
        """Move the weights to `device` (in place)."""
        self.device = self.torch.device(device)
        self.backbone.model.to(self.device)
        self.lins = [w.to(self.device) for w in self.lins]
        self.shift = self.shift.to(self.device)
        self.scale = self.scale.to(self.device)
        return self

    def distance(self, a: np.ndarray, b: np.ndarray) -> float:
        """a, b: (H, W, 3) float arrays in [0, 1]."""
        t = self.torch
        from ..models.mvs import ieee_f32
        with t.no_grad(), ieee_f32():
            xs = []
            for im in (a, b):
                x = t.as_tensor(np.asarray(im, np.float32),
                                device=self.device).permute(2, 0, 1)
                x = x[None] * 2 - 1                       # [0,1] -> [-1,1]
                xs.append((x - self.shift) / self.scale)
            fa, fb = (self.backbone.features(x) for x in xs)
            total = 0.0
            for i, (u, v) in enumerate(zip(fa, fb)):
                # lpips.normalize_tensor: x / (||x||_channels + 1e-10)
                u = u / (u.square().sum(1, keepdim=True).sqrt() + 1e-10)
                v = v / (v.square().sum(1, keepdim=True).sqrt() + 1e-10)
                d = (u - v).square()                       # (1, C, h, w)
                lw = self.lins[i]                          # (1, C, 1, 1)
                total += float((d * lw).sum(1).mean())
            return total


def _load_cpu(net: str, weights_dir: Optional[str]):
    import torch
    dirs = _search_dirs(weights_dir)
    bb_names = {"alex": ("alexnet-",), "vgg": ("vgg16-",)}[net]
    bb_path = _find(bb_names, dirs)
    lin_path = _find((net + ".", net + "_lpips", "lpips_" + net), dirs)
    if bb_path is None or lin_path is None:
        return None
    bb = torch.load(bb_path, map_location="cpu", weights_only=True)
    lin = torch.load(lin_path, map_location="cpu", weights_only=True)
    bb = bb.get("state_dict", bb)
    lin = lin.get("state_dict", lin)
    return _LPIPS(net, bb, lin)


@functools.lru_cache(maxsize=4)
def _load(net: str, weights_dir: Optional[str], device: str):
    """The model on `device`, or None without weight files. Malformed user
    weights are reported and give None; a failure to reach the device
    raises."""
    try:
        model = _load_cpu(net, weights_dir)
    except Exception as e:  # malformed user weights: report, don't crash eval
        print(f"[lpips] failed to load {net} weights: {e}")
        return None
    return None if model is None else model.to(device)


def lpips_distance(img: np.ndarray, ref: np.ndarray, net: str = "alex",
                   weights_dir: Optional[str] = None,
                   device="cpu") -> Optional[float]:
    """LPIPS(img, ref) in the lpips package's convention, computed on
    `device`, or None when the pretrained weights are not on disk (see the
    module docstring)."""
    model = _load(net, weights_dir, str(device))
    return None if model is None else model.distance(img, ref)
