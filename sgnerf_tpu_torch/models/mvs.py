"""2D convolution helpers of the MVS nets, shared with BPNet's 2D branch.

Counterpart of the low-level ops of `sgnerf_tpu/models/mvs.py` (the MVS
nets themselves are not ported yet, ROADMAP.md queue 1 item 14). The JAX
package runs NHWC with HWIO weights; the port runs NCHW with torch's OIHW
weights (BPNet's weights are converted once, models/params.py).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def leaky_relu(x, slope=0.01):
    return F.leaky_relu(x, negative_slope=slope)


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x (N,C,H,W), w (co,ci,kh,kw): torch-style symmetric k//2 padding, the
    input cast to the weight's dtype."""
    return F.conv2d(x.to(w.dtype), w, stride=stride,
                    padding=(w.shape[2] // 2, w.shape[3] // 2))


def batch_norm(x, p, eps=1e-5, slope=0.01, act=True):
    """Inference-mode BN over channel axis 1, then LeakyReLU(slope)."""
    def c(t):
        return t.reshape(1, -1, 1, 1)
    y = (x - c(p["running_mean"])) * torch.rsqrt(c(p["running_var"]) + eps) \
        * c(p["weight"]) + c(p["bias"])
    return leaky_relu(y, slope) if act else y


def resize_bilinear_align_corners(x: torch.Tensor, out_hw) -> torch.Tensor:
    """(N,C,H,W) -> (N,C,h,w) bilinear with align_corners=True, in float32
    (the JAX formula's weights are f32, which promotes a bf16 input)."""
    return F.interpolate(x.to(torch.float32), size=tuple(int(s) for s in
                                                          out_hw),
                         mode="bilinear", align_corners=True)


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """(N,C,H,W) -> (N,C,2H,2W), align_corners=True."""
    return resize_bilinear_align_corners(x, (2 * x.shape[2], 2 * x.shape[3]))
