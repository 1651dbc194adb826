"""Training losses (counterpart of `sgnerf_tpu/models/losses.py`; reference
BaseRenderingModel.compute_losses, base_rendering_model.py:534-662).

  * ray_masked_<item>: MSE restricted to rays with ray_mask > 0;
  * ray_miss_<item>: MSE over missed rays, scaled by the missed-ray count;
  * ray_depth_masked_<item>: MSE restricted to rays with valid gt depth;
  * <item>: plain MSE vs gt;
  * depth family: MSE(out * gt_mask, gt_depth * gt_mask);
  * bg family: MSE(out * (1 - gt_mask), 1 - gt_mask);
  * l2_size family: MSE(out, 0);
  * zero_one on conf_coefficient: mean(log(v) + log(1 - v)), v clamped to
    [eps, 1 - eps];
  * sparse: sum(w * |1 - exp(-2c)|) / (sum(w) + 1e-6);
  * each colour loss adds an extra 1e-6 to the total (kept for parity).

Masked selections are mask-weighted means, so shapes stay static.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch


def masked_mse(pred, gt, mask):
    """MSE over the masked subset; 0 when the mask is empty.
    pred/gt (B,R,3), mask (B,R) bool."""
    m = mask[..., None].to(pred.dtype)
    num = (((pred - gt) ** 2) * m).sum()
    elems = m.sum() * pred.shape[-1]
    return torch.where(elems > 0, num / torch.clamp(elems, min=1.0),
                       torch.zeros_like(num))


def compute_losses(output: Dict[str, torch.Tensor], gt_image: torch.Tensor, *,
                   color_loss_items: Sequence[str],
                   color_loss_weights: Sequence[float],
                   zero_one_loss_items: Sequence[str] = (),
                   zero_one_loss_weights: Sequence[float] = (),
                   depth_loss_items: Sequence[str] = (),
                   depth_loss_weights: Sequence[float] = (),
                   bg_loss_items: Sequence[str] = (),
                   bg_loss_weights: Sequence[float] = (),
                   l2_size_loss_items: Sequence[str] = (),
                   l2_size_loss_weights: Sequence[float] = (),
                   gt_depth: torch.Tensor = None,
                   gt_mask: torch.Tensor = None,
                   sparse_loss_weight: float = 0.0,
                   zero_epsilon: float = 1e-3,
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (loss_total, per-loss dict). gt_image (B,R,3); gt_depth /
    gt_mask (B,R) only when the depth/bg families are on."""
    total = gt_image.new_zeros(())
    losses: Dict[str, torch.Tensor] = {}
    ray_mask = output["ray_mask"]

    for name, w in zip(color_loss_items, color_loss_weights):
        if name.startswith("ray_masked"):
            item = name[len("ray_masked") + 1:]
            loss = masked_mse(output[item], gt_image, ray_mask > 0)
        elif name.startswith("ray_miss"):
            item = name[len("ray_miss") + 1:]
            miss = ray_mask == 0
            loss = masked_mse(output[item], gt_image, miss)
            loss = loss * miss.sum().to(loss.dtype)
        elif name.startswith("ray_depth_masked"):
            item = name[len("ray_depth_masked") + 1:]
            loss = masked_mse(output[item], gt_image,
                              output["ray_depth_mask"] > 0)
        else:
            loss = ((output[name] - gt_image) ** 2).mean()
        losses[name] = loss
        total = total + loss * w + 1e-6

    for name, w in zip(depth_loss_items, depth_loss_weights):
        m = gt_mask.to(torch.float32)
        loss = ((output[name] * m - gt_depth * m) ** 2).mean()
        losses[name] = loss
        total = total + loss * w

    for name, w in zip(bg_loss_items, bg_loss_weights):
        inv = 1.0 - gt_mask.to(torch.float32)
        val = output[name]
        if val.dim() == inv.dim() + 1:     # e.g. coarse_is_background (B,R,1)
            val = val[..., 0]
        loss = ((val * inv - inv) ** 2).mean()
        losses[name] = loss
        total = total + loss * w

    for name, w in zip(l2_size_loss_items, l2_size_loss_weights):
        loss = (output[name] ** 2).mean()
        losses[name] = loss
        total = total + loss * w

    for name, w in zip(zero_one_loss_items, zero_one_loss_weights):
        if output.get(name) is None:
            continue
        val = torch.clamp(output[name], zero_epsilon, 1.0 - zero_epsilon)
        loss = (torch.log(val) + torch.log(1.0 - val)).mean()
        losses[name] = loss
        total = total + loss * w

    if sparse_loss_weight > 0:
        wgt = output["weight"]
        conf = output["conf_coefficient"]
        loss = (wgt * torch.abs(1.0 - torch.exp(-2.0 * conf))).sum() / (
            wgt.sum() + 1e-6)
        losses["sparse"] = loss
        total = total + loss * sparse_loss_weight

    losses["total"] = total
    return total, losses


def mse2psnr(mse):
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-10))
