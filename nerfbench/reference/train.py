"""Plain PyTorch reference of the fine-tuning step: the render forward of
`pointnerf.py` on a batch of rays with jittered samples, SG-NeRF's losses,
autograd, and two Adams (optax's order of operations: the shading MLPs at
`lr`, the trained point attributes at `plr`, each on an exponential decay
evaluated at the count before the step).

Losses (reference BaseRenderingModel.compute_losses): the colour MSE over
rays with at least one neighbour (weight 1), each colour item adding 1e-6,
and 1e-4 times mean(log v + log(1 - v)) of the neighbours' clamped
confidences, v in [1e-3, 1 - 1e-3].
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .pointnerf import Grid, attribute_table, render_rays


def schedule(base: float, decay_exp: float, decay_iters: int,
             count: int) -> float:
    f32 = np.float32
    return float(f32(base) * np.power(f32(decay_exp),
                                      f32(count) / f32(decay_iters)))


@torch.no_grad()
def adam(tensors, grads, state, lr, b1=0.9, b2=0.999, eps=1e-8):
    n = state["count"] + 1
    f32 = np.float32
    c1 = float(f32(1) - np.power(f32(b1), f32(n)))
    c2 = float(f32(1) - np.power(f32(b2), f32(n)))
    for p, g, m, v in zip(tensors, grads, state["m"], state["v"]):
        m.copy_((1 - b1) * g + b1 * m)
        v.copy_((1 - b2) * (g * g) + b2 * v)
        p.add_((m / c1) / (torch.sqrt(v / c2) + eps) * (-lr))
    state["count"] = n


def losses(col, ray_mask, cc, gt, n_colour_items: int):
    m = ray_mask[:, None].to(col.dtype)
    elems = m.sum() * col.shape[-1]
    mse = torch.where(elems > 0,
                      (((col - gt) ** 2) * m).sum() / torch.clamp(elems, 1.0),
                      torch.zeros((), device=col.device))
    total = torch.zeros((), device=col.device) + mse + 1e-6
    for _ in range(n_colour_items - 1):
        total = total + 1e-6
    v = torch.clamp(cc, 1e-3, 1.0 - 1e-3)
    return total + (torch.log(v) + torch.log(1.0 - v)).mean() * 1e-4


def param_names(params) -> List[str]:
    return [f"{blk}.{i}.{k}" for blk in sorted(params)
            for i, layer in enumerate(params[blk]) for k in ("w", "b")]


def train_steps(attrs: Dict, params, ref: Dict, tcfg: Dict,
                batches: List[Dict], noise: List[torch.Tensor], mm):
    """Follow len(batches) steps from (attrs, params), which it updates in
    place. Returns (losses [steps], first gradient norm by leaf name,
    the leaves' values after the steps by name)."""
    grid = Grid(attrs["xyz"], ref)
    leaves = {n: t for n, t in zip(param_names(params), [
        layer[k] for blk in sorted(params) for layer in params[blk]
        for k in ("w", "b")])}
    for f in tcfg["fields"]:
        leaves[f] = attrs[f]
    names = list(leaves)
    net = [n for n in names if n not in tcfg["fields"]]
    pts = list(tcfg["fields"])
    st_net = {"count": 0, "m": [torch.zeros_like(leaves[n]) for n in net],
              "v": [torch.zeros_like(leaves[n]) for n in net]}
    st_pts = {"count": 0, "m": [torch.zeros_like(leaves[n]) for n in pts],
              "v": [torch.zeros_like(leaves[n]) for n in pts]}
    out_losses, grad1 = [], {}
    for step, (b, u) in enumerate(zip(batches, noise)):
        for t in leaves.values():
            t.requires_grad_(True)
        table = attribute_table(attrs, bool(ref["semantic"]),
                                ref["gather_dtype"])
        col, ray_mask, cc = render_rays(grid, params, ref, table,
                                        b["campos"], b["rot"], b["raydir"],
                                        mm, u=u)
        loss = losses(col, ray_mask, cc, b["gt"], int(tcfg["colour_items"]))
        grads = torch.autograd.grad(loss, [leaves[n] for n in names],
                                    allow_unused=True)
        for t in leaves.values():
            t.requires_grad_(False)
        loss = loss.detach()
        g = {n: (torch.zeros_like(leaves[n]) if gr is None else gr)
             for n, gr in zip(names, grads)}
        if step == 0:
            grad1 = {n: float(torch.linalg.norm(g[n].double())) for n in names}
        out_losses.append(loss.item())
        adam([leaves[n] for n in net], [g[n] for n in net], st_net,
             schedule(tcfg["lr"], tcfg["decay_exp"], tcfg["decay_iters"],
                      st_net["count"]))
        adam([leaves[n] for n in pts], [g[n] for n in pts], st_pts,
             schedule(tcfg["plr"], tcfg["decay_exp"], tcfg["decay_iters"],
                      st_pts["count"]))
    return out_losses, grad1, {n: leaves[n].detach() for n in names}
