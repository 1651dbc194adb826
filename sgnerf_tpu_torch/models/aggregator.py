"""Point-feature aggregation and shading MLPs ("viewmlp").

Counterpart of `sgnerf_tpu/models/aggregator.py` for the default variant
(reference point_aggregators.py): the linear distance kernel, per-neighbour
PE(feat) ++ PE(dist) -> block1 [-> ++ 96-d semantic embedding ->
block2_bpnet] -> per-neighbour alpha (order 2), weighted over K, then the
colour head on PE(viewdir). block2/block3/yuze, the other distance kernels
and order 1 come with ROADMAP item 15.

Parameters are a plain dict of layer lists, {"w": (in, out), "b": (out,)},
the reference tree's own layout (models/params.py carries them across).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.fused_agg import (fused_block1_alpha, fused_block1_alpha_color,
                             fused_block1_alpha_color_march, k2_supports,
                             k3_supports, k4_supports, leaky_relu, matmul,
                             softplus)
from ..ops.pe import positional_encoding


@dataclasses.dataclass(frozen=True)
class AggregatorConfig:
    """Static architecture config (the eval slice's fields of the
    reference AggregatorConfig, same defaults)."""
    point_features_dim: int = 32
    shading_feature_num: int = 256
    shading_feature_mlp_layer1: int = 2
    shading_feature_mlp_layer2_bpnet: int = 0   # SG-NeRF's semantic block
    predict_semantic: int = 0        # block2_bpnet's input takes the
    semantic_dim: int = 96           # semantic_dim-wide BPNet embedding
    shading_alpha_mlp_layer: int = 1
    shading_color_mlp_layer: int = 4
    num_feat_freqs: int = 3
    dist_xyz_freq: int = 5
    dist_xyz_deno: float = 0.0
    num_viewdir_freqs: int = 4
    agg_dist_pers: int = 20
    agg_weight_norm: int = 1
    act_type: str = "LeakyReLU"
    act_super: int = 1
    compute_dtype: str = "float32"   # "bfloat16": bf16 matmul inputs, f32 sums
    fused_mlp: str = "none"          # "cuda": kernel K2 (ops/fused_agg.py)
    fused_bwd: str = "cuda"          # backward of K2: "cuda" = kernel K3,
    #                                  "plain" = autograd of its plain version
    fused_color: bool = False        # the colour head inside the fused
    #                                  kernel (K4; --fused_color on)
    fused_march: bool = False        # eval renders: the colour head and the
    #                                  volume march inside the fused kernel
    #                                  (K5; --fused_march on)

    @property
    def dist_dim(self) -> int:
        if self.agg_dist_pers > 9:
            return 4 if self.agg_dist_pers == 30 else 6
        return 3

    @property
    def dist_xyz_dim(self) -> int:
        if self.dist_xyz_freq == 0:
            return self.dist_dim
        return 2 * abs(self.dist_xyz_freq) * self.dist_dim

    @property
    def block1_in(self) -> int:
        c = self.point_features_dim
        c += 2 * self.num_feat_freqs * c if self.num_feat_freqs > 0 else 0
        return c + self.dist_xyz_dim

    @property
    def viewdir_channels(self) -> int:
        return (2 * self.num_viewdir_freqs * 3 if self.num_viewdir_freqs > 0
                else 3)


def _act(cfg: AggregatorConfig, x):
    if cfg.act_type == "LeakyReLU":
        return leaky_relu(x)
    if cfg.act_type == "ReLU":
        return F.relu(x)
    if cfg.act_type == "ELU":
        return F.elu(x)
    raise ValueError(f"unknown act_type {cfg.act_type}")


def _mlp_init(gen: torch.Generator, sizes, gain):
    """Linear stack with the reference init (helpers/networks.py:113-124):
    W ~ U(+-gain*sqrt(6/(in+out))), b ~ U(+-1/sqrt(in))."""
    layers = []
    for n_in, n_out in zip(sizes[:-1], sizes[1:]):
        lim = gain * np.sqrt(2.0 / (n_in + n_out)) * np.sqrt(3.0)
        w = (torch.rand((n_in, n_out), generator=gen) * 2 - 1) * lim
        b = (torch.rand((n_out,), generator=gen) * 2 - 1) / np.sqrt(n_in)
        layers.append({"w": w.to(torch.float32), "b": b.to(torch.float32)})
    return layers


def init_aggregator_params(seed: int, cfg: AggregatorConfig,
                           device="cpu") -> Dict[str, Any]:
    """Seeded parameters with the reference's shapes and init law (the
    numbers differ from the JAX init: the generators differ)."""
    gen = torch.Generator().manual_seed(int(seed))
    gain = float(np.sqrt(2.0)) if cfg.act_type == "ReLU" else \
        float(np.sqrt(2.0 / (1 + 0.01 ** 2)))
    C = cfg.shading_feature_num
    params = {
        "block1": _mlp_init(gen, [cfg.block1_in]
                            + [C] * cfg.shading_feature_mlp_layer1, gain),
        "alpha_branch": _mlp_init(
            gen, [C] + [C // 2] * (cfg.shading_alpha_mlp_layer - 1) + [1],
            gain),
        "color_branch": _mlp_init(
            gen, [C + cfg.viewdir_channels]
            + [C // 2] * (cfg.shading_color_mlp_layer - 1) + [3], gain),
    }
    if cfg.shading_feature_mlp_layer2_bpnet > 0:
        # drawn last, so the other blocks' numbers do not move
        cin = C + (cfg.semantic_dim if cfg.predict_semantic == 1 else 0)
        params["block2_bpnet"] = _mlp_init(
            gen, [cin] + [C] * cfg.shading_feature_mlp_layer2_bpnet, gain)
    return {k: [{n: t.to(device) for n, t in layer.items()} for layer in v]
            for k, v in params.items()}


def _mlp_apply(cfg: AggregatorConfig, layers, x, act_last=True):
    bf16 = cfg.compute_dtype == "bfloat16"
    for i, layer in enumerate(layers):
        x = matmul(x, layer["w"], bf16) + layer["b"]
        if act_last or i < len(layers) - 1:
            x = _act(cfg, x)
    return x


def _dist_weights(dists, pnt_mask):
    """Linear kernel with unit axis weights (reference :465-514):
    mask / max(|d[:3]|, 1e-6), |.| floored at 1e-12 under the sqrt."""
    nrm = torch.sqrt(torch.clamp((dists[..., :3] ** 2).sum(-1), min=1e-12))
    return pnt_mask.to(dists.dtype) * (1.0 / torch.clamp(nrm, min=1e-6))


def _gradient_clamp(x, lo=0.0001, hi=1.0):
    """Pass-through clamp: value clamped, gradient unclamped (:863)."""
    return x - (x - torch.clamp(x, lo, hi)).detach()


def raw2out_density(cfg: AggregatorConfig, raw):
    return softplus(raw - 1.0) if cfg.act_super > 0 else F.relu(raw)


def raw2out_color(cfg: AggregatorConfig, raw):
    c = torch.sigmoid(raw)
    return c * (1 + 2 * 0.001) - 0.001 if cfg.act_super > 0 else c


def compute_dists(cfg: AggregatorConfig, sampled_xyz, sampled_xyz_pers,
                  sample_loc, sample_loc_w):
    """Per-neighbour offset features; agg_dist_pers 20 (the ScanNet
    default, reference :917-925) is world delta ++ z-scaled perspective
    delta."""
    p = cfg.agg_dist_pers
    world = sampled_xyz - sample_loc_w[..., None, :]
    if p == 0:
        return world
    pers = sampled_xyz_pers - sample_loc[..., None, :]
    if p == 1:
        return pers
    if p == 10:
        return torch.cat([world, pers], dim=-1)
    if p == 20:
        xp, sl = sampled_xyz_pers, sample_loc[..., None, :]
        d = torch.stack([xp[..., 0] * xp[..., 2] - sl[..., 0] * sl[..., 2],
                         xp[..., 1] * xp[..., 2] - sl[..., 1] * sl[..., 2],
                         xp[..., 2] - sl[..., 2]], dim=-1)
        return torch.cat([world, d], dim=-1)
    raise ValueError(f"unsupported agg_dist_pers {p}")


def use_fused(cfg: AggregatorConfig) -> bool:
    """The reference's gate for the fused kernel (aggregator.py:489-501),
    over the fields this slice carries: block2_bpnet runs un-fused."""
    return (cfg.fused_mlp == "cuda" and cfg.shading_feature_mlp_layer1 > 0
            and cfg.shading_feature_mlp_layer2_bpnet == 0
            and cfg.shading_alpha_mlp_layer == 1
            and cfg.num_feat_freqs > 0 and cfg.dist_xyz_freq > 0
            and cfg.act_type == "LeakyReLU" and cfg.act_super > 0)


def fused_paths(cfg: AggregatorConfig, *, K: int, F: int, Dd: int,
                color_branch, training: bool, device, march: bool = False,
                SR: int = 1) -> str:
    """Which aggregator path runs on `device`: "march" (K5), "color" (K4),
    "block1" (K2, the colour head outside) or "none" (un-fused). The
    reference's gate (use_fused), then the shapes each kernel takes
    (fused_agg.py k2_supports .. k4_supports; their shared-memory clause
    is the CUDA library's, asked on a CUDA device only): outside K2's the
    un-fused path; when training with the K3 backward, outside K3's too,
    so that no K2 forward runs without a backward to follow; K5 and K4
    outside theirs step down to K4 or K2 and the plain colour head."""
    if not use_fused(cfg):
        return "none"
    shape = dict(K=K, F=F, Dd=Dd, nf=cfg.num_feat_freqs,
                 df=abs(cfg.dist_xyz_freq), C=cfg.shading_feature_num,
                 bf16=cfg.compute_dtype == "bfloat16", device=device)
    if not k2_supports(**shape) or (training and cfg.fused_bwd == "cuda"
                                    and not k3_supports(**shape)):
        return "none"
    vf = cfg.num_viewdir_freqs
    n = len(color_branch)
    head = dict(vf=vf, Nh=color_branch[0]["w"].shape[1] if n > 1 else 3,
                n_clayers=n)
    if vf > 0 and march and cfg.fused_march and k4_supports(**shape, **head,
                                                            SR=SR):
        return "march"
    if vf > 0 and cfg.fused_color and k4_supports(**shape, **head):
        return "color"
    return "block1"


def aggregate(params: Dict[str, Any], cfg: AggregatorConfig, *,
              sampled_embedding,     # (B,R,SR,K,F)
              sampled_conf,          # (B,R,SR,K,1) or None
              sampled_label_embedding=None,   # (B,R,SR,K,S) or None
              sampled_xyz,           # (B,R,SR,K,3) world
              sampled_xyz_pers,      # (B,R,SR,K,3) perspective
              sample_pnt_mask,       # (B,R,SR,K) bool
              sample_loc,            # (B,R,SR,3) perspective
              sample_loc_w,          # (B,R,SR,3) world
              sample_ray_dirs,       # (B,R,SR,3)
              Rw2c: Optional[torch.Tensor] = None,   # (3,3)
              vsize=None,
              march=None):           # {"ray_dist": (B,R,SR)}: K5 (eval)
    """Dense masked aggregation (agg_intrp_order 2). Returns (decoded
    (B,R,SR,4) [alpha | rgb], ray_valid (B,R,SR), weight (B,R,SR,K),
    conf_coefficient (B,R,SR,K)). With `march` given, cfg.fused_march set
    and the fused path on, kernel K5 marches in-kernel and decoded is
    {"march": (B,R,4) [ray colour | background transmission]}."""
    B, R, SR, K, _ = sampled_embedding.shape
    mask = sample_pnt_mask
    ray_valid = mask.any(dim=-1)

    dists = compute_dists(cfg, sampled_xyz, sampled_xyz_pers, sample_loc,
                          sample_loc_w)
    weight = _dist_weights(dists, mask)
    if cfg.agg_weight_norm > 0:
        weight = weight / torch.clamp(weight.sum(-1, keepdim=True), min=1e-8)
    conf_coefficient = torch.ones_like(weight)
    if sampled_conf is not None:
        conf_coefficient = _gradient_clamp(sampled_conf[..., 0])
    w = weight * conf_coefficient

    viewdirs = sample_ray_dirs
    if Rw2c is not None:
        viewdirs = viewdirs @ Rw2c.T
    ori_viewdirs = viewdirs
    if cfg.num_viewdir_freqs > 0:
        viewdirs = positional_encoding(viewdirs, cfg.num_viewdir_freqs,
                                       ori=True)[..., 3:]

    d = dists
    if cfg.dist_xyz_deno != 0.0 and vsize is not None:
        d = d / float(cfg.dist_xyz_deno * np.linalg.norm(np.asarray(vsize)))
    if Rw2c is not None:
        d = torch.cat([d[..., :3] @ Rw2c.T, d[..., 3:]], dim=-1)

    color = None
    vf = cfg.num_viewdir_freqs
    training = torch.is_grad_enabled() and any(
        t.requires_grad for t in [sampled_embedding, d, w]
        + [t for k in ("block1", "alpha_branch", "color_branch")
           for layer in params[k] for t in layer.values()])
    path = fused_paths(cfg, K=K, F=sampled_embedding.shape[-1],
                       Dd=d.shape[-1], color_branch=params["color_branch"],
                       training=training, device=sampled_embedding.device,
                       march=march is not None, SR=SR)
    fused = path != "none"
    if fused:
        M = B * R * SR
        kw = dict(K=K, nf=cfg.num_feat_freqs, df=abs(cfg.dist_xyz_freq),
                  bf16=cfg.compute_dtype == "bfloat16")
        args = (sampled_embedding.reshape(M, K, -1).to(torch.float32),
                d.reshape(M, K, -1).to(torch.float32),
                (w * mask.to(weight.dtype)).reshape(M, K).to(torch.float32))
        vd = ori_viewdirs.reshape(M, 3).to(torch.float32)
    # the march kernel carries its own colour head, whatever fused_color says
    if path == "march":
        out4 = fused_block1_alpha_color_march(
            *args, vd, march["ray_dist"].reshape(M).to(torch.float32),
            ray_valid.reshape(M).to(torch.float32), params["block1"],
            params["alpha_branch"], params["color_branch"], vf=vf, SR=SR,
            **kw)
        return ({"march": out4.reshape(B, R, 4)}, ray_valid, weight,
                conf_coefficient)
    if path == "color":
        al, rawc = fused_block1_alpha_color(
            *args, vd, params["block1"], params["alpha_branch"],
            params["color_branch"], vf=vf, bwd=cfg.fused_bwd, **kw)
        alpha = al.reshape(B, R, SR, 1)
        color = raw2out_color(cfg, rawc.reshape(B, R, SR, 3))
    elif fused:
        fa, al = fused_block1_alpha(*args, params["block1"],
                                    params["alpha_branch"], bwd=cfg.fused_bwd,
                                    **kw)
        alpha = al.reshape(B, R, SR, 1)
        feat_agg = fa.reshape(B, R, SR, -1)
    else:
        if cfg.dist_xyz_freq != 0:
            d = positional_encoding(d, abs(cfg.dist_xyz_freq))
        feat = sampled_embedding
        if cfg.num_feat_freqs > 0:
            feat = torch.cat([feat, positional_encoding(
                feat, cfg.num_feat_freqs)], dim=-1)
        feat = _mlp_apply(cfg, params["block1"], torch.cat([feat, d], -1))
        if cfg.shading_feature_mlp_layer2_bpnet > 0:
            if sampled_label_embedding is not None:
                feat = torch.cat([feat, sampled_label_embedding], dim=-1)
            feat = _mlp_apply(cfg, params["block2_bpnet"], feat)
        raw_alpha = _mlp_apply(cfg, params["alpha_branch"], feat,
                               act_last=False)
        alpha_nb = raw2out_density(cfg, raw_alpha) * mask[..., None]
        alpha = (alpha_nb * w[..., None]).sum(-2)               # (B,R,SR,1)
        feat_agg = (feat * mask[..., None] * w[..., None]).sum(-2)

    if color is None:
        color = raw2out_color(cfg, _mlp_apply(
            cfg, params["color_branch"], torch.cat([feat_agg, viewdirs], -1),
            act_last=False))
    decoded = torch.cat([alpha, color], dim=-1)
    decoded = decoded * ray_valid[..., None].to(decoded.dtype)
    return decoded, ray_valid, weight, conf_coefficient
