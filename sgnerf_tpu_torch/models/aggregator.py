"""Point-feature aggregation and shading MLPs ("viewmlp").

Counterpart of `sgnerf_tpu/models/aggregator.py` (reference
point_aggregators.py and point_aggregators_yuze.py): a distance kernel
weighs the K neighbours (linear, quadric, avg, numlinear, numquadric,
trilinear, sh_intrp, gau_intrp, with the reference's non-unit axis-weight
branches); per neighbour PE(feat) ++ PE(dist) -> block1 [-> ++ PE(dist) ->
block2] [-> ++ 96-d semantic embedding -> block2_bpnet] [yuze: ->
block_linear] [-> ++ colour, dir - viewdir, dir . viewdir -> block3]
[yuze: -> ++ colour, PE(plane cos-angles) -> block4]; then either a
per-neighbour alpha weighted over K (order 2; yuze reads it from the
features before block3/block4) or the features weighted over K first and
one alpha per shading point (order 1); the colour head on PE(viewdir).
Only the default variant at order 2 with a distance-only kernel takes the
fused kernels (`use_fused`, the reference's gate); the others run the
plain products here, as they run outside any Pallas kernel in the JAX
package.

Parameters are a plain dict of layer lists, {"w": (in, out), "b": (out,)},
the reference tree's own layout (models/params.py carries them across).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.fused_agg import (fused_block1_alpha, fused_block1_alpha_color,
                             fused_block1_alpha_color_march, k2_supports,
                             k3_supports, k4_supports, leaky_relu, matmul,
                             softplus)
from ..ops.pe import positional_encoding
from ..utils.spherical import SphericalHarm_table


@dataclasses.dataclass(frozen=True)
class AggregatorConfig:
    """Static architecture config (the reference AggregatorConfig's fields,
    same defaults)."""
    point_features_dim: int = 32
    shading_feature_num: int = 256
    shading_feature_mlp_layer1: int = 2
    shading_feature_mlp_layer2: int = 0
    shading_feature_mlp_layer2_bpnet: int = 0   # SG-NeRF's semantic block
    shading_feature_mlp_layer3: int = 0   # per-neighbour colour/dir block
    shading_feature_mlp_layer4: int = 0   # yuze only: block4's depth
    shading_feature_mlp_linear: int = 0   # yuze only: block_linear on/off
    agg_variant: str = "default"     # "yuze": --which_agg_model viewmlp_yuze
    predict_semantic: int = 0        # block2_bpnet's input takes the
    semantic_dim: int = 96           # semantic_dim-wide BPNet embedding
    shading_alpha_mlp_layer: int = 1
    shading_color_mlp_layer: int = 4
    num_feat_freqs: int = 3
    dist_xyz_freq: int = 5
    dist_xyz_deno: float = 0.0
    num_viewdir_freqs: int = 4
    agg_dist_pers: int = 20
    agg_distance_kernel: str = "linear"
    agg_intrp_order: int = 2
    agg_weight_norm: int = 1
    act_type: str = "LeakyReLU"
    act_super: int = 1
    point_color_mode: str = "1"
    point_dir_mode: str = "1"
    axis_weight: Optional[Tuple[float, float, float]] = None
    sh_degree: int = 4               # sh_intrp: the basis' degree,
    sh_act: str = "sigmoid"          # its activation
    sh_dist_func: str = "sh_quadric"  # and its distance falloff
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
        # kernels that consume leading embedding channels (reference :315)
        if self.agg_distance_kernel == "sh_intrp":
            c -= self.sh_degree ** 2
        elif self.agg_distance_kernel == "gau_intrp":
            c -= 7
        c += 2 * self.num_feat_freqs * c if self.num_feat_freqs > 0 else 0
        return c + (self.dist_xyz_dim if self.agg_intrp_order > 0 else 0)

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
    # the optional blocks are drawn last, so the other blocks' numbers do
    # not move; input widths as the reference builds them (:185-228)
    if cfg.shading_feature_mlp_layer2_bpnet > 0:
        cin = C + (cfg.semantic_dim if cfg.predict_semantic == 1 else 0)
        params["block2_bpnet"] = _mlp_init(
            gen, [cin] + [C] * cfg.shading_feature_mlp_layer2_bpnet, gain)
    if cfg.shading_feature_mlp_layer2 > 0:
        # the distance features join again, gated on the order as in the
        # forward (the reference's init gates them on num_feat_freqs == 0)
        cin = C + (cfg.dist_xyz_dim if cfg.agg_intrp_order > 0 else 0)
        params["block2"] = _mlp_init(
            gen, [cin] + [C] * cfg.shading_feature_mlp_layer2, gain)
    color, dirs = "1" in cfg.point_color_mode, "1" in cfg.point_dir_mode
    if cfg.shading_feature_mlp_layer3 > 0:
        cin = C + (3 if color else 0) + (4 if dirs else 0)
        params["block3"] = _mlp_init(
            gen, [cin] + [C] * cfg.shading_feature_mlp_layer3, gain)
    if cfg.agg_variant == "yuze" and cfg.shading_feature_mlp_layer4 > 0:
        cin = C + (6 * cfg.num_feat_freqs if dirs else 0) + (3 if color else 0)
        params["block4"] = _mlp_init(
            gen, [cin] + [C] * cfg.shading_feature_mlp_layer4, gain)
    if cfg.agg_variant == "yuze" and cfg.shading_feature_mlp_linear > 0:
        # its depth is shading_feature_mlp_layer4 (a reference quirk)
        params["block_linear"] = _mlp_init(
            gen, [C] + [C] * cfg.shading_feature_mlp_layer4, gain)
    return {k: [{n: t.to(device) for n, t in layer.items()} for layer in v]
            for k, v in params.items()}


def _mlp_apply(cfg: AggregatorConfig, layers, x, act_last=True):
    bf16 = cfg.compute_dtype == "bfloat16"
    for i, layer in enumerate(layers):
        x = matmul(x, layer["w"], bf16) + layer["b"]
        if act_last or i < len(layers) - 1:
            x = _act(cfg, x)
    return x


def _safe_norm(x):
    """|x| over the last axis, the square sum floored at 1e-12 under the
    sqrt (a finite gradient at 0)."""
    return torch.sqrt(torch.clamp((x * x).sum(-1), min=1e-12))


def _dist_weights(cfg: AggregatorConfig, dists, pnt_mask):
    """dists (...,K,dist_dim) -> weights (...,K) (reference :465-514).
    Non-unit axis weights take the reference's branches with their quirks:
    linear gates on aw[0]/aw[2] but scales the xy norm by aw[0] and |z| by
    aw[1]; quadric multiplies the whole dists row by the 3-wide weight, so
    it broadcasts only for 3-wide dists (agg_dist_pers <= 9)."""
    kern = cfg.agg_distance_kernel
    m = pnt_mask.to(dists.dtype)
    aw = cfg.axis_weight
    lin_unit = aw is None or (aw[0] == 1 and aw[2] == 1)
    quad_unit = aw is None or (aw[0] == 1 and aw[1] == 1 and aw[2] == 1)

    def lin_w(d):
        if lin_unit:
            return 1.0 / torch.clamp(_safe_norm(d[..., :3]), min=1e-6)
        return 1.0 / torch.clamp(_safe_norm(d[..., :2]) * aw[0]
                                 + d[..., 2].abs() * aw[1], min=1e-6)

    def quad_w(d, full):
        if quad_unit:
            x = d if full else d[..., :3]
            return 1.0 / torch.clamp((x * x).sum(-1), min=1e-8)
        # the one branch that needs the weights as a tensor: a host copy,
        # made only here (every ScanNet script passes unit weights)
        awt = torch.tensor(aw, dtype=d.dtype, device=d.device)
        return 1.0 / torch.clamp((d * d * awt).sum(-1), min=1e-8)

    if kern == "linear":
        return m * lin_w(dists)
    if kern == "quadric":
        return m * quad_w(dists, full=False)
    if kern == "avg":
        return m
    if kern == "numlinear":
        w = m * (1.0 / torch.clamp(_safe_norm(dists), min=1e-6) if lin_unit
                 else lin_w(dists))
        return w / torch.clamp(m.sum(-1, keepdim=True), min=1.0)
    if kern == "numquadric":
        # unlike numlinear, not divided by the neighbour count (:483-491)
        return m * quad_w(dists, full=True)
    raise ValueError(f"unsupported agg_distance_kernel {kern}")


def _dist_weights_ex(cfg: AggregatorConfig, embedding, dists, pnt_mask,
                     vsize, grid_vox_sz):
    """The kernels that also read the embedding (trilinear, sh_intrp,
    gau_intrp; reference :428-558). Returns (weights, embedding with the
    channels the kernel consumed dropped)."""
    kern = cfg.agg_distance_kernel
    m = pnt_mask.to(dists.dtype)
    if kern == "trilinear":
        d = 1.0 - (dists * m[..., None] / max(grid_vox_sz, 1e-8)).abs()
        w = m * d[..., 0] * d[..., 1] * d[..., 2]
        return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-8), embedding
    if kern == "sh_intrp":
        nsh = cfg.sh_degree ** 2
        dist_norm = torch.linalg.norm(dists[..., :3], dim=-1)
        dirs = dists[..., :3] / torch.clamp(dist_norm[..., None], min=1e-8)
        shall = SphericalHarm_table(cfg.sh_degree).sh_all(dirs)
        act = {"sigmoid": torch.sigmoid, "tanh": torch.tanh,
               "passfunc": lambda x: x}[cfg.sh_act]
        distf = {"sh_linear": lambda r: 1.0 / torch.clamp(r, min=1e-8),
                 "sh_quadric": lambda r: 1.0 / torch.clamp(r ** 2, min=1e-8),
                 "passfunc": torch.ones_like}[cfg.sh_dist_func]
        w = m * act(shall * embedding[..., :nsh]).sum(-1) * distf(dist_norm)
        return w, embedding[..., nsh:]
    if kern == "gau_intrp":
        # axis-aligned anisotropic gaussians (reference :546-558)
        scale = embedding[..., 0].abs()
        radii = vsize[2] * 20 * torch.sigmoid(embedding[..., 1:4])
        g = dists[..., :3] / torch.clamp(radii, min=1e-6)
        w = m * scale * torch.exp(-0.5 * (g * g).sum(-1))
        return w, embedding[..., 7:]
    return _dist_weights(cfg, dists, pnt_mask), embedding


def _yuze_angle_features(sd, ov, freqs):
    """The yuze variant's rotation-invariant angle features
    (point_aggregators_yuze.py:686-703): the stored dir and the view dir
    projected on the xy, xz and yz planes, compared by signed cosine, PE'd
    in the order [xz, xy, yz]. The reference's quirks stay: the sign test
    is a0*b1 - a1*b1 (b1 twice) and the features are cosines. The norms are
    clipped, so masked (zero) rows stay finite."""
    def cosang(a, b):
        na = torch.sqrt(torch.clamp((a * a).sum(-1), min=1e-24))
        nb = torch.sqrt(torch.clamp((b * b).sum(-1), min=1e-24))
        c = (a * b).sum(-1) / na / nb
        pos = a[..., 0] * b[..., 1] - a[..., 1] * b[..., 1] > 0
        return torch.where(pos, c, -c)
    theta = cosang(sd[..., :2], ov[..., :2])
    row = cosang(sd[..., ::2], ov[..., ::2])
    fai = cosang(sd[..., 1:], ov[..., 1:])
    return positional_encoding(torch.stack([row, theta, fai], dim=-1), freqs)


def _rot_vec(v, rot):
    """The reference's Rw2c rotation `v_row @ Rw2c^T`
    (point_aggregators.py:565 transposes, then right-multiplies at
    :579/:599/:648). rot is (3,3) for the whole scene or (..., 3, 3) per
    neighbour."""
    if rot.dim() == 2:
        return v @ rot.T
    # a broadcast multiply and sum: torch.einsum runs it as batched 1x3 @ 3x3
    # products, 1.64 against 0.15 ms for an eval chunk's 1.77M rows (H100)
    return (v[..., None, :] * rot).sum(-1)


def gradient_clamp(x, lo=0.0001, hi=1.0):
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
    """The reference's gate for the fused kernel (aggregator.py:489-501):
    the default variant, block1 and the alpha head alone, order 2 and a
    kernel that reads distances only."""
    return (cfg.fused_mlp == "cuda" and cfg.agg_variant == "default"
            and cfg.shading_feature_mlp_layer1 > 0
            and cfg.shading_feature_mlp_layer2 == 0
            and cfg.shading_feature_mlp_layer2_bpnet == 0
            and cfg.shading_feature_mlp_layer3 == 0
            and cfg.shading_alpha_mlp_layer == 1
            and cfg.num_feat_freqs > 0 and cfg.dist_xyz_freq > 0
            and cfg.act_type == "LeakyReLU" and cfg.act_super > 0
            and cfg.agg_intrp_order == 2
            and cfg.agg_distance_kernel not in ("trilinear", "sh_intrp",
                                                "gau_intrp"))


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
              sampled_color=None,    # (B,R,SR,K,3) or None
              sampled_dir=None,      # (B,R,SR,K,3) or None
              sampled_xyz,           # (B,R,SR,K,3) world
              sampled_xyz_pers,      # (B,R,SR,K,3) perspective
              sample_pnt_mask,       # (B,R,SR,K) bool
              sample_loc,            # (B,R,SR,3) perspective
              sample_loc_w,          # (B,R,SR,3) world
              sample_ray_dirs,       # (B,R,SR,3)
              Rw2c: Optional[torch.Tensor] = None,   # (3,3) | (B,R,SR,K,3,3)
              vsize=None,
              march=None):           # {"ray_dist": (B,R,SR)}: K5 (eval)
    """Dense masked aggregation. Returns (decoded (B,R,SR,4) [alpha |
    rgb], ray_valid (B,R,SR), weight (B,R,SR,K), conf_coefficient
    (B,R,SR,K)). With `march` given, cfg.fused_march set and the fused
    path on, kernel K5 marches in-kernel and decoded is {"march": (B,R,4)
    [ray colour | background transmission]}. block3 and block4 read the
    neighbours' colour and stored dir."""
    if cfg.agg_intrp_order not in (1, 2):
        # the reference has no order-0 decode (point_aggregators.py:715/745
        # if == 1 / elif == 2): its module fails at the forward, as here
        raise ValueError(
            f"agg_intrp_order must be 1 or 2, got {cfg.agg_intrp_order}")
    B, R, SR, K, _ = sampled_embedding.shape
    mask = sample_pnt_mask
    ray_valid = mask.any(dim=-1)

    dists = compute_dists(cfg, sampled_xyz, sampled_xyz_pers, sample_loc,
                          sample_loc_w)
    kern = cfg.agg_distance_kernel
    if kern in ("trilinear", "sh_intrp", "gau_intrp"):
        weight, sampled_embedding = _dist_weights_ex(
            cfg, sampled_embedding, dists, mask,
            vsize if vsize is not None else (0.008,) * 3, 0.0)
    else:
        weight = _dist_weights(cfg, dists, mask)
    if (cfg.agg_weight_norm > 0 and kern != "trilinear"
            and not kern.startswith("num")):
        weight = weight / torch.clamp(weight.sum(-1, keepdim=True), min=1e-8)
    conf_coefficient = torch.ones_like(weight)
    if sampled_conf is not None:
        conf_coefficient = gradient_clamp(sampled_conf[..., 0])
    w = weight * conf_coefficient

    # viewdirs rotate into the canonical frame; per neighbour (an edited
    # scene's parts) by the first neighbour's rotation (reference :568/:579)
    viewdirs = sample_ray_dirs
    if Rw2c is not None:
        viewdirs = _rot_vec(viewdirs,
                            Rw2c if Rw2c.dim() == 2 else Rw2c[..., 0, :, :])
    ori_viewdirs = viewdirs
    if cfg.num_viewdir_freqs > 0:
        viewdirs = positional_encoding(viewdirs, cfg.num_viewdir_freqs,
                                       ori=True)[..., 3:]

    d = dists
    if cfg.dist_xyz_deno != 0.0 and vsize is not None:
        d = d / float(cfg.dist_xyz_deno * np.linalg.norm(np.asarray(vsize)))
    if Rw2c is not None:
        d = torch.cat([_rot_vec(d[..., :3], Rw2c), d[..., 3:]], dim=-1)

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
        alpha, feat_agg = _unfused(params, cfg, sampled_embedding, d, mask,
                                   w, sampled_label_embedding, sampled_color,
                                   sampled_dir, ori_viewdirs, Rw2c)

    if color is None:
        color = raw2out_color(cfg, _mlp_apply(
            cfg, params["color_branch"], torch.cat([feat_agg, viewdirs], -1),
            act_last=False))
    decoded = torch.cat([alpha, color], dim=-1)
    decoded = decoded * ray_valid[..., None].to(decoded.dtype)
    return decoded, ray_valid, weight, conf_coefficient


def _unfused(params, cfg: AggregatorConfig, feat, d, mask, w, sem, color,
             sdir, ori_viewdirs, Rw2c):
    """The plain per-neighbour body (the JAX package's :561-654) ->
    (alpha (B,R,SR,1), feat_agg (B,R,SR,C))."""
    if cfg.dist_xyz_freq != 0:
        d = positional_encoding(d, abs(cfg.dist_xyz_freq))
    if cfg.num_feat_freqs > 0:
        feat = torch.cat([feat, positional_encoding(feat, cfg.num_feat_freqs)],
                         dim=-1)
    if cfg.agg_intrp_order > 0:
        feat = torch.cat([feat, d], dim=-1)
    feat = _mlp_apply(cfg, params["block1"], feat)
    if cfg.shading_feature_mlp_layer2 > 0:
        # reference :624-630: the distance features join again
        if cfg.agg_intrp_order > 0:
            feat = torch.cat([feat, d], dim=-1)
        feat = _mlp_apply(cfg, params["block2"], feat)
    if cfg.shading_feature_mlp_layer2_bpnet > 0:
        if sem is not None:
            feat = torch.cat([feat, sem], dim=-1)
        feat = _mlp_apply(cfg, params["block2_bpnet"], feat)
    feat_branch = feat
    yuze = cfg.agg_variant == "yuze"
    if yuze:
        # yuze :649-651: the alpha head reads the features before block3
        # and block4 (density independent of view and rotation)
        if cfg.shading_feature_mlp_linear > 0:
            feat = _mlp_apply(cfg, params["block_linear"], feat)
        feat_branch = feat
    use_color = "1" in cfg.point_color_mode and color is not None
    use_dir = "1" in cfg.point_dir_mode and sdir is not None
    if use_dir and Rw2c is not None:
        sdir = _rot_vec(sdir, Rw2c)     # stored dirs in the canonical frame
    ov = ori_viewdirs[..., None, :].expand(feat.shape[:-1] + (3,))
    if cfg.shading_feature_mlp_layer3 > 0:
        # reference :638-653: colour, dir - viewdir and dir . viewdir
        parts = [feat] + ([color] if use_color else [])
        if use_dir:
            parts += [sdir - ov, (sdir * ov).sum(-1, keepdim=True)]
        feat = _mlp_apply(cfg, params["block3"], torch.cat(parts, dim=-1))
    if yuze and cfg.shading_feature_mlp_layer4 > 0:
        # yuze :670-705: colour and the PE'd plane cos-angles -> block4
        parts = [feat] + ([color] if use_color else [])
        if use_dir:
            parts.append(_yuze_angle_features(sdir, ov, cfg.num_feat_freqs))
        feat = _mlp_apply(cfg, params["block4"], torch.cat(parts, dim=-1))
    if cfg.agg_intrp_order == 1:
        # reference :715-742: features weighted over K first, then one
        # alpha decode a shading point
        feat_agg = (feat * mask[..., None] * w[..., None]).sum(-2)
        alpha = raw2out_density(cfg, _mlp_apply(
            cfg, params["alpha_branch"], feat_agg, act_last=False))
        return alpha, feat_agg
    raw_alpha = _mlp_apply(cfg, params["alpha_branch"],
                           feat_branch if yuze else feat, act_last=False)
    alpha_nb = raw2out_density(cfg, raw_alpha) * mask[..., None]
    alpha = (alpha_nb * w[..., None]).sum(-2)                   # (B,R,SR,1)
    feat_agg = (feat * mask[..., None] * w[..., None]).sum(-2)
    return alpha, feat_agg
