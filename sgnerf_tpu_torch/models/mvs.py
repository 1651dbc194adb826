"""MVS point-cloud initialisation: FeatureNet, CostRegNet and MVSNet, and
the per-point embedding (counterpart of `sgnerf_tpu/models/mvs.py`).

  * FeatureNet, the 2D pyramid (reference mvs/models.py:717-765), and
    CostRegNet, the 3D UNet (:767-812); the official MVSNet's FeatureNet
    and CostRegNet (depth_estimators/mvsnet.py:7-72) with its variance
    cost volume and softmax depth regression (:88-144);
  * InPlaceABN becomes batch norm with the stored statistics, then
    LeakyReLU (0.01) or ReLU: always inference mode, in the feed-forward
    training step too (the statistics are parameters the Adam moves, as
    in the JAX package);
  * homography warping, ndc <-> camera, bilinear sampling
    (mvs_utils.py);
  * MvsPointsModel.query_embedding (mvs_points_model.py:225-259): points
    warped into the reference view gather the pyramid's features, colour,
    view direction and confidence, fused by premlp (63 -> 32).

The JAX package runs NHWC / NDHWC with HWIO / DHWIO weights; the port runs
NCHW / NCDHW with torch's OIHW / OIDHW weights and the transposed 3D
convs in ConvTranspose3d's (ci, co, kd, kh, kw). Weights cross with
`mvs_params_from_jax` / `mvs_params_to_jax` (models/params.py). The 2D
helpers serve BPNet's 2D branch as well.

Precision: the nets run in IEEE float32 on the card, the cuDNN and cuBLAS
TF32 modes off inside `ieee_f32()`. The depth is a softmax-weighted mean
over 128 planes of the 3D UNet's output; TF32's 10-bit mantissa moves that
output by about 1e-3 of its magnitude and the regressed depth with it,
and the photometric confidence sums the probability around a truncated
index that such a shift can move. In IEEE f32 the card differs from the
CPU forward in the order of its sums only. The setting is made here for
each forward, so it does not depend on what ran before in the process.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def ieee_f32():
    """cuDNN convolutions and cuBLAS products in IEEE float32 (TF32 off),
    the previous modes restored after."""
    cd, mm = torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cd
        torch.backends.cuda.matmul.allow_tf32 = mm


# ------------------------------------------------------------ low-level ops

def leaky_relu(x, slope=0.01):
    return F.leaky_relu(x, negative_slope=slope)


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x (N,C,H,W), w (co,ci,kh,kw): torch-style symmetric k//2 padding, the
    input cast to the weight's dtype."""
    return F.conv2d(x.to(w.dtype), w, stride=stride,
                    padding=(w.shape[2] // 2, w.shape[3] // 2))


def conv3d(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x (N,C,D,H,W), w (co,ci,kd,kh,kw), symmetric k//2 padding."""
    return F.conv3d(x.to(w.dtype), w, stride=stride,
                    padding=tuple(k // 2 for k in w.shape[2:]))


def conv_transpose3d_s2(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-2 transposed conv, kernel 3, padding 1, output padding 1: each
    spatial dim doubles. w in ConvTranspose3d's layout (ci,co,kd,kh,kw)."""
    return F.conv_transpose3d(x.to(w.dtype), w, stride=2, padding=1,
                              output_padding=1)


def batch_norm(x, p, eps=1e-5, slope=0.01, act=True):
    """Inference-mode BN over channel axis 1, then LeakyReLU(slope)."""
    shape = (1, -1) + (1,) * (x.dim() - 2)

    def c(t):
        return t.reshape(shape)
    y = (x - c(p["running_mean"])) * torch.rsqrt(c(p["running_var"]) + eps) \
        * c(p["weight"]) + c(p["bias"])
    return leaky_relu(y, slope) if act else y


def bilinear_interpolate(img: torch.Tensor, x: torch.Tensor,
                         y: torch.Tensor) -> torch.Tensor:
    """img (H,W,C); x, y (...,) pixel coords -> (...,C): the four taps,
    each zero outside the image (grid_sample's bilinear, zeros padding,
    align_corners=True, after the grid's denormalisation), in the JAX
    package's order of operations."""
    H, W, _ = img.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    dx = (x - x0)[..., None]
    dy = (y - y0)[..., None]

    def tap(xi, yi):
        inb = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        v = img[yi.clamp(0, H - 1).long(), xi.clamp(0, W - 1).long()]
        return v * inb[..., None]

    x0i, y0i = x0.to(torch.int32), y0.to(torch.int32)
    v00 = tap(x0i, y0i)
    v01 = tap(x0i + 1, y0i)
    v10 = tap(x0i, y0i + 1)
    v11 = tap(x0i + 1, y0i + 1)
    return ((1 - dx) * (1 - dy) * v00 + dx * (1 - dy) * v01
            + (1 - dx) * dy * v10 + dx * dy * v11)


def grid_sample_norm(feat: torch.Tensor, grid_xy: torch.Tensor
                     ) -> torch.Tensor:
    """feat (C,H,W); grid_xy (...,2) in [-1,1] -> (...,C), bilinear with
    zeros padding and align_corners=True (JAX's grid_sample_norm, which
    tests/test_mvs.py holds to this call)."""
    lead = grid_xy.shape[:-1]
    out = F.grid_sample(feat[None].to(grid_xy.dtype),
                        grid_xy.reshape(1, 1, -1, 2), mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    return out[0, :, 0].T.reshape(lead + (feat.shape[0],))


def resize_bilinear_align_corners(x: torch.Tensor, out_hw) -> torch.Tensor:
    """(N,C,H,W) -> (N,C,h,w) bilinear with align_corners=True, in float32
    (the JAX formula's weights are f32, which promotes a bf16 input)."""
    return F.interpolate(x.to(torch.float32), size=tuple(int(s) for s in
                                                          out_hw),
                         mode="bilinear", align_corners=True)


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """(N,C,H,W) -> (N,C,2H,2W), align_corners=True."""
    return resize_bilinear_align_corners(x, (2 * x.shape[2], 2 * x.shape[3]))


# ------------------------------------------------------------- feature nets

def conv_bn_relu(x, p, stride=1, conv=conv2d, slope=0.01):
    return batch_norm(conv(x, p["conv"]["weight"], stride=stride), p["bn"],
                      slope=slope)


def feature_net_apply(params, imgs):
    """imgs (V,3,H,W) -> the pyramid [imgs, (V,8,H,W), (V,16,H/2,W/2),
    (V,32,H/4,W/4)] (the reference's `intermediate=True` mode)."""
    x1 = conv_bn_relu(conv_bn_relu(imgs, params["conv0"]["0"]),
                      params["conv0"]["1"])
    x2 = conv_bn_relu(x1, params["conv1"]["0"], stride=2)
    x2 = conv_bn_relu(conv_bn_relu(x2, params["conv1"]["1"]),
                      params["conv1"]["2"])
    x3 = conv_bn_relu(x2, params["conv2"]["0"], stride=2)
    x3 = conv_bn_relu(conv_bn_relu(x3, params["conv2"]["1"]),
                      params["conv2"]["2"])
    x3 = conv2d(x3, params["toplayer"]["weight"]) \
        + params["toplayer"]["bias"].reshape(1, -1, 1, 1)
    return [imgs, x1, x2, x3]


def official_feature_apply(params, imgs):
    """The official MVSNet FeatureNet: 8 convs with ReLU to one 32-channel
    map at 1/4 resolution. imgs (V,3,H,W) -> (V,32,H/4,W/4)."""
    def r(x, p, s=1):
        return conv_bn_relu(x, p, stride=s, slope=0.0)
    x = r(r(imgs, params["conv0"]), params["conv1"])
    x = r(r(r(x, params["conv2"], 2), params["conv3"]), params["conv4"])
    x = r(r(x, params["conv5"], 2), params["conv6"])
    return conv2d(x, params["feature"]["weight"]) \
        + params["feature"]["bias"].reshape(1, -1, 1, 1)


def _unet3d(params, x, slope):
    """CostRegNet's encoder-decoder (both variants), x (N,C,D,H,W)."""
    def c(x, p, s=1):
        return conv_bn_relu(x, p, stride=s, conv=conv3d, slope=slope)
    conv0 = c(x, params["conv0"])
    conv2 = c(c(conv0, params["conv1"], 2), params["conv2"])
    conv4 = c(c(conv2, params["conv3"], 2), params["conv4"])
    y = c(c(conv4, params["conv5"], 2), params["conv6"])
    y = conv4 + batch_norm(
        conv_transpose3d_s2(y, params["conv7"]["0"]["weight"]),
        params["conv7"]["1"], slope=slope)
    y = conv2 + batch_norm(
        conv_transpose3d_s2(y, params["conv9"]["0"]["weight"]),
        params["conv9"]["1"], slope=slope)
    return conv0 + batch_norm(
        conv_transpose3d_s2(y, params["conv11"]["0"]["weight"]),
        params["conv11"]["1"], slope=slope)


def official_cost_reg_apply(params, x):
    """The official CostRegNet with its 1-channel prob conv (ReLU).
    x (N,32,D,H,W) -> (N,1,D,H,W)."""
    y = _unet3d(params, x, 0.0)
    return conv3d(y, params["prob"]["weight"]) \
        + params["prob"]["bias"].reshape(1, -1, 1, 1, 1)


def cost_reg_apply(params, x):
    """CostRegNet 3D UNet (LeakyReLU). x (N,C,D,H,W) -> (N,8,D,H,W)."""
    return _unet3d(params, x, 0.01)


# --------------------------------------------------------------- warp utils

def homo_warp(src_feat, proj_mat, depth_values):
    """src_feat (C,H,W); proj_mat (3,4) = src_proj @ ref_proj_inv;
    depth_values (D,H,W). Returns the warped volume (C,D,H,W) and its grid
    (D,H,W,2) in [-1,1] (reference mvs_utils.homo_warp :430-470)."""
    C, H, W = src_feat.shape
    D = depth_values.shape[0]
    dev, dt = src_feat.device, src_feat.dtype
    R = proj_mat[:, :3]
    T = proj_mat[:, 3:]
    ys, xs = torch.meshgrid(torch.arange(H, dtype=dt, device=dev),
                            torch.arange(W, dtype=dt, device=dev),
                            indexing="ij")
    ref_xyz = torch.stack([xs, ys, torch.ones_like(xs)]).reshape(3, -1)
    src_xyz = R @ ref_xyz                                   # (3, H*W)
    src_xyz = (src_xyz[:, None, :] * depth_values.reshape(1, D, -1)
               + T.reshape(3, 1, 1))
    z = torch.where(src_xyz[2].abs() < 1e-9,
                    torch.full_like(src_xyz[2], 1e-9), src_xyz[2])
    gx = src_xyz[0] / z
    gy = src_xyz[1] / z
    grid = torch.stack([gx / ((W - 1) / 2) - 1, gy / ((H - 1) / 2) - 1],
                       dim=-1).reshape(D, H, W, 2)
    warped = F.grid_sample(src_feat[None], grid.reshape(1, D, H * W, 2),
                           mode="bilinear", padding_mode="zeros",
                           align_corners=True)
    return warped.reshape(C, D, H, W), grid


def ndc_2_cam(ndc_xyz, near_far, intrinsic, W, H):
    inv_scale = torch.tensor([W - 1.0, H - 1.0], dtype=ndc_xyz.dtype,
                             device=ndc_xyz.device)
    cam_z = ndc_xyz[..., 2:3] * (near_far[1] - near_far[0]) + near_far[0]
    cam_xy = ndc_xyz[..., :2] * inv_scale * cam_z
    cam_xyz = torch.cat([cam_xy, cam_z], dim=-1)
    return cam_xyz @ torch.linalg.inv(intrinsic.T)


def homo_warp_nongrid(c2w, w2c, intrinsic, ref_cam_xyz, HD, WD):
    """Project ref-camera points into a source view (reference :299-316).
    ref_cam_xyz (M,3) -> (grid_xy in [-1,1] (M,2), in-frame mask (M,))."""
    if w2c is not None:
        ones = torch.ones_like(ref_cam_xyz[:, :1])
        src = torch.cat([ref_cam_xyz, ones], -1) @ c2w.T @ w2c.T
        src = src[:, :3]
    else:
        src = ref_cam_xyz
    pix = (src / src[:, 2:3]) @ intrinsic.T
    gxy = pix[:, :2]
    lim = torch.tensor([WD - 1.0, HD - 1.0], dtype=gxy.dtype,
                       device=gxy.device)
    mask = ((gxy >= 0) & (gxy <= lim)).all(dim=-1)
    grid = torch.stack([gxy[:, 0] / ((WD - 1.0) / 2.0) - 1.0,
                        gxy[:, 1] / ((HD - 1.0) / 2.0) - 1.0], dim=-1)
    return grid, mask


# ------------------------------------------------------------ MvsPointsModel

@dataclasses.dataclass(frozen=True)
class MVSConfig:
    depth_grid: int = 128
    dprob_thresh: float = 0.8
    point_features_dim: int = 32
    premlp_layers: int = 2
    init_view_num: int = 3


def init_mvs_params(seed: int, cfg: MVSConfig, device="cpu"
                    ) -> Dict[str, Any]:
    """Seeded init of the FeatureNets, CostRegNets and premlp (He-normal
    convs, BN at identity, premlp Glorot-uniform), the JAX init's
    distributions and tree, in the port's layout (its own random numbers:
    parity tests carry the JAX weights over)."""
    from .params import mvs_params_from_jax
    gen = torch.Generator().manual_seed(int(seed))

    def conv(kshape):               # drawn in the JAX layout, fan-in there
        fan_in = int(np.prod(kshape[:-1]))
        return {"weight": torch.randn(kshape, generator=gen)
                * float(np.sqrt(2.0 / fan_in))}

    def bn(c):
        return {"weight": torch.ones(c), "bias": torch.zeros(c),
                "running_mean": torch.zeros(c), "running_var": torch.ones(c)}

    def cbr2(ci, co, k=3):
        return {"conv": conv((k, k, ci, co)), "bn": bn(co)}

    def cbr3(ci, co, k=3):
        return {"conv": conv((k, k, k, ci, co)), "bn": bn(co)}

    def unet(ci):
        return {
            "conv0": cbr3(ci, 8), "conv1": cbr3(8, 16), "conv2": cbr3(16, 16),
            "conv3": cbr3(16, 32), "conv4": cbr3(32, 32),
            "conv5": cbr3(32, 64), "conv6": cbr3(64, 64),
            "conv7": {"0": conv((3, 3, 3, 32, 64)), "1": bn(32)},
            "conv9": {"0": conv((3, 3, 3, 16, 32)), "1": bn(16)},
            "conv11": {"0": conv((3, 3, 3, 8, 16)), "1": bn(8)},
        }

    feat = {
        "conv0": {"0": cbr2(3, 8), "1": cbr2(8, 8)},
        "conv1": {"0": cbr2(8, 16, 5), "1": cbr2(16, 16), "2": cbr2(16, 16)},
        "conv2": {"0": cbr2(16, 32, 5), "1": cbr2(32, 32), "2": cbr2(32, 32)},
        "toplayer": {"weight": conv((1, 1, 32, 32))["weight"],
                     "bias": torch.zeros(32)},
    }
    official_cost = unet(32)
    official_cost["prob"] = {"weight": conv((3, 3, 3, 8, 1))["weight"],
                             "bias": torch.zeros(1)}
    official = {
        "feature": {
            "conv0": cbr2(3, 8), "conv1": cbr2(8, 8),
            "conv2": cbr2(8, 16, 5), "conv3": cbr2(16, 16),
            "conv4": cbr2(16, 16), "conv5": cbr2(16, 32, 5),
            "conv6": cbr2(32, 32),
            "feature": {"weight": conv((3, 3, 32, 32))["weight"],
                        "bias": torch.zeros(32)},
        },
        "cost_regularization": official_cost,
    }
    # premlp: 63 -> 32 (features 8+16+32, colour 3, dir 3, conf 1)
    premlp, cin = [], 63
    for _ in range(cfg.premlp_layers):
        a = float(np.sqrt(2.0 / (cin + cfg.point_features_dim)) * np.sqrt(3))
        premlp.append({
            "w": torch.rand((cin, cfg.point_features_dim), generator=gen)
            * (2 * a) - a,
            "b": torch.zeros(cfg.point_features_dim)})
        cin = cfg.point_features_dim
    tree = {"FeatureNet": feat, "CostRegNet": unet(32 + 9),
            "official": official, "premlp": premlp}
    return mvs_params_from_jax(tree, device)


class MvsPointsModel:
    """Depth -> point cloud -> per-point embedding pipeline. Images come in
    the datasets' (V,H,W,3) layout and are moved to channels-first here."""

    def __init__(self, cfg: MVSConfig, params: Optional[Dict] = None,
                 seed: int = 0, device="cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.params = (params if params is not None
                       else init_mvs_params(seed, cfg, self.device))

    # ----------------------------------------------------------- depth (MVS)

    def predict_depth(self, imgs, proj_mats, depth_values):
        """Official-MVSNet depth inference (reference
        depth_estimators/mvsnet.py:88-144). imgs (V,H,W,3), reference view
        first; proj_mats (V,3,4) = src_proj @ ref_proj_inv at feature
        scale; depth_values (D,). Returns (depth (h,w), photometric
        confidence (h,w), prob (D,h,w))."""
        p = self.params["official"]
        with ieee_f32():
            feats = official_feature_apply(p["feature"],
                                           imgs.permute(0, 3, 1, 2))
            V, C, h, w = feats.shape
            D = depth_values.shape[0]
            dvals = depth_values[:, None, None].expand(D, h, w)
            vol_sum = vol_sq = 0.0
            for v in range(V):
                warped, _ = homo_warp(feats[v], proj_mats[v], dvals)
                vol_sum = vol_sum + warped
                vol_sq = vol_sq + warped ** 2
            variance = vol_sq / V - (vol_sum / V) ** 2      # (C,D,h,w)
            # CostRegNet's three stride-2 levels need D, h and w divisible
            # by 8: zero-pad up front, crop the regularised volume after (a
            # no-op at MVSNet's own shapes)
            pads = [(-s) % 8 for s in (D, h, w)]
            var_p = F.pad(variance, (0, pads[2], 0, pads[1], 0, pads[0]))
            cost = official_cost_reg_apply(
                p["cost_regularization"], var_p[None])[0, 0, :D, :h, :w]
        prob = torch.softmax(cost, dim=0)
        depth = (prob * dvals).sum(0)
        # photometric confidence: the probability of the 4 planes around the
        # truncated regressed index (reference 4*avg_pool3d over a (1,2)
        # zero-padded D axis, mvsnet.py:133-135: taps off either end count 0)
        ar = torch.arange(D, dtype=prob.dtype, device=prob.device)
        d_index = (prob * ar[:, None, None]).sum(0)
        idx = d_index.to(torch.int32).long()
        taps = idx[None] + torch.arange(-1, 3, device=prob.device)[
            :, None, None]
        valid = (taps >= 0) & (taps < D)
        got = torch.gather(prob, 0, taps.clamp(0, D - 1))
        conf = torch.where(valid, got, torch.zeros_like(got)).sum(0)
        return depth, conf, prob

    # ----------------------------------------------------- point unprojection

    def depth2point(self, sampled_ndc_depth, intrinsic, near_far):
        H, W = sampled_ndc_depth.shape
        dev, dt = sampled_ndc_depth.device, sampled_ndc_depth.dtype
        ys = torch.linspace(0, 1, H, dtype=dt, device=dev)
        xs = torch.linspace(0, 1, W, dtype=dt, device=dev)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        ndc = torch.stack([gx, gy, sampled_ndc_depth], dim=-1)
        return ndc, ndc_2_cam(ndc, near_far, intrinsic, W, H)

    def gen_points(self, imgs, proj_mats, intrinsic, near_far,
                   gt_depth=None):
        """A camera-space point per depth pixel of the reference view: from
        gt_depth (manual_depth_view 0) or MVSNet's depth (1). Returns
        (cam_xyz (h,w,3), mask (h,w), conf (h,w)). The reference's gaussian
        depth jitter (manual_std_depth > 0) is not carried: both packages'
        trainers build their MVSConfig without it, so it is always 0."""
        cfg = self.cfg
        if gt_depth is not None:
            depth = gt_depth
            conf = torch.ones_like(depth)
            mask = (depth >= near_far[0]) & (depth <= near_far[1])
        else:
            depth_values = torch.linspace(float(near_far[0]),
                                          float(near_far[1]), cfg.depth_grid,
                                          device=imgs.device)
            depth, conf, _ = self.predict_depth(imgs, proj_mats,
                                                depth_values)
            mask = conf > cfg.dprob_thresh
        ndc_depth = (depth - near_far[0]) / (near_far[1] - near_far[0])
        _, cam_xyz = self.depth2point(ndc_depth, intrinsic, near_far)
        return cam_xyz, mask, conf

    # -------------------------------------------------------- point embedding

    def query_embedding(self, HDWD, cam_xyz, photometric_confidence, imgs,
                        c2ws, w2cs, intrinsics, cam_vid=0, pointdir_w=True):
        """cam_xyz (M,3) in view cam_vid's camera frame; imgs (V,H,W,3).
        Returns (embedding (M,F), colour (M,3), dir (M,3), conf (M,1)):
        the reference's appr_feature_str0 = imgfeat_0_0123 dir_0
        point_conf (mvs_points_model.py:225-259)."""
        HD, WD = HDWD
        with ieee_f32():
            feats = feature_net_apply(self.params["FeatureNet"],
                                      imgs.permute(0, 3, 1, 2))
            grid, mask = homo_warp_nongrid(
                c2ws[cam_vid], None if cam_vid == 0 else w2cs[0],
                intrinsics[0], cam_xyz, HD, WD)
            gathered = []
            color = None
            for lid in range(4):        # view 0: colour, then the pyramid
                g = grid_sample_norm(feats[lid][0], grid) * mask[:, None]
                if lid == 0:
                    color = g
                else:
                    gathered.append(g)
            emb = torch.cat(gathered, dim=-1)                 # (M, 56)
            # dir_0: camera 0 to the point, in world coords
            cam_pos = torch.cat([c2ws[0][:3, 3], c2ws[0].new_ones(1)])
            cam_pos_cam = (cam_pos @ w2cs[cam_vid].T)[:3]
            dirs = cam_xyz - cam_pos_cam[None]
            dirs = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True)
                           + 1e-6)
            if pointdir_w:
                dirs = dirs @ c2ws[cam_vid][:3, :3].T
            conf = (photometric_confidence[:, None]
                    if photometric_confidence is not None
                    else torch.ones_like(emb[:, :1]))
            x = torch.cat([emb, color, dirs, conf], dim=-1)  # (M, 63)
            for layer in self.params["premlp"]:
                x = leaky_relu(x @ layer["w"] + layer["b"])
        return x, color, dirs, conf

    @torch.no_grad()
    def embed_points(self, xyz_world: np.ndarray, dataset, nearest_view_fn):
        """Each world point's embedding from its most head-on camera (the
        bootstrap's, reference run/train_ft.py:737-771): the points of one
        camera are warped into its full frame together. Returns numpy
        (embedding, colour, dir, conf)."""
        campos, camdir = dataset.get_campos_ray()
        cam_ind = nearest_view_fn(campos, camdir, xyz_world)
        n = len(xyz_world)
        F_ = self.cfg.point_features_dim
        emb = np.zeros((n, F_), np.float32)
        col = np.zeros((n, 3), np.float32)
        dirs = np.zeros((n, 3), np.float32)
        conf = np.ones((n, 1), np.float32)
        dev = self.device

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)
        for ci in np.unique(cam_ind):
            sel = cam_ind == ci
            item = dataset.get_item(int(ci), full_img=True)
            c2w = np.asarray(item["c2w"], np.float32)
            w2c = np.linalg.inv(c2w)
            pts = xyz_world[sel]
            cam_xyz = (np.concatenate(
                [pts, np.ones_like(pts[:, :1])], -1) @ w2c.T)[:, :3]
            e, c, d, cf = self.query_embedding(
                (dataset.height, dataset.width), t(cam_xyz), None,
                t(item["full_image"])[None], t(c2w)[None], t(w2c)[None],
                t(item["intrinsic"])[None], cam_vid=0, pointdir_w=True)
            emb[sel] = e.cpu().numpy()
            col[sel] = c.cpu().numpy()
            dirs[sel] = d.cpu().numpy()
            conf[sel] = cf.cpu().numpy()
        return emb, col, dirs, conf
