"""BPNet: joint 2D/3D semantic segmentation with bidirectional projection.

Counterpart of `sgnerf_tpu/models/bpnet/bpnet.py` (reference
models/bpneter/bpnet.py):
  * `compute_linking`: project voxel centres into each view and keep the
    pixels whose depth agrees within voxel_size (occlusion test);
  * `voxelize` at 0.05 m with link passthrough (keep-first);
  * `bpnet_forward`: the staged 2D ResUNet-34 / 3D MinkUNet18A forward with
    Linking fusion at p5..p2;
  * `BPNet.train_bpnet`: view_num images of the train split (the current
    frame first), BN on its running statistics, the forward over the whole
    point cloud, devoxelized by the inverse map. Inference only: BPNet's
    weights never train, in either package.

The host ops are numpy copies of the JAX package's. `compute_dtype`
"bfloat16" casts the weights, images and grid features to bf16 (the sparse
products accumulate in f32) and returns f32 logits and features, as the JAX
package does; "float32" runs IEEE f32 products on the card: constructing a
float32 BPNet on a CUDA device turns cuDNN's TF32 off for the process
(`torch.backends.cudnn.allow_tf32 = False`; no other convolution runs in
the port) and its sparse products follow
`torch.backends.cuda.matmul.allow_tf32`, off by PyTorch's default.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...ops.sparse import SparseGrid, _gather_rows, make_sparse_grid
from . import unet2d, unet3d
from .linking import apply_linking, init_linking_params
from .unet3d import PLANES_18A

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32) * 255.0
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32) * 255.0


@dataclasses.dataclass(frozen=True)
class BPNetConfig:
    classes: int = 20
    view_num: int = 3
    voxel_size: float = 0.05
    img_wh: Tuple[int, int] = (640, 480)
    layers_2d: int = 34
    compute_dtype: str = "float32"   # or "bfloat16" (see the module doc)
    aug: int = 0                     # train-time augmentation: 2D blur and
    #                                  the prevoxel elastic distortion


# ------------------------------------------------------------------- host ops

def elastic_distortion(coords: np.ndarray, granularity: float,
                       magnitude: float,
                       rng: np.random.Generator) -> np.ndarray:
    """Elastic distortion of point coordinates (reference
    bpnet_dataset/augmentation.py:159-201): a Gaussian noise grid at
    `granularity` spacing, box-blurred twice along each axis (3-tap,
    zero-padded), trilinearly interpolated at each point and added scaled
    by `magnitude`."""
    coords = np.asarray(coords, np.float32)
    cmin = coords.min(0)
    noise_dim = ((coords - cmin).max(0) // granularity).astype(int) + 3
    noise = rng.standard_normal(size=(*noise_dim, 3)).astype(np.float32)

    def blur_axis(x, axis):
        pad = [(0, 0)] * x.ndim
        pad[axis] = (1, 1)
        xp = np.pad(x, pad)
        sl = [slice(None)] * x.ndim
        out = np.zeros_like(x)
        for k in range(3):
            sl[axis] = slice(k, k + x.shape[axis])
            out += xp[tuple(sl)]
        return out / 3.0

    for _ in range(2):
        for axis in range(3):
            noise = blur_axis(noise, axis)

    u = (coords - (cmin - granularity)) / granularity
    u = np.clip(u, 0.0, noise_dim.astype(np.float32) - 1.0 - 1e-6)
    i0 = np.floor(u).astype(np.int64)
    f = (u - i0).astype(np.float32)
    disp = np.zeros_like(coords)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = (np.where(dx, f[:, 0], 1 - f[:, 0])
                     * np.where(dy, f[:, 1], 1 - f[:, 1])
                     * np.where(dz, f[:, 2], 1 - f[:, 2]))
                disp += w[:, None] * noise[i0[:, 0] + dx, i0[:, 1] + dy,
                                           i0[:, 2] + dz]
    return coords + disp * magnitude


# reference ELASTIC_DISTORT_PARAMS (bpneter/bpnet.py:157)
ELASTIC_DISTORT_PARAMS = ((0.2, 0.4), (0.8, 1.6))


def prevoxel_distort(coords: np.ndarray,
                     rng: np.random.Generator) -> np.ndarray:
    """With p = 0.95, ElasticDistortion at both (granularity, magnitude)
    scales in sequence (augmentation.py:196-201)."""
    if rng.random() < 0.95:
        for granularity, magnitude in ELASTIC_DISTORT_PARAMS:
            coords = elastic_distortion(coords, granularity, magnitude, rng)
    return coords


def compute_linking(intrinsic4: np.ndarray, c2w: np.ndarray,
                    coords_world: np.ndarray, depth: np.ndarray,
                    voxel_size: float) -> np.ndarray:
    """-> (N,3) int32 [row, col, valid] (reference computeLinking)."""
    H, W = depth.shape
    w2c = np.linalg.inv(c2w)
    p = (np.concatenate([coords_world,
                         np.ones((len(coords_world), 1))], 1) @ w2c.T).T
    px = p[0] * intrinsic4[0, 0] / p[2] + intrinsic4[0, 2]
    py = p[1] * intrinsic4[1, 1] / p[2] + intrinsic4[1, 2]
    pi = np.round(np.stack([px, py])).astype(np.int64)
    inside = (pi[0] >= 0) & (pi[1] >= 0) & (pi[0] < W) & (pi[1] < H) \
        & (p[2] > 1e-6)
    link = np.zeros((len(coords_world), 3), np.int32)
    ii = np.where(inside)[0]
    occl = np.abs(depth[pi[1][ii], pi[0][ii]] - p[2][ii]) <= voxel_size
    ii = ii[occl]
    link[ii, 0] = pi[1][ii]
    link[ii, 1] = pi[0][ii]
    link[ii, 2] = 1
    return link


def voxelize(locs: np.ndarray, feats: np.ndarray, voxel_size: float,
             links: Optional[np.ndarray] = None, return_first: bool = False):
    """Deterministic quantization, the first point of each voxel kept.
    Returns (coords (M,3) int32 origin-aligned, vfeats (M,C),
    inds_reconstruct (N,), vlinks[, first_idx (M,)])."""
    coords = np.floor(locs / voxel_size)
    coords = coords - coords.min(0)
    coords = coords.astype(np.int64)
    key = (coords[:, 0] << 42) + (coords[:, 1] << 21) + coords[:, 2]
    _, first_idx, inv = np.unique(key, return_index=True,
                                  return_inverse=True)
    vcoords = coords[first_idx].astype(np.int32)
    vfeats = feats[first_idx]
    vlinks = links[first_idx] if links is not None else None
    if return_first:
        return vcoords, vfeats, inv.astype(np.int64), vlinks, first_idx
    return vcoords, vfeats, inv.astype(np.int64), vlinks


def representative_child(fine: SparseGrid, coarse: SparseGrid
                         ) -> torch.Tensor:
    """For each coarse row, the row of its first fine child in {0,1}^3
    order (-1 if none): the ancestry that carries links across strides."""
    offs = np.stack(np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"),
                    -1).reshape(-1, 3)
    dev = coarse.coords.device
    child = coarse.coords[:, None, :] * 2 + torch.as_tensor(
        offs, dtype=torch.int32, device=dev)
    row, ok = _gather_rows(fine, child)
    pos = torch.arange(8, device=dev)
    first = torch.where(ok, pos, torch.full_like(pos, 8)).min(dim=1).values
    r = torch.gather(row, 1, first.clamp(max=7)[:, None])[:, 0]
    has = ok.any(dim=1)
    return torch.where(has & coarse.mask, r, torch.full_like(r, -1))


# --------------------------------------------------------------------- params

def init_bpnet_params(gen: torch.Generator, cfg: BPNetConfig):
    """Seeded parameters with the reference's shapes (conv weights He-
    normal, BN at identity), drawn from `gen` on the CPU."""
    return {
        "unet2d": unet2d.init_unet2d_params(gen, cfg.classes),
        "unet3d": unet3d.init_unet3d_params(gen, 3, cfg.classes),
        "linker_p5": init_linking_params(gen, 512, PLANES_18A[3],
                                         cfg.view_num),
        "linker_p4": init_linking_params(gen, 256, PLANES_18A[4],
                                         cfg.view_num),
        "linker_p3": init_linking_params(gen, 128, PLANES_18A[5],
                                         cfg.view_num),
        "linker_p2": init_linking_params(gen, 96, PLANES_18A[6],
                                         cfg.view_num),
    }


def map_tensors(fn, tree):
    """fn over every tensor leaf of a nested dict/list tree."""
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tensors(fn, v) for v in tree]
    return fn(tree) if torch.is_tensor(tree) else tree


# -------------------------------------------------------------------- forward

def _scale_links(links, H, W, h, w):
    """links (M,4,V) at image res (h,w) -> feature res (H,W) (reference:
    links[:,1:3] * (H-1)/(h-1), truncated)."""
    scaled = ((H - 1.0) / (h - 1.0) * links[:, 1:3, :].to(torch.float32)
              ).to(torch.int32)
    return torch.cat([links[:, :1, :], scaled, links[:, 3:, :]], dim=1)


def _level_links(links_p1, rep_row):
    """Carry p1-row links to a coarser level by representative child rows."""
    out = links_p1[rep_row.clamp(min=0).long()]
    return torch.where((rep_row >= 0)[:, None, None], out,
                       torch.zeros_like(out))


def bpnet_forward(params, cfg: BPNetConfig, grid_p1: SparseGrid,
                  imgs: torch.Tensor, links_p1: torch.Tensor,
                  down_caps: Sequence[int]):
    """grid_p1: voxel grid (feats = colours in [-1,1]); imgs (V,h,w,3)
    normalized; links_p1 (M,4,V) [batch,row,col,valid] at image res.

    Returns (softmax3d (M,classes), logits2d (V,h,w,classes), feat3d
    (M,96)), all float32."""
    V, h, w, _ = imgs.shape
    imgs = imgs.permute(0, 3, 1, 2)
    if cfg.compute_dtype == "bfloat16":
        def cast(t):
            return t.to(torch.bfloat16) if t.is_floating_point() else t
        params = map_tensors(cast, params)
        imgs = imgs.to(torch.bfloat16)
        grid_p1 = dataclasses.replace(grid_p1,
                                      feats=grid_p1.feats.to(torch.bfloat16))
    p2d = params["unet2d"]
    x, x2, x3, x4, x5 = unet2d.encoder_apply(p2d, imgs)

    p3d = params["unet3d"]
    out_p1 = unet3d.layer0(p3d, grid_p1)
    out_b1p2 = unet3d.down_stage(p3d, 1, out_p1, down_caps[0])
    out_b2p4 = unet3d.down_stage(p3d, 2, out_b1p2, down_caps[1])
    out_b3p8 = unet3d.down_stage(p3d, 3, out_b2p4, down_caps[2])
    out_b4p16 = unet3d.down_stage(p3d, 4, out_b3p8, down_caps[3])

    # ancestry chains p1 -> p2 -> p4 -> p8 -> p16
    def chain(rep_lo, rep_parent):
        return torch.where(rep_lo >= 0, rep_parent[rep_lo.clamp(min=0).long()],
                           torch.full_like(rep_lo, -1))
    rep2 = representative_child(out_p1, out_b1p2)
    rep4 = chain(representative_child(out_b1p2, out_b2p4), rep2)
    rep8 = chain(representative_child(out_b2p4, out_b3p8), rep4)
    rep16 = chain(representative_child(out_b3p8, out_b4p16), rep8)

    def links_at(rep, feat):
        return _scale_links(_level_links(links_p1, rep), feat.shape[2],
                            feat.shape[3], h, w)

    fused3d, fused2d = apply_linking(params["linker_p5"], x5, out_b4p16,
                                     links_at(rep16, x5), cfg.view_num)
    p4 = unet2d.up_block(p2d, "up4", "delayer4", fused2d, x4)
    feat3d = unet3d.up_stage(p3d, "convtr4", fused3d, out_b3p8)

    fused3d, fused2d = apply_linking(params["linker_p4"], p4, feat3d,
                                     links_at(rep8, p4), cfg.view_num)
    p3 = unet2d.up_block(p2d, "up3", "delayer3", fused2d, x3)
    g = unet3d.blocks_on_cat(p3d, "block5", fused3d, out_b3p8.feats)
    feat3d = unet3d.up_stage(p3d, "convtr5", g, out_b2p4)

    fused3d, fused2d = apply_linking(params["linker_p3"], p3, feat3d,
                                     links_at(rep4, p3), cfg.view_num)
    p2 = unet2d.up_block(p2d, "up2", "delayer2", fused2d, x2)
    g = unet3d.blocks_on_cat(p3d, "block6", fused3d, out_b2p4.feats)
    feat3d = unet3d.up_stage(p3d, "convtr6", g, out_b1p2)

    fused3d, fused2d = apply_linking(params["linker_p2"], p2, feat3d,
                                     links_at(rep2, p2), cfg.view_num)
    g = unet3d.blocks_on_cat(p3d, "block7", fused3d, out_b1p2.feats)
    feat3d = unet3d.up_stage(p3d, "convtr7", g, out_p1)

    g = unet3d.blocks_on_cat(p3d, "block8", feat3d, out_p1.feats)
    res3d_feat = g.feats.to(torch.float32)                  # (M, 96)
    logits3d = unet3d.cls_head(p3d, g).to(torch.float32)
    softmax3d = torch.softmax(logits3d, dim=-1) * g.mask[:, None].to(
        torch.float32)
    logits2d = unet2d.cls_apply(p2d, fused2d, (h, w)).to(torch.float32)
    return softmax3d, logits2d.permute(0, 2, 3, 1), res3d_feat


# ------------------------------------------------------------------ the model

class BPNet:
    """BPNet on `device` with its weights (the port's tree, on the CPU or
    the device); seeded from `seed` when none are given."""

    def __init__(self, cfg: BPNetConfig, params=None, seed: int = 0,
                 device="cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
        if params is None:
            params = init_bpnet_params(torch.Generator().manual_seed(seed),
                                       cfg)
        self.params = map_tensors(lambda t: t.to(self.device), params)
        if self.device.type == "cuda" and cfg.compute_dtype == "float32":
            torch.backends.cudnn.allow_tf32 = False
        # voxelization structure cache (aug = 0): while xyz and feats stay
        # frozen, (vcoords, inds_reconstruct, first_idx, the SparseGrid) are
        # constant, so a later refresh projects links for the ~1e5 voxel
        # representatives only instead of np.unique over the whole cloud
        self._vox_cache = None
        self.timings = {}        # the last refresh: host_s, forward_s

    def _select_views(self, frames_path: List[str], image_path: str):
        """The view split; the current frame leads when present (reference
        train_bpnet :500-516). The generator is seeded with the salted
        `hash` of the path, as in the JAX package: the views differ from
        process to process (PYTHONHASHSEED), agree within one."""
        V = self.cfg.view_num
        partial_n = max(1, len(frames_path) // V)
        buckets = [frames_path[v * partial_n:(v + 1) * partial_n]
                   for v in range(V - 1)]
        buckets.append(frames_path[(V - 1) * partial_n:])
        rng = np.random.default_rng(abs(hash(image_path)) % (2 ** 31))
        chosen = []
        for v in range(V):
            if image_path in buckets[v]:
                chosen.insert(0, image_path)
            else:
                chosen.append(buckets[v][rng.integers(len(buckets[v]))]
                              if buckets[v] else image_path)
        return chosen[:V]

    def _load_view(self, path: str, coords_world: np.ndarray,
                   intrinsic4: np.ndarray,
                   rng: Optional[np.random.Generator] = None):
        from PIL import Image
        wh = self.cfg.img_wh
        with Image.open(path) as im:
            im = im.resize(wh, Image.NEAREST)
            if self.cfg.aug and rng is not None and rng.random() < 0.5:
                # reference augmentation_2d.py RandomGaussianBlur (p = 0.5)
                from PIL import ImageFilter
                im = im.filter(ImageFilter.GaussianBlur(radius=1.1))
            img = np.asarray(im, np.float32)
        dp = path.replace("color", "depth").replace(".jpg", ".png")
        with Image.open(dp) as im:
            depth = np.asarray(im.resize(wh, Image.NEAREST),
                               np.float32) / 1000.0
        pose = np.loadtxt(path.replace("color", "pose")
                          .replace(".jpg", ".txt")).astype(np.float64)
        link = np.ones((len(coords_world), 4), np.int32)
        link[:, 1:4] = compute_linking(intrinsic4, pose, coords_world, depth,
                                       self.cfg.voxel_size)
        lp = path.replace("color", "label").replace(".jpg", ".png")
        label2d = None
        if os.path.exists(lp):
            with Image.open(lp) as im:
                label2d = np.asarray(
                    im.convert("I").resize(wh, Image.NEAREST), np.int64)
        img = (img - IMAGENET_MEAN) / IMAGENET_STD
        return img, link, label2d

    def forward(self, grid, imgs, links, down_caps):
        """bpnet_forward with gradients off."""
        with torch.no_grad():
            return bpnet_forward(self.params, self.cfg, grid, imgs, links,
                                 down_caps)

    def train_bpnet(self, locs_in: np.ndarray, feats_in: np.ndarray,
                    train_id_paths, image_path, intrinsic4: np.ndarray,
                    device_out: bool = False):
        """Whole-cloud semantic inference for one training step.

        Returns (labels3d (N,), probs3d (N,classes), labels2d (V,h,w)
        argmax maps, point_feat (N,96), gt2d (V,h,w) or None); with
        `device_out` the first, second and fourth are float32/int32 tensors
        on the device (devoxelized there), else numpy arrays."""
        t0 = time.perf_counter()
        dev = self.device
        frames = train_id_paths[0] if isinstance(
            train_id_paths[0], (list, tuple)) else train_id_paths
        if isinstance(image_path, (list, tuple)):
            image_path = image_path[0]
        views = self._select_views(list(frames), image_path)
        rng = np.random.default_rng() if self.cfg.aug else None

        cache = None
        if not self.cfg.aug:
            fp = (locs_in.shape, feats_in.shape,
                  float(locs_in[:: max(1, len(locs_in) // 997)].sum(
                      dtype=np.float64)),
                  float(feats_in[:: max(1, len(feats_in) // 997)].sum(
                      dtype=np.float64)))
            if self._vox_cache is not None and self._vox_cache["fp"] == fp:
                cache = self._vox_cache
        link_pts = cache["link_pts"] if cache is not None else locs_in

        imgs, links, gts = [], [], []
        for vpath in views:
            # links from the original coords (the reference's get_2d runs
            # before prevoxel_transforms); on a cache hit only the voxel
            # representatives are projected
            img, link, gt = self._load_view(vpath, link_pts, intrinsic4,
                                            rng=rng)
            imgs.append(img)
            links.append(link)
            gts.append(gt)
        imgs = np.stack(imgs)                        # (V,h,w,3)
        links = np.stack(links, axis=-1)             # (N or M, 4, V)
        links[:, 0, :] = 0

        if cache is not None:
            grid, inds_rec, down_caps = (cache["grid"], cache["inds_rec"],
                                         cache["down_caps"])
            vlinks = links
        else:
            locs_vox = (prevoxel_distort(locs_in, rng) if self.cfg.aug
                        else locs_in)
            vcoords, vfeats, inds_rec_np, vlinks, first_idx = voxelize(
                locs_vox, feats_in, self.cfg.voxel_size, links,
                return_first=True)
            vfeats = vfeats / 127.5 - 1.0
            dims = tuple(int(d) for d in vcoords.max(0) + 1)
            M = len(vcoords)
            grid = make_sparse_grid(
                torch.as_tensor(vcoords, device=dev),
                torch.as_tensor(np.asarray(vfeats, np.float32), device=dev),
                dims)
            down_caps = (M, M, max(M // 2, 64), max(M // 4, 64))
            inds_rec = torch.as_tensor(inds_rec_np, device=dev)
            if not self.cfg.aug:
                self._vox_cache = {
                    "fp": fp, "grid": grid, "inds_rec": inds_rec,
                    "down_caps": down_caps,
                    "link_pts": np.ascontiguousarray(locs_in[first_idx])}
        t1 = time.perf_counter()

        softmax3d, logits2d, feat3d = self.forward(
            grid, torch.as_tensor(np.asarray(imgs, np.float32), device=dev),
            torch.as_tensor(vlinks, device=dev), down_caps)
        labels2d = logits2d.argmax(-1).cpu().numpy()
        gt2d = np.stack(gts) if all(g is not None for g in gts) else None
        probs = softmax3d[inds_rec]
        point_feat = feat3d[inds_rec]
        labels = probs.argmax(-1).to(torch.int32)
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        self.timings = {"host_s": t1 - t0,
                        "forward_s": time.perf_counter() - t1}
        if device_out:
            return labels, probs, labels2d, point_feat, gt2d
        return (labels.cpu().numpy(), probs.cpu().numpy(), labels2d,
                point_feat.cpu().numpy(), gt2d)
