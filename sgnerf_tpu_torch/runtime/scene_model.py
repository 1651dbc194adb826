"""SceneModel: point cloud, grid, parameters, training state, checkpoints
and full-frame rendering.

Counterpart of `sgnerf_tpu/runtime/scene_model.py` for one device:
checkpoint resume (`{iter}_net_ray_marching.{npz,pth}`, resume_iter
latest|best|N; an edited `.pth`'s per-point Rw2c is factored into a part
table, `factor_rotations`), the point bootstrap from the dataset's init points
(`setup_from_points`), the train step (`optimize`, `optimize_multi`),
prune and grow with grid rebuild (growing's probes: runtime/growing.py),
checkpoint save and `.pth` export, and the chunked full-frame render. The
sharded paths come with later slices. `--chunk_stack` is accepted and
ignored: the JAX package renders B chunks per `lax.map` body with it, and
here every chunk is its own plain call.

`--wcoord_query 0` (the flag's default) is Point-NeRF's perspective-space
query: the train step and the render build each frame's grid in camera
perspective space on a static frustum spec, made once from the first
item's intrinsics (`ensure_pspec`). The world grid is built all the same:
growing's probes query it, as in the JAX package.

The device is `device` when given, else `--gpu_ids` (options.py
`device_from_opt`); nothing probes the machine, so a CUDA run on a machine
without a card fails at its first allocation.
"""
from __future__ import annotations

import dataclasses
import glob
import math
import os
import re
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.aggregator import init_aggregator_params
from ..models.checkpoint_io import (convert_reference_checkpoint,
                                    export_reference_checkpoint, load_native,
                                    load_reference_states,
                                    load_semantic_embedding,
                                    load_torch_state_dict, save_native,
                                    save_semantic_embedding,
                                    unpack_embedding_modes)
from ..models.params import params_from_jax, params_to_jax
from ..models.point_cloud import (NeuralPointCloud, build_grid,
                                  grid_spec_for_cloud, grow as grow_cloud,
                                  make_point_cloud, prune as prune_cloud,
                                  set_bpnet_feats)
from ..models.renderer import (attribute_table, render_rays,
                               render_rays_perspective)
from ..models.train import (TrainState, adam_init, create_train_state,
                            train_step, train_step_multi, trained_fields)
from ..ops.query_pers import perspective_grid, perspective_spec_from_camera
from ..options.options import configs_from_opt, device_from_opt
from .native import nearest_view, vox_downsample_closest


def get_latest_epoch(ckpt_dir: str) -> Optional[int]:
    iters = []
    for f in glob.glob(os.path.join(ckpt_dir, "*_net_ray_marching.*")):
        m = re.match(r"(\d+)_net_ray_marching", os.path.basename(f))
        if m:
            iters.append(int(m.group(1)))
    return max(iters) if iters else None


def factor_rotations(rw2c):
    """An edited .pth's dense per-point Rw2c (N,3,3) (reference
    neural_points.py:650) -> (the part table (T,3,3), each point's row
    (N,) int32): rows equal to 6 decimals are one part, each part's first
    point gives its row. A (3,3) or missing Rw2c passes through, with no
    index."""
    if rw2c is None or np.asarray(rw2c).ndim != 3:
        return rw2c, None
    rw2c = np.asarray(rw2c, np.float32)
    _, first, inv = np.unique(np.round(rw2c.reshape(len(rw2c), -1), 6),
                              axis=0, return_index=True, return_inverse=True)
    # numpy 2.0 returned the inverse as (N,1) for axis=0
    return rw2c[first], inv.reshape(-1).astype(np.int32)


def batch_to_device(item: Dict, device) -> Dict[str, torch.Tensor]:
    """A dataset item -> the train step's batch (B = 1) on `device`."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)
    b = {"campos": t(item["campos"])[None], "raydir": t(item["raydir"])[None],
         "camrotc2w": t(item["camrotc2w"])[None],
         "near": float(item["near"]), "far": float(item["far"]),
         "bg_color": t(item["bg_color"]), "gt_image": t(item["gt_image"])[None]}
    if "bg_ray" in item:         # --bgmodel plane: the per-ray background
        b["bg_ray"] = t(item["bg_ray"])[None]
    if "pixel_label" in item:
        b["pixel_label"] = torch.as_tensor(
            np.asarray(item["pixel_label"], np.int32), device=device)[None]
    if "gt_depth" in item:
        b["gt_depth"] = t(item["gt_depth"])[None]
        b["gt_mask"] = t(item["gt_mask"])[None]
        b["ray_depth_mask"] = (b["gt_depth"] > 0).to(torch.float32)
    return b


class SceneModel:
    def __init__(self, opt, device=None):
        self.opt = opt
        self.device = (torch.device(device) if device is not None
                       else device_from_opt(opt))
        self.cfg, self.tcfg, self.grid_kwargs = configs_from_opt(
            opt, self.device)
        self.expr_dir = os.path.join(opt.checkpoints_dir, opt.name or "default")
        os.makedirs(self.expr_dir, exist_ok=True)
        self.state: Optional[TrainState] = None
        self.grid = self.spec = None
        self._table = None
        self.best_psnr = 0.0
        self.best_iter = 0
        self.generator = None       # render noise of the train step
        self.perspective = int(getattr(opt, "wcoord_query", 1)) == 0
        self.pspec = None           # the frustum spec, built by ensure_pspec
        if self.perspective:
            print("[scene_model] wcoord_query=0: per-frame perspective-space "
                  "querier (reference query_point_indices.py); growing "
                  "probes still use the world grid")

    @property
    def params(self):
        return self.state.params

    @property
    def cloud(self) -> NeuralPointCloud:
        return self.state.cloud

    @property
    def step(self) -> int:
        return self.state.step

    @property
    def table(self) -> torch.Tensor:
        """The eval renders' packed attribute table of the current cloud."""
        if self._table is None:
            with torch.no_grad():
                self._table = attribute_table(
                    self.cloud, self.cfg.gather_dtype,
                    bool(self.cfg.semantic_guidance))
        return self._table

    def set_semantics(self, label_prob: torch.Tensor, label: torch.Tensor,
                      sem_embedding: torch.Tensor):
        """BPNet's per-point outputs into the cloud (SemanticDriver's
        refresh); the cached eval table goes with the old ones."""
        set_bpnet_feats(self.cloud, label_prob, label, sem_embedding)
        self._table = None

    # ------------------------------------------------------------- checkpoints

    def resolve_resume(self) -> Optional[str]:
        it = self.opt.resume_iter
        search_dirs = [self.expr_dir]
        if self.opt.resume_dir:
            search_dirs.insert(0, self.opt.resume_dir)
        for d in search_dirs:
            if it == "latest":
                it_num = get_latest_epoch(d)
                if it_num is None:
                    continue
            else:
                it_num = it          # a step number or "best"
            for ext in (".npz", ".pth"):
                p = os.path.join(d, f"{it_num}_net_ray_marching{ext}")
                if os.path.exists(p):
                    return p
        return None

    def load_checkpoint(self, path: str):
        """Native .npz (save_checkpoint, either package) or reference .pth."""
        if path.endswith(".pth"):
            params, pts = convert_reference_checkpoint(
                load_torch_state_dict(path))
            pts = unpack_embedding_modes(
                pts, str(self.opt.point_conf_mode),
                str(self.opt.point_dir_mode), str(self.opt.point_color_mode),
                self.opt.point_features_dim)
            states = path.replace("_net_ray_marching.pth", "_states.pth")
            if os.path.exists(states):
                st = load_reference_states(states)
                self.best_psnr = float(st.get("best_PSNR", 0.0) or 0.0)
                self.best_iter = int(st.get("best_iter", 0) or 0)
            rw2c, rot_idx = factor_rotations(pts["Rw2c"])
            cloud = make_point_cloud(
                pts["xyz"], pts["embedding"], conf=pts["conf"],
                dir=pts["dir"], color=pts["color"], feats=pts["feats"],
                label=pts["label"], Rw2c=rw2c, rot_idx=rot_idx,
                capacity=self._capacity_for(len(pts["xyz"])),
                device=self.device)
            # the companion BPNet embedding, when one was saved
            sem_path = path.replace("_net_ray_marching.pth",
                                    "_semanticEmbedding.pth")
            if os.path.exists(sem_path):
                sem = load_semantic_embedding(sem_path)
                cloud.sem_embedding[:len(sem)] = torch.as_tensor(
                    sem, device=self.device)
        else:
            tree, meta = load_native(path)
            params = tree["params"]
            cloud = NeuralPointCloud.from_arrays(tree["cloud"], self.device)
            if meta:
                self.best_psnr = meta.get("best_psnr", 0.0)
                self.best_iter = meta.get("best_iter", 0)
        self._finish_setup(params, cloud)
        it = re.match(r"(\d+|best)_", os.path.basename(path))
        self.state.step = (self.best_iter if (it and it.group(1) == "best")
                           else int(it.group(1)) if it else 0)
        print(f"loaded checkpoint {path} (step {self.step}, "
              f"{int(self.cloud.n_active)} points)")

    def save_checkpoint(self, it, best: bool = False):
        tag = "best" if best else str(it)
        tree = {"params": params_to_jax(self.params),
                "cloud": self.cloud.to_arrays()}
        meta = {"iter": int(it), "best_psnr": float(self.best_psnr),
                "best_iter": int(self.best_iter)}
        save_native(os.path.join(
            self.expr_dir, f"{tag}_net_ray_marching.npz"), tree, meta)

    def export_reference(self, it):
        """Also write a reference-format .pth (+ {it}_states.pth)."""
        c = self.cloud.to_arrays()
        act = c["active"]
        pts = {k: c[k][act] for k in ("xyz", "embedding", "conf", "dir",
                                      "color", "feats")}
        pts["Rw2c"] = c["Rw2c"]
        if pts["Rw2c"].ndim == 3:      # expand the part table per point
            pts["Rw2c"] = pts["Rw2c"][c["rot_idx"][act]]
        export_reference_checkpoint(
            params_to_jax(self.params), pts,
            os.path.join(self.expr_dir, f"{it}_net_ray_marching.pth"))
        # the companion BPNet point embedding (reference
        # saveSemanticEmbedding), when a refresh wrote one
        save_semantic_embedding(
            c["sem_embedding"][act],
            os.path.join(self.expr_dir, f"{it}_semanticEmbedding.pth"))
        torch.save({"best_PSNR": float(self.best_psnr),
                    "best_iter": int(self.best_iter),
                    "epoch_count": 0, "total_steps": int(it)},
                   os.path.join(self.expr_dir, f"{it}_states.pth"))

    # ---------------------------------------------------------------- creation

    def _capacity_for(self, n: int) -> int:
        # headroom for growing, rounded for stable shapes
        cap = int(n * 1.3) + 1024
        return (cap + 1023) // 1024 * 1024

    def _finish_setup(self, params, cloud: NeuralPointCloud):
        self.spec = grid_spec_for_cloud(cloud, **self.grid_kwargs)
        self.grid = build_grid(cloud, self.spec)
        if params is None or "block1" not in params:
            params = init_aggregator_params(0, self.cfg.agg, self.device)
        else:
            params = params_from_jax(params, self.device)
        self.state = create_train_state(params, cloud, self.tcfg)
        self._table = None

    def setup_from_points(self, xyz: np.ndarray, feats: Optional[np.ndarray],
                          labels: Optional[np.ndarray], dataset=None):
        """Bootstrap from the dataset's init points (reference
        run/train_ft.py:650-800): voxel downsampling, random embeddings
        (feature_init_method=rand), colours from the raw RGB, unit conf,
        each point's direction to its most head-on camera."""
        opt = self.opt
        if opt.vox_res > 0:
            keep = vox_downsample_closest(xyz, opt.vox_res)
            xyz = xyz[keep]
            feats = feats[keep] if feats is not None else None
            labels = labels[keep] if labels is not None else None
            print(f"after voxelize: {len(xyz)} points")
        n = len(xyz)
        rng = np.random.default_rng(0)
        embedding = rng.uniform(-0.5, 0.5, size=(n, opt.point_features_dim)
                                ).astype(np.float32)
        color = (np.asarray(feats, np.float32) / 255.0 if feats is not None
                 else np.zeros((n, 3), np.float32))
        conf = np.ones((n, 1), np.float32)
        if dataset is not None:
            campos, camdir = dataset.get_campos_ray()
            d = campos[nearest_view(campos, camdir, xyz)] - xyz
            dirs = d / (np.linalg.norm(d, axis=-1, keepdims=True) + 1e-6)
        else:
            dirs = np.zeros((n, 3), np.float32)
        if 0 < opt.default_conf < 1.0:
            conf = conf * opt.default_conf
        cloud = make_point_cloud(
            xyz, embedding, conf=conf, dir=dirs, color=color, feats=feats,
            label=labels, capacity=self._capacity_for(n), device=self.device)
        self._finish_setup(None, cloud)
        print(f"scene set up with {n} points (capacity {cloud.capacity})")

    # ------------------------------------------------------- perspective query

    def ensure_pspec(self, item: Dict):
        """In perspective mode, build the static frustum GridSpec once, from
        the item's camera (the reference derives the same bounds each frame,
        get_hyperparameters in query_point_indices.py); a no-op otherwise.
        max_o 0 or unset: every occupied frustum voxel can hold a point."""
        if not self.perspective or self.pspec is not None:
            return
        opt = self.opt
        W, H = int(opt.img_wh[0]), int(opt.img_wh[1])
        n_act = (int(self.cloud.n_active) if self.state is not None
                 else 1_000_000)
        intr = np.asarray(item["intrinsic"], np.float32)[:3, :3]
        max_o = int(opt.max_o) if opt.max_o else 0
        P = int(opt.P) if opt.P else 16
        spec = perspective_spec_from_camera(
            intr, W, H, float(item["near"]), float(item["far"]),
            self.grid_kwargs["vsize"], self.grid_kwargs["vscale"],
            self.grid_kwargs["kernel_size"], max_o or 1, P)
        if not max_o:
            n_vox = math.prod(spec.vdim)
            spec = dataclasses.replace(
                spec, max_o=int(max(1024, min(n_vox, n_act))))
        self.pspec = spec
        print(f"[scene_model] perspective frustum grid: vdim={spec.vdim} "
              f"max_o={spec.max_o} P={spec.P}")

    # ---------------------------------------------------------------- training

    def _generator(self) -> torch.Generator:
        if self.generator is None:
            self.generator = torch.Generator(device=self.device)
            self.generator.manual_seed(0)
        return self.generator

    def _pspec_for_step(self):
        if self.perspective and self.pspec is None:
            raise RuntimeError("perspective mode (--wcoord_query 0): call "
                               "ensure_pspec(item) before optimize()")
        return self.pspec

    def optimize(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """One train step on a batch (batch_to_device), its render noise
        drawn from the model's generator. Returns the losses as device
        scalars (not synchronised). In perspective mode, ensure_pspec must
        have run."""
        self.state, losses = train_step(
            self.state, self.grid, self.cfg, self.tcfg, batch,
            generator=self._generator(), pspec=self._pspec_for_step())
        self._table = None
        return losses

    def optimize_multi(self, batches: List[Dict]) -> List[Dict]:
        """G train steps in a row; returns the per-step loss dicts."""
        self.state, losses = train_step_multi(
            self.state, self.grid, self.cfg, self.tcfg, batches,
            generator=self._generator(), pspec=self._pspec_for_step())
        self._table = None
        return losses

    def prune_points(self, thresh: float):
        cloud = prune_cloud(self.cloud, thresh)
        print(f"prune: {int(self.cloud.n_active)} -> "
              f"{int(cloud.n_active)} points")
        self._rebuild(cloud)

    def grow_points(self, new_xyz, new_embedding, new_conf, new_color,
                    new_dir):
        """Add host arrays of new points into the cloud's free slots. When
        they do not fit, the live rows are first re-allocated on the host
        at _capacity_for(n_active + G), every per-point field carried (the
        JAX re-allocation keeps only the five grown ones). Then rebuild the
        grid."""
        cloud = self.cloud
        need = int(cloud.n_active) + len(new_xyz)
        if need > cloud.capacity:
            old = cloud.to_arrays()
            act = old.pop("active")
            live = {f: a[act] for f, a in old.items()
                    if f not in ("n_active", "Rw2c")}
            cloud = make_point_cloud(
                Rw2c=old["Rw2c"], num_classes=old["label_prob"].shape[1],
                sem_dim=old["sem_embedding"].shape[1],
                capacity=self._capacity_for(need), device=self.device,
                **live)
        cloud = grow_cloud(cloud, new_xyz, new_embedding, new_conf,
                           new_color, new_dir)
        print(f"grow: +{len(new_xyz)} -> {int(cloud.n_active)} points")
        self._rebuild(cloud)

    def _rebuild(self, cloud: NeuralPointCloud):
        """Swap the cloud and rebuild the grid; MLP params, their optimizer
        state and the step stay, the point optimizer restarts (the point
        set changed)."""
        self._refit_spec(cloud)
        self.grid = None       # free the old grid before building the new
        self.grid = build_grid(cloud, self.spec)
        self.state.cloud = cloud
        self.state.opt_pts = adam_init([getattr(cloud, f)
                                        for f in trained_fields(self.tcfg)])
        self._table = None

    def _refit_spec(self, cloud: NeuralPointCloud):
        """After a topology change, recompute the grid spec only when its
        auto-sized caps no longer fit the cloud."""
        if self.opt.max_o and self.opt.P:
            return        # user-pinned caps: reference truncation semantics
        from ..ops.grid import auto_grid_caps
        act = cloud.active.cpu().numpy()
        xyz = cloud.xyz.detach().cpu().numpy()[act]
        need_o, need_p = auto_grid_caps(
            xyz, self.spec.min_corner, self.spec.vsize, self.spec.vdim)
        if ((not self.opt.max_o and need_o > self.spec.max_o)
                or (not self.opt.P and need_p > self.spec.P)):
            old = (self.spec.max_o, self.spec.P)
            self.spec = grid_spec_for_cloud(cloud, **self.grid_kwargs)
            print(f"[grid] auto caps re-fit after topology change: "
                  f"(max_o,P) {old} -> ({self.spec.max_o}, {self.spec.P})")

    # --------------------------------------------------------------- rendering

    @torch.inference_mode()
    def render_image(self, item: Dict, chunk_rays: int = 9216,
                     bg_image=None) -> np.ndarray:
        """Chunked full-frame render -> (R, 3) colours of item["raydir"]:
        a plain loop over chunks of `chunk_rays` rays (the last one padded).
        The reference's attr_dedup overflow re-render has nothing to do
        here: the plain attribute gather has no distinct-id cap. With
        `bg_image` (R,3), the per-ray plane background of --bgmodel plane
        replaces the constant one through each ray's background
        transmission: colour + bgT * (bg_image - bg_color)."""
        dev = self.device
        self.ensure_pspec(item)
        raydir = torch.as_tensor(np.asarray(item["raydir"], np.float32),
                                 device=dev)
        R = raydir.shape[0]
        pad = (-R) % chunk_rays
        if pad:
            raydir = torch.cat([raydir, raydir.new_zeros((pad, 3))])
        campos = torch.as_tensor(np.asarray(item["campos"], np.float32),
                                 device=dev)[None]
        rot = torch.as_tensor(np.asarray(item["camrotc2w"], np.float32),
                              device=dev)[None]
        bg = torch.as_tensor(np.asarray(item["bg_color"], np.float32),
                             device=dev)
        near, far = float(item["near"]), float(item["far"])
        table = self.table
        cols, bgts = [], []
        cam = dict(campos=campos, camrotc2w=rot, near=near, far=far,
                   bg_color=bg, table=table)
        if self.perspective:
            # the frame's perspective grid, once for all its chunks
            cam["pgrid"] = perspective_grid(self.cloud.xyz, self.cloud.active,
                                            rot[0], campos[0], self.pspec)[0]
        for s in range(0, raydir.shape[0], chunk_rays):
            rd = raydir[None, s:s + chunk_rays]
            if self.perspective:
                out = render_rays_perspective(self.params, self.cloud,
                                              self.pspec, self.cfg, raydir=rd,
                                              **cam)
            else:
                out = render_rays(self.params, self.cloud, self.grid,
                                  self.cfg, raydir=rd, **cam)
            cols.append(out["coarse_raycolor"][0])
            bgts.append(out["coarse_is_background"][0])
        col = torch.cat(cols)[:R]
        if bg_image is not None:
            bgt = torch.cat(bgts)[:R]
            col = col + bgt * (torch.tensor(
                np.asarray(bg_image, np.float32), device=dev).reshape(-1, 3)
                - bg)
        return col.cpu().numpy()
