"""SceneModel: point cloud, grid, parameters, training state, checkpoints
and full-frame rendering.

Counterpart of `sgnerf_tpu/runtime/scene_model.py` for one device:
checkpoint resume (`{iter}_net_ray_marching.{npz,pth}`, resume_iter
latest|best|N), the point bootstrap from the dataset's init points
(`setup_from_points`), the train step (`optimize`, `optimize_multi`),
prune and grow with grid rebuild (growing's probes: runtime/growing.py),
checkpoint save and `.pth` export, and the chunked full-frame render. The
sharded paths come with later slices.

The device is `device` when given, else `--gpu_ids` (options.py
`device_from_opt`); nothing probes the machine, so a CUDA run on a machine
without a card fails at its first allocation.
"""
from __future__ import annotations

import glob
import os
import re
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.aggregator import init_aggregator_params
from ..models.checkpoint_io import (convert_reference_checkpoint,
                                    export_reference_checkpoint, load_native,
                                    load_reference_states,
                                    load_torch_state_dict, save_native,
                                    unpack_embedding_modes)
from ..models.params import params_from_jax, params_to_jax
from ..models.point_cloud import (NeuralPointCloud, build_grid,
                                  grid_spec_for_cloud, grow as grow_cloud,
                                  make_point_cloud, prune as prune_cloud)
from ..models.renderer import attribute_table, render_rays
from ..models.train import (TrainState, adam_init, create_train_state,
                            train_step, train_step_multi, trained_fields)
from ..options.options import configs_from_opt, device_from_opt
from .native import nearest_view, vox_downsample_closest


def get_latest_epoch(ckpt_dir: str) -> Optional[int]:
    iters = []
    for f in glob.glob(os.path.join(ckpt_dir, "*_net_ray_marching.*")):
        m = re.match(r"(\d+)_net_ray_marching", os.path.basename(f))
        if m:
            iters.append(int(m.group(1)))
    return max(iters) if iters else None


def batch_to_device(item: Dict, device) -> Dict[str, torch.Tensor]:
    """A dataset item -> the train step's batch (B = 1) on `device`."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)
    b = {"campos": t(item["campos"])[None], "raydir": t(item["raydir"])[None],
         "camrotc2w": t(item["camrotc2w"])[None],
         "near": float(item["near"]), "far": float(item["far"]),
         "bg_color": t(item["bg_color"]), "gt_image": t(item["gt_image"])[None]}
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
                self._table = attribute_table(self.cloud,
                                              self.cfg.gather_dtype)
        return self._table

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
            if pts["Rw2c"] is not None and np.asarray(pts["Rw2c"]).ndim == 3:
                raise NotImplementedError(
                    "per-point Rw2c (edited scenes) is not ported yet "
                    "(ROADMAP.md, queue 1 item 16)")
            cloud = make_point_cloud(
                pts["xyz"], pts["embedding"], conf=pts["conf"],
                dir=pts["dir"], color=pts["color"], feats=pts["feats"],
                label=pts["label"], Rw2c=pts["Rw2c"],
                capacity=self._capacity_for(len(pts["xyz"])),
                device=self.device)
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

    # ---------------------------------------------------------------- training

    def _generator(self) -> torch.Generator:
        if self.generator is None:
            self.generator = torch.Generator(device=self.device)
            self.generator.manual_seed(0)
        return self.generator

    def optimize(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """One train step on a batch (batch_to_device), its render noise
        drawn from the model's generator. Returns the losses as device
        scalars (not synchronised)."""
        self.state, losses = train_step(
            self.state, self.grid, self.cfg, self.tcfg, batch,
            generator=self._generator())
        self._table = None
        return losses

    def optimize_multi(self, batches: List[Dict]) -> List[Dict]:
        """G train steps in a row; returns the per-step loss dicts."""
        self.state, losses = train_step_multi(
            self.state, self.grid, self.cfg, self.tcfg, batches,
            generator=self._generator())
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
    def render_image(self, item: Dict, chunk_rays: int = 9216) -> np.ndarray:
        """Chunked full-frame render -> (R, 3) colours of item["raydir"]:
        a plain loop over chunks of `chunk_rays` rays (the last one padded).
        The reference's attr_dedup overflow re-render has nothing to do
        here: the plain attribute gather has no distinct-id cap."""
        dev = self.device
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
        cols = []
        for s in range(0, raydir.shape[0], chunk_rays):
            out = render_rays(self.params, self.cloud, self.grid, self.cfg,
                              campos=campos,
                              raydir=raydir[None, s:s + chunk_rays],
                              camrotc2w=rot, near=near, far=far,
                              bg_color=bg, table=table)
            cols.append(out["coarse_raycolor"][0])
        return torch.cat(cols)[:R].cpu().numpy()
