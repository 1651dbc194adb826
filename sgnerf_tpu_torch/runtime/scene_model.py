"""SceneModel for the eval render: checkpoint resume, grid build and chunked
full-frame rendering.

Counterpart of the eval half of `sgnerf_tpu/runtime/scene_model.py`
(`__init__`, `resolve_resume`, `load_checkpoint`, `render_image`). Training,
growing and the sharded paths come with later slices.
"""
from __future__ import annotations

import glob
import os
import re
from typing import Dict, Optional

import numpy as np
import torch

from sgnerf_tpu.models.checkpoint_io import (convert_reference_checkpoint,
                                             load_native, load_reference_states,
                                             load_torch_state_dict,
                                             unpack_embedding_modes)

from ..models.aggregator import init_aggregator_params
from ..models.params import params_from_jax
from ..models.point_cloud import (NeuralPointCloud, build_grid,
                                  grid_spec_for_cloud, make_point_cloud)
from ..models.renderer import attribute_table, render_rays
from ..options.options import configs_from_opt


def get_latest_epoch(ckpt_dir: str) -> Optional[int]:
    iters = []
    for f in glob.glob(os.path.join(ckpt_dir, "*_net_ray_marching.*")):
        m = re.match(r"(\d+)_net_ray_marching", os.path.basename(f))
        if m:
            iters.append(int(m.group(1)))
    return max(iters) if iters else None


class SceneModel:
    def __init__(self, opt, device: Optional[torch.device] = None):
        self.opt = opt
        self.cfg, self.grid_kwargs = configs_from_opt(opt)
        self.device = torch.device(device or (
            "cuda" if torch.cuda.is_available() else "cpu"))
        self.expr_dir = os.path.join(opt.checkpoints_dir, opt.name or "default")
        os.makedirs(self.expr_dir, exist_ok=True)
        self.params = self.cloud = self.grid = self.spec = self.table = None
        self.step = 0
        self.best_psnr = 0.0
        self.best_iter = 0

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
                it_num = it
            for ext in (".npz", ".pth"):
                p = os.path.join(d, f"{it_num}_net_ray_marching{ext}")
                if os.path.exists(p):
                    return p
        return None

    def load_checkpoint(self, path: str):
        """Native .npz (checkpoint_io.save_native) or reference .pth."""
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
                dir=pts["dir"], color=pts["color"], capacity=self._capacity_for(
                    len(pts["xyz"])), device=self.device)
            if pts["Rw2c"] is not None:
                cloud.Rw2c = torch.as_tensor(
                    np.asarray(pts["Rw2c"], np.float32), device=self.device)
        else:
            tree, meta = load_native(path)
            params = tree["params"]
            cloud = NeuralPointCloud.from_arrays(tree["cloud"], self.device)
            if meta:
                self.best_psnr = meta.get("best_psnr", 0.0)
                self.best_iter = meta.get("best_iter", 0)
        self._finish_setup(params, cloud)
        it = re.match(r"(\d+|best)_", os.path.basename(path))
        self.step = (self.best_iter if (it and it.group(1) == "best")
                     else int(it.group(1)) if it else 0)
        print(f"loaded checkpoint {path} (step {self.step}, "
              f"{int(self.cloud.n_active)} points)")

    def _capacity_for(self, n: int) -> int:
        # the reference's headroom for growing, rounded for stable shapes
        cap = int(n * 1.3) + 1024
        return (cap + 1023) // 1024 * 1024

    def _finish_setup(self, params, cloud: NeuralPointCloud):
        self.spec = grid_spec_for_cloud(cloud, **self.grid_kwargs)
        self.grid = build_grid(cloud, self.spec)
        if params is None or "block1" not in params:
            self.params = init_aggregator_params(0, self.cfg.agg, self.device)
        else:
            self.params = params_from_jax(params, self.device)
        self.cloud = cloud
        self.table = attribute_table(cloud, self.cfg.gather_dtype)

    # --------------------------------------------------------------- rendering

    @torch.inference_mode()
    def render_image(self, item: Dict, chunk_rays: int = 9216) -> np.ndarray:
        """Chunked full-frame render -> (R, 3) colours of item["raydir"].

        A plain loop over chunks of `chunk_rays` rays (the last chunk is
        padded). The reference's attr_dedup overflow re-render has nothing
        to do here: the plain attribute gather has no distinct-id cap."""
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
        cols = []
        for s in range(0, raydir.shape[0], chunk_rays):
            out = render_rays(self.params, self.cloud, self.grid, self.cfg,
                              campos=campos,
                              raydir=raydir[None, s:s + chunk_rays],
                              camrotc2w=rot, near=near, far=far,
                              bg_color=bg, table=self.table)
            cols.append(out["coarse_raycolor"][0])
        return torch.cat(cols)[:R].cpu().numpy()
