"""SceneModel: point cloud, grid, parameters, training state, checkpoints
and full-frame rendering.

Counterpart of `sgnerf_tpu/runtime/scene_model.py`: checkpoint resume
(`{iter}_net_ray_marching.{npz,pth}`, resume_iter latest|best|N; an edited
`.pth`'s per-point Rw2c is factored into a part table, `factor_rotations`),
the point bootstrap from the dataset's init points (`setup_from_points`),
the train step (`optimize`, `optimize_multi`), prune and grow with grid
rebuild (growing's probes: runtime/growing.py), checkpoint save and `.pth`
export, and the chunked full-frame render. `--chunk_stack` is accepted and
ignored: the JAX package renders B chunks per `lax.map` body with it, and
here every chunk is its own plain call.

Multi-device (parallel/): `--ray_shards N` splits every batch's and every
render chunk's rays over N devices, the scene replicated; `--scene_shards
N` cuts the scene into N x-slabs (`build_sharded_scene`, rebuilt with the
grid after prune and grow), each render and train step runs over the
slabs, and the slabs' trained attributes are folded back into the cloud
(`_sync_from_spatial`) before anything reads it: save, export, prune, grow,
the growing probes (on the world grid, as in the JAX package) and
SemanticDriver's snapshot; refreshed semantics go to the slabs
(`push_semantics_to_shards`). The devices are --gpu_ids' (options.py
`shard_devices`), the first of them the model's; fewer ids than shards
raise at startup. The slabs' point Adam starts afresh with each slab
build, as the point Adam does after a rebuild; the MLP parameters keep
theirs.

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
                            train_step_multi, trained_fields)
from ..ops.query_pers import perspective_grid, perspective_spec_from_camera
from ..options.options import (configs_from_opt, device_from_opt,
                               shard_counts, shard_devices)
from ..parallel.mesh import ShardGroup
from ..utils import spans
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
        # --ray_shards / --scene_shards (parallel/): the shards' devices
        self.ray_mesh: Optional[ShardGroup] = None
        self.mesh: Optional[ShardGroup] = None
        self.sharded_scene = self.sspec = None
        self._spatial_tstate = None     # made at the first sharded step
        self._pending_spatial_cloud = None
        self._shard_tables = None       # the slabs' eval attribute tables
        self._spatial_dirty = False     # the slabs trained past the cloud
        n_ray, n_scene = shard_counts(opt)
        if n_ray or n_scene:
            group = ShardGroup(shard_devices(opt, n_ray or n_scene))
            if group.master != ShardGroup([self.device]).master:
                raise ValueError(
                    f"the first --gpu_ids entry ({group.master}) is the "
                    f"model's device, given as {self.device}")
            devs = [str(d) for d in group.devices]
            if n_ray:
                self.ray_mesh = group
                print(f"[ray_shards] rays split over {n_ray} shards on "
                      f"{devs} (scene and parameters replicated)")
            else:
                self.mesh = group
                print(f"[scene_shards] the scene cut into {n_scene} x-slabs "
                      f"on {devs}")

    @property
    def params(self):
        return self.state.params

    @property
    def cloud(self) -> NeuralPointCloud:
        """The point cloud, with the slabs' trained attributes folded in."""
        self._sync_from_spatial()
        return self.state.cloud

    @property
    def step(self) -> int:
        return self.state.step

    @property
    def table(self) -> torch.Tensor:
        """The eval renders' packed attribute table of the current cloud."""
        if self._table is None:
            # a plain tensor even inside inference_mode: its copies to other
            # shards' cards are kept while it is unchanged (ShardGroup)
            with torch.inference_mode(False), torch.no_grad():
                self._table = attribute_table(
                    self.cloud, self.cfg.gather_dtype,
                    bool(self.cfg.semantic_guidance))
        return self._table

    def set_semantics(self, label_prob: torch.Tensor, label: torch.Tensor,
                      sem_embedding: torch.Tensor):
        """BPNet's per-point outputs into the cloud (SemanticDriver's
        refresh), and into the slabs under --scene_shards; the cached eval
        tables go with the old ones."""
        set_bpnet_feats(self.cloud, label_prob, label, sem_embedding)
        self._table = None
        self.push_semantics_to_shards()

    # ------------------------------------------------------------ scene shards

    def _setup_spatial(self, cloud: NeuralPointCloud):
        """--scene_shards: cut the cloud into the group's x-slabs and build
        each slab's tables on its device. In perspective mode the halo
        width needs the frustum spec: the build waits for ensure_pspec."""
        if self.mesh is None:
            return
        if self.perspective and self.pspec is None:
            self._pending_spatial_cloud = cloud
            return
        from ..parallel.spatial import (build_sharded_scene,
                                        perspective_halo_voxels)
        # the old slabs go before the new ones are built
        self.sharded_scene = self._spatial_tstate = self._shard_tables = None
        self._spatial_dirty = False
        halo = (perspective_halo_voxels(self.spec, self.pspec)
                if self.perspective else None)
        # plain tensors, trainable, also when a render's ensure_pspec (in
        # inference mode) triggers the build
        with torch.inference_mode(False):
            self.sharded_scene, self.sspec = build_sharded_scene(
                cloud, self.spec, self.mesh.size, devices=self.mesh.devices,
                halo_override=halo, build_tables=not self.perspective)
        rows = [s.nbr_packed.shape[0] for s in self.sharded_scene.shards]
        print(f"[scene_shards] {self.mesh.size} slabs of "
              f"{self.sspec.cap_pts} point rows (of {cloud.capacity})"
              + (f", halo {self.sspec.halo} (perspective)"
                 if self.perspective else
                 f", {rows[0]} cache rows each (of "
                 f"{self.grid.nbr_packed.shape[0]})"))

    def _sync_from_spatial(self):
        """Fold the slabs' trained fields into the cloud (a halo point's
        copies are equal: the halo gradient sync keeps them so)."""
        if not self._spatial_dirty:
            return
        self._spatial_dirty = False
        cloud, master = self.state.cloud, self.mesh.master
        with torch.no_grad():
            for f in trained_fields(self.tcfg):
                dst = getattr(cloud, f)
                for s in self.sharded_scene.shards:
                    n = s.n_rows
                    dst[s.gid[:n].to(master)] = getattr(s.cloud, f)[:n].to(
                        master)
        self._table = None

    def push_semantics_to_shards(self):
        """The cloud's BPNet outputs (label, label_prob, sem_embedding) into
        every slab's rows, halo copies too."""
        if self.sharded_scene is None:
            return
        cloud, master = self.state.cloud, self.mesh.master
        with torch.no_grad():
            for s, dev in zip(self.sharded_scene.shards, self.mesh.devices):
                idx = s.gid[:s.n_rows].to(master)
                for f in ("label", "label_prob", "sem_embedding"):
                    getattr(s.cloud, f)[:s.n_rows] = getattr(
                        cloud, f)[idx].to(dev)
        self._shard_tables = None

    def _spatial_state(self):
        from ..parallel.spatial import create_spatial_train_state
        if self._spatial_tstate is None:
            self._spatial_tstate = create_spatial_train_state(
                self.state.params, self.sharded_scene, self.tcfg,
                opt_net=self.state.opt_net, step=self.state.step)
        return self._spatial_tstate

    def _spatial_tables(self):
        """The slabs' eval attribute tables, built once per change."""
        if self._shard_tables is None:
            with torch.inference_mode(False), torch.no_grad():
                self._shard_tables = [attribute_table(
                    s.cloud, self.cfg.gather_dtype,
                    bool(self.cfg.semantic_guidance))
                    for s in self.sharded_scene.shards]
        return self._shard_tables

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
        self._setup_spatial(cloud)

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
        if self._pending_spatial_cloud is not None:
            # --scene_shards waited for the frustum spec (the halo width)
            cloud, self._pending_spatial_cloud = \
                self._pending_spatial_cloud, None
            self._setup_spatial(cloud)

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
        return self.optimize_multi([batch])[0]

    def optimize_multi(self, batches: List[Dict]) -> List[Dict]:
        """G train steps in a row; returns the per-step loss dicts."""
        pspec = self._pspec_for_step()
        if self.sharded_scene is not None:
            from ..parallel.spatial import spatial_train_step_multi
            st, losses = spatial_train_step_multi(
                self._spatial_state(), self.sspec, self.cfg, self.tcfg,
                batches, generator=self._generator(), pspec=pspec)
            self.state.step = st.step
            self._spatial_dirty = True
            self._shard_tables = None
        else:
            self.state, losses = train_step_multi(
                self.state, self.grid, self.cfg, self.tcfg, batches,
                generator=self._generator(), pspec=pspec,
                ray_mesh=self.ray_mesh)
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
        self._setup_spatial(cloud)

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
        transmission: colour + bgT * (bg_image - bg_color). Under
        --ray_shards each chunk's rays are split over the shards; under
        --scene_shards each chunk renders over the slabs. While a
        profiler records, the frame records the span `sgnerf.frame` with
        its upload, chunks and readback (utils/spans.py)."""
        dev = self.device
        with spans.frame(dev):
            self.ensure_pspec(item)
            with spans.span("sgnerf.frame.upload", dev):
                raydir = torch.as_tensor(
                    np.asarray(item["raydir"], np.float32), device=dev)
                R = raydir.shape[0]
                pad = (-R) % chunk_rays
                if pad:
                    raydir = torch.cat([raydir, raydir.new_zeros((pad, 3))])
                campos = torch.as_tensor(
                    np.asarray(item["campos"], np.float32), device=dev)[None]
                rot = torch.as_tensor(
                    np.asarray(item["camrotc2w"], np.float32),
                    device=dev)[None]
                bg = torch.as_tensor(np.asarray(item["bg_color"], np.float32),
                                     device=dev)
            near, far = float(item["near"]), float(item["far"])
            render = self._chunk_renderer(campos, rot, near, far, bg)
            cols, bgts = [], []
            for s in range(0, raydir.shape[0], chunk_rays):
                out = render(raydir[None, s:s + chunk_rays])
                cols.append(out["coarse_raycolor"][0])
                bgts.append(out["coarse_is_background"][0])
            with spans.span("sgnerf.frame.readback", dev):
                col = torch.cat(cols)[:R]
                if bg_image is not None:
                    bgt = torch.cat(bgts)[:R]
                    col = col + bgt * (torch.tensor(
                        np.asarray(bg_image, np.float32),
                        device=dev).reshape(-1, 3) - bg)
                col = col.cpu().numpy()
                spans.settle()
        return col

    def _chunk_renderer(self, campos, rot, near, far, bg):
        """A frame's chunk render, raydir (1,Rc,3) -> render output, for the
        model's mode; what every chunk shares (the eval tables, the frame
        grids of the perspective path) is built once here."""
        cam = dict(campos=campos, camrotc2w=rot, near=near, far=far,
                   bg_color=bg)
        if self.sharded_scene is not None:
            from ..parallel.spatial import (frame_grids, render_rays_spatial,
                                            render_rays_spatial_perspective)
            cam["tables"] = self._spatial_tables()
            if self.perspective:
                pgrids = frame_grids(self.sharded_scene, self.pspec, campos,
                                     rot)
                return lambda rd: render_rays_spatial_perspective(
                    self.params, self.sharded_scene, self.sspec, self.pspec,
                    self.cfg, raydir=rd, pgrids=pgrids, **cam)
            return lambda rd: render_rays_spatial(
                self.params, self.sharded_scene, self.sspec, self.cfg,
                raydir=rd, **cam)
        cam["table"] = self.table
        if self.perspective:
            # the frame's perspective grid, once for all its chunks
            with torch.inference_mode(False), torch.no_grad():
                cam["pgrid"] = perspective_grid(
                    self.cloud.xyz, self.cloud.active, rot[0].clone(),
                    campos[0].clone(), self.pspec)[0]
        if self.ray_mesh is not None:
            from ..parallel.sharded import render_rays_sharded
            return lambda rd: render_rays_sharded(
                self.params, self.cloud, self.grid, self.cfg, self.ray_mesh,
                raydir=rd, pspec=self.pspec if self.perspective else None,
                **cam)
        if self.perspective:
            return lambda rd: render_rays_perspective(
                self.params, self.cloud, self.pspec, self.cfg, raydir=rd,
                **cam)
        return lambda rd: render_rays(self.params, self.cloud, self.grid,
                                      self.cfg, raydir=rd, **cam)
