#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (sgnerf_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port's main paths once through the entry points a user calls,
at full width, on a synthetic 4.2M-point room scan (the scene bench.py
renders, sgnerf_tpu_torch/data/synthetic.py) with seeded random weights
saved as a native checkpoint and loaded back through
SceneModel.load_checkpoint: the eval render of the default viewmlp config
(the flags of dev_scripts/myexp_scannet_colmap/test_default.sh) and the
fine-tune train step (the flags of scene0113_00_default.sh). Phases:

  1. card name and power limit, torch and CUDA versions;
  2. build every CUDA kernel from csrc/, one nvcc per source in parallel;
  3. scene: cloud, checkpoint round trip, grid build (seconds printed);
  4. one 640x480 frame through SceneModel.render_image with every kernel
     launch counter reset just before: K1 and K2 must have launched, the
     image must be finite and most rays must find neighbours; then 512
     rays rendered with the kernel path and the un-fused path must agree;
  5. K1 and K2 against their plain versions on the inputs captured from
     one chunk of that frame (K1 ids equal; K2 within tolerance in f32
     and bf16), timed with CUDA events;
  6. the train step at full width (1024 random rays of the phase-4 camera,
     seeded target colours): 8 SceneModel.optimize steps with the counters
     reset just before; K2 and K3 must launch once a step, K1 never (f32
     cache: exact top-k), the loss must be finite and fall. Then one step's
     losses and gradients with the kernels and with the un-fused plain path,
     from the same state and noise, must agree;
  7. K3 against its plain version on the arguments and cotangent captured
     from phase 6's first step, in f32 and bf16, timed with CUDA events;
  8. the training CLI, sgnerf_tpu_torch.run.train_ft.main, on a synthetic
     ScanNet export written under build/ (640x480 views inside the room,
     the room scan as the resumed checkpoint): 10 steps, then the
     checkpoints and the test PSNR line.

Any failure raises and the script exits non-zero before its last line.
The last line is {"ok": true, "device": {...}}; the line before it holds
the per-kernel JSON record. Without a CUDA device it exits non-zero at once.
"""
import contextlib
import dataclasses
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
N_POINTS = 4_200_000
W_IMG, H_IMG, FOCAL = 640, 480, 580.0
# K2 tolerance vs its plain version on the card: the kernel sums the
# 284-term first layer in another order than cuBLAS (f32, no TF32); in bf16
# a one-ulp difference before the cast can flip an input's bf16 rounding
K2_TOL = {False: dict(atol=1e-4, rtol=1e-4), True: dict(atol=2e-2, rtol=1e-2)}
# render of 512 rays, kernel path vs un-fused path, f32 compute
RENDER_ATOL = 1e-4
# K3 vs its plain version, per output tensor, relative to the plain
# tensor's largest magnitude: summation order (f32); a flipped bf16
# rounding of a product input (bf16)
K3_TOL = {False: 2e-3, True: 3e-2}
# train step, kernel path vs un-fused path from the same state and noise
LOSS_RTOL = 1e-5
TRAIN_STEPS = 8
# the card's peaks (NVIDIA H100 SXM data sheet): HBM bytes/s, FP32 FLOP/s
# outside the tensor cores
HBM_BPS, F32_FLOPS = 3.35e12, 67e12

TEST_DEFAULT_FLAGS = [
    "--name", "smoke", "--checkpoints_dir", os.path.join(REPO, "build"),
    "--resume_iter", "latest", "--split", "test",
    "--vscale", "2", "2", "2", "--kernel_size", "3", "3", "3",
    "--query_size", "3", "3", "3", "--vsize", "0.008", "0.008", "0.008",
    "--wcoord_query", "1", "--z_depth_dim", "400",
    "--ranges", "-10.0", "-10.0", "-10.0", "10.0", "10.0", "10.0",
    "--SR", "24", "--K", "8", "--NN", "2",
    "--act_type", "LeakyReLU", "--agg_intrp_order", "2",
    "--agg_distance_kernel", "linear", "--agg_dist_pers", "20",
    "--radius_limit_scale", "4", "--point_features_dim", "32",
    "--shading_feature_mlp_layer1", "2", "--shading_alpha_mlp_layer", "1",
    "--shading_color_mlp_layer", "4", "--shading_feature_num", "256",
    "--dist_xyz_freq", "5", "--num_feat_freqs", "3",
    "--num_viewdir_freqs", "4", "--raydist_mode_unit", "1",
    "--near_plane", "0.1", "--far_plane", "8.0",
    "--which_ray_generation", "near_far_linear",
    "--which_tonemap_func", "off", "--which_render_func", "radiance",
    "--which_blend_func", "alpha",
    "--gather_dtype", "bfloat16", "--cache_dtype", "bfloat16",
    "--bg_color", "white", "--img_wh", str(W_IMG), str(H_IMG),
    # bench.py's grid spec: max_o/P sized from the occupancy, not the
    # script's fixed 610000/32 (which would drop points of this scene)
    "--max_o", "0", "--P", "0",
]

# dev_scripts/myexp_scannet_colmap/scene0113_00_default.sh, with the grid
# caps sized from the occupancy (--max_o 0 --P 0) and growing off
TRAIN_FLAGS = [
    "--dataset_name", "scannet_ft", "--resume_iter", "latest",
    "--load_points", "1", "--feat_grad", "1", "--conf_grad", "1",
    "--dir_grad", "0", "--color_grad", "1", "--vox_res", "900",
    "--prune_thresh", "0.1", "--prune_iter", "10000", "--feedforward", "0",
    "--depth_occ", "0", "--manual_depth_view", "1", "--init_view_num", "3",
    "--depth_conf_thresh", "0.8", "--geo_cnsst_num", "0",
    "--edge_filter", "10",
    "--appr_feature_str0", "imgfeat_0_0123", "dir_0", "point_conf",
    "--point_conf_mode", "1", "--point_dir_mode", "1",
    "--point_color_mode", "1", "--default_conf", "-1",
    "--agg_feat_xyz_mode", "None", "--agg_alpha_xyz_mode", "None",
    "--agg_color_xyz_mode", "None", "--feature_init_method", "rand",
    "--agg_axis_weight", "1.", "1.", "1.", "--agg_dist_pers", "20",
    "--radius_limit_scale", "4", "--depth_limit_scale", "0",
    "--vscale", "2", "2", "2", "--kernel_size", "3", "3", "3",
    "--query_size", "3", "3", "3", "--vsize", "0.008", "0.008", "0.008",
    "--wcoord_query", "1", "--z_depth_dim", "400", "--max_o", "0",
    "--ranges", "-10.0", "-10.0", "-10.0", "10.0", "10.0", "10.0",
    "--SR", "24", "--K", "8", "--P", "0", "--NN", "2",
    "--act_type", "LeakyReLU", "--agg_intrp_order", "2",
    "--agg_distance_kernel", "linear", "--point_features_dim", "32",
    "--shpnt_jitter", "passfunc", "--which_agg_model", "viewmlp",
    "--apply_pnt_mask", "1", "--shading_feature_mlp_layer0", "1",
    "--shading_feature_mlp_layer1", "2", "--shading_feature_mlp_layer2", "0",
    "--shading_feature_mlp_layer3", "0", "--shading_alpha_mlp_layer", "1",
    "--shading_color_mlp_layer", "4", "--shading_feature_num", "256",
    "--dist_xyz_freq", "5", "--num_feat_freqs", "3", "--dist_xyz_deno", "0",
    "--raydist_mode_unit", "1", "--near_plane", "0.1", "--far_plane", "8.0",
    "--which_ray_generation", "near_far_linear", "--dir_norm", "0",
    "--which_tonemap_func", "off", "--which_render_func", "radiance",
    "--which_blend_func", "alpha", "--out_channels", "4",
    "--num_pos_freqs", "10", "--num_viewdir_freqs", "4",
    "--random_sample", "random", "--random_sample_size", "32",
    "--batch_size", "1", "--plr", "0.002", "--lr", "0.0005",
    "--lr_policy", "iter_exponential_decay", "--lr_decay_iters", "1000000",
    "--lr_decay_exp", "0.1", "--gpu_ids", "0",
    "--save_iter_freq", "5000", "--save_point_freq", "10000",
    "--maximum_step", "1000000", "--niter", "10000",
    "--niter_decay", "10000", "--n_threads", "2", "--train_and_test", "0",
    "--test_num", "25", "--test_freq", "50000", "--print_freq", "100",
    "--test_num_step", "50", "--prob_freq", "0",
    "--zero_one_loss_items", "conf_coefficient",
    "--zero_one_loss_weights", "0.0001", "--sparse_loss_weight", "0",
    "--color_loss_weights", "1.0", "0.0", "0.0",
    "--color_loss_items", "ray_masked_coarse_raycolor",
    "ray_miss_coarse_raycolor", "coarse_raycolor",
    "--bg_color", "white", "--split", "train", "--train_step", "5",
    "--img_wh", str(W_IMG), str(H_IMG),
]


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps=10):
    """Median milliseconds of fn() over reps runs, by CUDA events."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes, flops, peak_flops):
    """(least ms the card could take, what bounds it): the bytes the
    function must move over the HBM rate against its operations over the
    peak rate for their type."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = flops / peak_flops * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops
            else (t_ops, "operations"))


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def mlp_fma_per_row(block1):
    """FMAs of one neighbour row through block1 (one product per layer)."""
    return sum(l_["w"].shape[0] * l_["w"].shape[1] for l_ in block1)


class Tee(io.TextIOBase):
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def frame_item():
    """A 640x480 camera inside the room, looking along +x, image-down -z."""
    import torch
    from sgnerf_tpu_torch.ops.camera import get_dtu_raydir
    intr = np.array([[FOCAL, 0, W_IMG / 2], [0, FOCAL, H_IMG / 2], [0, 0, 1]],
                    np.float32)
    rot = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32)
    px, py = np.meshgrid(np.arange(W_IMG, dtype=np.float32),
                         np.arange(H_IMG, dtype=np.float32))
    pix = np.stack([px, py], -1).reshape(-1, 2)
    raydir = get_dtu_raydir(torch.from_numpy(pix), torch.from_numpy(intr),
                            torch.from_numpy(rot), False).numpy()
    return {"raydir": raydir, "campos": np.array([-1.5, 0.3, 0.2], np.float32),
            "camrotc2w": rot, "near": np.float32(0.1), "far": np.float32(8.0),
            "bg_color": np.ones(3, np.float32)}


def build_scene(opt, n_points):
    """The room scan with seeded embeddings and port-initialised weights ->
    native checkpoint -> SceneModel.load_checkpoint."""
    import torch
    from sgnerf_tpu_torch.data.synthetic import room_scan
    from sgnerf_tpu_torch.models.aggregator import init_aggregator_params
    from sgnerf_tpu_torch.models.checkpoint_io import save_native
    from sgnerf_tpu_torch.models.params import params_to_jax
    from sgnerf_tpu_torch.runtime.scene_model import SceneModel

    rng = np.random.default_rng(0)
    xyz = room_scan(rng, n_points)
    cloud = {
        "xyz": xyz,
        "embedding": (rng.normal(size=(n_points, 32)) * 0.1).astype(np.float32),
        "conf": np.ones((n_points, 1), np.float32),
        "dir": (xyz / np.linalg.norm(xyz, axis=-1, keepdims=True)).astype(
            np.float32),
        "color": np.clip(xyz * 0.2 + 0.5, 0, 1).astype(np.float32),
        "Rw2c": np.eye(3, dtype=np.float32),
        "active": np.ones(n_points, bool),
        "n_active": np.asarray(n_points, np.int32),
    }
    model = SceneModel(opt)
    params = params_to_jax(init_aggregator_params(0, model.cfg.agg))
    save_native(os.path.join(model.expr_dir, "0_net_ray_marching.npz"),
                {"params": params, "cloud": cloud},
                {"iter": 0, "best_psnr": 0.0, "best_iter": 0})
    t0 = time.perf_counter()
    model.load_checkpoint(model.resolve_resume())
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def time_grid_build(model):
    """Seconds of one grid build (spec given) of the loaded cloud."""
    import torch
    from sgnerf_tpu_torch.models.point_cloud import build_grid
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid = build_grid(model.cloud, model.spec)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    assert torch.equal(grid.nbr_packed, model.grid.nbr_packed)
    return dt


def capture_first_call(module, name, store):
    """Wrap module.<name> so its first call's arguments land in `store`;
    the call goes through to the wrapped function unchanged. Returns the
    original, to be put back."""
    fn = getattr(module, name)

    def wrapped(*args, **kw):
        if name not in store:
            store[name] = (args, kw)
        return fn(*args, **kw)
    setattr(module, name, wrapped)
    return fn


def capture_first_grad(module, name, store):
    """Wrap module.<name> (the aggregator's K2 call): the first call's
    inputs land in store["args"] (detached copies, so later updates of the
    weights do not move them) and the cotangent its outputs receive in the
    backward in store["g"] (M, C+1). Returns the original."""
    import torch
    fn = getattr(module, name)

    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        if "args" not in store:
            feat, d, w, block1, alpha = args
            store["args"] = (
                feat.detach().clone(), d.detach().clone(),
                w.detach().clone(),
                [{k: v.detach().clone() for k, v in l_.items()}
                 for l_ in block1],
                [{k: v.detach().clone() for k, v in l_.items()}
                 for l_ in alpha])
            store["kw"] = kw
            parts = {}

            def hook(i):
                def save(g):
                    parts[i] = g.detach().clone()
                    if len(parts) == 2:
                        store["g"] = torch.cat([parts[0], parts[1]], -1)
                return save
            for i, t in enumerate(out):
                t.register_hook(hook(i))
        return out
    setattr(module, name, wrapped)
    return fn


def write_scannet_export(root, n_views=6):
    """A ScanNet export of n_views 640x480 posed views inside the room
    (seeded images; the room scan supplies the geometry through the
    checkpoint)."""
    from PIL import Image
    exported = os.path.join(root, "scene_smoke", "exported")
    for sub in ("color", "pose", "intrinsic"):
        os.makedirs(os.path.join(exported, sub), exist_ok=True)
    intr = np.eye(4)
    intr[:3, :3] = [[FOCAL, 0, W_IMG / 2], [0, FOCAL, H_IMG / 2], [0, 0, 1]]
    np.savetxt(os.path.join(exported, "intrinsic/intrinsic_color.txt"), intr)
    rng = np.random.default_rng(3)
    for i in range(n_views):
        yaw = 2 * np.pi * i / n_views
        fwd = np.array([np.cos(yaw), np.sin(yaw), 0.0])
        down = np.array([0.0, 0.0, -1.0])
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2] = np.cross(down, fwd), down, fwd
        c2w[:3, 3] = -1.2 * fwd + np.array([0.0, 0.0, 0.2])
        np.savetxt(os.path.join(exported, f"pose/{i}.txt"), c2w)
        img = rng.uniform(0, 255, (H_IMG // 8, W_IMG // 8, 3)).astype(np.uint8)
        Image.fromarray(img).resize((W_IMG, H_IMG), Image.BILINEAR).save(
            os.path.join(exported, f"color/{i}.jpg"))


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false: "
                 "this run needs an NVIDIA GPU")
    from sgnerf_tpu_torch.options import TestOptions
    from sgnerf_tpu_torch.models import aggregator as agg_mod
    from sgnerf_tpu_torch.models.renderer import render_rays
    from sgnerf_tpu_torch.ops import _cuda
    from sgnerf_tpu_torch.ops import query as query_mod
    from sgnerf_tpu_torch.ops.fused_agg import (fused_block1_alpha,
                                                fused_block1_alpha_plain)
    from sgnerf_tpu_torch.ops.fused_knn import (fused_knn_select,
                                                fused_knn_select_plain)

    for d in ("smoke", "smoke_ft", "smoke_scans"):   # this script's outputs
        shutil.rmtree(os.path.join(REPO, "build", d), ignore_errors=True)

    # ---- 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 2. kernels
    log(f"phase 2: kernels built and loaded in {_cuda.build_all():.1f} s "
        f"({_cuda.BUILD_DIR})")

    # ---- 3. scene
    opt = TestOptions().parse(TEST_DEFAULT_FLAGS)
    t0 = time.perf_counter()
    model, load_s = build_scene(opt, N_POINTS)
    spec = model.spec
    log(f"phase 3: {N_POINTS} points, grid vdim {spec.vdim} max_o "
        f"{spec.max_o} P {spec.P}, cache rows {model.grid.nbr_packed.shape[0]}"
        f"; checkpoint load + grid build {load_s:.2f} s, grid build alone "
        f"{time_grid_build(model):.2f} s (scene total "
        f"{time.perf_counter() - t0:.1f} s)")
    assert model.cfg.knn_mode == "fused" and model.cfg.agg.fused_mlp == "cuda"

    # ---- 4. one frame through the eval path
    item = frame_item()
    captured = {}
    knn_fn = capture_first_call(query_mod, "fused_knn_select", captured)
    agg_fn = capture_first_call(agg_mod, "fused_block1_alpha", captured)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_knn_select.launches = 0
    fused_block1_alpha.launches = 0
    t0 = time.perf_counter()
    col = model.render_image(item)
    frame_s = time.perf_counter() - t0
    launches = {"fused_knn_select": fused_knn_select.launches,
                "fused_block1_alpha": fused_block1_alpha.launches}
    query_mod.fused_knn_select, agg_mod.fused_block1_alpha = knn_fn, agg_fn
    n_rays = W_IMG * H_IMG
    hit_share = float(np.mean(np.any(col != 1.0, axis=-1)))
    log(f"phase 4: frame {W_IMG}x{H_IMG} in {frame_s * 1e3:.1f} ms "
        f"({n_rays / frame_s:.0f} rays/s), launches {launches}, peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"rays with neighbours {hit_share:.3f}")
    assert all(v > 0 for v in launches.values()), launches
    assert col.shape == (n_rays, 3) and np.isfinite(col).all()
    assert hit_share > 0.5, hit_share
    t0 = time.perf_counter()
    col2 = model.render_image(item)
    warm_s = time.perf_counter() - t0
    log(f"phase 4: the same frame again (warm) in {warm_s * 1e3:.1f} ms "
        f"({n_rays / warm_s:.0f} rays/s), max |diff| to the first "
        f"{float(np.abs(col - col2).max()):.3e}")

    sub = slice(n_rays // 2, n_rays // 2 + 512)     # rays through the room
    dev = model.device
    kw = dict(campos=torch.from_numpy(item["campos"][None]).to(dev),
              raydir=torch.from_numpy(item["raydir"][None, sub]).to(dev),
              camrotc2w=torch.from_numpy(item["camrotc2w"][None]).to(dev),
              near=0.1, far=8.0, bg_color=torch.ones(3, device=dev),
              table=model.table)
    plain_cfg = dataclasses.replace(
        model.cfg, knn_mode="exact",
        agg=dataclasses.replace(model.cfg.agg, fused_mlp="none"))
    with torch.inference_mode():
        a = render_rays(model.params, model.cloud, model.grid, model.cfg,
                        **kw)["coarse_raycolor"]
        b = render_rays(model.params, model.cloud, model.grid, plain_cfg,
                        **kw)["coarse_raycolor"]
    render_err = float((a - b).abs().max())
    log(f"phase 4: 512 rays, kernel path vs un-fused path: max |diff| "
        f"{render_err:.3e} (tolerance {RENDER_ATOL})")
    assert torch.isfinite(a).all() and render_err <= RENDER_ATOL

    # ---- 5. K1 and K2 vs their plain versions on one chunk's inputs
    records = [phase5_k1(captured, launches), phase5_k2(captured, launches)]
    del model, a, b, kw, captured
    torch.cuda.empty_cache()

    # ---- 6-7. the train step, then K3 vs its plain version
    records.append(phase6_7_train(item))
    torch.cuda.empty_cache()

    # ---- 8. the training CLI
    phase8_train_ft()

    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def phase5_k1(captured, launches):
    import torch
    from sgnerf_tpu_torch.ops.fused_knn import (fused_knn_select,
                                                fused_knn_select_plain)
    args, kwargs = captured["fused_knn_select"]
    with torch.inference_mode():
        ids = fused_knn_select(*args, **kwargs)
        ref = fused_knn_select_plain(*args, **kwargs)
        torch.cuda.synchronize()
        id_err = float((ids - ref).abs().max())
        assert torch.equal(ids, ref), int((ids != ref).sum())
        ms = cuda_ms(lambda: fused_knn_select(*args, **kwargs))
        plain_ms = cuda_ms(lambda: fused_knn_select_plain(*args, **kwargs))
    rows, delta, ok = args[:3]
    M, C, K = rows.shape[0], kwargs["C"], kwargs["K"]
    # d2 of every candidate: 3 differences, 3 squares, 2 sums
    bound_ms, bound_by = bound(nbytes(rows, delta, ok) + M * K * 4,
                               8.0 * M * C, F32_FLOPS)
    log(f"phase 5: K1 fused_knn_select M={M} C={C} K={K}: ids equal; "
        f"{ms:.3f} ms vs plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms "
        f"({bound_by})")
    return {"name": "fused_knn_select", "route": "cuda",
            "source": "sgnerf_tpu_torch/csrc/fused_knn.cu",
            "replaces": "sgnerf_tpu/ops/fused_knn.py:232",
            "launches": launches["fused_knn_select"],
            "max_abs_err": id_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def phase5_k2(captured, launches):
    import torch
    from sgnerf_tpu_torch.ops.fused_agg import (fused_block1_alpha,
                                                fused_block1_alpha_plain)
    args, kwargs = captured["fused_block1_alpha"]
    plain_kw = {k: v for k, v in kwargs.items() if k != "bwd"}
    errs = {}
    with torch.inference_mode():
        for bf16 in (False, True):
            kw2, kwp = dict(kwargs, bf16=bf16), dict(plain_kw, bf16=bf16)
            got = torch.cat(fused_block1_alpha(*args, **kw2), dim=-1)
            ref = torch.cat(fused_block1_alpha_plain(*args, **kwp), dim=-1)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            ok = torch.allclose(got, ref, **K2_TOL[bf16])
            t_k = cuda_ms(lambda: fused_block1_alpha(*args, **kw2))
            t_p = cuda_ms(lambda: fused_block1_alpha_plain(*args, **kwp))
            log(f"phase 5: K2 fused_block1_alpha bf16={bf16} M="
                f"{args[0].shape[0]} K={kwargs['K']}: max |diff| {err:.3e} "
                f"(max |ref| {float(ref.abs().max()):.3f}, tolerance "
                f"{K2_TOL[bf16]}) ; {t_k:.3f} ms vs plain {t_p:.3f} ms")
            assert ok, (bf16, err)
            errs[bf16] = (err, t_k, t_p, got)
    # the bf16 mode really rounds: its output differs from the f32 mode's
    mode_diff = float((errs[True][3] - errs[False][3]).abs().max())
    log(f"phase 5: K2 kernel bf16 vs f32 mode: max |diff| {mode_diff:.3e}")
    assert mode_diff > 0.0
    main_bf16 = bool(kwargs["bf16"])
    err, t_k, t_p, _ = errs[main_bf16]
    feat, d, w, block1, alpha = args
    rows = feat.shape[0] * feat.shape[1]
    C = block1[0]["w"].shape[1]
    weights = [t for l_ in block1 + alpha for t in l_.values()]
    bound_ms, bound_by = bound(
        nbytes(feat, d, w, *weights) + feat.shape[0] * (C + 1) * 4,
        2.0 * rows * (mlp_fma_per_row(block1) + C), F32_FLOPS)
    log(f"phase 5: K2 bound {bound_ms:.3f} ms ({bound_by}, f32)")
    return {"name": "fused_block1_alpha", "route": "cuda",
            "source": "sgnerf_tpu_torch/csrc/fused_agg.cu",
            "replaces": "sgnerf_tpu/ops/fused_agg.py:724",
            "launches": launches["fused_block1_alpha"],
            "max_abs_err": err, "ms": t_k, "plain_ms": t_p,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def phase6_7_train(item):
    """Phase 6 (the train step at full width) and phase 7 (K3 vs plain);
    returns K3's record."""
    import torch
    from sgnerf_tpu_torch.models import aggregator as agg_mod
    from sgnerf_tpu_torch.models.renderer import draw_render_noise
    from sgnerf_tpu_torch.models.train import loss_and_grads
    from sgnerf_tpu_torch.options import TrainOptions
    from sgnerf_tpu_torch.ops.fused_agg import (fused_block1_alpha,
                                                fused_block1_alpha_bwd,
                                                fused_block1_alpha_bwd_plain)
    from sgnerf_tpu_torch.ops.fused_knn import fused_knn_select
    from sgnerf_tpu_torch.runtime.scene_model import (SceneModel,
                                                      batch_to_device)

    opt = TrainOptions().parse(TRAIN_FLAGS + [
        "--name", "smoke", "--checkpoints_dir", os.path.join(REPO, "build")])
    t0 = time.perf_counter()
    model = SceneModel(opt)
    model.load_checkpoint(model.resolve_resume())
    torch.cuda.synchronize()
    cfg = model.cfg
    assert (cfg.knn_mode == "exact" and cfg.agg.fused_mlp == "cuda"
            and cfg.agg.fused_bwd == "cuda" and cfg.gather_dtype == "float32")
    log(f"phase 6: train model (f32 cache) loaded in "
        f"{time.perf_counter() - t0:.1f} s, cache rows "
        f"{model.grid.nbr_packed.shape[0]}")

    rng = np.random.default_rng(6)
    R = 32 * 32
    pick = rng.choice(len(item["raydir"]), size=R, replace=False)
    train_item = dict(item, raydir=item["raydir"][pick],
                      gt_image=rng.uniform(0, 1, (R, 3)).astype(np.float32))
    batch = batch_to_device(train_item, model.device)

    captured = {}
    agg_fn = capture_first_grad(agg_mod, "fused_block1_alpha", captured)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_knn_select.launches = 0
    fused_block1_alpha.launches = 0
    fused_block1_alpha_bwd.launches = 0
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        out = model.optimize(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(out["total"]))
    launches = {"fused_knn_select": fused_knn_select.launches,
                "fused_block1_alpha": fused_block1_alpha.launches,
                "fused_block1_alpha_bwd": fused_block1_alpha_bwd.launches}
    agg_mod.fused_block1_alpha = agg_fn
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"phase 6: {TRAIN_STEPS} steps of {R} rays at {N_POINTS} points: "
        f"losses {[round(v, 6) for v in losses]}, step ms "
        f"{[round(v, 1) for v in step_ms]}, median "
        f"{statistics.median(step_ms):.1f} ms, peak memory {peak:.2f} GiB, "
        f"launches {launches}")
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert launches == {"fused_knn_select": 0,
                        "fused_block1_alpha": TRAIN_STEPS,
                        "fused_block1_alpha_bwd": TRAIN_STEPS}, launches

    profile_step(model, batch)

    # the same step through the kernels and through the un-fused path
    gen = torch.Generator(device=model.device).manual_seed(11)
    noise = draw_render_noise(gen, cfg, 1, R)
    plain_cfg = dataclasses.replace(
        cfg, agg=dataclasses.replace(cfg.agg, fused_mlp="none"))
    lk, gk_net, gk_pts = loss_and_grads(model.state, model.grid, cfg,
                                        model.tcfg, batch, noise=noise)
    lp, gp_net, gp_pts = loss_and_grads(model.state, model.grid, plain_cfg,
                                        model.tcfg, batch, noise=noise)
    loss_err = abs(float(lk["total"]) - float(lp["total"])) \
        / abs(float(lp["total"]))
    grad_err = max(float((a - b).abs().max()) / float(b.abs().max())
                   for a, b in zip(gk_net + gk_pts, gp_net + gp_pts)
                   if float(b.abs().max()) > 0)
    log(f"phase 6: one step, kernel path vs un-fused path: loss rel diff "
        f"{loss_err:.3e} (tolerance {LOSS_RTOL}), worst gradient max|diff| "
        f"/ max|plain| {grad_err:.3e} (tolerance {K3_TOL[False]})")
    assert loss_err <= LOSS_RTOL and grad_err <= K3_TOL[False]
    del model, batch, gk_net, gk_pts, gp_net, gp_pts
    torch.cuda.empty_cache()

    # ---- 7. K3 vs its plain version on the captured step
    feat, d, w, block1, alpha = captured["args"]
    g = captured["g"]
    kw = {k: v for k, v in captured["kw"].items() if k not in ("bf16", "bwd")}
    res = {}
    for bf16 in (False, True):
        got = fused_block1_alpha_bwd(feat, d, w, block1, alpha, g,
                                     bf16=bf16, **kw)
        ref = fused_block1_alpha_bwd_plain(feat, d, w, block1, alpha, g,
                                           bf16=bf16, **kw)
        torch.cuda.synchronize()
        flat = [(a, b) for a, b in zip(_flat_grads(got), _flat_grads(ref))]
        rel = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
               for a, b in flat]
        err = max(float((a - b).abs().max()) for a, b in flat)
        t_k = cuda_ms(lambda: fused_block1_alpha_bwd(
            feat, d, w, block1, alpha, g, bf16=bf16, **kw))
        t_p = cuda_ms(lambda: fused_block1_alpha_bwd_plain(
            feat, d, w, block1, alpha, g, bf16=bf16, **kw))
        log(f"phase 7: K3 fused_block1_alpha_bwd bf16={bf16} M="
            f"{feat.shape[0]} K={kw['K']}: max |diff| / max |plain| per "
            f"output {[f'{v:.2e}' for v in rel]} (tolerance {K3_TOL[bf16]})"
            f"; {t_k:.3f} ms vs plain {t_p:.3f} ms")
        assert max(rel) <= K3_TOL[bf16], (bf16, rel)
        res[bf16] = (err, t_k, t_p)
    again = fused_block1_alpha_bwd(feat, d, w, block1, alpha, g, bf16=False,
                                   **kw)
    first = fused_block1_alpha_bwd(feat, d, w, block1, alpha, g, bf16=False,
                                   **kw)
    assert all(torch.equal(a, b) for a, b in zip(_flat_grads(again),
                                                  _flat_grads(first)))
    log("phase 7: K3 reruns are bit-identical")
    err, t_k, t_p = res[False]
    rows = feat.shape[0] * feat.shape[1]
    C = block1[0]["w"].shape[1]
    weights = [t for l_ in block1 + alpha for t in l_.values()]
    # recompute (one product per layer + alpha head), then two products per
    # layer (dW and the input gradient) and the alpha-head terms
    fma = rows * (3 * mlp_fma_per_row(block1) + 4 * C)
    bound_ms, bound_by = bound(
        nbytes(feat, d, w, g, *weights) * 2 - nbytes(g), 2.0 * fma,
        F32_FLOPS)
    log(f"phase 7: K3 bound {bound_ms:.3f} ms ({bound_by}, f32: "
        f"{fma / 1e9:.1f} G FMA)")
    return {"name": "fused_block1_alpha_bwd", "route": "cuda",
            "source": "sgnerf_tpu_torch/csrc/fused_agg_bwd.cu",
            "replaces": "sgnerf_tpu/ops/fused_agg.py:523",
            "launches": launches["fused_block1_alpha_bwd"],
            "max_abs_err": err, "ms": t_k, "plain_ms": t_p,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def profile_step(model, batch, top=8):
    """One more train step under torch.profiler: the device time by kernel
    (the largest `top`), the device-busy sum against the step's wall
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.optimize(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    def dev_us(e):
        t = getattr(e, "self_device_time_total", None)
        return e.self_cuda_time_total if t is None else t
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: -dev_us(e))
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    log(f"phase 6: profiled step {wall_ms:.1f} ms wall, device busy "
        f"{busy_ms:.1f} ms ({busy_ms / wall_ms:.0%}); by kernel (ms): "
        + "; ".join(f"{e.key[:48]} {dev_us(e) / 1e3:.2f}"
                    for e in kernels[:top]))


def _flat_grads(grads):
    dfeat, dd, dw, dblock1, dalpha = grads
    return [dfeat, dd, dw] + [t for l_ in dblock1 + dalpha
                              for t in (l_["w"], l_["b"])]


def phase8_train_ft():
    """The training CLI on a synthetic ScanNet export, resuming the room
    scan's checkpoint: 10 steps, checkpoints, test PSNR."""
    import torch
    from sgnerf_tpu_torch.ops.fused_agg import (fused_block1_alpha,
                                                fused_block1_alpha_bwd)
    from sgnerf_tpu_torch.run import train_ft

    build = os.path.join(REPO, "build")
    scans = os.path.join(build, "smoke_scans")
    write_scannet_export(scans)
    expr = os.path.join(build, "smoke_ft", "ft")
    os.makedirs(expr, exist_ok=True)
    for ext in ("", ".meta.json"):
        shutil.copy(os.path.join(build, "smoke", "0_net_ray_marching.npz"
                                 + ext),
                    os.path.join(expr, "0_net_ray_marching.npz" + ext))
    flags = TRAIN_FLAGS + [
        "--name", "ft", "--checkpoints_dir", os.path.join(build, "smoke_ft"),
        "--data_root", scans + "/", "--scan", "scene_smoke",
        "--maximum_step", "10", "--save_iter_freq", "10", "--test_num", "1",
        "--test_freq", "0", "--print_freq", "5"]
    fused_block1_alpha.launches = fused_block1_alpha_bwd.launches = 0
    tee = Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        train_ft.main(flags)
    torch.cuda.synchronize()
    out = tee.buf.getvalue()
    log(f"phase 8: train_ft ran 10 steps, saved, exported and tested in "
        f"{time.perf_counter() - t0:.1f} s; launches K2 "
        f"{fused_block1_alpha.launches} K3 {fused_block1_alpha_bwd.launches}")
    for f in ("10_net_ray_marching.npz", "10_net_ray_marching.pth"):
        assert os.path.exists(os.path.join(expr, f)), f
    assert "training from step 0 to 10" in out
    psnr_lines = [l_ for l_ in out.splitlines() if "psnr:" in l_]
    assert psnr_lines and all(np.isfinite(float(l_.split("psnr:")[1].split()[0]))
                              for l_ in psnr_lines), psnr_lines
    assert fused_block1_alpha_bwd.launches == 10


if __name__ == "__main__":
    main()
