#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (sgnerf_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port's main path once through the entry points a user calls:
the eval render of the default viewmlp config (the flags of
dev_scripts/myexp_scannet_colmap/test_default.sh), at full width, on a
synthetic 4.2M-point room scan (bench.py's scene) with seeded random
weights saved as a native checkpoint and loaded back through
SceneModel.load_checkpoint. Phases:

  1. card name and power limit, torch and CUDA versions;
  2. build both CUDA kernels from csrc/ (seconds printed);
  3. scene: cloud, checkpoint round trip, grid build (seconds printed);
  4. one 640x480 frame through SceneModel.render_image with every kernel
     launch counter reset just before: both kernels must have launched,
     the image must be finite and most rays must find neighbours; then
     512 rays of the frame rendered again with the kernel path and with
     the un-fused PyTorch path must agree;
  5. each kernel against its plain PyTorch version on the inputs captured
     from one chunk of that frame (K1 ids equal; K2 within tolerance in
     f32 and bf16), timed with CUDA events.

Any failure raises and the script exits non-zero before its last line.
The last line is {"ok": true, "device": {...}}; the line before it holds
the per-kernel JSON record. Without a CUDA device it exits non-zero at once.
"""
import dataclasses
import json
import os
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
    """bench.py's room scan with seeded embeddings and port-initialised
    weights -> native checkpoint -> SceneModel.load_checkpoint."""
    import torch
    import bench
    from sgnerf_tpu.models.checkpoint_io import save_native
    from sgnerf_tpu_torch.models.aggregator import init_aggregator_params
    from sgnerf_tpu_torch.models.params import params_to_jax
    from sgnerf_tpu_torch.runtime.scene_model import SceneModel

    rng = np.random.default_rng(0)
    xyz = bench._room_scan(rng, n_points)
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
    the call goes through to the wrapped function unchanged."""
    fn = getattr(module, name)

    def wrapped(*args, **kw):
        if name not in store:
            store[name] = (args, kw)
        return fn(*args, **kw)
    setattr(module, name, wrapped)
    return fn


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false: "
                 "this run needs an NVIDIA GPU")
    from sgnerf_tpu.options.options import TestOptions
    from sgnerf_tpu_torch.models import aggregator as agg_mod
    from sgnerf_tpu_torch.models.renderer import render_rays
    from sgnerf_tpu_torch.ops import _cuda
    from sgnerf_tpu_torch.ops import query as query_mod
    from sgnerf_tpu_torch.ops.fused_agg import (fused_block1_alpha,
                                                fused_block1_alpha_plain)
    from sgnerf_tpu_torch.ops.fused_knn import (fused_knn_select,
                                                fused_knn_select_plain)

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

    # ---- 4. one frame through the main path
    item = frame_item()
    captured = {}
    capture_first_call(query_mod, "fused_knn_select", captured)
    capture_first_call(agg_mod, "fused_block1_alpha", captured)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_knn_select.launches = 0
    fused_block1_alpha.launches = 0
    t0 = time.perf_counter()
    col = model.render_image(item)
    frame_s = time.perf_counter() - t0
    launches = {"fused_knn_select": fused_knn_select.launches,
                "fused_block1_alpha": fused_block1_alpha.launches}
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
    kw = dict(campos=torch.from_numpy(item["campos"][None]).cuda(),
              raydir=torch.from_numpy(item["raydir"][None, sub]).cuda(),
              camrotc2w=torch.from_numpy(item["camrotc2w"][None]).cuda(),
              near=0.1, far=8.0, bg_color=torch.ones(3, device="cuda"),
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

    # ---- 5. each kernel vs its plain version on one chunk's inputs
    records = []
    args, kwargs = captured["fused_knn_select"]
    with torch.inference_mode():
        ids = fused_knn_select(*args, **kwargs)
        ref = fused_knn_select_plain(*args, **kwargs)
        torch.cuda.synchronize()
        id_err = float((ids - ref).abs().max())
        assert torch.equal(ids, ref), int((ids != ref).sum())
        ms = cuda_ms(lambda: fused_knn_select(*args, **kwargs))
        plain_ms = cuda_ms(lambda: fused_knn_select_plain(*args, **kwargs))
    log(f"phase 5: K1 fused_knn_select M={args[0].shape[0]} C="
        f"{kwargs['C']} K={kwargs['K']}: ids equal; {ms:.3f} ms vs plain "
        f"{plain_ms:.3f} ms")
    records.append({"name": "fused_knn_select", "route": "cuda",
                    "source": "sgnerf_tpu_torch/csrc/fused_knn.cu",
                    "replaces": "sgnerf_tpu/ops/fused_knn.py:232",
                    "launches": launches["fused_knn_select"],
                    "max_abs_err": id_err, "ms": ms, "plain_ms": plain_ms})

    args, kwargs = captured["fused_block1_alpha"]
    errs = {}
    with torch.inference_mode():
        for bf16 in (False, True):
            kw2 = dict(kwargs, bf16=bf16)
            got = torch.cat(fused_block1_alpha(*args, **kw2), dim=-1)
            ref = torch.cat(fused_block1_alpha_plain(*args, **kw2), dim=-1)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            ok = torch.allclose(got, ref, **K2_TOL[bf16])
            t_k = cuda_ms(lambda: fused_block1_alpha(*args, **kw2))
            t_p = cuda_ms(lambda: fused_block1_alpha_plain(*args, **kw2))
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
    records.append({"name": "fused_block1_alpha", "route": "cuda",
                    "source": "sgnerf_tpu_torch/csrc/fused_agg.cu",
                    "replaces": "sgnerf_tpu/ops/fused_agg.py:724",
                    "launches": launches["fused_block1_alpha"],
                    "max_abs_err": err, "ms": t_k, "plain_ms": t_p})

    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
