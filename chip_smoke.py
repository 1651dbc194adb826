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
     one chunk of that frame (K1 ids equal, and a rerun the same bits; K2
     within tolerance in f32 and bf16), timed with CUDA events (K1 one
     call, as every kernel, and beside it the device time of back-to-back
     launches; its share of the bound, K1's and K6's registers, shared
     memory and blocks an SM, the SHFL and VOTE count of each
     instantiation's SASS; then the cache-row gather in front of K1,
     nbr_packed[slot], timed alone); K2's bound in each
     mode against the unit it runs on (bf16: the bf16 tensor cores; f32:
     three TF32 products), the cuBLAS time of block1's bf16 products at
     the chunk's shape as a yardstick, K2's registers, shared memory and
     blocks an SM, and the count of tensor-core instructions in its
     SASS; then K2's f32 mode at tests/test_fused_agg.py's inputs against
     that file's own limits (features 3e-5, alpha 3e-6, aggregate()'s
     decoded output 3e-6);
  6. the train step at full width (1024 random rays of the phase-4 camera,
     seeded target colours): 8 SceneModel.optimize steps with the counters
     reset just before; K2 and K3 must launch once a step, K1 never (f32
     cache: exact top-k), the loss must be finite and fall. Then one step's
     losses and gradients with the kernels and with the un-fused plain path,
     from the same state and noise, must agree, the un-fused block1 taking
     the kernel forward's LeakyReLU branch at the few activations where its
     own lies on the other side of zero (each within K2_TOL; the gradients
     on its own branches are logged too);
  7. K3 against its plain version on the arguments and cotangent captured
     from phase 6's first step, in f32 and bf16, timed with CUDA events
     (the plain version takes the LeakyReLU branch of the forward that
     ran, K3a's, where its own recompute lies on the other one; K3a's
     activations summed as K2 sums them must equal K2's features bit for
     bit); each of its three launches (K3a recompute, K3b data gradients, K3c
     weight gradients) against its plain statement and timed alone; K3's
     bound (block1's three passes of products at the tensor cores' rate
     for their type, the alpha head on the FP32 cores), the four backward products by
     torch.matmul (f32, TF32 off) as a yardstick, K3's registers, shared
     memory and blocks an SM, HGMMA and no HMMA in K3b's SASS, and a
     full-shape rerun that gives the same bits;
  8. the training CLI, sgnerf_tpu_torch.run.train_ft.main, on a synthetic
     ScanNet export written under build/ (640x480 views inside the room,
     the room scan as the resumed checkpoint): 10 steps, then the
     checkpoints and the test PSNR line;
  9. the phase-3 checkpoint loaded again, then the phase-4 frame with
     --fused_color on (every counter reset just before): K4 and K1 launch
     once a chunk, K2 never, and the image agrees with the phase-4 frame;
 10. the same with --fused_march on: K5 (and K1) once a chunk, K4 and K2
     never, the image agrees with the phase-4 frame;
 11. the same with RenderConfig(knn_mode="dedup") (tiles of 64 rays, a
     cap of 160 cache rows a tile): K6 once a chunk, K1 never; the shading
     points past their tile's cap and the distinct cache rows a tile; on
     the first chunk K6's ids equal K1's on every point within its tile's
     cap and are -1 past it; with no point past the cap the image agrees
     with the phase-4 frame. Then again with tiles of dedup_cap // SR
     rays, which cannot overflow: the image agrees with the phase-4 frame;
 12. K4, K5 (f32 and bf16) and K6 against their plain versions on the
     inputs captured from the first chunk of phases 9-11, timed with CUDA
     events (K6 as K1 in phase 5: a rerun, device time beside the one
     call, share of the bound, resources); in bf16 K4 also against
     the plain colour head run on the K2 kernel's reduced rows and K5
     against the plain march run on K4's outputs, each at a limit below
     the gap between the kernel's bf16 and f32 modes, and the plain
     colour head's per-layer bf16 rounding flips between K2's and the
     plain reduced rows;
 13. the train step of phase 6 with --fused_color on: one step's loss and
     gradients equal phase 6's kernel path (K2 + the colour head outside
     + K3) from the same state and noise; then 3 steps, each launching K4,
     K2 (the backward's recompute) and K3 once;
 14. the row gather K7 (gather_rows_pallas) and its staged form
     (gather_rows_staged, the TPU probes' counterpart) bit-equal to
     index_select at the probes' two shapes (cache: 221,184 rows of 640 B
     from 1.2M; attribute: 1,769,472 rows of 128 B from 1M), in int16 and
     f32; K7's transpose twice the same bits and within 1e-6 (relative to
     its largest magnitude) of index_add_ in f32. Then the probe
     (sgnerf_tpu_torch/dev/probe_gather.py) with the counters reset just
     before: K7 and the staged form at wave 8, 16, 32 and index_select,
     ms, GB/s and share of the bound, and static ids at the cache shape;
 15. growing at full width: the phase-6 train model on phase 8's export,
     holes cut into the walls the train views face (their points pruned),
     then probe_and_grow with opacity_thresh 0 (growth forced) with the
     counters reset just before: the probe frame's ms and K2 launches, the
     points grown, n_active before and after, the grow + grid rebuild
     seconds, the peak memory; n_active must grow by the points grown.
     The middle 2304-ray chunk of that probe frame (the rows through the
     holes) rendered with prob=True through the kernel path, K2 against
     its plain version on the inputs captured there, and the chunk
     through the un-fused path: ray_mask equal, the other eight probe
     outputs within tolerance. A train step after growing must give a finite
     loss; one probe frame under
     torch.profiler (device time by kernel). Then train_ft.main
     with the canonical growing flags (--prob_freq 5 ...) for 10 steps,
     through the probes of steps 5 and 10.

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
# bf16 mode, K4 vs the plain colour head on the K2 kernel's reduced rows
# (K4 computes them with K2's tile body, bit for bit), and K5 vs the plain
# march on K4's outputs (K5 runs K4's colour head on the same rows). Against
# the plain version (K2_TOL) a one-ulp difference of the K-sum flips a
# colour input's bf16 rounding, and the flip travels to the logits (1.6e-2
# on a chunk). Here only the colour layers' summation order is left (K4: a
# flipped hidden rounding moved 3 of 2004 test logits by <= 5e-4) and the
# march's exp (K5). Each limit lies below the kernel's bf16-vs-f32 gap
COLOR_SOUND_TOL = {"K4": dict(atol=2e-3, rtol=0.0),
                   "K5": dict(atol=1e-6, rtol=0.0)}
# render of 512 rays, kernel path vs un-fused path, f32 compute
RENDER_ATOL = 1e-4
# K3 vs its plain version (f32), per output tensor, relative to the plain
# tensor's largest magnitude: summation order (f32); a flipped bf16
# rounding of a product input (bf16). K3 is the gradient of the forward
# that ran (K3a's activations are K2's bit for bit); the plain K3 takes
# that forward's LeakyReLU branch at the few activations (3 of 100M at the
# train step) where its own recompute lies on the other one, each within
# K2_TOL of it (`fused_block1_alpha_bwd_plain(branches=)`; phase 7 logs
# the plain K3 on its own branches too)
K3_TOL = {False: 2e-3, True: 3e-2}
# K3's launches vs their plain statements on the same inputs: K3a's saved
# activations as K2 (K2_TOL); K3b's data gradients as K3 (K3_TOL, relative);
# K3c's weight gradients, IEEE f32 products of the same operands on both
# sides, relative to the largest magnitude: the summation order only
K3C_RTOL = 1e-5
# tests/test_fused_agg.py's own limits for K2's f32 mode (F9): features,
# alpha (:93-94) and aggregate()'s decoded output (:45)
F9_LIMITS = {"features": 3e-5, "alpha": 3e-6, "decoded": 3e-6}
# train step, kernel path vs un-fused path from the same state and noise
LOSS_RTOL = 1e-5
# K7's transpose (a sequential sum per id) vs index_add_ (atomics), f32,
# relative to the largest magnitude: the two sum in different orders
GATHER_BWD_RTOL = 1e-6
TRAIN_STEPS = 8
FUSED_COLOR_STEPS = 3
# the card's peaks (NVIDIA H100 SXM data sheet, dense): HBM bytes/s, FP32
# FLOP/s outside the tensor cores, bf16 and TF32 FLOP/s on the tensor cores
HBM_BPS, F32_FLOPS = 3.35e12, 67e12
BF16_FLOPS, TF32_FLOPS = 989e12, 495e12

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


def knn_resources_and_sass(res, sass=True):
    """Phases 5 and 12: K1's and K6's registers, shared memory and blocks an
    SM; then (sass) the SHFL and VOTE instructions of each instantiation
    in the SASS of csrc/fused_knn.cu (N keys a lane; "v": the 16-byte
    path the main path takes at C = 64)."""
    import re
    from sgnerf_tpu_torch.ops import _cuda
    for k in ("K1", "K6"):
        r = res[k]
        log(f"  {k} resources: {r['registers']} registers a thread, "
            f"{r['smem_bytes']} B of shared memory a block, "
            f"{r['blocks_per_sm']} block(s) an SM")
    if not sass:
        return
    if _cuda.cuobjdump() is None:
        log("  SASS: cuobjdump not found, not read")
        return
    counts = _cuda.sass_counts(_cuda.build("fused_knn"), ("SHFL", "VOTE"))
    by_kernel = {"K1": {}, "K6": {}}
    for fn, c in counts.items():
        m = re.search(r"fused_knn_(tiled_)?kernelILi(\d)ELb(\d)E", fn)
        if m:
            key = m.group(2) + ("v" if m.group(3) == "1" else "")
            by_kernel["K6" if m.group(1) else "K1"][key] = (c["SHFL"],
                                                            c["VOTE"])
    for k, v in by_kernel.items():
        log(f"  {k} SASS (SHFL, VOTE) by instantiation: "
            f"{dict(sorted(v.items()))}")
    assert all("8v" in v and v["8v"][0] > 0 for v in by_kernel.values()), \
        by_kernel


def bound(nbytes, flops, peak_flops):
    """(least ms the card could take, what bounds it): the bytes the
    function must move over the HBM rate against its operations over the
    peak rate for their type. flops/peak_flops may be lists, one entry per
    unit the operations run on (their times add)."""
    if not isinstance(flops, (list, tuple)):
        flops, peak_flops = [flops], [peak_flops]
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = sum(f / p for f, p in zip(flops, peak_flops)) * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops
            else (t_ops, "operations"))


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def mlp_fma_per_row(block1):
    """FMAs of one neighbour row through block1 (one product per layer)."""
    return sum(l_["w"].shape[0] * l_["w"].shape[1] for l_ in block1)


def block1_ops(block1, rows, bf16):
    """([FLOP on the tensor cores, FLOP on the CUDA cores], [their peaks],
    the tensor-core unit) of K2's tile body for `rows` neighbour rows: the
    block1 products in bf16, or as three tf32 products (3xTF32) in f32
    mode; the alpha head and the K-sum (2 C FMA a row) in f32."""
    C = block1[0]["w"].shape[1]
    mm = 2.0 * rows * mlp_fma_per_row(block1)
    if bf16:
        return [mm, 4.0 * rows * C], [BF16_FLOPS, F32_FLOPS], "bf16 tensor"
    return [3 * mm, 4.0 * rows * C], [TF32_FLOPS, F32_FLOPS], "3xTF32 tensor"


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


def capture_first_call(module, name, store, on_call=None):
    """Wrap module.<name> so its first call's arguments land in `store`
    (and every call's go to `on_call`, when given); the call goes through
    to the wrapped function unchanged. Returns the original, to be put
    back."""
    fn = getattr(module, name)

    def wrapped(*args, **kw):
        if name not in store:
            store[name] = (args, kw)
        if on_call is not None:
            on_call(*args, **kw)
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


def kernel_wrappers():
    """The eight kernel wrappers, each with its `.launches` count."""
    from sgnerf_tpu_torch.ops import fused_agg, fused_knn, pallas_gather
    return [fused_knn.fused_knn_select, fused_agg.fused_block1_alpha,
            fused_agg.fused_block1_alpha_bwd,
            fused_agg.fused_block1_alpha_color,
            fused_agg.fused_block1_alpha_color_march,
            fused_knn.fused_knn_select_tiled,
            pallas_gather.gather_rows_pallas,
            pallas_gather.gather_rows_staged]


NO_GATHER = {"gather_rows_pallas": 0, "gather_rows_staged": 0}


def reset_launches():
    for fn in kernel_wrappers():
        fn.launches = 0


def read_launches():
    return {fn.__name__: fn.launches for fn in kernel_wrappers()}


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
    from sgnerf_tpu_torch.runtime.scene_model import SceneModel

    for d in ("smoke", "smoke_ft", "smoke_scans",
              "smoke_grow"):                          # this script's outputs
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
    take3d = query_mod.take3d

    def take3d_slot(table, coords, dims):       # the cache-row gather's slot
        out = take3d(table, coords, dims)
        if table is model.grid.dil_slot and "slot" not in captured:
            captured["slot"] = out
        return out
    query_mod.take3d = take3d_slot
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    col = model.render_image(item)
    frame_s = time.perf_counter() - t0
    launches = read_launches()
    query_mod.fused_knn_select, agg_mod.fused_block1_alpha = knn_fn, agg_fn
    query_mod.take3d = take3d
    n_rays = W_IMG * H_IMG
    hit_share = float(np.mean(np.any(col != 1.0, axis=-1)))
    log(f"phase 4: frame {W_IMG}x{H_IMG} in {frame_s * 1e3:.1f} ms "
        f"({n_rays / frame_s:.0f} rays/s), launches {launches}, peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"rays with neighbours {hit_share:.3f}")
    assert launches["fused_knn_select"] > 0, launches
    assert launches["fused_block1_alpha"] > 0, launches
    assert sum(launches.values()) == (launches["fused_knn_select"]
                                      + launches["fused_block1_alpha"])
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
    records = {"K1": phase5_k1(captured, launches, model.grid.nbr_packed),
               "K2": phase5_k2(captured, launches)}
    phase5_f9(torch.device("cuda"))
    # phase 11 holds K6's ids to K1's on this chunk: K1's inputs wait on
    # the host, so phases 6-8 run on the card as they did before phase 9
    k1_args, k1_kw = captured["fused_knn_select"]
    k1_host = ([t.cpu() if torch.is_tensor(t) else t for t in k1_args],
               k1_kw)
    del model, a, b, kw, captured, k1_args
    torch.cuda.empty_cache()

    # ---- 6-7. the train step, then K3 vs its plain version
    records["K3"] = phase6_7_train(item)
    torch.cuda.empty_cache()

    # ---- 8. the training CLI
    phase8_train_ft()

    # ---- 9-11. the opt-in render paths on the phase-3 scene, reloaded
    model = SceneModel(opt)
    model.load_checkpoint(model.resolve_resume())
    paths = phase9_11_frames(model, item, col, k1_host)
    del model, k1_host
    torch.cuda.empty_cache()
    # ---- 12. K4-K6 vs their plain versions
    records.update(phase12_k4_k6(paths))
    del paths
    torch.cuda.empty_cache()

    # ---- 13. the train step with the colour head in kernel K4
    phase13_train_fused_color(item)
    torch.cuda.empty_cache()

    # ---- 14. K7 and the staged form vs index_select, then the probe
    records.update(phase14_gather(torch.device("cuda")))
    torch.cuda.empty_cache()

    # ---- 15. growing at full width
    phase15_growing()

    log(json.dumps({"kernels": [records[k] for k in sorted(records)]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def phase5_k1(captured, launches, nbr_packed):
    """Phase 5, K1: ids bit-equal to the plain version's and on a rerun; its
    time (one call, as every kernel is timed; beside it the device time of
    back-to-back launches), its share of the bound, resources and SASS;
    then the cache-row gather in front of it (query.py, nbr_packed[slot])
    timed alone."""
    import torch
    from sgnerf_tpu_torch.ops import _cuda
    from sgnerf_tpu_torch.ops.fused_knn import (fused_knn_resources,
                                                fused_knn_select,
                                                fused_knn_select_plain)
    args, kwargs = captured["fused_knn_select"]
    with torch.inference_mode():
        ids = fused_knn_select(*args, **kwargs)
        ref = fused_knn_select_plain(*args, **kwargs)
        torch.cuda.synchronize()
        id_err = float((ids - ref).abs().max())
        assert torch.equal(ids, ref), int((ids != ref).sum())
        assert torch.equal(fused_knn_select(*args, **kwargs), ids)
        ms = cuda_ms(lambda: fused_knn_select(*args, **kwargs))
        dev_ms = _cuda.device_ms(lambda: fused_knn_select(*args, **kwargs))
        plain_ms = cuda_ms(lambda: fused_knn_select_plain(*args, **kwargs))
    rows, delta, ok = args[:3]
    M, C, K = rows.shape[0], kwargs["C"], kwargs["K"]
    # d2 of every candidate: 3 differences, 3 squares, 2 sums
    bound_ms, bound_by = bound(nbytes(rows, delta, ok) + M * K * 4,
                               8.0 * M * C, F32_FLOPS)
    found = float((ids >= 0).sum(dim=1).float().mean())
    log(f"phase 5: K1 fused_knn_select M={M} C={C} K={K}: ids equal, a "
        f"rerun the same bits; {ms:.4f} ms (one call) vs plain "
        f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}) = "
        f"{bound_ms / ms:.1%} of it; device time back to back {dev_ms:.4f} "
        f"ms ({bound_ms / dev_ms:.1%}); {found:.2f} of K ids found a point")
    knn_resources_and_sass(fused_knn_resources(C, 160, rows.device))
    slot = captured["slot"].reshape(-1)
    assert slot.numel() == M, (slot.numel(), M)
    max_d = nbr_packed.shape[0]
    with torch.inference_mode():
        gathered = nbr_packed[slot.clamp(0, max_d - 1).long()]
        assert torch.equal(gathered.reshape(M, -1), rows)
        g_ms = cuda_ms(lambda: nbr_packed[slot.clamp(0, max_d - 1).long()])
        g_dev = _cuda.device_ms(
            lambda: nbr_packed[slot.clamp(0, max_d - 1).long()])
    g_bound, _ = bound(nbytes(slot) + 2 * nbytes(rows), 0, F32_FLOPS)
    log(f"phase 5: the cache-row gather in front of K1 (nbr_packed[slot], "
        f"{M} rows of {rows.shape[1] * 2} B from {max_d}): {g_ms:.4f} ms "
        f"(one call; device time back to back {g_dev:.4f} ms), bound "
        f"{g_bound:.4f} ms (bytes: the slots and rows read, the rows "
        f"written) = {g_bound / g_ms:.1%}; K1 reading rows by slot would "
        f"not write and read back {2 * nbytes(rows) / 1e6:.1f} MB")
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
    in_bytes = nbytes(feat, d, w, *weights) + feat.shape[0] * (C + 1) * 4
    bounds = {}
    for bf16 in (True, False):
        flops, peaks, unit = block1_ops(block1, rows, bf16)
        bounds[bf16] = bound(in_bytes, flops, peaks)
        log(f"phase 5: K2 bf16={bf16} bound {bounds[bf16][0]:.3f} ms "
            f"({bounds[bf16][1]}: {flops[0] / 1e9:.0f} GFLOP on the {unit} "
            f"cores at {peaks[0] / 1e12:.0f} TFLOP/s + the f32 head); "
            f"kernel {errs[bf16][1]:.3f} ms = "
            f"{bounds[bf16][0] / errs[bf16][1]:.1%} of it")
    bound_ms, bound_by = bounds[main_bf16]
    phase5_k2_yardsticks(args, kwargs)
    return {"name": "fused_block1_alpha", "route": "cuda",
            "source": "sgnerf_tpu_torch/csrc/fused_agg.cu",
            "replaces": "sgnerf_tpu/ops/fused_agg.py:724",
            "launches": launches["fused_block1_alpha"],
            "max_abs_err": err, "ms": t_k, "plain_ms": t_p,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def phase5_k2_yardsticks(args, kwargs):
    """Phase 5: what judges K2's design beside its bound: cuBLAS's time for
    block1's bf16 products at the chunk's shape (torch.matmul; no single
    PyTorch call computes K2, so library_ms stays null), K2's registers,
    shared memory and blocks an SM in each mode, and whether its SASS
    holds tensor-core instructions."""
    import torch
    from sgnerf_tpu_torch.ops import _cuda
    from sgnerf_tpu_torch.ops.fused_agg import fused_block1_alpha_resources
    feat, d, _, block1, _ = args
    rows = feat.shape[0] * feat.shape[1]
    in0 = block1[0]["w"].shape[0]
    with torch.inference_mode():
        x = torch.randn(rows, in0, device=feat.device).to(torch.bfloat16)
        ws = [l_["w"].to(torch.bfloat16) for l_ in block1]

        def products():
            h = x
            for wl in ws:
                h = torch.matmul(h, wl)
            return h
        t_mm = cuda_ms(products)
        del x
    log(f"phase 5: cuBLAS yardstick, block1's {len(ws)} bf16 products at "
        f"the chunk's shape ({rows}, {in0}) x "
        f"{[tuple(wl.shape) for wl in ws]} through torch.matmul: "
        f"{t_mm:.3f} ms")
    for bf16 in (True, False):
        res = fused_block1_alpha_resources(
            feat.shape[-1], kwargs["nf"], d.shape[-1], kwargs["df"],
            block1[0]["w"].shape[1], bf16, feat.device)
        log(f"phase 5: K2 bf16={bf16} resources: {res['registers']} "
            f"registers a thread, {res['smem_bytes']} B of shared memory "
            f"a block, {res['blocks_per_sm']} block(s) of 256 threads an SM")
    lib = _cuda.build("fused_agg")
    if _cuda.cuobjdump() is not None:
        ops = ("HGMMA", "HMMA")
        by_fn = _cuda.sass_counts(lib, ops).values()
        counts = {op: sum(c[op] for c in by_fn) for op in ops}
        log(f"phase 5: K2 SASS ({os.path.basename(lib)}): tensor-core "
            f"instructions {counts}")
        assert counts["HGMMA"] + counts["HMMA"] > 0, counts
    else:
        log("phase 5: K2 SASS: cuobjdump not found, not checked")


def phase5_f9(dev):
    """Phase 5: K2's f32 mode at tests/test_fused_agg.py's inputs (the same
    draws; the port's seeded init for the weights) against that file's own
    limits: features and alpha (test_fused_pads_nonmultiple_rows: M = 35,
    d * 0.01), aggregate()'s decoded output (test_fused_matches_xla_forward:
    7 rays of 5 samples), the IEEE f32 plain path on the other side."""
    import torch
    from sgnerf_tpu_torch.models.aggregator import (AggregatorConfig,
                                                    aggregate,
                                                    init_aggregator_params)
    from sgnerf_tpu_torch.ops.fused_agg import (fused_block1_alpha,
                                                fused_block1_alpha_plain)
    cfg = AggregatorConfig()
    rng = np.random.default_rng(2)
    M, K = 35, 8
    feat = rng.normal(size=(M, K, 32)).astype(np.float32) * 0.2
    d = rng.normal(size=(M, K, 6)).astype(np.float32) * 0.01
    w = rng.random((M, K)).astype(np.float32)
    p = init_aggregator_params(3, cfg, device=dev)
    args = [torch.from_numpy(a).to(dev) for a in (feat, d, w)] + [
        p["block1"], p["alpha_branch"]]
    kw = dict(K=K, nf=3, df=5, bf16=False)
    errs = {}
    with torch.inference_mode():
        got = fused_block1_alpha(*args, **kw)
        ref = fused_block1_alpha_plain(*args, **kw)
        for key, a, b in zip(("features", "alpha"), got, ref):
            errs[key] = float((a - b).abs().max())
        rng = np.random.default_rng(0)      # test_fused_agg.py _agg_inputs
        B, R, SR = 1, 7, 5

        def mk(shape):
            return torch.from_numpy(
                rng.normal(size=shape).astype(np.float32)).to(dev)
        mask = torch.from_numpy(rng.random((B, R, SR, K)) < 0.5).to(dev)
        emb = mk((B, R, SR, K, 32)) * 0.2
        mk((B, R, SR, K, 3)), mk((B, R, SR, K, 3))   # colour, direction
        akw = dict(sampled_embedding=emb,
                   sampled_conf=mk((B, R, SR, K, 1)).abs(),
                   sampled_xyz=mk((B, R, SR, K, 3)),
                   sampled_xyz_pers=mk((B, R, SR, K, 3)),
                   sample_pnt_mask=mask, sample_loc=mk((B, R, SR, 3)),
                   sample_loc_w=mk((B, R, SR, 3)),
                   sample_ray_dirs=mk((B, R, SR, 3)), Rw2c=None,
                   vsize=(0.008,) * 3)
        p = init_aggregator_params(0, cfg, device=dev)
        a = aggregate(p, dataclasses.replace(cfg, fused_mlp="cuda"), **akw)
        b = aggregate(p, cfg, **akw)
        errs["decoded"] = float((a[0] - b[0]).abs().max())
    log("phase 5: F9, K2 f32 at tests/test_fused_agg.py's inputs: max |diff| "
        + ", ".join(f"{k} {v:.3e} (limit {F9_LIMITS[k]})"
                    for k, v in errs.items()))
    assert all(errs[k] <= F9_LIMITS[k] for k in errs), errs


def phase9_11_frames(model, item, col, k1_host):
    """Phases 9-11: the phase-4 frame through the three opt-in render
    paths. Returns, per kernel, the first chunk's captured arguments of the
    path that carries it and the launch counts of its frame."""
    import torch
    from sgnerf_tpu_torch.models import aggregator as agg_mod
    from sgnerf_tpu_torch.ops import query as query_mod

    base = model.cfg
    n_chunks = -(-W_IMG * H_IMG // 9216)
    rep = dataclasses.replace
    k6_want = {"fused_knn_select_tiled": n_chunks, "fused_knn_select": 0,
               "fused_block1_alpha": n_chunks}
    paths = [
        ("K4", 9, rep(base, agg=rep(base.agg, fused_color=True)), agg_mod,
         "fused_block1_alpha_color",
         {"fused_block1_alpha_color": n_chunks,
          "fused_knn_select": n_chunks, "fused_block1_alpha": 0}),
        ("K5", 10, rep(base, agg=rep(base.agg, fused_march=True)), agg_mod,
         "fused_block1_alpha_color_march",
         {"fused_block1_alpha_color_march": n_chunks,
          "fused_knn_select": n_chunks, "fused_block1_alpha_color": 0,
          "fused_block1_alpha": 0}),
        ("K6", 11, rep(base, knn_mode="dedup"), query_mod,
         "fused_knn_select_tiled", k6_want),
        # tiles of dedup_cap // SR rays hold no more shading points than
        # the cap, so none can overflow and the frame must be phase 4's
        (None, 11, rep(base, knn_mode="dedup",
                       dedup_tile=base.dedup_cap // base.SR), query_mod,
         "fused_knn_select_tiled", k6_want),
    ]
    out = {}
    for key, phase, cfg, module, name, want in paths:
        store, over = {}, []

        def count_overflow(rows, inv, delta, ok, r2, **kw):
            over.append(((inv == kw["U"]) & ok).sum())
        orig = capture_first_call(module, name, store,
                                  count_overflow if phase == 11 else None)
        orig_tu = capture_first_call(query_mod, "tile_unique", store)
        model.cfg = cfg
        try:
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            img = model.render_image(item)
            frame_s = time.perf_counter() - t0
            launches = read_launches()
        finally:
            setattr(module, name, orig)
            query_mod.tile_unique = orig_tu
            model.cfg = base
        diff = float(np.abs(img - col).max())
        tiles = (f" (dedup_tile {cfg.dedup_tile} rays, dedup_cap "
                 f"{cfg.dedup_cap})" if phase == 11 else "")
        log(f"phase {phase}: {name} frame {W_IMG}x{H_IMG}{tiles} in "
            f"{frame_s * 1e3:.1f} ms ({W_IMG * H_IMG / frame_s:.0f} rays/s), "
            f"launches {launches}, max |diff| to the phase-4 frame {diff:.3e}"
            f" (tolerance {RENDER_ATOL})")
        assert all(launches[k] == v for k, v in want.items()), (want,
                                                                 launches)
        assert np.isfinite(img).all()
        n_over = int(sum(over)) if phase == 11 else 0
        if phase == 11:
            phase11_ids(store, name, k1_host, n_over)
        if key is None:
            assert n_over == 0, n_over
        if n_over == 0:
            assert diff <= RENDER_ATOL, (name, diff)
        if key is not None:
            out[key] = (store[name], launches)
    return out


def phase11_ids(store, name, k1_host, n_over):
    """Phase 11 on the first chunk: the distinct cache rows per tile, and
    K6's ids against K1's on phase 4's inputs of the same chunk (k1_host):
    equal on every shading point whose row is within its tile's cap, -1 on
    every other."""
    import torch
    from sgnerf_tpu_torch.ops.fused_knn import (fused_knn_select,
                                                fused_knn_select_tiled,
                                                tile_unique)
    args, kw = store[name]
    inv, ok = args[1], args[3]
    T, U = kw["T"], kw["U"]
    # a cap of T rows cannot overflow: it lists every distinct row
    slot, slot_ok = store["tile_unique"][0][:2]
    distinct = (tile_unique(slot, slot_ok, T, T)[0] >= 0).sum(dim=1).float()
    tile_over = (distinct > U).sum()
    log(f"phase 11: tiles of T={T} points, cap U={U}: shading points past "
        f"the cap {n_over} in the frame; first chunk: distinct cache rows "
        f"a tile median {float(distinct.median()):.0f}, max "
        f"{float(distinct.max()):.0f}; {int(tile_over)} of "
        f"{distinct.numel()} tiles over the cap")
    k1_args, k1_kw = k1_host
    k1_args = [t.to(inv.device) if torch.is_tensor(t) else t
               for t in k1_args]
    Mq = k1_args[0].shape[0]
    with torch.inference_mode():
        ids6 = fused_knn_select_tiled(*args, **kw)[:Mq]
        ids1 = fused_knn_select(*k1_args, **k1_kw)
    within = inv[:Mq] < U
    lost = (~within & ((ids1 >= 0).any(dim=-1))).sum()
    log(f"phase 11: first chunk, K6 ids vs K1 ids on the "
        f"{int(within.sum())} of {Mq} points that hold a row of their "
        f"tile (inv < U): {int((ids6[within] != ids1[within]).sum())} "
        f"differ; {int(lost)} points past the cap lose the neighbours K1 "
        f"finds")
    assert torch.equal(ids6[within], ids1[within])
    assert bool((ids6[~within] == -1).all())


def color_sound_ref(key, args, kw):
    """K4: the K2 kernel's (reduced rows, alpha), then the plain colour head
    -> ((M, 4) [alpha | logits], reduced rows). K5: the K4 kernel's
    outputs, then the plain march -> ((M/SR, 4), None)."""
    import torch
    from sgnerf_tpu_torch.ops import fused_agg
    feat, d, w, vd = args[:4]
    block1, alpha, color = args[-3:]
    common = dict(K=kw["K"], nf=kw["nf"], df=kw["df"], bf16=kw["bf16"])
    if key == "K4":
        fa, al = fused_agg.fused_block1_alpha(feat, d, w, block1, alpha,
                                              **common)
        hc = fused_agg.color_tail_plain(fa, vd, color, vf=kw["vf"],
                                        bf16=kw["bf16"])
        return torch.cat([al, hc], dim=-1), fa
    al, hc = fused_agg.fused_block1_alpha_color(
        feat, d, w, vd, block1, alpha, color, vf=kw["vf"], **common)
    return fused_agg.march_tail_plain(al, hc, args[4], args[5],
                                      SR=kw["SR"]), None


def color_flips(fa_a, fa_b, vd, color, vf):
    """The plain bf16 colour head on two sets of reduced rows: per layer,
    how many inputs round to another bf16 value, and the logits' max
    |diff|."""
    import torch
    from sgnerf_tpu_torch.ops.fused_agg import leaky_relu, matmul
    from sgnerf_tpu_torch.ops.pe import positional_encoding
    pe = positional_encoding(vd, vf, ori=True)[..., 3:]
    xs = [torch.cat([fa, pe], dim=-1) for fa in (fa_a, fa_b)]
    flips = []
    for i, layer in enumerate(color):
        ra, rb = (x.to(torch.bfloat16) for x in xs)
        flips.append(int((ra != rb).sum()))
        xs = [matmul(x, layer["w"], True) + layer["b"] for x in xs]
        if i < len(color) - 1:
            xs = [leaky_relu(x) for x in xs]
    return flips, float((xs[0] - xs[1]).abs().max())


def phase12_sound_bf16(key, args, kwargs, got_bf16, got_f32):
    """Phase 12, bf16: K4 against the plain colour head on the K2 kernel's
    reduced rows, K5 against the plain march on K4's outputs; the limit
    must lie below the gap between the kernel's bf16 and f32 modes, so
    that a kernel that never rounds fails. For K4, where the bf16
    difference to the plain version comes from: the flips of the plain
    colour head's bf16 roundings between K2's and the plain reduced
    rows."""
    import torch
    from sgnerf_tpu_torch.ops.fused_agg import fused_block1_alpha_plain
    kw = {k: v for k, v in kwargs.items() if k != "bwd"}
    kw["bf16"] = True
    tol = COLOR_SOUND_TOL[key]
    ref, fa_k2 = color_sound_ref(key, args, kw)
    torch.cuda.synchronize()
    err = float((got_bf16 - ref).abs().max())
    gap = float((got_bf16 - got_f32).abs().max())
    limit = tol["atol"] + tol["rtol"] * float(ref.abs().max())
    what = ("the plain colour head on K2's reduced rows" if key == "K4"
            else "the plain march on K4's outputs")
    log(f"phase 12: {key} bf16 vs {what}: max |diff| {err:.3e} (tolerance "
        f"{tol}); kernel bf16 vs f32 mode: max |diff| {gap:.3e}")
    if key == "K4":
        feat, d, w, vd = args[:4]
        block1, alpha, color = args[-3:]
        fa_p, _ = fused_block1_alpha_plain(
            feat, d, w, block1, alpha, K=kw["K"], nf=kw["nf"], df=kw["df"],
            bf16=True)
        flips, dlog = color_flips(fa_k2, fa_p, vd, color, kw["vf"])
        log(f"phase 12: K4 bf16, the plain colour head on K2's vs the plain "
            f"reduced rows (max |diff| {float((fa_k2 - fa_p).abs().max()):.3e}"
            f"): inputs rounding to another bf16 value per colour layer "
            f"{flips} of {fa_k2.shape[0]} x {[l_['w'].shape[0] for l_ in color]}"
            f"; logits max |diff| {dlog:.3e}; K4 alpha equals K2's: "
            f"{torch.equal(got_bf16[:, :1], ref[:, :1])}")
    assert torch.allclose(got_bf16, ref, **tol), (key, err)
    assert gap > limit, (key, gap, limit)


def phase12_k4_k6(paths):
    """Phase 12: K4, K5 and K6 against their plain versions on the first
    chunk's inputs of phases 9-11; returns their records."""
    import torch
    from sgnerf_tpu_torch.ops import _cuda, fused_agg, fused_knn

    records = {}
    for key, entry in (("K4", "fused_block1_alpha_color"),
                       ("K5", "fused_block1_alpha_color_march")):
        (args, kwargs), launches = paths[key]
        kernel = getattr(fused_agg, entry)
        plain = getattr(fused_agg, entry + "_plain")
        plain_kw = {k: v for k, v in kwargs.items() if k != "bwd"}

        def run(fn, **kw):        # K4's (alpha, rgb) as one (M, 4) tensor
            out = fn(*args, **kw)
            return torch.cat(out, dim=-1) if isinstance(out, tuple) else out
        res = {}
        with torch.inference_mode():
            for bf16 in (False, True):
                kw2, kwp = dict(kwargs, bf16=bf16), dict(plain_kw, bf16=bf16)
                got, ref = run(kernel, **kw2), run(plain, **kwp)
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                ok = torch.allclose(got, ref, **K2_TOL[bf16])
                t_k = cuda_ms(lambda: kernel(*args, **kw2))
                t_p = cuda_ms(lambda: plain(*args, **kwp))
                log(f"phase 12: {key} {entry} bf16={bf16} M="
                    f"{args[0].shape[0]}: max |diff| {err:.3e} (max |ref| "
                    f"{float(ref.abs().max()):.3f}, tolerance "
                    f"{K2_TOL[bf16]}); {t_k:.3f} ms vs plain {t_p:.3f} ms")
                assert ok, (key, bf16, err)
                res[bf16] = (err, t_k, t_p, got)
            phase12_sound_bf16(key, args, kwargs, res[True][3], res[False][3])
            assert torch.equal(run(kernel, **kwargs), run(kernel, **kwargs))
        err, t_k, t_p, _ = res[bool(kwargs["bf16"])]
        feat = args[0]
        block1, alpha, color = args[-3:]
        M, rows = feat.shape[0], feat.shape[0] * feat.shape[1]
        weights = [t for l_ in block1 + alpha + color for t in l_.values()]
        out_bytes = M * 16 if key == "K4" else M // kwargs["SR"] * 16
        # block1 on the tensor cores (K2's body), the colour head in f32
        flops, peaks, unit = block1_ops(block1, rows,
                                        bool(kwargs["bf16"]))
        flops[1] += 2.0 * M * mlp_fma_per_row(color)
        bound_ms, bound_by = bound(
            nbytes(*args[:-3], *weights) + out_bytes, flops, peaks)
        log(f"phase 12: {key} bound {bound_ms:.3f} ms ({bound_by}: "
            f"{flops[0] / 1e9:.0f} GFLOP on the {unit} cores + "
            f"{flops[1] / 1e9:.1f} GFLOP in f32); reruns bit-identical")
        records[key] = {
            "name": entry, "route": "cuda",
            "source": "sgnerf_tpu_torch/csrc/fused_agg_color.cu",
            "replaces": ("sgnerf_tpu/ops/fused_agg.py:741" if key == "K4"
                         else "sgnerf_tpu/ops/fused_agg.py:267"),
            "launches": launches[entry], "max_abs_err": err, "ms": t_k,
            "plain_ms": t_p, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}

    (args, kwargs), launches = paths["K6"]
    with torch.inference_mode():
        ids = fused_knn.fused_knn_select_tiled(*args, **kwargs)
        ref = fused_knn.fused_knn_select_tiled_plain(*args, **kwargs)
        torch.cuda.synchronize()
        assert torch.equal(ids, ref), int((ids != ref).sum())
        assert torch.equal(fused_knn.fused_knn_select_tiled(*args, **kwargs),
                           ids)
        ms = cuda_ms(lambda: fused_knn.fused_knn_select_tiled(*args,
                                                              **kwargs))
        dev_ms = _cuda.device_ms(
            lambda: fused_knn.fused_knn_select_tiled(*args, **kwargs))
        plain_ms = cuda_ms(lambda: fused_knn.fused_knn_select_tiled_plain(
            *args, **kwargs))
    rows, inv, delta, ok = args[:4]
    M, C, K, U = inv.shape[0], kwargs["C"], kwargs["K"], kwargs["U"]
    bound_ms, bound_by = bound(nbytes(rows, inv, delta, ok) + M * K * 4,
                               8.0 * M * C, F32_FLOPS)
    res = fused_knn.fused_knn_resources(C, U, rows.device)
    sms = torch.cuda.get_device_properties(rows.device).multi_processor_count
    log(f"phase 12: K6 fused_knn_select_tiled M={M} T={kwargs['T']} "
        f"U={U} ({rows.shape[0]} distinct-row slots, "
        f"{nbytes(rows) / 1e6:.1f} MB): ids equal, a rerun the same bits; "
        f"{ms:.4f} ms (one call) vs plain {plain_ms:.3f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}) = {bound_ms / ms:.1%} of it; device "
        f"time back to back {dev_ms:.4f} ms ({bound_ms / dev_ms:.1%}); a "
        f"persistent grid of at most {sms * res['K6']['blocks_per_sm']} "
        f"blocks ({sms} SMs)")
    knn_resources_and_sass(res, sass=False)
    records["K6"] = {
        "name": "fused_knn_select_tiled", "route": "cuda",
        "source": "sgnerf_tpu_torch/csrc/fused_knn.cu",
        "replaces": "sgnerf_tpu/ops/fused_knn.py:183",
        "launches": launches["fused_knn_select_tiled"],
        "max_abs_err": float((ids - ref).abs().max()), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}
    return records


def train_batch(item, device, R=32 * 32):
    """R random rays of the frame's camera with seeded target colours."""
    from sgnerf_tpu_torch.runtime.scene_model import batch_to_device
    rng = np.random.default_rng(6)
    pick = rng.choice(len(item["raydir"]), size=R, replace=False)
    return batch_to_device(dict(
        item, raydir=item["raydir"][pick],
        gt_image=rng.uniform(0, 1, (R, 3)).astype(np.float32)), device)


def step_diff(model, cfg, ref_cfg, batch, seed=11, on_branches=False):
    """One step's losses and gradients under cfg and under ref_cfg, from the
    same state and noise: (relative loss difference, worst gradient
    max|diff| / max|ref|). With on_branches (ref_cfg un-fused), the
    reference's block1 takes the LeakyReLU branches of the forward cfg ran
    (unfused_block1_on_branches); returns also the worst gradient
    difference on its own branches and the flips per layer."""
    import torch
    from sgnerf_tpu_torch.models import aggregator as agg_mod
    from sgnerf_tpu_torch.models.renderer import draw_render_noise
    from sgnerf_tpu_torch.models.train import loss_and_grads
    from sgnerf_tpu_torch.ops.fused_agg import k3a_recompute

    def run(c, store=None):
        gen = torch.Generator(device=model.device).manual_seed(seed)
        noise = draw_render_noise(gen, cfg, 1, batch["raydir"].shape[1])
        fn = (None if store is None else
              capture_first_call(agg_mod, "fused_block1_alpha", store))
        try:
            loss, g_net, g_pts = loss_and_grads(model.state, model.grid, c,
                                                model.tcfg, batch,
                                                noise=noise)
        finally:
            if fn is not None:
                agg_mod.fused_block1_alpha = fn
        return float(loss["total"]), g_net + g_pts

    def worst(got, ref):
        return max(float((a - b).abs().max()) / float(b.abs().max())
                   for a, b in zip(got, ref) if float(b.abs().max()) > 0)
    store = {} if on_branches else None
    lk, gk = run(cfg, store)
    lp, gp = run(ref_cfg)
    loss_err = abs(lk - lp) / abs(lp)
    if not on_branches:
        return loss_err, worst(gk, gp)
    (feat, d, _, block1, alpha), kw = store["fused_block1_alpha"]
    hs = k3a_recompute(feat.detach(), d.detach(),
                       [{k: v.detach() for k, v in l_.items()}
                        for l_ in block1],
                       [{k: v.detach() for k, v in l_.items()}
                        for l_ in alpha],
                       nf=kw["nf"], df=kw["df"], bf16=kw["bf16"])[1]
    flips = []
    with unfused_block1_on_branches(agg_mod, hs, flips):
        lb, gb = run(ref_cfg)
    assert abs(lb - lp) <= LOSS_RTOL * abs(lp), (lb, lp)
    return loss_err, worst(gk, gb), worst(gk, gp), flips


@contextlib.contextmanager
def unfused_block1_on_branches(agg_mod, hs, flips):
    """The un-fused path's block1 (aggregator._mlp_apply on the block1
    input) taking at every LeakyReLU the branch of hs (L, N, C), the
    activations of the forward the kernel path ran (K3a's, K2's bit for
    bit): where its own pre-activation lies on the other side of zero, it
    takes hs's slope. Appends to `flips`, per layer, the count of such
    activations and whether each lies within K2_TOL of the kernel's."""
    import torch
    from sgnerf_tpu_torch.ops.fused_agg import matmul
    orig = agg_mod._mlp_apply

    def apply(cfg, layers, x, act_last=True):
        if (x.shape[-1] != cfg.block1_in or len(layers) != hs.shape[0]
                or not act_last):
            return orig(cfg, layers, x, act_last)
        bf16 = cfg.compute_dtype == "bfloat16"
        for layer, h in zip(layers, hs):
            z = matmul(x, layer["w"], bf16) + layer["b"]
            pos = h.view(z.shape) >= 0
            flip = pos != (z >= 0)
            zk = torch.where(pos, h.view(z.shape), h.view(z.shape) / 0.01)
            flips.append((int(flip.sum()), bool(torch.allclose(
                z.detach()[flip], zk[flip], **K2_TOL[bf16]))))
            x = torch.where(pos, z, 0.01 * z)
        return x
    agg_mod._mlp_apply = apply
    try:
        yield
    finally:
        agg_mod._mlp_apply = orig


def phase13_train_fused_color(item):
    """Phase 13: the phase-6 train step with --fused_color on."""
    import torch
    from sgnerf_tpu_torch.options import TrainOptions
    from sgnerf_tpu_torch.runtime.scene_model import SceneModel

    opt = TrainOptions().parse(TRAIN_FLAGS + [
        "--fused_color", "on", "--name", "smoke",
        "--checkpoints_dir", os.path.join(REPO, "build")])
    model = SceneModel(opt)
    model.load_checkpoint(model.resolve_resume())
    cfg = model.cfg
    assert cfg.agg.fused_color and cfg.agg.fused_bwd == "cuda"
    batch = train_batch(item, model.device)
    k2_cfg = dataclasses.replace(
        cfg, agg=dataclasses.replace(cfg.agg, fused_color=False))
    loss_err, grad_err = step_diff(model, cfg, k2_cfg, batch)
    log(f"phase 13: one step, K4 + K2 + K3 vs phase 6's K2 + K3: loss rel "
        f"diff {loss_err:.3e} (tolerance {LOSS_RTOL}), worst gradient "
        f"max|diff| / max|ref| {grad_err:.3e} (tolerance {K3_TOL[False]})")
    assert loss_err <= LOSS_RTOL and grad_err <= K3_TOL[False]
    torch.cuda.synchronize()
    reset_launches()
    losses, step_ms = [], []
    for _ in range(FUSED_COLOR_STEPS):
        t0 = time.perf_counter()
        out = model.optimize(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(out["total"]))
    launches = read_launches()
    log(f"phase 13: {FUSED_COLOR_STEPS} steps with --fused_color on: losses "
        f"{[round(v, 6) for v in losses]}, step ms "
        f"{[round(v, 1) for v in step_ms]}, launches {launches}")
    n = FUSED_COLOR_STEPS
    assert np.isfinite(losses).all()
    assert launches == {"fused_knn_select": 0, "fused_block1_alpha": n,
                        "fused_block1_alpha_bwd": n,
                        "fused_block1_alpha_color": n,
                        "fused_block1_alpha_color_march": 0,
                        "fused_knn_select_tiled": 0, **NO_GATHER}, launches


def phase6_7_train(item):
    """Phase 6 (the train step at full width) and phase 7 (K3 vs plain);
    returns K3's record."""
    import torch
    from sgnerf_tpu_torch.models import aggregator as agg_mod
    from sgnerf_tpu_torch.options import TrainOptions
    from sgnerf_tpu_torch.ops.fused_agg import (fused_block1_alpha_bwd,
                                                fused_block1_alpha_bwd_plain)
    from sgnerf_tpu_torch.runtime.scene_model import SceneModel

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

    batch = train_batch(item, model.device)
    R = batch["raydir"].shape[1]

    captured = {}
    agg_fn = capture_first_grad(agg_mod, "fused_block1_alpha", captured)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        out = model.optimize(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(out["total"]))
    launches = read_launches()
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
                        "fused_block1_alpha_bwd": TRAIN_STEPS,
                        "fused_block1_alpha_color": 0,
                        "fused_block1_alpha_color_march": 0,
                        "fused_knn_select_tiled": 0, **NO_GATHER}, launches

    profile_call("phase 6: profiled step", lambda: model.optimize(batch))

    # the same step through the kernels and through the un-fused path
    plain_cfg = dataclasses.replace(
        cfg, agg=dataclasses.replace(cfg.agg, fused_mlp="none"))
    loss_err, grad_err, grad_own, flips = step_diff(
        model, cfg, plain_cfg, batch, on_branches=True)
    log(f"phase 6: one step, kernel path vs un-fused path: loss rel diff "
        f"{loss_err:.3e} (tolerance {LOSS_RTOL}), worst gradient max|diff| "
        f"/ max|plain| {grad_err:.3e} with the un-fused block1 on the "
        f"kernel forward's LeakyReLU branches (tolerance {K3_TOL[False]}), "
        f"{grad_own:.3e} on its own; activations on the other branch, per "
        f"layer (count, within K2_TOL): {flips}")
    assert loss_err <= LOSS_RTOL and grad_err <= K3_TOL[False]
    assert flips and all(ok for _, ok in flips), flips
    del model, batch
    torch.cuda.empty_cache()

    # ---- 7. K3 vs its plain version on the captured step
    feat, d, w, block1, alpha = captured["args"]
    g = captured["g"]
    kw = {k: v for k, v in captured["kw"].items() if k not in ("bf16", "bwd")}
    res = {}
    for bf16 in (False, True):
        got = _flat_grads(fused_block1_alpha_bwd(feat, d, w, block1, alpha,
                                                 g, bf16=bf16, **kw))
        hs_k = phase7_k3a_is_k2(feat, d, w, block1, alpha, kw, bf16)
        ref = _flat_grads(fused_block1_alpha_bwd_plain(
            feat, d, w, block1, alpha, g, bf16=bf16, branches=hs_k, **kw))
        own = _flat_grads(fused_block1_alpha_bwd_plain(
            feat, d, w, block1, alpha, g, bf16=bf16, **kw))
        torch.cuda.synchronize()
        rel = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
               for a, b in zip(got, ref)]
        rel_own = [float((a - b).abs().max())
                   / max(float(b.abs().max()), 1e-30)
                   for a, b in zip(got, own)]
        err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        del ref, own, hs_k
        t_k = cuda_ms(lambda: fused_block1_alpha_bwd(
            feat, d, w, block1, alpha, g, bf16=bf16, **kw))
        t_p = cuda_ms(lambda: fused_block1_alpha_bwd_plain(
            feat, d, w, block1, alpha, g, bf16=bf16, **kw))
        log(f"phase 7: K3 fused_block1_alpha_bwd bf16={bf16} M="
            f"{feat.shape[0]} K={kw['K']}: max |diff| / max |plain| per "
            f"output against the plain K3 in f32 on the forward's branches "
            f"{[f'{v:.2e}' for v in rel]} (tolerance {K3_TOL[bf16]}); "
            f"against the plain K3 on its own branches "
            f"{[f'{v:.2e}' for v in rel_own]}; {t_k:.3f} ms vs plain "
            f"{t_p:.3f} ms")
        res[bf16] = (err, t_k, t_p, rel)
    again = fused_block1_alpha_bwd(feat, d, w, block1, alpha, g, bf16=False,
                                   **kw)
    first = fused_block1_alpha_bwd(feat, d, w, block1, alpha, g, bf16=False,
                                   **kw)
    assert all(torch.equal(a, b) for a, b in zip(_flat_grads(again),
                                                  _flat_grads(first)))
    log(f"phase 7: K3 reruns at the full shape ({feat.shape[0]} points x "
        f"{kw['K']}) are bit-identical")
    bound_ms, bound_by, t_lib = phase7_k3_parts(feat, d, w, block1, alpha,
                                                g, kw)
    for bf16, (_, _, _, rel) in res.items():   # after the per-launch lines
        assert max(rel) <= K3_TOL[bf16], (bf16, rel)
    err, t_k, t_p, _ = res[False]
    return {"name": "fused_block1_alpha_bwd", "route": "cuda",
            "source": "sgnerf_tpu_torch/csrc/fused_agg_bwd.cu",
            "replaces": "sgnerf_tpu/ops/fused_agg.py:523",
            "launches": launches["fused_block1_alpha_bwd"],
            "max_abs_err": err, "ms": t_k, "plain_ms": t_p,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": t_lib}


def phase7_k3a_is_k2(feat, d, w, block1, alpha, kw, bf16):
    """Phase 7: K3a's last activations, weighted and summed over K in
    order, equal K2's features bit for bit (the backward reads the
    forward's activations); the activations on the other LeakyReLU branch
    than the plain recompute's, layer by layer, each within K2_TOL of it.
    Returns K3a's activations."""
    import torch
    from sgnerf_tpu_torch.ops.fused_agg import (fused_block1_alpha,
                                                k3a_recompute,
                                                k3a_recompute_plain)
    akw = dict(nf=kw["nf"], df=kw["df"], bf16=bf16)
    fa, _ = fused_block1_alpha(feat, d, w, block1, alpha, K=kw["K"], **akw)
    hs_k = k3a_recompute(feat, d, block1, alpha, **akw)[1]
    hw = hs_k[-1].view(*w.shape, -1) * w[..., None]
    s = torch.zeros_like(fa)
    for k in range(kw["K"]):
        s = s + hw[:, k]
    hs_p = k3a_recompute_plain(feat, d, block1, alpha, **akw)[1]
    flip = (hs_k >= 0) != (hs_p >= 0)
    near = bool(torch.allclose(hs_k[flip], hs_p[flip], **K2_TOL[bf16]))
    log(f"phase 7: bf16={bf16} K3a's last activations summed as K2 sums "
        f"them equal K2's features bit for bit: {torch.equal(s, fa)}; "
        f"activations on the other LeakyReLU branch than the plain "
        f"recompute's, per layer, {[int(f.sum()) for f in flip]} of "
        f"{hs_p[0].numel()} a layer, within K2_TOL of it: {near}")
    assert torch.equal(s, fa) and near
    return hs_k


def phase7_k3_parts(feat, d, w, block1, alpha, g, kw):
    """Phase 7 on the captured step: K3's three launches against their
    plain statements and timed alone (f32 and bf16), K3's bound by unit,
    the torch.matmul yardstick of its four products, its resources and
    K3b's SASS. Returns (bound ms, bound by, yardstick ms)."""
    import torch
    from sgnerf_tpu_torch.ops import _cuda
    from sgnerf_tpu_torch.ops.fused_agg import (
        fused_block1_alpha_bwd_resources, k3a_recompute, k3a_recompute_plain,
        k3b_data_grads, k3b_data_grads_plain, k3c_weight_grads,
        k3c_weight_grads_plain)
    K, nf, df = kw["K"], kw["nf"], kw["df"]
    Fd = feat.shape[-1]
    for bf16 in (False, True):
        a_kw = dict(nf=nf, df=df, bf16=bf16)
        b_kw = dict(K=K, nf=nf, df=df, F=Fd, bf16=bf16)
        xa = k3a_recompute(feat, d, block1, alpha, **a_kw)
        pa = k3a_recompute_plain(feat, d, block1, alpha, **a_kw)
        xb = k3b_data_grads(*pa, w, g, block1, alpha, **b_kw)
        pb = k3b_data_grads_plain(*pa, w, g, block1, alpha, **b_kw)
        xc = k3c_weight_grads(pa[0], pa[1], pb[3], pb[4], bf16=bf16)
        pc = k3c_weight_grads_plain(pa[0], pa[1], pb[3], pb[4], bf16=bf16)
        torch.cuda.synchronize()
        ea = [float((a - b).abs().max()) for a, b in zip(xa, pa)]
        # activations whose LeakyReLU branch K3a and the plain version take
        # differently: the backward's slope differs there
        flips = int(((xa[1] >= 0) != (pa[1] >= 0)).sum())
        oka = all(torch.allclose(a, b, **K2_TOL[bf16]) for a, b in zip(xa, pa))
        gb = list(xb[:4]) + [xb[4].sum(0)]
        rb = list(pb[:4]) + [pb[4].sum(0)]
        eb = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
              for a, b in zip(gb, rb)]
        ec = float((xc - pc).abs().max()) / float(pc.abs().max())
        ms = [cuda_ms(lambda: k3a_recompute(feat, d, block1, alpha, **a_kw)),
              cuda_ms(lambda: k3b_data_grads(*pa, w, g, block1, alpha,
                                             **b_kw)),
              cuda_ms(lambda: k3c_weight_grads(pa[0], pa[1], pb[3], pb[4],
                                               bf16=bf16))]
        log(f"phase 7: K3 bf16={bf16} launches: K3a {ms[0]:.3f} ms, max "
            f"|diff| x/h/raw {[f'{v:.2e}' for v in ea]} (tolerance "
            f"{K2_TOL[bf16]}), {flips} of {pa[1].numel()} activations on "
            f"the other branch; K3b {ms[1]:.3f} ms, max |diff| / max |plain| "
            f"dfeat/dd/dw/dh/[dwa|dba] {[f'{v:.2e}' for v in eb]} "
            f"(tolerance {K3_TOL[bf16]}); K3c {ms[2]:.3f} ms, max |diff| / "
            f"max |plain| {ec:.2e} (tolerance {K3C_RTOL}); sum "
            f"{sum(ms):.3f} ms")
        assert oka and max(eb) <= K3_TOL[bf16] and ec <= K3C_RTOL, (
            bf16, ea, eb, ec)
        del xa, pa, xb, pb, xc, pc
    rows = feat.shape[0] * feat.shape[1]
    C = block1[0]["w"].shape[1]
    fma = rows * mlp_fma_per_row(block1)   # one pass of block1's products
    weights = [t for l_ in block1 + alpha for t in l_.values()]
    # the bytes: the inputs, the per-row outputs and the weight gradient,
    # each once; the saved activations K3a writes and K3b/K3c read again
    # are the design's, not the function's
    nb = nbytes(feat, d, w, g, *weights) * 2 - nbytes(g)
    bounds = {}
    for bf16 in (False, True):
        # block1's three passes of products (recompute, data gradient,
        # weight gradient) at the card's rate for their type: the bf16
        # tensor cores, or 3xTF32 (three tf32 products each) in f32 mode;
        # the alpha head on the FP32 cores (4 C FMA a row: the head's dot,
        # d_w, da, dwa). K3c runs dW on the FP32 cores by design; the
        # bound does not.
        tc = (1 if bf16 else 3) * 3 * 2.0 * fma
        cc = 2.0 * 4 * rows * C
        peaks = [BF16_FLOPS if bf16 else TF32_FLOPS, F32_FLOPS]
        bounds[bf16] = bound(nb, [tc, cc], peaks)
        log(f"phase 7: K3 bf16={bf16} bound {bounds[bf16][0]:.3f} ms "
            f"({bounds[bf16][1]}): recompute + data gradient + weight "
            f"gradient {tc / 1e9:.0f} GFLOP on the "
            f"{'bf16' if bf16 else '3xTF32'} tensor cores at "
            f"{peaks[0] / 1e12:.0f} TFLOP/s ({tc / peaks[0] * 1e3:.3f} ms) "
            f"+ the alpha head {cc / 1e9:.2f} GFLOP on the FP32 cores at "
            f"67 TFLOP/s ({cc / F32_FLOPS * 1e3:.3f} ms); "
            f"{2 * fma / 1e9:.1f} GFLOP a pass of block1's products")
    # yardstick: the four backward products alone, f32 with TF32 off
    with torch.inference_mode():
        gen = torch.Generator(device=feat.device).manual_seed(0)
        x = torch.randn(rows, block1[0]["w"].shape[0], device=feat.device,
                        generator=gen)
        hs = [torch.randn(rows, C, device=feat.device, generator=gen)
              for _ in block1]
        wts = [l_["w"].detach() for l_ in block1]

        def products():
            outs = []
            for i in reversed(range(len(block1))):
                outs.append(torch.matmul(hs[i], wts[i].t()))      # da / dx
                outs.append(torch.matmul(
                    (x if i == 0 else hs[i - 1]).t(), hs[i]))     # dW
            return outs
        t_lib = cuda_ms(products)
        del x, hs
    log(f"phase 7: yardstick, K3's {2 * len(block1)} products by "
        f"torch.matmul (f32, TF32 off) at the step's shape ({rows} rows): "
        f"{t_lib:.3f} ms")
    for bf16 in (False, True):
        res = fused_block1_alpha_bwd_resources(Fd, nf, d.shape[-1], df, C,
                                               bf16, feat.device)
        log(f"phase 7: K3 bf16={bf16} resources (registers a thread, shared "
            f"memory bytes a block, blocks of 256 threads an SM): "
            + "; ".join(f"{k} {v['registers']}, {v['smem_bytes']}, "
                        f"{v['blocks_per_sm']}" for k, v in res.items()))
    lib = _cuda.build("fused_agg_bwd")
    if _cuda.cuobjdump() is not None:
        for name, counts in _cuda.sass_counts(lib,
                                              ("HGMMA", "HMMA")).items():
            if "k3b_dgrad_kernel" in name:
                log(f"phase 7: K3b SASS ({name[:60]}): {counts}")
                assert counts["HGMMA"] > 0 and counts["HMMA"] == 0, counts
    else:
        log("phase 7: K3b SASS: cuobjdump not found, not checked")
    return bounds[False][0], bounds[False][1], t_lib


def profile_call(what, fn, top=8):
    """fn() once more under torch.profiler: the device time by kernel (the
    largest `top`), the device-busy sum against the call's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    def dev_us(e):
        t = getattr(e, "self_device_time_total", None)
        return e.self_cuda_time_total if t is None else t
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: -dev_us(e))
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    log(f"{what} {wall_ms:.1f} ms wall, device busy "
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
    reset_launches()
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


def phase14_gather(dev):
    """Phase 14: K7 and the staged form against index_select at the
    probes' shapes, K7's transpose; then the probe, the path of both
    kernels, with every counter reset just before. Returns their
    records."""
    import torch
    from sgnerf_tpu_torch.dev import probe_gather
    from sgnerf_tpu_torch.ops.pallas_gather import (gather_rows_pallas,
                                                    gather_rows_staged)
    errs = {}
    for shape in ("cache", "attr"):
        table, idx = probe_gather.make_case(shape, dev, seed=1)
        gen = torch.Generator(device=dev).manual_seed(2)
        f32 = torch.randn(table.shape[0], table.shape[1] // 2, device=dev,
                          generator=gen)
        for t in (table, f32):
            ref = t.index_select(0, idx)
            for fn in (gather_rows_pallas, gather_rows_staged):
                got = fn(t, idx)
                torch.cuda.synchronize()
                err = float((got.float() - ref.float()).abs().max())
                errs[fn.__name__] = max(errs.get(fn.__name__, 0.0), err)
                assert torch.equal(got, ref), (shape, t.dtype, fn.__name__)
            del ref, got
        log(f"phase 14: {shape}: {idx.numel()} rows of "
            f"{table.shape[1] * 2} B from {table.shape[0]}: K7 and the "
            f"staged form equal index_select in int16 and f32")
        # K7's transpose: the same bits twice, against index_add_
        leaf = f32.requires_grad_(True)
        g = torch.randn(idx.numel(), f32.shape[1], device=dev, generator=gen)
        grads = []
        for _ in range(2):
            leaf.grad = None
            gather_rows_pallas(leaf, idx).backward(g)
            grads.append(leaf.grad)
        ref = torch.zeros_like(f32).index_add_(0, idx.long(), g)
        torch.cuda.synchronize()
        err = float((grads[0] - ref).abs().max())
        rel = err / float(ref.abs().max())
        log(f"phase 14: {shape}: K7 transpose reruns equal "
            f"{torch.equal(grads[0], grads[1])}; vs index_add_ max |diff| "
            f"{err:.3e}, relative to max |ref| {rel:.3e} (tolerance "
            f"{GATHER_BWD_RTOL})")
        assert torch.equal(grads[0], grads[1]) and rel <= GATHER_BWD_RTOL
        del table, idx, f32, leaf, g, grads, ref
        torch.cuda.empty_cache()

    torch.cuda.synchronize()
    reset_launches()
    probe = probe_gather.run(dev, log=log)
    launches = read_launches()
    log(f"phase 14: probe launches {launches}")
    assert launches["gather_rows_pallas"] > 0, launches
    assert launches["gather_rows_staged"] > 0, launches
    assert sum(launches.values()) == (launches["gather_rows_pallas"]
                                      + launches["gather_rows_staged"])

    def pick(form):
        return next(r for r in probe if r["case"] == "cache"
                    and r["form"] == form and r["wave"] in (16, None))
    lib = pick("index_select")
    records = {}
    for key, form, what in (
            ("K7", "gather_rows_pallas", "sgnerf_tpu/ops/pallas_gather.py:79"),
            ("P", "gather_rows_staged",
             "dev_scripts/probe_pallas_gather.py:66")):
        rec = pick(form)
        records[key] = {
            "name": form, "route": "cuda",
            "source": "sgnerf_tpu_torch/csrc/gather_rows.cu",
            "replaces": what, "launches": launches[form],
            "max_abs_err": errs[form], "ms": rec["ms"],
            "plain_ms": lib["ms"], "bound_ms": rec["bound_ms"],
            "bound_by": "bytes", "library_ms": lib["ms"]}
    return records


def cut_holes(model, dataset, radius=0.4):
    """Prune the points within `radius` of where each view's central ray
    leaves the 5 x 5 x 3 m room: holes in the walls the views face, which
    their rays see through. Returns the points removed."""
    import torch
    half = np.array([2.5, 2.5, 1.5])
    centres = []
    for i in range(len(dataset)):
        c2w = dataset.get_item(i)["c2w"].astype(np.float64)
        o, f = c2w[:3, 3], c2w[:3, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            t = np.where(f != 0, (np.sign(f) * half - o) / f, np.inf)
        centres.append(o + t.min() * f)
    cloud = model.cloud
    near = torch.zeros_like(cloud.active)
    for c in centres:
        d = cloud.xyz - torch.as_tensor(c, dtype=torch.float32,
                                        device=cloud.xyz.device)
        near |= (d * d).sum(-1) < radius ** 2
    n0 = int(cloud.n_active)
    with torch.no_grad():
        cloud.conf[near] = 0.0
    model.prune_points(0.1)
    return n0 - int(model.cloud.n_active)


def probe_chunk_checks(model, item, chunk, chunk_rays=2304):
    """Phase 15's checks on one chunk of the probe frame `item`, on the
    grown model: the chunk rendered with prob=True through the kernel
    path, K2's inputs captured there, and K2 against its plain version on
    them (K2_TOL); then the chunk through the un-fused path: ray_mask
    equal, the other probe outputs within RENDER_ATOL."""
    import torch
    from sgnerf_tpu_torch.models import aggregator as agg_mod
    from sgnerf_tpu_torch.models.renderer import render_rays
    from sgnerf_tpu_torch.ops.fused_agg import (fused_block1_alpha,
                                                fused_block1_alpha_plain)
    from sgnerf_tpu_torch.runtime.growing import PROBE_KEYS
    dev = model.device
    s = slice(chunk * chunk_rays, (chunk + 1) * chunk_rays)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)
    kw = dict(campos=t(item["campos"])[None],
              raydir=t(item["raydir"][s])[None],
              camrotc2w=t(item["camrotc2w"])[None],
              near=float(item["near"]), far=float(item["far"]),
              bg_color=t(item["bg_color"]), table=model.table, prob=True)
    plain_cfg = dataclasses.replace(
        model.cfg, agg=dataclasses.replace(model.cfg.agg, fused_mlp="none"))
    captured = {}
    k2_fn = capture_first_call(agg_mod, "fused_block1_alpha", captured)
    try:
        with torch.inference_mode():
            a = render_rays(model.params, model.cloud, model.grid, model.cfg,
                            **kw)
    finally:
        agg_mod.fused_block1_alpha = k2_fn
    args, kwargs = captured["fused_block1_alpha"]
    plain_kw = {k: v for k, v in kwargs.items() if k != "bwd"}
    with torch.inference_mode():
        got = torch.cat(fused_block1_alpha(*args, **kwargs), dim=-1)
        ref = torch.cat(fused_block1_alpha_plain(*args, **plain_kw), dim=-1)
        torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    tol = K2_TOL[bool(kwargs["bf16"])]
    log(f"phase 15: K2 on probe chunk {chunk} (M={args[0].shape[0]} "
        f"K={kwargs['K']} bf16={kwargs['bf16']}): max |diff| to plain "
        f"{err:.3e} (tolerance {tol})")
    assert torch.allclose(got, ref, **tol), err
    del captured, args, got, ref

    with torch.inference_mode():
        b = render_rays(model.params, model.cloud, model.grid, plain_cfg,
                        **kw)
    hits = int(b["ray_mask"].sum())
    diffs = {k: float((a[k].float() - b[k].float()).abs().max())
             for k in PROBE_KEYS if k != "ray_mask"}
    log(f"phase 15: probe chunk {chunk} ({hits} of {chunk_rays} rays hit), "
        f"kernel path vs un-fused path: ray_mask equal "
        f"{torch.equal(a['ray_mask'], b['ray_mask'])}, max |diff| {diffs} "
        f"(tolerance {RENDER_ATOL})")
    assert torch.equal(a["ray_mask"], b["ray_mask"])
    assert hits > 0, hits
    for k, d in diffs.items():
        assert torch.isfinite(a[k]).all() and d <= RENDER_ATOL, (k, d)


def phase15_growing():
    """Phase 15: a forced growing cycle on the 4.2M-point train model, then
    train_ft with the canonical growing flags."""
    import torch
    from sgnerf_tpu_torch.data import create_dataset
    from sgnerf_tpu_torch.options import TrainOptions
    from sgnerf_tpu_torch.run import train_ft
    from sgnerf_tpu_torch.runtime import growing
    from sgnerf_tpu_torch.runtime.scene_model import SceneModel

    build = os.path.join(REPO, "build")
    scans = os.path.join(build, "smoke_scans")          # phase 8's export
    data = ["--data_root", scans + "/", "--scan", "scene_smoke"]
    # full probe frames (no_crop): every pixel of a view is probed
    opt = TrainOptions().parse(TRAIN_FLAGS + data + [
        "--name", "smoke", "--checkpoints_dir", build,
        "--random_sample", "no_crop", "--prob_num_step", "100",
        "--prob_mul", "0.4"])
    opt.split = "train"
    dataset = create_dataset(opt)
    model = SceneModel(opt)
    model.load_checkpoint(model.resolve_resume())
    t0 = time.perf_counter()
    cut = cut_holes(model, dataset)
    torch.cuda.synchronize()
    log(f"phase 15: holes cut: {cut} points pruned in "
        f"{time.perf_counter() - t0:.2f} s (prune + grid rebuild)")

    times = {}

    def timed(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            times[name] = time.perf_counter() - t
            return out
        return run
    probe_maps = growing.render_probe_maps
    timed_maps, items = timed("probe", probe_maps), []

    def probe_frame(model_, item, **kw):
        items.append(item)      # the item only: its grid must go at grow
        return timed_maps(model_, item, **kw)
    growing.render_probe_maps = probe_frame
    model.grow_points = timed("grow", model.grow_points)
    n0 = int(model.cloud.n_active)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    try:
        grown = growing.probe_and_grow(model, dataset, opt, 0,
                                       opacity_thresh=0.0)
    finally:
        growing.render_probe_maps = probe_maps
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    n1 = int(model.cloud.n_active)
    n_rays = dataset.get_item(0)["raydir"].shape[0]
    n_chunks = -(-n_rays // 2304)
    log(f"phase 15: probe frame of {n_rays} rays ({n_chunks} chunks of "
        f"2304) in {times['probe'] * 1e3:.1f} ms, launches {launches}; "
        f"grown {grown} points, n_active {n0} -> {n1} (capacity "
        f"{model.cloud.capacity}); grow + grid rebuild "
        f"{times.get('grow', 0.0):.2f} s; peak memory {peak:.2f} GiB")
    assert n1 == n0 + grown > n0, (n0, n1, grown)
    assert launches["fused_block1_alpha"] == n_chunks, launches
    assert sum(launches.values()) == n_chunks, launches
    assert int(model.cloud.active.sum()) == n1
    probe_chunk_checks(model, items[0], n_chunks // 2)   # rows through holes
    probe_item = dataset.get_item(0, full_img=True)
    profile_call("phase 15: profiled probe frame",
                 lambda: growing.render_probe_maps(model, probe_item))
    out = model.optimize(train_batch(dataset.get_item(0), model.device))
    loss = float(out["total"])
    log(f"phase 15: one train step after growing: loss {loss:.6f}")
    assert np.isfinite(loss)
    del model, out
    torch.cuda.empty_cache()

    # the training CLI with the canonical growing flags
    expr = os.path.join(build, "smoke_grow", "ft")
    os.makedirs(expr, exist_ok=True)
    for ext in ("", ".meta.json"):
        shutil.copy(os.path.join(build, "smoke",
                                 "0_net_ray_marching.npz" + ext),
                    os.path.join(expr, "0_net_ray_marching.npz" + ext))
    flags = TRAIN_FLAGS + data + [
        "--name", "ft", "--checkpoints_dir", os.path.join(build, "smoke_grow"),
        "--maximum_step", "10", "--save_iter_freq", "10", "--test_num", "1",
        "--test_freq", "0", "--print_freq", "5",
        # scene0113_00_default.sh's growing flags, every 5 steps
        "--prob_freq", "5", "--prob_num_step", "100",
        "--prob_kernel_size", "3", "3", "3", "1", "1", "1",
        "--prob_tiers", "40000", "120000", "--prob_thresh", "0.7",
        "--prob_mul", "0.4"]
    tee = Tee(sys.stdout)
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        train_ft.main(flags)
    torch.cuda.synchronize()
    text = tee.buf.getvalue()
    probes = [l_ for l_ in text.splitlines()
              if l_.startswith(("grow: +", "probe_and_grow: "))]
    log(f"phase 15: train_ft with --prob_freq 5 ran 10 steps in "
        f"{time.perf_counter() - t0:.1f} s; probes {probes}; launches "
        f"{read_launches()}")
    assert "training from step 0 to 10" in text
    assert len(probes) == 2, probes
    assert os.path.exists(os.path.join(expr, "10_net_ray_marching.npz"))


if __name__ == "__main__":
    main()
