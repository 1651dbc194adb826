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
     once a chunk, K2 never on its own (K4's first launch is K2's kernel,
     counted under K4), and the image agrees with the phase-4 frame;
 10. the same with --fused_march on: K5 (and K1) once a chunk, K4 and K2
     never, the image agrees with the phase-4 frame, and in f32 also
     within the JAX package's own limit for the march
     (tests/test_fused_agg.py test_fused_march_matches_standard_render,
     2e-5);
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
     plain reduced rows; K4's and K5's bounds with the colour products
     priced on the unit they run on (bf16 tensor cores, or 3xTF32), K4 -
     K2 and K5 - K2 (K2 timed on the same chunk), the colour launch alone
     (fused_color_head on K2's rows: its time in each mode, registers,
     shared memory, blocks an SM and the HGMMA count of its SASS, which
     must not be 0) and, as K4's and K5's library_ms, cuBLAS's four colour
     products (bf16 in, f32 out) at the chunk's shape;
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
     through the probes of steps 5 and 10;
 16. the semantic branch at full width (the canonical SG-NeRF config,
     dev_scripts/myexp_scannet_colmap/scene0241_02_semanticGuidance.sh):
     a ScanNet export with depth and ScanNet-40 label pngs from a z-buffer
     of the room scan and seeded colours as BPNet's input; the BPNet
     refresh over the 4.2M points (ResNet-34 at 640x480 x 3 views,
     MinkUNet18A at 5 cm) in bf16, first and cached, then f32 on the same
     voxels: wall times split into voxelize + links and forward +
     devoxelize, voxels at each stride, peak memory; bf16 3D labels agree
     with f32 on > 95% of voxels; the card's f32 forward against the
     port's CPU forward at 160x120 and 200k points (BPNET_CPU_TOL). Then
     train_ft.main with the semantic train flags for 10 steps, a refresh
     every step, a save at step 5 and 10: losses, refreshes applied and in
     the background, step times with a refresh in flight and, on 5 more
     steps of the trained model, without one (one of them under
     torch.profiler), the attribute-table
     rebuild at 42 and 138 columns, and a background refresh against a
     synchronous one on the same snapshot (BPNET_BG_TOL). Then run/test_ft
     on its checkpoint with the eval script's flags (and the two semantic
     flags): K1 once a chunk, K2 never, the frame once more under
     torch.profiler, and the frame equal to the knn_mode="exact" frame
     within 1e-6;
 17. block3 at full width (dev_scripts/myexp_scannet_colmap/scene0000_00.sh:
     scene0113_00_default.sh's flags with --shading_feature_mlp_layer3 2)
     on the phase-3 room scan with block3 weights: the gate's path is the
     un-fused one; point colour's gradient norm; 8 SceneModel.optimize
     steps of 1024 rays with the counters reset just before: no kernel
     launches, the loss falls, Adam moves the colours; one step under
     torch.profiler. Then train_ft.main with the script's flags for 10
     steps on phase 8's export; then one 640x480 eval frame with
     test_default.sh's bf16 cache and gathers, block3 and the train
     script's point modes: K1 once a chunk and nothing else, under
     torch.profiler once, equal to the knn_mode="exact" frame within
     RENDER_ATOL;
 18. the perspective-space path (--wcoord_query 0) at full width on a
     seeded NeRF-synthetic scene the script writes (1M points on a sphere
     and a torus in load_blender_cloud's pickle, 4 train and 2 test
     800x800 RGBA views; tests/test_cli_blender.py's flags at width 256,
     K 8, D 400, 1024-ray batches): the frustum spec, 8 train steps (K2 and
     K3 once a step, nothing else), K2 and K3 against their plain versions
     on the step's own chunk (phases 5's and 7's checks and tolerances);
     then one 800x800 test frame and its frame grid, timed: K2 once a
     chunk, under torch.profiler once, within RENDER_ATOL of the un-fused
     path's frame;
 19. the DTU path on a seeded DTU scan at DTU's sizes (49 views, pair.txt,
     640x512 images, 160x128 depth maps, cam files at 1/4; a sphere on
     dtu_ft's ground plane 0): MVSNet's depth inference (D 128, 3 views at
     640x480, seeded weights) on the card against the port's CPU forward
     (MVS_CPU_TOL) and its ms a call; dev_scripts/dtu_test_inf/
     inftest_scan1.sh's flags through train_ft.main at --maximum_step 0,
     the cloud from the dataset's depth (--manual_depth_view 0), then a
     second bootstrap through MVSNet (--manual_depth_view 1
     --depth_conf_thresh 0 --geo_cnsst_num 0): point counts, the
     bootstrap's and create_all_bg's seconds, the test frame's PSNR, then
     the frame again warm (ms, PSNR) and under torch.profiler; the ete
     script dtu_dgt_d012_img0123_conf_color_dir_agg2.sh through
     run/train.py: 10 steps (n_points, the median step, one step under
     torch.profiler), saves at 5 and 10, a resume from 10_feedforward.pkl,
     FeatureNet's first weight moved. Neither DTU path launches a kernel;
 20. the tools at full width on the phase-3 room scan and phase 8's
     export (views 0 and 3): the editor crops a box of the +x wall out of
     the scene (crop_point_cloud) and saves both parts as .pth; the
     editing CLI puts the box back rotated 30 deg about z and moved,
     and renders the 2 test frames with test_default.sh's flags and the
     counters reset just before: K1 and K2 once a chunk and nothing else;
     on the chunk through the moved box the per-neighbour rotation table
     (MiB, the neighbours in the moved part), its gather and the offsets'
     rotation timed alone, K2 against its plain version (K2_TOL); 512
     rays about the box, kernel path vs un-fused path (RENDER_ATOL); the
     warm edit frame against the default scene's on the same camera; the
     edited scene's .pth round trip (export with a dense per-point Rw2c,
     the np.unique that factors it, the load; the reloaded scene renders
     the 512 rays as the edited one); test_edit on that .pth (1 frame, the
     predicted-label cloud) and result's IoU against the room's labelled
     surfaces; render_vid (4 frames of the SLERP path); one viewer render
     through its HTTP server; vis_grow_train (1 probe frame, K2 on 2304-ray
     chunks); evaluate with LPIPS on the card on weights the phase writes,
     alex and vgg against the CPU (LPIPS_TOL). Every time is logged with
     the card's name and power limit;
 21. the opt-in training gathers at full width (phase 6's step with
     --gather_dtype bfloat16): one step's losses under the six
     --gather_vjp transposes bit-equal and their point gradients within
     bf16_limit of the f32 transpose's; 8 steps under each (median ms,
     peak GiB, K2 and K3 once a step, raydedup's and batchdedup's
     overflow, batchdedup's 0; scatter's, sorted's and int8's step under
     torch.profiler); --gather_round stochastic: SR_DRAWS draws
     of the table on its bf16 grid, their mean within SR_RMS_LIMIT, 8
     steps; --gather_dtype int8: q, scale and zero on the card equal the
     CPU's, 8 steps; a --knn_mode approx eval frame (the exact select: K1
     never, K2 once a chunk; the first chunk's ids equal the exact path's,
     the frame within RENDER_ATOL of phase 4's); train_ft 10 steps on
     phase 8's export with --gather_dtype bfloat16 --gather_round
     stochastic --gather_vjp batchdedup (gvjp_overflow 0 in its prints).
     `phase21_alone()` runs it with only the set-up it needs;
 22. the multi-device paths on two shards of card 0 (`--gpu_ids 0,0`):
     phase 4's frame through SceneModel with --ray_shards 2 and with
     --scene_shards 2 (K1 and K2 twice a chunk, nothing else; within
     RENDER_ATOL of phase 4's frame, bit-equality logged; the host syncs
     inside one chunk by torch.cuda's sync debug mode), each slab's table
     bytes against the whole scene's, phase 6's step through each (losses
     within 1e-4 relative and gradients within K3_TOL of the unsharded
     step on the same state and noise; K2 and K3 once a shard; 4 steps
     timed; the host syncs inside a step), train_ft (2 steps) then test_ft
     with each flag on phase 8's export, phase 18's perspective frame on
     two slabs against the unsharded one, and the ray-DP frame over cards
     0 and 1 where the machine has two. `phase22_alone()` runs it with
     only the set-up it needs.

Any failure raises and the script exits non-zero before its last line.
The last line is {"ok": true, "device": {...}}; the line before it holds
the per-kernel JSON record. Without a CUDA device it exits non-zero at once.
"""
import contextlib
import dataclasses
import gc
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SMI = "card not read"          # nvidia-smi's name and power limit (phase 1)
N_POINTS = 4_200_000
W_IMG, H_IMG, FOCAL = 640, 480, 580.0
# K2 tolerance vs its plain version on the card: the kernel sums the
# 284-term first layer in another order than cuBLAS (f32, no TF32); in bf16
# a one-ulp difference before the cast can flip an input's bf16 rounding
K2_TOL = {False: dict(atol=1e-4, rtol=1e-4), True: dict(atol=2e-2, rtol=1e-2)}
# bf16 mode, K4 vs the plain colour head on the K2 kernel's reduced rows
# (K4's first launch is K2's kernel, bit for bit), taking the kernel's
# hidden roundings where the two sums round a midpoint apart
# (ops/fused_agg.py color_tail_on_roundings, FLIP_BOUND), and K5 vs the
# plain march on K4's outputs (K5 runs K4's colour head on the same
# rows). Against the plain version (K2_TOL) a one-ulp difference
# of the K-sum flips a colour input's bf16 rounding, and the flip travels
# to the logits (1.6e-2 on a chunk). Here only the last colour layer's
# summation order is left (K4) and the march's exp (K5). Each limit lies
# below the kernel's bf16-vs-f32 gap
COLOR_SOUND_TOL = {"K4": dict(atol=2e-3, rtol=0.0),
                   "K5": dict(atol=1e-6, rtol=0.0)}
# FLIP_BOUND's basis (ops/fused_agg.py): the colour head's sums on the
# tensor cores within 2 units of n 2^-24 sum |x w| of float64's (rounded
# toward zero), cuBLAS's within 1 (to nearest); phase 12 measures both on
# the chunk's last colour layer and holds them to these
SUM_UNITS = {"tensor cores": 2.0, "cuBLAS": 1.0}
# render of 512 rays, kernel path vs un-fused path, f32 compute
RENDER_ATOL = 1e-4
# tests/test_fused_agg.py test_fused_march_matches_standard_render's own
# limit for the march kernel's frame against the standard render (f32)
MARCH_JAX_ATOL = 2e-5
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


def capture_first_call(module, name, store, on_call=None, call=0):
    """Wrap module.<name> so the arguments of its call number `call` (from
    0; the first by default) land in store[name] (and every call's go to
    `on_call`, when given); the call goes through to the wrapped function
    unchanged. Returns the original, to be put back."""
    fn = getattr(module, name)
    count = [0]

    def wrapped(*args, **kw):
        if count[0] == call:
            store[name] = (args, kw)
        count[0] += 1
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

    for d in ("smoke", "smoke_ft", "smoke_scans", "smoke_grow", "smoke_sem",
              "smoke_sem_scans", "smoke_b3", "smoke_nerf",
              "smoke_pers", "smoke_dtu", "smoke_dtu_data",
              "smoke_edit", "smoke_gathers", "smoke_pers22",
              "smoke_shards"):                               # its outputs
        shutil.rmtree(os.path.join(REPO, "build", d), ignore_errors=True)

    t_last = [time.perf_counter()]

    def stamp(what):
        now = time.perf_counter()
        log(f"[time] {what}: {now - t_last[0]:.1f} s")
        t_last[0] = now

    # ---- 1. the card
    global SMI
    SMI = smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
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

    stamp("phases 1-5")

    # ---- 6-7. the train step, then K3 vs its plain version
    records["K3"] = phase6_7_train(item)
    torch.cuda.empty_cache()

    # ---- 8. the training CLI
    phase8_train_ft()

    stamp("phases 6-8")

    # ---- 9-11. the opt-in render paths on the phase-3 scene, reloaded
    model = SceneModel(opt)
    model.load_checkpoint(model.resolve_resume())
    paths = phase9_11_frames(model, item, col, k1_host)
    del model, k1_host
    torch.cuda.empty_cache()
    stamp("phases 9-11")

    # ---- 12. K4-K6 vs their plain versions
    records.update(phase12_k4_k6(paths))
    del paths
    torch.cuda.empty_cache()
    stamp("phase 12")

    # ---- 13. the train step with the colour head in kernel K4
    phase13_train_fused_color(item)
    torch.cuda.empty_cache()

    # ---- 14. K7 and the staged form vs index_select, then the probe
    records.update(phase14_gather(torch.device("cuda")))
    torch.cuda.empty_cache()

    # ---- 15. growing at full width
    phase15_growing()
    torch.cuda.empty_cache()
    stamp("phases 13-15")

    # ---- 16. the semantic branch at full width
    phase16_semantic()
    stamp("phase 16")

    # ---- 17. block3 (scene0000_00.sh) at full width
    phase17_block3(item)
    stamp("phase 17")

    # ---- 18. the perspective path (--wcoord_query 0) at full width
    phase18_perspective()
    stamp("phase 18")

    # ---- 19. the DTU path: MVS nets, bootstrap, plane, feed-forward
    phase19_dtu()
    stamp("phase 19")

    # ---- 20. the tools: editing, test_edit, render_vid, viewer, evaluate
    phase20_tools()
    stamp("phase 20")

    # ---- 21. the opt-in training gathers (bf16/int8 tables, transposes)
    phase21_gathers(item, col)
    torch.cuda.empty_cache()
    stamp("phase 21")

    # ---- 22. --ray_shards and --scene_shards on two shards of the card
    phase22_shards(item, col)
    torch.cuda.empty_cache()
    stamp("phase 22")

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


def hold_k2(args, kwargs, label):
    """K2 against its plain version on captured (args, kwargs), in f32 and
    bf16 (K2_TOL), each timed with CUDA events; the bf16 mode must differ
    from the f32 one. Returns {bf16: (max |diff|, ms, plain ms, out)}."""
    import torch
    from sgnerf_tpu_torch.ops.fused_agg import (fused_block1_alpha,
                                                fused_block1_alpha_plain)
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
            log(f"{label}: K2 fused_block1_alpha bf16={bf16} M="
                f"{args[0].shape[0]} K={kwargs['K']}: max |diff| {err:.3e} "
                f"(max |ref| {float(ref.abs().max()):.3f}, tolerance "
                f"{K2_TOL[bf16]}) ; {t_k:.3f} ms vs plain {t_p:.3f} ms")
            assert ok, (bf16, err)
            errs[bf16] = (err, t_k, t_p, got)
    # the bf16 mode really rounds: its output differs from the f32 mode's
    mode_diff = float((errs[True][3] - errs[False][3]).abs().max())
    log(f"{label}: K2 kernel bf16 vs f32 mode: max |diff| {mode_diff:.3e}")
    assert mode_diff > 0.0
    return errs


def phase5_k2(captured, launches):
    args, kwargs = captured["fused_block1_alpha"]
    errs = hold_k2(args, kwargs, "phase 5")
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
        if key == "K5" and cfg.agg.compute_dtype == "float32":
            log(f"phase 10: K5 f32 frame vs the phase-4 frame: max |diff| "
                f"{diff:.3e} (the JAX package's limit {MARCH_JAX_ATOL})")
            assert diff <= MARCH_JAX_ATOL, diff
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
    that a kernel that never rounds fails. K4's colour head sums on the
    tensor cores, the plain one through cuBLAS: a hidden value within the
    two f32 sums' difference of a bf16 midpoint rounds either way, and the
    flip travels to the logits. So the plain head takes the kernel's
    rounding there (color_tail_on_roundings, on the colour launch's own
    hidden values): every hidden value must be a bf16 value, at most
    FLIP_SHARE of a layer's may flip, and each flip must have the plain
    pre-activation within FLIP_BOUND units of the f32 sums' error bound of
    the values that round to the kernel's. FLIP_BOUND's basis is measured
    first: the last layer's sums on the tensor cores and through cuBLAS
    against float64 (SUM_UNITS). The difference from the fully plain head,
    and the plain colour head's flips between K2's and the plain reduced
    rows, are logged."""
    import torch
    from sgnerf_tpu_torch.ops.fused_agg import (FLIP_BOUND, FLIP_SHARE,
                                                _bf16, color_head_hidden,
                                                color_tail_on_roundings,
                                                fused_block1_alpha_plain,
                                                sum_error_units)
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
    held = (f"tolerance {tol}" if key == "K5"
            else "not held: the next line's is")
    log(f"phase 12: {key} bf16 vs {what}: max |diff| {err:.3e} ({held}); "
        f"kernel bf16 vs f32 mode: max |diff| {gap:.3e}")
    if key == "K4":
        feat, d, w, vd = args[:4]
        block1, alpha, color = args[-3:]
        head, hid = color_head_hidden(torch.cat([fa_k2, ref[:, :1]], -1), vd,
                                      color, vf=kw["vf"], bf16=True)
        assert torch.equal(head, got_bf16)      # K4's second launch
        x, wl, bl = hid[-1], _bf16(color[-1]["w"]), color[-1]["b"]
        units = {"tensor cores": sum_error_units(head[:, 1:], x, wl, bl),
                 "cuBLAS": sum_error_units(x @ wl + bl, x, wl, bl)}
        exact = x.double() @ wl.double() + bl.double()
        toward_zero = float((head[:, 1:].double().abs() <= exact.abs())
                            .double().mean())
        log(f"phase 12: K4 bf16, the last colour layer's {x.shape[0]} x "
            f"{wl.shape[1]} sums of {x.shape[1]} bf16 products against "
            f"float64: largest error in units of n 2^-24 sum |x w| "
            f"{ {k: round(v, 4) for k, v in units.items()} } (limits "
            f"{SUM_UNITS}, FLIP_BOUND {FLIP_BOUND} their sum); the "
            f"kernel's |sum| at or below the exact one in "
            f"{toward_zero:.4f} of them")
        assert all(units[k] <= SUM_UNITS[k] for k in units), units
        # raises on unrounded hidden values, more flips than FLIP_SHARE of
        # a layer, or a flip past FLIP_BOUND units of the plain sum
        logits, flips, worst = color_tail_on_roundings(
            fa_k2, vd, color, hid, vf=kw["vf"])
        ref = torch.cat([ref[:, :1], logits], dim=-1)
        err = float((got_bf16 - ref).abs().max())
        log(f"phase 12: K4 bf16, hidden values all bf16; roundings the "
            f"tensor cores' and cuBLAS's f32 sums put a midpoint (or "
            f"LeakyReLU's kink) apart per hidden layer {flips} of "
            f"{fa_k2.shape[0]} x {hid.shape[-1]} (limit {FLIP_SHARE} of "
            f"them), the plain pre-activation within {worst:.3f} units of "
            f"the kernel's rounding (limit {FLIP_BOUND}); K4 vs the plain "
            f"colour head taking those roundings: max |diff| {err:.3e} "
            f"(tolerance {tol})")
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


def k2_on_chunk_ms(args, kwargs):
    """Phase 12: K2 alone on K4's or K5's chunk ({bf16: ms}), so that K4 -
    K2 and K5 - K2 (the colour head's cost) come from one call."""
    import torch
    from sgnerf_tpu_torch.ops.fused_agg import fused_block1_alpha
    feat, d, w = args[:3]
    block1, alpha = args[-3:-1]
    kw = dict(K=kwargs["K"], nf=kwargs["nf"], df=kwargs["df"])
    with torch.inference_mode():
        return {bf16: cuda_ms(lambda: fused_block1_alpha(
            feat, d, w, block1, alpha, bf16=bf16, **kw))
            for bf16 in (True, False)}


def color_products_ms(fa, vd, color, vf):
    """The yardstick beside K4 and K5 (library_ms; the port never calls
    it): cuBLAS's four colour products at the chunk's shape, bf16 in and
    f32 out (torch.mm's out_dtype; where this torch lacks it, bf16 out),
    each on its own bf16 input of the layer's shape."""
    import torch
    from sgnerf_tpu_torch.ops.pe import positional_encoding
    x = torch.cat([fa, positional_encoding(vd, vf, ori=True)[..., 3:]],
                  dim=-1).to(torch.bfloat16)
    ins = [x] + [torch.randn(x.shape[0], l_["w"].shape[0], device=x.device,
                             dtype=torch.bfloat16) for l_ in color[1:]]
    ws = [l_["w"].to(torch.bfloat16) for l_ in color]
    try:
        torch.mm(ins[0], ws[0], out_dtype=torch.float32)
        kw, out = dict(out_dtype=torch.float32), "f32"
    except TypeError:
        kw, out = {}, "bf16"

    def products():
        for a, wl in zip(ins, ws):
            torch.mm(a, wl, **kw)
    return cuda_ms(products), out


def phase12_color_head_alone(args, kwargs):
    """Phase 12: K4's and K5's second launch alone (fused_color_head on the
    K2 kernel's reduced rows of the chunk): its time in each mode against
    the plain colour head, registers, shared memory and blocks an SM, and
    the HGMMA count of its SASS (the colour products run on the tensor
    cores: it fails on none); returns the cuBLAS yardstick's ms."""
    import torch
    from sgnerf_tpu_torch.ops import _cuda
    from sgnerf_tpu_torch.ops.fused_agg import (color_head_plain,
                                                fused_block1_alpha,
                                                fused_color_head,
                                                fused_color_head_resources)
    feat, d, w, vd = args[:4]
    block1, alpha, color = args[-3:]
    vf = kwargs["vf"]
    C = block1[0]["w"].shape[1]
    n = len(color)
    Nh = color[0]["w"].shape[1] if n > 1 else 3
    with torch.inference_mode():
        for bf16 in (True, False):
            red = torch.cat(fused_block1_alpha(
                feat, d, w, block1, alpha, K=kwargs["K"], nf=kwargs["nf"],
                df=kwargs["df"], bf16=bf16), dim=-1)
            t_h = cuda_ms(lambda: fused_color_head(red, vd, color, vf=vf,
                                                   bf16=bf16))
            t_p = cuda_ms(lambda: color_head_plain(red, vd, color, vf=vf,
                                                   bf16=bf16))
            res = fused_color_head_resources(C, vf, Nh, n, bf16, red.device)
            log(f"phase 12: the colour launch alone (fused_color_head) "
                f"bf16={bf16} on K2's {red.shape[0]} rows: {t_h:.3f} ms vs "
                f"plain {t_p:.3f} ms; {res['registers']} registers a "
                f"thread, {res['smem_bytes']} B of shared memory a block, "
                f"{res['blocks_per_sm']} block(s) of 256 threads an SM")
        lib_ms, out = color_products_ms(red[:, :C], vd, color, vf)
    log(f"phase 12: yardstick (library_ms of K4 and K5), cuBLAS's {n} "
        f"colour products at the chunk's shape, bf16 in, {out} out: "
        f"{lib_ms:.3f} ms")
    lib = _cuda.build("fused_agg_color")
    if _cuda.cuobjdump() is not None:
        ops = ("HGMMA", "HMMA")
        by_fn = _cuda.sass_counts(lib, ops).values()
        counts = {op: sum(c[op] for c in by_fn) for op in ops}
        log(f"phase 12: colour head SASS ({os.path.basename(lib)}): "
            f"tensor-core instructions {counts}")
        assert counts["HGMMA"] > 0, counts
    else:
        log("phase 12: colour head SASS: cuobjdump not found, not checked")
    return lib_ms


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
        t_k2 = k2_on_chunk_ms(args, kwargs)
        # block1 (K2's launch) and the colour products on the tensor
        # cores: bf16, or three tf32 passes (3xTF32); the alpha head and
        # the K-sum in f32; each mode's bound, the main mode's recorded
        bounds = {}
        for bf16 in (True, False):
            flops, peaks, unit = block1_ops(block1, rows, bf16)
            color_flops = 2.0 * M * mlp_fma_per_row(color) * (1 if bf16
                                                                else 3)
            flops[0] += color_flops
            bounds[bf16] = bound(
                nbytes(*args[:-3], *weights) + out_bytes, flops, peaks)
            log(f"phase 12: {key} bf16={bf16} bound {bounds[bf16][0]:.3f} "
                f"ms ({bounds[bf16][1]}: {flops[0] / 1e9:.0f} GFLOP on the "
                f"{unit} cores, of them {color_flops / 1e9:.1f} the colour "
                f"head's, + {flops[1] / 1e9:.1f} GFLOP in f32); kernel "
                f"{res[bf16][1]:.3f} ms = "
                f"{bounds[bf16][0] / res[bf16][1]:.1%} of it; {key} - K2 "
                f"(K2 {t_k2[bf16]:.3f} ms on the same chunk) = "
                f"{res[bf16][1] - t_k2[bf16]:.3f} ms")
        bound_ms, bound_by = bounds[bool(kwargs["bf16"])]
        log(f"phase 12: {key} reruns bit-identical")
        if key == "K4":   # K5 runs the same colour products: one yardstick
            library_ms = phase12_color_head_alone(args, kwargs)
        records[key] = {
            "name": entry, "route": "cuda",
            "source": "sgnerf_tpu_torch/csrc/fused_agg_color.cu",
            "replaces": ("sgnerf_tpu/ops/fused_agg.py:741" if key == "K4"
                         else "sgnerf_tpu/ops/fused_agg.py:267"),
            "launches": launches[entry], "max_abs_err": err, "ms": t_k,
            "plain_ms": t_p, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}

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
    from sgnerf_tpu_torch.ops.fused_agg import fused_block1_alpha_bwd
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
    res = hold_k3(captured, "phase 7")
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


def hold_k3(captured, label):
    """K3 against its plain version on a step's captured K2 arguments and
    cotangent (capture_first_grad), in f32 and bf16: per output, max |diff|
    / max |plain| against the plain K3 on the kernel forward's LeakyReLU
    branches (K3_TOL; phase7_k3a_is_k2 first), and logged against the plain
    K3 on its own; each timed with CUDA events. Returns {bf16: (max |diff|,
    ms, plain ms, relative errors)}; the caller asserts the tolerance."""
    import torch
    from sgnerf_tpu_torch.ops.fused_agg import (fused_block1_alpha_bwd,
                                                fused_block1_alpha_bwd_plain)
    feat, d, w, block1, alpha = captured["args"]
    g = captured["g"]
    kw = {k: v for k, v in captured["kw"].items() if k not in ("bf16", "bwd")}
    res = {}
    for bf16 in (False, True):
        got = _flat_grads(fused_block1_alpha_bwd(feat, d, w, block1, alpha,
                                                 g, bf16=bf16, **kw))
        hs_k = phase7_k3a_is_k2(feat, d, w, block1, alpha, kw, bf16, label)
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
        log(f"{label}: K3 fused_block1_alpha_bwd bf16={bf16} M="
            f"{feat.shape[0]} K={kw['K']}: max |diff| / max |plain| per "
            f"output against the plain K3 in f32 on the forward's branches "
            f"{[f'{v:.2e}' for v in rel]} (tolerance {K3_TOL[bf16]}); "
            f"against the plain K3 on its own branches "
            f"{[f'{v:.2e}' for v in rel_own]}; {t_k:.3f} ms vs plain "
            f"{t_p:.3f} ms")
        res[bf16] = (err, t_k, t_p, rel)
    return res


def phase7_k3a_is_k2(feat, d, w, block1, alpha, kw, bf16, label="phase 7"):
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
    log(f"{label}: bf16={bf16} K3a's last activations summed as K2 sums "
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



# ------------------------------------------------------------- phase 16

# dev_scripts/myexp_scannet_colmap/scene0241_02_semanticGuidance.sh differs
# from scene0113_00_default.sh (TRAIN_FLAGS) in these flags, besides the
# scan and the step, print, save and test counts
SEMANTIC_TRAIN = {
    "--semantic_guidance": ["1"], "--predict_semantic": ["1"],
    "--shading_feature_mlp_layer2_bpnet": ["1"], "--bpnet_dtype": ["bfloat16"],
    "--prune_thresh": ["-1"], "--prune_iter": ["-1"],
    "--prob_freq": ["1000000"], "--prob_num_step": ["1000000"],
    "--test_freq": ["500000"]}
# scene0241_02_semanticGuidance_test.sh differs from test_default.sh
# (TEST_DEFAULT_FLAGS) in these, besides the scan and --resume_iter best;
# the two semantic flags are not in the script, but the JAX package cannot
# render the train script's checkpoint without them (block2_bpnet's input
# is 256 + 96 wide, and the embedding is gathered only under guidance)
SEMANTIC_EVAL = {
    "--compute_dtype": ["bfloat16"], "--shading_feature_mlp_layer2_bpnet": ["1"],
    "--semantic_guidance": ["1"], "--predict_semantic": ["1"]}
# ScanNet-40 ids of the room scan's surfaces: walls, floor, ceiling (not in
# the 20 classes: remapped to 255), the 12 boxes as furniture classes of
# SCANNET20_REMAP_IDS (cabinet .. curtain)
WALL, FLOOR, CEILING = 1, 2, 22
FURNITURE = (3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16)
SEM_TRAIN_STEPS = 10
BPNET_CPU_POINTS = 200_000        # the CPU forward's share of the room scan
# the card's BPNet forward vs the port's own CPU forward (f32 both, TF32
# off), the same products summed in other orders: features within 1e-4 of
# their largest magnitude (3.6e-6 measured); probabilities within 1e-2
# absolute: the seeded weights (He init, BN at identity) drive the logits
# to ~1e3, where a 1e-6 relative reordering moves a logit by ~1e-3 and a
# near-tied probability by as much (1.03e-3 measured; 1e-3 was set before
# the first reading); labels may flip where two classes tie within that
BPNET_CPU_TOL = {"probs": 1e-2, "feat": 1e-4, "labels": 0.999}
# a background refresh vs a synchronous one on the same snapshot (bf16,
# the same kernels on another stream)
BPNET_BG_TOL = {"probs": 1e-2, "labels": 0.999}


def with_flags(base, new):
    """base flag list with the values of `new` ({flag: [values]}) put in
    place of its own, the flags it lacks appended."""
    out, i, seen = [], 0, set()
    while i < len(base):
        j = i + 1
        while j < len(base) and not base[j].startswith("--"):
            j += 1
        flag = base[i]
        out += [flag] + (list(new[flag]) if flag in new else base[i + 1:j])
        seen.add(flag)
        i = j
    for flag, vals in new.items():
        if flag not in seen:
            out += [flag] + list(vals)
    return out


def room_surface_ids(xyz):
    """ScanNet-40 id of each room-scan point's surface, from room_scan's
    layout: the first half on the 5x5x3 m shell (the face its coordinate
    sits on), then the 12 boxes in order."""
    n = len(xyz)
    n_room = n // 2
    ids = np.empty(n, np.int32)
    shell = np.abs(xyz[:n_room]) / np.array([2.5, 2.5, 1.5], np.float32)
    axis = shell.argmax(1)
    ids[:n_room] = np.where(axis < 2, WALL,
                            np.where(xyz[:n_room, 2] < 0, FLOOR, CEILING))
    n_f = n - n_room
    per = np.full(12, n_f // 12)
    per[:n_f - per.sum()] += 1
    ids[n_room:] = np.repeat(np.asarray(FURNITURE, np.int32), per)
    return ids


def surface_colours(ids, seed=5):
    """Seeded 0-255 RGB per point: one base colour per surface id and
    per-point noise (BPNet's input, the cloud's `feats`)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(30, 225, (256, 3))
    noise = rng.normal(scale=12.0, size=(len(ids), 3))
    return np.clip(base[ids] + noise, 0, 255).astype(np.float32)


def write_semantic_export(root, xyz, ids, dev, n_views=6):
    """write_scannet_export's views, with each view's depth (mm, uint16)
    and ScanNet-40 label png from a z-buffer of the room scan on `dev`
    (the nearest point a pixel)."""
    import torch
    from PIL import Image
    write_scannet_export(root, n_views)
    exported = os.path.join(root, "scene_smoke", "exported")
    for sub in ("depth", "label"):
        os.makedirs(os.path.join(exported, sub), exist_ok=True)
    pts = torch.as_tensor(xyz, device=dev)
    tids = torch.as_tensor(ids, device=dev)
    n = pts.shape[0]
    hit_share = []
    for i in range(n_views):
        c2w = torch.as_tensor(np.loadtxt(os.path.join(
            exported, f"pose/{i}.txt")), dtype=torch.float32, device=dev)
        cam = (pts - c2w[:3, 3]) @ c2w[:3, :3]
        z = cam[:, 2]
        px = torch.round(cam[:, 0] * FOCAL / z + W_IMG / 2).long()
        py = torch.round(cam[:, 1] * FOCAL / z + H_IMG / 2).long()
        ok = (z > 0.1) & (px >= 0) & (px < W_IMG) & (py >= 0) & (py < H_IMG)
        # the nearest point a pixel: min over (depth in 0.1 mm, point id)
        key = (z * 1e4).long() * n + torch.arange(n, device=dev)
        best = torch.full((H_IMG * W_IMG,), torch.iinfo(torch.long).max,
                          device=dev)
        best.scatter_reduce_(0, (py * W_IMG + px)[ok], key[ok], "amin")
        hit = best < torch.iinfo(torch.long).max
        idx = torch.where(hit, best % n, torch.zeros_like(best))
        depth = torch.where(hit, z[idx] * 1000.0, torch.zeros_like(z[idx]))
        label = torch.where(hit, tids[idx], torch.zeros_like(tids[idx]))
        Image.fromarray(depth.reshape(H_IMG, W_IMG).round().clamp(
            0, 65535).cpu().numpy().astype(np.uint16)).save(
                os.path.join(exported, f"depth/{i}.png"))
        Image.fromarray(label.reshape(H_IMG, W_IMG).cpu().numpy().astype(
            np.uint8)).save(os.path.join(exported, f"label/{i}.png"))
        hit_share.append(float(hit.float().mean()))
    return hit_share


def semantic_checkpoint(expr, opt, xyz, feats):
    """The room scan with BPNet's input colours and the semantic config's
    seeded weights (block2_bpnet on 256 + 96 inputs) as a native
    checkpoint in `expr`."""
    from sgnerf_tpu_torch.models.aggregator import init_aggregator_params
    from sgnerf_tpu_torch.models.checkpoint_io import save_native
    from sgnerf_tpu_torch.models.params import params_to_jax
    from sgnerf_tpu_torch.options import configs_from_opt
    cfg, _, _ = configs_from_opt(opt)
    assert cfg.agg.shading_feature_mlp_layer2_bpnet == 1
    n = len(xyz)
    rng = np.random.default_rng(0)
    cloud = {
        "xyz": xyz,
        "embedding": (rng.normal(size=(n, 32)) * 0.1).astype(np.float32),
        "conf": np.ones((n, 1), np.float32),
        "dir": (xyz / np.linalg.norm(xyz, axis=-1, keepdims=True)).astype(
            np.float32),
        "color": feats / 255.0, "feats": feats,
        "Rw2c": np.eye(3, dtype=np.float32),
        "active": np.ones(n, bool), "n_active": np.asarray(n, np.int32)}
    os.makedirs(expr, exist_ok=True)
    params = params_to_jax(init_aggregator_params(0, cfg.agg))
    assert params["block2_bpnet"][0]["w"].shape == (256 + 96, 256)
    save_native(os.path.join(expr, "0_net_ray_marching.npz"),
                {"params": params, "cloud": cloud},
                {"iter": 0, "best_psnr": 0.0, "best_iter": 0})


def gib(base=0):
    """Peak GiB since the last reset: in all, and above `base` bytes (what
    was allocated before the measured work)."""
    import torch
    peak = torch.cuda.max_memory_allocated()
    return (f"{peak / 2 ** 30:.2f} GiB ({(peak - base) / 2 ** 30:.2f} GiB "
            f"above the {base / 2 ** 30:.2f} GiB held before)")


def voxel_agreement(a, b, inds_rec, n_vox):
    """Share of voxels whose devoxelized labels agree (one point a voxel)."""
    import torch
    pos = torch.empty(n_vox, dtype=torch.long, device=a.device)
    pos.scatter_(0, inds_rec, torch.arange(inds_rec.shape[0],
                                           device=a.device))
    return float((a[pos] == b[pos]).float().mean())


def phase16_bpnet(xyz, feats, item, dev):
    """Phase 16b: the BPNet refresh at full width (bf16, then f32 on the
    same voxel structure), held to the port's CPU forward at a reduced
    size and bf16 labels to f32 labels."""
    import torch
    from sgnerf_tpu_torch.models.bpnet.bpnet import (BPNet, BPNetConfig,
                                                     map_tensors)
    intr4 = np.eye(4)
    intr4[:3, :3] = item["intrinsic"]
    args = (item["train_id_paths"], item["image_path"], intr4)
    cfg16 = BPNetConfig(img_wh=(W_IMG, H_IMG), compute_dtype="bfloat16")
    net16 = BPNet(cfg16, seed=7, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    runs = {}
    for name in ("first", "cached"):
        t0 = time.perf_counter()
        out = net16.train_bpnet(xyz, feats, *args, device_out=True)
        torch.cuda.synchronize()
        runs[name] = (time.perf_counter() - t0, dict(net16.timings), out)
    cache = net16._vox_cache
    vc = cache["grid"].coords.cpu().numpy()
    counts = [len(np.unique(vc >> s, axis=0)) for s in range(5)]
    for name, (wall, split, _) in runs.items():
        log(f"phase 16: BPNet refresh bf16 ({name}) over {len(xyz)} points, "
            f"ResNet-34 at {W_IMG}x{H_IMG} x {cfg16.view_num} views, "
            f"MinkUNet18A at {cfg16.voxel_size * 100:.0f} cm: "
            f"{wall:.3f} s wall (voxelize + links {split['host_s']:.3f} s, "
            f"forward + devoxelize {split['forward_s']:.3f} s)")
    log(f"phase 16: voxels at stride 1/2/4/8/16: {counts}; peak memory "
        f"{gib(base)}")
    l_first, l_cached = runs["first"][2][0], runs["cached"][2][0]
    same = voxel_agreement(l_first, l_cached, cache["inds_rec"], counts[0])
    log(f"phase 16: cached refresh vs first: labels equal on {same:.6f} of "
        f"voxels, probs max |diff| "
        f"{float((runs['first'][2][1] - runs['cached'][2][1]).abs().max()):.3e}")
    assert same >= BPNET_BG_TOL["labels"], same

    net32 = BPNet(dataclasses.replace(cfg16, compute_dtype="float32"),
                  params=net16.params, device=dev)
    net32._vox_cache = cache              # the same cloud: the same voxels
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out32 = net32.train_bpnet(xyz, feats, *args, device_out=True)
    torch.cuda.synchronize()
    log(f"phase 16: BPNet refresh f32 (cached voxels) "
        f"{time.perf_counter() - t0:.3f} s wall (forward + devoxelize "
        f"{net32.timings['forward_s']:.3f} s); peak memory {gib(base)}")
    agree = voxel_agreement(l_cached, out32[0], cache["inds_rec"], counts[0])
    log(f"phase 16: bf16 vs f32 3D labels agree on {agree:.4f} of "
        f"{counts[0]} voxels (> 0.95 required, the JAX package's criterion)")
    assert agree > 0.95, agree
    for o in (runs["cached"][2], out32):
        assert torch.isfinite(o[1]).all() and torch.isfinite(o[3]).all()
        assert o[1].shape == (len(xyz), 20) and o[3].shape == (len(xyz), 96)
    del runs, out32, net32

    # the card's f32 forward vs the port's own CPU forward, reduced size
    n_sub = min(BPNET_CPU_POINTS, len(xyz))
    sub = np.random.default_rng(9).choice(len(xyz), n_sub, replace=False)
    small = BPNetConfig(img_wh=(160, 120), compute_dtype="float32")
    intr_s = intr4.copy()
    intr_s[:2] /= W_IMG / 160
    outs = []
    for d in (dev, "cpu"):
        net = BPNet(small, params=map_tensors(lambda t: t.to(d),
                                              net16.params), device=d)
        t0 = time.perf_counter()
        o = net.train_bpnet(xyz[sub], feats[sub], args[0], args[1], intr_s,
                            device_out=True)
        outs.append(([t.cpu() if torch.is_tensor(t) else t for t in o],
                     time.perf_counter() - t0, net._vox_cache["grid"].M))
    (g, g_s, m), (c, c_s, _) = outs
    perr = float((g[1] - c[1]).abs().max())
    ferr = float((g[3] - c[3]).abs().max() / c[3].abs().max().clamp(min=1))
    lab = float((g[0] == c[0]).float().mean())
    log(f"phase 16: BPNet f32 at 160x120, {n_sub} points ({m} voxels): card "
        f"{g_s:.2f} s, CPU {c_s:.2f} s; probs max |diff| {perr:.3e}, feature "
        f"max |diff| / max {ferr:.3e}, labels equal {lab:.5f} (tolerance "
        f"{BPNET_CPU_TOL})")
    assert perr <= BPNET_CPU_TOL["probs"] and ferr <= BPNET_CPU_TOL["feat"]
    assert lab >= BPNET_CPU_TOL["labels"], lab


def phase16_train_ft(data, item):
    """Phase 16c: train_ft.main with the scene0241_02_semanticGuidance.sh
    flags (refresh every step), the step times with and without a refresh
    in flight, the table rebuild, and a background refresh against a
    synchronous one on the same snapshot."""
    import torch
    from sgnerf_tpu_torch.models.renderer import attribute_table
    from sgnerf_tpu_torch.run import train_ft
    from sgnerf_tpu_torch.runtime.scene_model import (SceneModel,
                                                      batch_to_device)
    from sgnerf_tpu_torch.runtime.semantic import SemanticDriver
    build = os.path.join(REPO, "build")
    flags = with_flags(TRAIN_FLAGS, SEMANTIC_TRAIN) + data + [
        "--name", "sem", "--checkpoints_dir", os.path.join(build, "smoke_sem"),
        "--maximum_step", str(SEM_TRAIN_STEPS), "--save_iter_freq",
        str(SEM_TRAIN_STEPS // 2), "--test_num", "1", "--print_freq", "1"]
    log(f"phase 16: train_ft flags changed from the script: --max_o 0 --P 0 "
        f"(auto caps), --maximum_step {SEM_TRAIN_STEPS} --save_iter_freq "
        f"{SEM_TRAIN_STEPS // 2} --print_freq 1 --test_num 1")
    seen, steps = {}, []
    refresh = SemanticDriver.maybe_refresh
    optimize = SceneModel.optimize_multi

    # the main stream only: a device-wide synchronize would wait for the
    # refresh in flight on SemanticDriver's stream
    def spy_refresh(self, model, it, steps=1):
        seen["sem"], seen["model"] = self, model
        torch.cuda.current_stream().synchronize()
        t0 = time.perf_counter()
        refresh(self, model, it, steps)
        torch.cuda.current_stream().synchronize()
        seen.setdefault("refresh_s", []).append(time.perf_counter() - t0)

    def timed_step(self, batches):
        drv = seen.get("sem")
        torch.cuda.current_stream().synchronize()
        t0 = time.perf_counter()
        out = optimize(self, batches)
        torch.cuda.current_stream().synchronize()
        steps.append((time.perf_counter() - t0,
                      bool(drv is not None and drv.in_flight), out))
        return out
    SemanticDriver.maybe_refresh = spy_refresh
    SceneModel.optimize_multi = timed_step
    tee = Tee(sys.stdout)
    reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(tee):
            train_ft.main(flags)
        torch.cuda.synchronize()
    finally:
        SemanticDriver.maybe_refresh = refresh
        SceneModel.optimize_multi = optimize
    wall = time.perf_counter() - t0
    drv, model = seen["sem"], seen["model"]
    losses = [float(ls["total"]) for _, _, out in steps for ls in out]
    busy = [s for s, f, _ in steps if f]
    idle = [s for s, f, _ in steps if not f]
    med = (lambda v: f"{statistics.median(v) * 1e3:.1f} ms" if v
           else "none")
    log(f"phase 16: train_ft ran {SEM_TRAIN_STEPS} semantic steps in "
        f"{wall:.1f} s (saves, export and test included); losses {losses}; "
        f"refreshes applied {drv.n_applied}, background {drv.n_background}; "
        f"first refresh {seen['refresh_s'][0]:.2f} s (synchronous); median "
        f"step {med(busy)} with a refresh in flight ({len(busy)} steps), "
        f"{med(idle)} without ({len(idle)}); launches {read_launches()}")
    assert all(np.isfinite(losses)) and len(losses) == SEM_TRAIN_STEPS
    assert drv.n_background >= 1 and drv.n_applied >= 2, (
        drv.n_applied, drv.n_background)
    assert read_launches()["fused_block1_alpha"] == 0    # block2_bpnet
    expr = os.path.join(build, "smoke_sem", "sem")
    for f in (f"{SEM_TRAIN_STEPS // 2}_net_ray_marching.npz",
              f"{SEM_TRAIN_STEPS}_net_ray_marching.npz",
              f"{SEM_TRAIN_STEPS}_net_ray_marching.pth",
              f"{SEM_TRAIN_STEPS}_semanticEmbedding.pth"):
        assert os.path.exists(os.path.join(expr, f)), f

    # the step with no refresh in flight: the trained model on one batch
    # of the train view, its pixel labels from BPNet's last 2D prediction
    drv.flush(model)
    it = dict(item, pixel_label=drv.pixel_labels_for(item))
    batch = batch_to_device(it, model.device)
    quiet = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(model.optimize(batch)["total"])
        quiet.append(time.perf_counter() - t0)
    log(f"phase 16: {len(quiet)} more steps with no refresh in flight: "
        f"median {statistics.median(quiet) * 1e3:.1f} ms (last loss "
        f"{loss:.6f})")
    assert np.isfinite(loss)
    profile_call("phase 16: profiled semantic step",
                 lambda: model.optimize(batch))
    cloud = model.cloud
    ms = {c: cuda_ms(lambda c=c: attribute_table(cloud, "float32", c))
          for c in (False, True)}
    log(f"phase 16: attribute table rebuild (the train step's, "
        f"{cloud.capacity} rows): {ms[False]:.3f} ms at 42 columns, "
        f"{ms[True]:.3f} ms at 138 (with the 96-d embedding)")

    # a background refresh vs a synchronous one on the same snapshot
    snap = drv._snapshot(model, item)
    sync = drv.bpnet.train_bpnet(*snap, device_out=True)
    res = {}
    drv._follow_caller()
    th = threading.Thread(target=lambda: res.update(out=drv._run(snap)))
    th.start()
    th.join()
    bg, event = res["out"]
    torch.cuda.current_stream().wait_event(event)
    cache = drv.bpnet._vox_cache
    lab = voxel_agreement(bg[0], sync[0], cache["inds_rec"], cache["grid"].M)
    perr = float((bg[1] - sync[1]).abs().max())
    log(f"phase 16: background refresh (worker thread, side stream) vs "
        f"synchronous (default stream) on one snapshot: labels equal on "
        f"{lab:.6f} of {cache['grid'].M} voxels, probs max |diff| "
        f"{perr:.3e} (tolerance {BPNET_BG_TOL})")
    assert lab >= BPNET_BG_TOL["labels"] and perr <= BPNET_BG_TOL["probs"]
    seen.clear()


def phase16_eval(data, item):
    """Phase 16d: run/test_ft on phase 16c's checkpoint with the eval
    script's flags (bf16 cache, gathers and compute): K1 once a chunk, K2
    never; then the frame against knn_mode="exact"."""
    import torch
    from sgnerf_tpu_torch.options import TestOptions
    from sgnerf_tpu_torch.run import test_ft
    from sgnerf_tpu_torch.runtime.scene_model import SceneModel
    build = os.path.join(REPO, "build")
    flags = with_flags(TEST_DEFAULT_FLAGS, SEMANTIC_EVAL) + data + [
        "--name", "sem", "--checkpoints_dir", os.path.join(build, "smoke_sem"),
        "--test_num_step", "50"]
    tee = Tee(sys.stdout)
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        test_ft.main(flags)
    torch.cuda.synchronize()
    launches = read_launches()
    frames = [l_ for l_ in tee.buf.getvalue().splitlines()
              if l_.startswith("num.")]
    n_rays = len(item["raydir"])
    chunks = -(-n_rays // 9216)
    log(f"phase 16: test_ft (semantic eval flags) rendered {len(frames)} "
        f"frame(s) in {time.perf_counter() - t0:.1f} s, launches {launches} "
        f"(K1 once a chunk: {chunks} a frame)")
    assert frames and launches["fused_knn_select"] == chunks * len(frames)
    assert sum(launches.values()) == launches["fused_knn_select"], launches

    opt = TestOptions().parse(flags)
    model = SceneModel(opt)
    model.load_checkpoint(model.resolve_resume())
    assert model.cfg.knn_mode == "fused" and model.cfg.semantic_guidance
    reset_launches()
    t0 = time.perf_counter()
    col = model.render_image(item)
    frame_s = time.perf_counter() - t0
    k1 = read_launches()["fused_knn_select"]
    profile_call("phase 16: profiled semantic eval frame",
                 lambda: model.render_image(item))
    model.cfg = dataclasses.replace(model.cfg, knn_mode="exact")
    exact = model.render_image(item)
    diff = float(np.abs(col - exact).max())
    log(f"phase 16: semantic eval frame of {n_rays} rays in "
        f"{frame_s * 1e3:.1f} ms (K1 {k1} launches), vs knn_mode exact: max "
        f"|diff| {diff:.3e} (tolerance 1e-6)")
    assert col.shape == (n_rays, 3) and np.isfinite(col).all()
    assert k1 == chunks and diff <= 1e-6, (k1, diff)


def phase16_semantic(dev="cuda"):
    """Phase 16: the semantic branch at full width."""
    import torch
    from sgnerf_tpu_torch.data import create_dataset
    from sgnerf_tpu_torch.data.synthetic import room_scan
    from sgnerf_tpu_torch.options import TestOptions, TrainOptions
    build = os.path.join(REPO, "build")
    scans = os.path.join(build, "smoke_sem_scans")
    data = ["--data_root", scans + "/", "--scan", "scene_smoke",
            "--dataset_name", "scannet_ft"]
    t0 = time.perf_counter()
    xyz = room_scan(np.random.default_rng(0), N_POINTS)
    ids = room_surface_ids(xyz)
    feats = surface_colours(ids)
    hit = write_semantic_export(scans, xyz, ids, torch.device(dev))
    export_s = time.perf_counter() - t0
    opt = TrainOptions().parse(with_flags(TRAIN_FLAGS, SEMANTIC_TRAIN) + data
                               + ["--name", "sem", "--checkpoints_dir",
                                  os.path.join(build, "smoke_sem")])
    opt.split = "train"
    semantic_checkpoint(os.path.join(build, "smoke_sem", "sem"), opt, xyz,
                        feats)
    dataset = create_dataset(opt)
    item = dataset.get_item(0)
    log(f"phase 16: semantic export (depth and label pngs, pixels hit "
        f"{[round(h, 3) for h in hit]}) in {export_s:.1f} s, checkpoint in "
        f"{time.perf_counter() - t0 - export_s:.1f} s; pixel labels of view 0: "
        f"{np.unique(item['pixel_label']).tolist()}")
    phase16_bpnet(xyz, feats, item, dev)
    torch.cuda.empty_cache()
    phase16_train_ft(data, item)
    torch.cuda.empty_cache()
    # the frame test_ft renders first: the test split's view 0, whole
    test_opt = TestOptions().parse(TEST_DEFAULT_FLAGS + data
                                   + ["--test_num_step", "50"])
    test_opt.random_sample = "no_crop"
    phase16_eval(data, create_dataset(test_opt).get_item(0))


# ------------------------------------------------ 17. block3 at full width
# dev_scripts/myexp_scannet_colmap/scene0000_00.sh differs from
# scene0113_00_default.sh (TRAIN_FLAGS) in these, besides the scan and name
B3_TRAIN = {"--shading_feature_mlp_layer3": ["2"], "--test_num_step": ["2"]}
B3_STEPS = 8
# the eval frame: test_default.sh's flags with block3, and the point modes
# of the train script (and of dev_scripts/w_scannet_etf/*_test.sh):
# test_default.sh leaves them at "0", which builds block3 without the
# colour and dir inputs, 256 wide against the checkpoint's 263, and fails
# in both packages
B3_EVAL = {"--shading_feature_mlp_layer3": ["2"], "--point_conf_mode": ["1"],
           "--point_dir_mode": ["1"], "--point_color_mode": ["1"]}


def block3_checkpoint(expr, agg_cfg):
    """Phase 3's room-scan checkpoint with the port's seeded weights of
    agg_cfg (block3 included), written to expr."""
    from sgnerf_tpu_torch.models.aggregator import init_aggregator_params
    from sgnerf_tpu_torch.models.checkpoint_io import load_native, save_native
    from sgnerf_tpu_torch.models.params import params_to_jax
    tree, meta = load_native(os.path.join(REPO, "build", "smoke",
                                          "0_net_ray_marching.npz"))
    tree["params"] = params_to_jax(init_aggregator_params(0, agg_cfg))
    save_native(os.path.join(expr, "0_net_ray_marching.npz"), tree, meta)


def phase17_block3(item):
    """Phase 17: scene0000_00.sh's aggregator (block3 on colour and dir)
    at full width: the train step (un-fused: the reference's gate), colour's
    gradient, train_ft on phase 8's export, and the eval frame with
    test_default.sh's bf16 cache and gathers (K1, no K2)."""
    import torch
    from sgnerf_tpu_torch.models import aggregator as agg_mod
    from sgnerf_tpu_torch.models.renderer import draw_render_noise
    from sgnerf_tpu_torch.models.train import loss_and_grads, trained_fields
    from sgnerf_tpu_torch.options import TestOptions, TrainOptions
    from sgnerf_tpu_torch.run import train_ft
    from sgnerf_tpu_torch.runtime.scene_model import SceneModel
    build = os.path.join(REPO, "build")
    ck = os.path.join(build, "smoke_b3")
    flags = with_flags(TRAIN_FLAGS, B3_TRAIN)
    opt = TrainOptions().parse(flags + ["--name", "b3",
                                        "--checkpoints_dir", ck])
    t0 = time.perf_counter()
    model = SceneModel(opt)
    block3_checkpoint(model.expr_dir, model.cfg.agg)
    model.load_checkpoint(model.resolve_resume())
    torch.cuda.synchronize()
    cfg = model.cfg
    agg = cfg.agg
    path = agg_mod.fused_paths(
        agg, K=cfg.K, F=agg.point_features_dim, Dd=agg.dist_dim,
        color_branch=model.params["color_branch"], training=True,
        device=model.device)
    log(f"phase 17: block3 train model ({N_POINTS} points, block3 "
        f"{[tuple(l_['w'].shape) for l_ in model.params['block3']]}) loaded "
        f"in {time.perf_counter() - t0:.1f} s; the gate's path: {path}")
    assert agg.fused_mlp == "cuda" and path == "none", (agg.fused_mlp, path)

    batch = train_batch(item, model.device)
    R = batch["raydir"].shape[1]
    gen = torch.Generator(device=model.device).manual_seed(11)
    noise = draw_render_noise(gen, cfg, 1, R)
    _, _, g_pts = loss_and_grads(model.state, model.grid, cfg, model.tcfg,
                                 batch, noise=noise)
    gc = g_pts[trained_fields(model.tcfg).index("color")]
    gnorm = float(gc.norm())
    rows = int((gc.abs().sum(-1) > 0).sum())
    log(f"phase 17: point colour's gradient (--color_grad 1): norm "
        f"{gnorm:.4e} over {rows} points")
    assert np.isfinite(gnorm) and gnorm > 0 and rows > 0
    color0 = model.cloud.color.clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, step_ms = [], []
    for _ in range(B3_STEPS):
        t0 = time.perf_counter()
        out = model.optimize(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(out["total"]))
    launches = read_launches()
    moved = int((model.cloud.color != color0).any(-1).sum())
    log(f"phase 17: {B3_STEPS} block3 steps of {R} rays at {N_POINTS} "
        f"points: losses {[round(v, 6) for v in losses]}, step ms "
        f"{[round(v, 1) for v in step_ms]}, median "
        f"{statistics.median(step_ms):.1f} ms, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, colours "
        f"moved by Adam {moved}, launches {launches}")
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert sum(launches.values()) == 0 and moved > 0, launches
    profile_call("phase 17: profiled block3 step",
                 lambda: model.optimize(batch))
    del model, batch, color0, gc, g_pts
    torch.cuda.empty_cache()

    # train_ft with scene0000_00.sh's flags on phase 8's export
    expr = os.path.join(ck, "ft")
    os.makedirs(expr, exist_ok=True)
    for ext in ("", ".meta.json"):
        shutil.copy(os.path.join(ck, "b3", "0_net_ray_marching.npz" + ext),
                    os.path.join(expr, "0_net_ray_marching.npz" + ext))
    ft_flags = flags + [
        "--name", "ft", "--checkpoints_dir", ck,
        "--data_root", os.path.join(build, "smoke_scans") + "/",
        "--scan", "scene_smoke", "--maximum_step", "10",
        "--save_iter_freq", "10", "--test_num", "1", "--test_freq", "0",
        "--print_freq", "5"]
    reset_launches()
    tee = Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        train_ft.main(ft_flags)
    torch.cuda.synchronize()
    out = tee.buf.getvalue()
    log(f"phase 17: train_ft (scene0000_00.sh's flags) ran 10 steps, saved, "
        f"exported and tested in {time.perf_counter() - t0:.1f} s; "
        f"launches {read_launches()}")
    for f in ("10_net_ray_marching.npz", "10_net_ray_marching.pth"):
        assert os.path.exists(os.path.join(expr, f)), f
    assert "training from step 0 to 10" in out
    psnr_lines = [l_ for l_ in out.splitlines() if "psnr:" in l_]
    assert psnr_lines and all(np.isfinite(float(
        l_.split("psnr:")[1].split()[0])) for l_ in psnr_lines), psnr_lines
    assert sum(read_launches().values()) == 0, read_launches()

    # the eval frame: test_default.sh's bf16 cache and gathers, block3
    topt = TestOptions().parse(with_flags(TEST_DEFAULT_FLAGS, dict(
        B3_EVAL, **{"--name": ["b3"], "--checkpoints_dir": [ck]})))
    model = SceneModel(topt)
    model.load_checkpoint(model.resolve_resume())
    assert model.cfg.knn_mode == "fused"
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    col = model.render_image(item)
    first_s = time.perf_counter() - t0
    launches = read_launches()
    t0 = time.perf_counter()
    col = model.render_image(item)
    frame_s = time.perf_counter() - t0
    chunks = -(-len(item["raydir"]) // 9216)
    log(f"phase 17: block3 eval frame {W_IMG}x{H_IMG}: first "
        f"{first_s * 1e3:.1f} ms, warm {frame_s * 1e3:.1f} ms; launches of "
        f"the first {launches} ({chunks} chunks)")
    assert launches["fused_knn_select"] == chunks, launches
    assert sum(launches.values()) == chunks, launches
    profile_call("phase 17: profiled block3 eval frame",
                 lambda: model.render_image(item))
    model.cfg = dataclasses.replace(model.cfg, knn_mode="exact")
    exact = model.render_image(item)
    diff = float(np.abs(col - exact).max())
    log(f"phase 17: block3 frame, K1 vs knn_mode exact: max |diff| "
        f"{diff:.3e} (tolerance {RENDER_ATOL})")
    assert np.isfinite(col).all() and diff <= RENDER_ATOL, diff
    del model
    torch.cuda.empty_cache()


# ----------------------------------- 18. the perspective path at full width
NERF_W = 800                   # NeRF-synthetic views are 800x800
NERF_POINTS = 1_000_000
NERF_STEPS = 8
# the lego scene's field of view (transforms_*.json camera_angle_x)
NERF_ANGLE_X = 0.6911112070083618


def nerf_flags(root, name, ckpt):
    """tests/test_cli_blender.py's flags at full width (256 the flag
    default), K 8, D 400 and 800x800, with --wcoord_query 0; 1024-ray
    batches (random_sample_size 32, phase 6's) instead of 64."""
    return [
        "--scan", "lego", "--dataset_name", "nerf_synth_ft",
        "--data_root", root, "--checkpoints_dir", ckpt, "--name", name,
        "--cloud_path", os.path.join(root, "lego", "cloud.pkl"),
        "--num_point", str(NERF_POINTS),
        "--img_wh", str(NERF_W), str(NERF_W), "--random_sample", "random",
        "--random_sample_size", "32",
        "--which_ray_generation", "near_far_linear",
        "--which_render_func", "radiance", "--which_blend_func", "alpha",
        "--which_tonemap_func", "off",
        "--near_plane", "2.0", "--far_plane", "6.0",
        "--z_depth_dim", "400", "--SR", "4", "--K", "8", "--P", "10",
        "--max_o", "40000", "--vsize", "0.02", "0.02", "0.02",
        "--vscale", "2", "2", "2", "--kernel_size", "3", "3", "3",
        "--radius_limit_scale", "4", "--agg_dist_pers", "20",
        "--agg_distance_kernel", "linear", "--agg_intrp_order", "2",
        "--point_features_dim", "32", "--num_feat_freqs", "3",
        "--dist_xyz_freq", "5", "--num_viewdir_freqs", "4",
        "--act_type", "LeakyReLU", "--shading_color_mlp_layer", "4",
        "--shading_feature_mlp_layer1", "2", "--shading_feature_num", "256",
        "--act_super", "1",
        "--color_loss_items", "ray_masked_coarse_raycolor",
        "ray_miss_coarse_raycolor", "coarse_raycolor",
        "--color_loss_weights", "1.0", "0.0", "0.0",
        "--zero_one_loss_items", "conf_coefficient",
        "--zero_one_loss_weights", "0.0001",
        "--lr", "0.001", "--plr", "0.002",
        "--lr_policy", "iter_exponential_decay",
        "--lr_decay_iters", "1000000", "--raydist_mode_unit", "1",
        "--bg_color", "white", "--vox_res", "0",
        "--ranges", "-10", "-10", "-10", "10", "10", "10",
        "--wcoord_query", "0", "--shpnt_jitter", "uniform",
        "--n_threads", "0"]


def write_nerf_export(root, n_points=NERF_POINTS, seed=9, n_train=4,
                      n_test=2):
    """A seeded NeRF-synthetic scene under root/lego: n_points on the
    surface of a sphere (r 0.7) and a torus (R 1.0, r 0.2) in
    load_blender_cloud's pickle, and 800x800 RGBA views from a ring at
    radius 4 and 30 degrees elevation (blender c2w poses, lego's field of
    view), each the points splatted in, nearest last, alpha 0 elsewhere."""
    import pickle
    from PIL import Image
    lego = os.path.join(root, "lego")
    rng = np.random.default_rng(seed)
    n_s = n_points // 2
    s = rng.normal(size=(n_s, 3))
    s = 0.7 * s / np.linalg.norm(s, axis=-1, keepdims=True)
    u, v = rng.uniform(0, 2 * np.pi, (2, n_points - n_s))
    t = np.stack([(1.0 + 0.2 * np.cos(v)) * np.cos(u),
                  (1.0 + 0.2 * np.cos(v)) * np.sin(u), 0.2 * np.sin(v)], -1)
    xyz = np.concatenate([s, t]).astype(np.float32)
    rgb = np.clip(xyz * 0.4 + 0.5, 0, 1)
    os.makedirs(lego, exist_ok=True)
    with open(os.path.join(lego, "cloud.pkl"), "wb") as f:
        pickle.dump({"point_xyz": xyz}, f)
    W = NERF_W
    focal = 0.5 * W / np.tan(0.5 * NERF_ANGLE_X)
    for split, n, off in (("train", n_train, 0.0), ("test", n_test, 0.5)):
        os.makedirs(os.path.join(lego, split), exist_ok=True)
        frames = []
        for i in range(n):
            az = 2 * np.pi * (i + off) / n
            el = np.pi / 6
            campos = 4.0 * np.array([np.cos(el) * np.cos(az),
                                     np.cos(el) * np.sin(az), np.sin(el)])
            back = campos / np.linalg.norm(campos)
            right = np.cross([0.0, 0.0, 1.0], back)
            right /= np.linalg.norm(right)
            up = np.cross(back, right)
            c2w = np.eye(4)
            c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = (right, up,
                                                              back, campos)
            # the splat in the opencv frame the dataset reads (x right,
            # y down, z forward)
            cam = (xyz - campos) @ np.stack([right, -up, -back], -1)
            z = cam[:, 2]
            px = np.floor(cam[:, 0] * focal / z + W / 2).astype(np.int64)
            py = np.floor(cam[:, 1] * focal / z + W / 2).astype(np.int64)
            ok = (z > 0) & (px >= 0) & (px < W) & (py >= 0) & (py < W)
            order = np.argsort(-z[ok])                 # far first
            img = np.zeros((W, W, 4), np.uint8)
            img[py[ok][order], px[ok][order], :3] = (
                rgb[ok][order] * 255).astype(np.uint8)
            img[py[ok][order], px[ok][order], 3] = 255
            Image.fromarray(img, "RGBA").save(
                os.path.join(lego, split, f"r_{i}.png"))
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": c2w.tolist()})
        with open(os.path.join(lego, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": NERF_ANGLE_X, "frames": frames}, f)


def phase18_perspective():
    """Phase 18: the perspective-space path (--wcoord_query 0) on a
    NeRF-synthetic scene at full width: 8 train steps (K2 and K3 each
    step, held to their plain versions on the path's own chunk), then one
    800x800 test frame with its frame grid, against the un-fused path."""
    import torch
    from sgnerf_tpu_torch.data import create_dataset
    from sgnerf_tpu_torch.models import aggregator as agg_mod
    from sgnerf_tpu_torch.ops.query_pers import perspective_grid
    from sgnerf_tpu_torch.options import TrainOptions
    from sgnerf_tpu_torch.runtime.scene_model import (SceneModel,
                                                      batch_to_device)
    build = os.path.join(REPO, "build")
    root = os.path.join(build, "smoke_nerf")
    t0 = time.perf_counter()
    write_nerf_export(root)
    export_s = time.perf_counter() - t0
    opt = TrainOptions().parse(nerf_flags(root, "pers",
                                          os.path.join(build, "smoke_pers")))
    opt.split = "train"
    dataset = create_dataset(opt)
    t0 = time.perf_counter()
    model = SceneModel(opt)
    xyz, feats, labels = dataset.load_init_points()
    with contextlib.redirect_stdout(io.StringIO()):
        model.setup_from_points(xyz, feats, labels, dataset=dataset)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cfg = model.cfg
    assert model.perspective and cfg.agg.fused_mlp == "cuda"
    rng = np.random.default_rng(4)
    items = [dataset.get_item(int(rng.integers(0, len(dataset))), rng=rng)
             for _ in range(NERF_STEPS)]
    with contextlib.redirect_stdout(io.StringIO()):
        model.ensure_pspec(items[0])
    ps = model.pspec
    log(f"phase 18: NeRF-synthetic export ({len(xyz)} points, "
        f"{len(dataset)} train views {NERF_W}x{NERF_W}) in {export_s:.1f} s; "
        f"model set up (world grid {model.spec.vdim}) in {setup_s:.1f} s; "
        f"frustum grid vdim {ps.vdim} max_o {ps.max_o} P {ps.P}")
    batches = [batch_to_device(it, model.device) for it in items]
    captured = {}
    agg_fn = capture_first_grad(agg_mod, "fused_block1_alpha", captured)
    torch.cuda.synchronize()
    reset_launches()
    losses, step_ms = [], []
    try:
        for b in batches:
            t0 = time.perf_counter()
            out = model.optimize(b)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(out["total"]))
    finally:
        agg_mod.fused_block1_alpha = agg_fn
    launches = read_launches()
    R = batches[0]["raydir"].shape[1]
    log(f"phase 18: {NERF_STEPS} perspective steps of {R} rays: losses "
        f"{[round(v, 6) for v in losses]}, step ms "
        f"{[round(v, 1) for v in step_ms]}, median "
        f"{statistics.median(step_ms):.1f} ms, launches {launches}")
    assert np.isfinite(losses).all()
    assert launches == {"fused_knn_select": 0,
                        "fused_block1_alpha": NERF_STEPS,
                        "fused_block1_alpha_bwd": NERF_STEPS,
                        "fused_block1_alpha_color": 0,
                        "fused_block1_alpha_color_march": 0,
                        "fused_knn_select_tiled": 0, **NO_GATHER}, launches
    profile_call("phase 18: profiled perspective step",
                 lambda: model.optimize(batches[0]))
    hold_k2(captured["args"], captured["kw"], "phase 18")
    res = hold_k3(captured, "phase 18")
    for bf16, (_, _, _, rel) in res.items():
        assert max(rel) <= K3_TOL[bf16], (bf16, rel)
    del captured, batches

    # one test frame: its perspective grid, then the render
    topt = TrainOptions().parse(nerf_flags(root, "pers",
                                           os.path.join(build, "smoke_pers")))
    topt.split, topt.random_sample = "test", "no_crop"
    item = create_dataset(topt).get_item(0)
    cam = [torch.as_tensor(np.asarray(item[k], np.float32),
                           device=model.device)
           for k in ("camrotc2w", "campos")]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid = perspective_grid(model.cloud.xyz, model.cloud.active, *cam,
                            model.pspec)[0]
    torch.cuda.synchronize()
    grid_ms = (time.perf_counter() - t0) * 1e3
    n_occ = int((grid.vox_slot >= 0).sum())
    del grid
    reset_launches()
    t0 = time.perf_counter()
    col = model.render_image(item)
    frame_s = time.perf_counter() - t0
    launches = read_launches()
    t0 = time.perf_counter()
    col = model.render_image(item)
    warm_s = time.perf_counter() - t0
    n_rays = len(item["raydir"])
    chunks = -(-n_rays // 9216)
    hit = float(np.mean(np.any(col != 1.0, axis=-1)))
    log(f"phase 18: frame grid of {int(model.cloud.n_active)} points "
        f"{grid_ms:.1f} ms ({n_occ} occupied voxels); test frame "
        f"{NERF_W}x{NERF_W} first {frame_s * 1e3:.1f} ms, warm "
        f"{warm_s * 1e3:.1f} ms ({n_rays / warm_s:.0f} rays/s), rays off "
        f"the background {hit:.3f}, launches of the first {launches}")
    assert launches["fused_block1_alpha"] == chunks, launches
    assert sum(launches.values()) == chunks, launches
    assert col.shape == (n_rays, 3) and np.isfinite(col).all() and hit > 0.05
    profile_call("phase 18: profiled perspective test frame",
                 lambda: model.render_image(item))
    model.cfg = dataclasses.replace(model.cfg, agg=dataclasses.replace(
        model.cfg.agg, fused_mlp="none"))
    plain = model.render_image(item)
    diff = float(np.abs(col - plain).max())
    log(f"phase 18: test frame, kernel path vs un-fused path: max |diff| "
        f"{diff:.3e} (tolerance {RENDER_ATOL})")
    assert diff <= RENDER_ATOL, diff
    del model
    torch.cuda.empty_cache()



# ---------------------------------------------------- 19. the DTU path
DTU_VIEWS = 49                     # DTU's views a scan
DTU_NATIVE = (640, 512)            # MVSNet's rectified training images
DTU_DEPTH = (160, 128)             # its depth maps and cam files (1/4)
DTU_F = 720.0                      # native focal (pixels)
DTU_FF_STEPS = 10
# ground plane 0 of dtu_ft's table (pointnerf dtu_ft_dataset.py:894-899)
DTU_PLANE_PNT = np.array([-0.49666997, 0.52160616, 3.6239593])
DTU_PLANE_N = np.array([-0.11364093, 0.38778102, 0.91471942])
DTU_SPHERE_R = 0.35
DTU_TABLE_R = 0.8                  # depth maps cover the table this far
MVS_CPU_TOL = {"depth": 1e-4, "prob": 1e-4, "conf": 1e-4, "flips": 0.01}


def script_args(path):
    """The python command's arguments of a dev_scripts/*.sh (its `source`d
    body put in place, its shell variables substituted)."""
    import shlex
    lines = []
    for line in open(path).read().replace("\\\n", " ").splitlines():
        if line.strip().startswith("source "):
            inc = os.path.join(os.path.dirname(path),
                               os.path.basename(shlex.split(line)[1]))
            lines += open(inc).read().replace("\\\n", " ").splitlines()
        else:
            lines.append(line)
    env = {}
    for line in lines:
        k, eq, v = line.partition("=")
        if eq and k.isidentifier():
            env[k] = (shlex.split(v) or [""])[0]
    cmd = next(l_ for l_ in lines if l_.strip().startswith("python"))
    for k in sorted(env, key=len, reverse=True):
        cmd = cmd.replace("${" + k + "}", env[k]).replace("$" + k, env[k])
    return shlex.split(cmd)[2:]


def _dtu_cast(pos, dirs):
    """z-depth t (dirs have camera z = 1 in their frame, turned to world)
    of the first hit of the sphere on the table or of the table, the
    surface (0 sphere, 1 table, -1 none) and the hit points; float64
    tensors on the rays' device."""
    import torch
    dev = dirs.device
    n = torch.tensor(DTU_PLANE_N / np.linalg.norm(DTU_PLANE_N), device=dev)
    p0 = torch.tensor(DTU_PLANE_PNT, device=dev)
    c0 = p0 - DTU_SPHERE_R * n
    pos = torch.as_tensor(pos, device=dev)
    oc = pos - c0
    b = dirs @ oc
    a = (dirs * dirs).sum(-1)
    disc = b * b - a * ((oc @ oc) - DTU_SPHERE_R ** 2)
    inf = torch.full_like(b, float("inf"))
    t_s = torch.where(disc > 0, (-b - disc.clamp(min=0).sqrt()) / a, inf)
    t_s = torch.where(t_s > 0, t_s, inf)
    dn = dirs @ n
    t_p = torch.where(dn > 1e-6, ((p0 - pos) @ n) / torch.where(
        dn > 1e-6, dn, torch.ones_like(dn)), inf)
    t = torch.minimum(t_s, t_p)
    miss = torch.isinf(t)
    surf = torch.where(miss, -1, torch.where(t_s <= t_p, 0, 1))
    t = torch.where(miss, torch.zeros_like(t), t)
    return t, surf, pos + dirs * t[:, None]


def write_dtu_scan(root, seed=12, dev="cuda"):
    """A seeded DTU scan in the MVSNet layout at DTU's sizes: 49 views
    (seven rings of seven around the plane's normal, 3.2 m from a 0.35 m
    sphere standing on plane 0), pair.txt with 10 sources a view by
    viewing angle, 640x512 textured images, 160x128 depth maps (the
    sphere and the table within 0.8 m of its foot) and cam files at 1/4
    scale. The rays are cast on `dev`."""
    import torch
    from PIL import Image
    rng = np.random.default_rng(seed)
    n = DTU_PLANE_N / np.linalg.norm(DTU_PLANE_N)
    c0 = DTU_PLANE_PNT - DTU_SPHERE_R * n
    u = np.cross(n, [1.0, 0, 0])
    u /= np.linalg.norm(u)
    v_ = np.cross(n, u)
    cams, fwds = [], []
    for r in range(7):
        th = np.radians(8 + 4 * r)
        for j in range(7):
            ph = 2 * np.pi * j / 7 + 0.3 * r
            fwd = np.cos(th) * n + np.sin(th) * (np.cos(ph) * u
                                                  + np.sin(ph) * v_)
            pos = c0 - 3.2 * fwd
            x = np.cross([0.0, 1.0, 0.0], fwd)
            x /= np.linalg.norm(x)
            c2w = np.eye(4)
            c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = (
                x, np.cross(fwd, x), fwd, pos)
            cams.append(c2w)
            fwds.append(fwd)
    camdir = os.path.join(root, "Cameras", "train")
    rect = os.path.join(root, "Rectified", "scan1_train")
    depths = os.path.join(root, "Depths", "scan1_train")
    for d in (camdir, rect, depths):
        os.makedirs(d, exist_ok=True)
    fwds = np.stack(fwds)
    pair = [str(DTU_VIEWS)]
    k4 = np.array([[DTU_F / 4, 0, DTU_NATIVE[0] / 8],
                   [0, DTU_F / 4, DTU_NATIVE[1] / 8], [0, 0, 1]])
    for vid, c2w in enumerate(cams):
        ang = np.degrees(np.arccos(np.clip(fwds @ fwds[vid], -1, 1)))
        srcs = [int(s) for s in np.argsort(ang) if s != vid][:10]
        pair += [str(vid), " ".join([str(len(srcs))] + [
            f"{s} {100 - ang[s]:.3f}" for s in srcs])]
        w2c = np.linalg.inv(c2w)
        with open(os.path.join(camdir, f"{vid:08d}_cam.txt"), "w") as f:
            f.write("extrinsic\n" + "\n".join(
                " ".join(f"{x:.8f}" for x in row) for row in w2c)
                + "\n\nintrinsic\n" + "\n".join(
                " ".join(f"{x:.8f}" for x in row) for row in k4)
                + f"\n\n2.0 {(4.725 - 2.0) / 192:.6f}\n")
        for (W, H), scale, kind in ((DTU_NATIVE, 4.0, "img"),
                                    (DTU_DEPTH, 1.0, "depth")):
            k = k4 * np.array([[scale], [scale], [1.0]])
            gy, gx = torch.meshgrid(
                torch.arange(H, dtype=torch.float64, device=dev),
                torch.arange(W, dtype=torch.float64, device=dev),
                indexing="ij")
            d_cam = torch.stack([(gx + 0.5 - k[0, 2]) / k[0, 0],
                                 (gy + 0.5 - k[1, 2]) / k[1, 1],
                                 torch.ones_like(gx)], -1).reshape(-1, 3)
            t, surf, hit = _dtu_cast(
                c2w[:3, 3], d_cam @ torch.tensor(c2w[:3, :3].T, device=dev))
            if kind == "depth":
                far_table = (surf == 1) & ((hit - torch.tensor(
                    DTU_PLANE_PNT, device=dev)).norm(dim=-1) > DTU_TABLE_R)
                depth = torch.where(far_table | (surf < 0),
                                    torch.zeros_like(t), t).cpu().numpy()
                with open(os.path.join(depths, f"depth_map_{vid:04d}.pfm"),
                          "wb") as f:
                    f.write(b"Pf\n" + f"{W} {H}\n".encode() + b"-1.0\n")
                    np.flipud(depth.reshape(H, W)).astype("<f").tofile(f)
                continue
            ph = torch.tensor([0.0, 2.1, 4.2], device=dev)
            sph = 0.5 + 0.35 * torch.sin(
                9 * hit[:, :1] + 7 * hit[:, 1:2] + 5 * hit[:, 2:3] + ph)
            tab = 0.975 + 0.02 * torch.sin(3 * hit[:, :1] + ph) \
                * torch.cos(3 * hit[:, 1:2])
            col = torch.where((surf == 0)[:, None], sph, torch.where(
                (surf == 1)[:, None], tab, torch.zeros_like(tab)))
            col = col.cpu().numpy() + rng.normal(0, 0.004, col.shape)
            Image.fromarray((np.clip(col, 0, 1) * 255).round().astype(
                np.uint8).reshape(H, W, 3)).save(
                os.path.join(rect, f"rect_{vid + 1:03d}_3_r5000.png"),
                compress_level=1)
    with open(os.path.join(root, "Cameras", "pair.txt"), "w") as f:
        f.write("\n".join(pair) + "\n")


def timed(module, name, store):
    """Wrap module.<name> so each call's seconds (synchronised) are
    appended to store[name]. Returns the original."""
    import torch
    fn = getattr(module, name)

    def wrapped(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        store.setdefault(name, []).append(time.perf_counter() - t0)
        return out
    setattr(module, name, wrapped)
    return fn


def phase19_mvsnet(dataset, opt, dev):
    """MVSNet's depth inference at D 128 on one init item (3 views at
    img_wh) with seeded weights: the card against the port's CPU forward,
    and the ms of a call."""
    import torch
    from sgnerf_tpu_torch.runtime.mvs_bootstrap import mvs_model, mvsnet_inputs
    item = dataset.get_init_item(0)
    card = mvs_model(opt, dev)
    cpu = mvs_model(opt, "cpu")
    ins = mvsnet_inputs(item, opt.depth_grid, dev)
    with torch.no_grad():
        d, c, p = card.predict_depth(*ins[:3])
        ms = cuda_ms(lambda: card.predict_depth(*ins[:3]), reps=5)
        t0 = time.perf_counter()
        dc, cc, pc = cpu.predict_depth(*mvsnet_inputs(item, opt.depth_grid,
                                                      "cpu")[:3])
        cpu_s = time.perf_counter() - t0
    d, c, p = d.cpu(), c.cpu(), p.cpu()
    near, far = float(item["near"]), float(item["far"])
    D = p.shape[0]
    ar = torch.arange(D, dtype=torch.float32)[:, None, None]
    same = (p * ar).sum(0).int() == (pc * ar).sum(0).int()
    err = {"depth": float((d - dc).abs().max()) / (far - near),
           "prob": float((p - pc).abs().max()),
           "conf": float((c - cc).abs()[same].max()),
           "flips": float((~same).float().mean())}
    log(f"phase 19: MVSNet depth inference, {len(item['images'])} views "
        f"{tuple(item['images'].shape[1:3])}, D {D}, depth {tuple(d.shape)}: "
        f"card {ms:.2f} ms a call (CPU forward {cpu_s:.1f} s); card vs CPU: "
        f"depth {err['depth']:.2e} of (far - near), prob {err['prob']:.2e}, "
        f"conf {err['conf']:.2e} where the truncated index agrees, which it "
        f"does not on {err['flips']:.2%} (limits {MVS_CPU_TOL}); finite "
        f"{bool(torch.isfinite(d).all())}")
    assert torch.isfinite(d).all() and torch.isfinite(c).all()
    assert all(err[k] <= MVS_CPU_TOL[k] for k in err), err


def phase19_inftest(ck, flags):
    """inftest_scan1.sh's flags through train_ft at --maximum_step 0: the
    MVS bootstrap, every train frame's plane background, the save, the
    export and the test frame; once on the dataset's depth, once on
    MVSNet's. Then the test frame again, warm and under torch.profiler."""
    import torch
    from sgnerf_tpu_torch.models import background
    from sgnerf_tpu_torch.options import TestOptions
    from sgnerf_tpu_torch.run import train_ft
    from sgnerf_tpu_torch.runtime import mvs_bootstrap
    from sgnerf_tpu_torch.runtime.scene_model import SceneModel
    from sgnerf_tpu_torch.utils.metrics import psnr
    from sgnerf_tpu_torch.data import create_dataset
    runs = {
        "dataset depth": {"--manual_depth_view": ["0"]},
        "MVSNet depth": {"--manual_depth_view": ["1"],
                         "--depth_conf_thresh": ["0"],
                         "--geo_cnsst_num": ["0"]},
    }
    log("phase 19: reduction: the cloud comes from --manual_depth_view 0 "
        "(the dataset's depth maps), not 1: seeded MVSNet weights give "
        "meaningless confidences")
    log("phase 19: reduction: a second bootstrap with --manual_depth_view 1 "
        "--depth_conf_thresh 0 --geo_cnsst_num 0 runs the MVSNet branch end "
        "to end")
    counts = {}
    for i, (what, over) in enumerate(runs.items()):
        name = f"inf{i}"
        store = {}
        origs = [(mvs_bootstrap, "gen_points_filter_embeddings",
                  timed(mvs_bootstrap, "gen_points_filter_embeddings",
                        store)),
                 (train_ft, "create_all_bg",
                  timed(train_ft, "create_all_bg", store))]
        tee = Tee(sys.stdout)
        reset_launches()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(tee):
                train_ft.main(with_flags(flags, dict(over, **{
                    "--name": [name]})))
        finally:
            for mod, attr, fn in origs:
                setattr(mod, attr, fn)
        torch.cuda.synchronize()
        launches = read_launches()
        out = tee.buf.getvalue()
        n = int(out.split("MVS bootstrap produced ")[1].split()[0])
        counts[what] = n
        psnr_l = [l_ for l_ in out.splitlines() if "psnr:" in l_]
        log(f"phase 19: train_ft with inftest_scan1.sh's flags ({what}): "
            f"{n} points; bootstrap {store['gen_points_filter_embeddings'][0]:.2f}"
            f" s, create_all_bg over the train frames "
            f"{store['create_all_bg'][0]:.2f} s, whole run "
            f"{time.perf_counter() - t0:.1f} s; {psnr_l[-1].strip()}; "
            f"{sum(launches.values())} kernel launches {launches}")
        assert "[bgmodel] plane backgrounds for" in out
        assert "training from step 0 to 0" in out and n > 1000
        assert sum(launches.values()) == 0, launches
        for f in ("0_net_ray_marching.npz", "0_net_ray_marching.pth"):
            assert os.path.exists(os.path.join(ck, name, f)), f
        assert all(np.isfinite(float(l_.split("psnr:")[1].split()[0]))
                   for l_ in psnr_l)

    # the test frame again: warm, its PSNR, under the profiler
    topt = TestOptions().parse(with_flags(flags, {
        "--name": ["inf0"], "--resume_iter": ["0"], "--resume_dir": [""]}))
    topt.split, topt.random_sample = "test", "no_crop"
    ds = create_dataset(topt)
    model = SceneModel(topt)
    with contextlib.redirect_stdout(io.StringIO()):
        model.load_checkpoint(model.resolve_resume())
    item = ds.get_item(0, full_img=True)
    init = ds.get_init_item(0)
    act = model.cloud.active
    cloud = model.cloud.xyz[act].cpu().numpy()
    bg = background.plane_bg_ray(item, init, cloud, device=model.device)
    reset_launches()
    col = model.render_image(item, bg_image=bg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    col = model.render_image(item, bg_image=bg)
    warm_ms = (time.perf_counter() - t0) * 1e3
    hit = float(np.mean(np.any(bg > 0, -1)))
    log(f"phase 19: test frame {item['w']}x{item['h']} with its plane "
        f"background ({hit:.1%} of rays with a plane colour): warm "
        f"{warm_ms:.1f} ms, PSNR {psnr(col, item['gt_image']):.3f}, "
        f"launches {read_launches()}")
    assert np.isfinite(col).all() and hit > 0.05
    assert sum(read_launches().values()) == 0
    profile_call("phase 19: profiled test frame",
                 lambda: model.render_image(item, bg_image=bg))
    del model
    torch.cuda.empty_cache()
    return counts


def phase19_ete(ck, flags):
    """dtu_dgt_d012_img0123_conf_color_dir_agg2.sh's flags through
    run/train.py: DTU_FF_STEPS steps (a save halfway and at the end), the
    median step, one step under torch.profiler, then a resume from the
    last save for two more steps; FeatureNet's first weight must have
    moved."""
    import pickle
    import torch
    from sgnerf_tpu_torch.models import feedforward as ff
    from sgnerf_tpu_torch.models.mvs import MVSConfig, init_mvs_params
    from sgnerf_tpu_torch.run import train
    step_s = []
    make = train.make_feedforward_step

    def timed_make(*args, **kw):
        fn = make(*args, **kw)

        def step(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            if len(step_s) == 3:
                profile_call("phase 19: profiled feed-forward step",
                             lambda: fn(*a, **k))
            return out
        return step
    train.make_feedforward_step = timed_make
    half = str(DTU_FF_STEPS // 2)
    tee = Tee(sys.stdout)
    reset_launches()
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            train.main(with_flags(flags, {
                "--maximum_step": [str(DTU_FF_STEPS)],
                "--save_iter_freq": [half], "--print_freq": [half]}))
        run_s = time.perf_counter() - t0
        launches = read_launches()
        out = tee.buf.getvalue()
        n_pts = sorted({l_.split("n_points: ")[1].split(",")[0]
                        for l_ in out.splitlines() if "n_points: " in l_})
        log(f"phase 19: run/train.py with the ete script's flags: "
            f"{DTU_FF_STEPS} steps in {run_s:.1f} s, n_points {n_pts}, "
            f"step ms {[round(s * 1e3, 1) for s in step_s]}, median "
            f"{statistics.median(step_s[:DTU_FF_STEPS]) * 1e3:.1f} ms; "
            f"{sum(launches.values())} kernel launches {launches}")
        assert sum(launches.values()) == 0, launches
        expr = os.path.join(ck, "dtu_dgt_d012_img0123_conf_color_dir_agg2")
        for f in (f"{half}_feedforward.pkl", f"{DTU_FF_STEPS}_feedforward.pkl",
                  f"{DTU_FF_STEPS}_feedforward.npz"):
            assert os.path.exists(os.path.join(expr, f)), f
        losses = [l_ for l_ in out.splitlines() if l_.startswith("step: ")]
        assert losses and all("ray_depth_masked_coarse_raycolor" in l_
                              for l_ in losses), losses
        tee = Tee(sys.stdout)
        with contextlib.redirect_stdout(tee):
            train.main(with_flags(flags, {
                "--maximum_step": [str(DTU_FF_STEPS + 2)],
                "--save_iter_freq": [half], "--print_freq": ["1"]}))
    finally:
        train.make_feedforward_step = make
    out = tee.buf.getvalue()
    line = next(l_ for l_ in out.splitlines() if "resumed" in l_)
    log(f"phase 19: resume: {line.strip()}; then steps "
        f"{[l_.split(',')[0] for l_ in out.splitlines() if l_.startswith('step: ')]}")
    assert f"{DTU_FF_STEPS}_feedforward.pkl (step {DTU_FF_STEPS})" in line
    with open(os.path.join(expr, f"{DTU_FF_STEPS}_feedforward.pkl"),
              "rb") as f:
        tree = pickle.load(f)
    from sgnerf_tpu_torch.models.params import mvs_params_from_jax
    w = ff.tree_leaves(mvs_params_from_jax(tree["mvs"])["FeatureNet"])[0]
    w0 = ff.tree_leaves(init_mvs_params(0, MVSConfig())["FeatureNet"])[0]
    moved = float((w - w0).abs().max())
    log(f"phase 19: FeatureNet's first weight moved by {moved:.3e} (max) "
        f"over {DTU_FF_STEPS} steps")
    assert moved > 0
    torch.cuda.empty_cache()


def phase19_dtu(dev="cuda", inf_over=None, ete_over=None):
    """Phase 19: the DTU path on a seeded DTU scan at DTU's sizes: MVSNet's
    depth inference (card vs CPU), inftest_scan1.sh through train_ft (the
    MVS bootstrap, the plane background), the ete script through
    run/train.py (the feed-forward trainer, save and resume); no kernel
    launches on either path. inf_over / ete_over ({flag: [values]}) and
    dev="cpu" serve a rehearsal on the CPU at a small size."""
    from sgnerf_tpu_torch.data import create_dataset
    from sgnerf_tpu_torch.options import TrainOptions
    build = os.path.join(REPO, "build")
    data = os.path.join(build, "smoke_dtu_data")
    ck = os.path.join(build, "smoke_dtu")
    t0 = time.perf_counter()
    write_dtu_scan(data, dev=dev)
    log(f"phase 19: DTU scan ({DTU_VIEWS} views {DTU_NATIVE[0]}x"
        f"{DTU_NATIVE[1]}, depth {DTU_DEPTH[0]}x{DTU_DEPTH[1]}) written in "
        f"{time.perf_counter() - t0:.1f} s")
    inf = with_flags(script_args(os.path.join(
        REPO, "dev_scripts", "dtu_test_inf", "inftest_scan1.sh")), {
        "--data_root": [data], "--checkpoints_dir": [ck],
        "--resume_dir": [os.path.join(ck, "no_init")],
        "--pre_d_est": [os.path.join(ck, "no_mvsnet.ckpt")],
        "--gpu_ids": ["0" if dev == "cuda" else "-1"], **(inf_over or {})})
    opt = TrainOptions().parse(inf)
    opt.split = "train"
    phase19_mvsnet(create_dataset(opt), opt, dev)
    phase19_inftest(ck, inf)
    ete = with_flags(script_args(os.path.join(
        REPO, "dev_scripts", "ete",
        "dtu_dgt_d012_img0123_conf_color_dir_agg2.sh")), {
        "--data_root": [data], "--checkpoints_dir": [ck],
        "--gpu_ids": ["0" if dev == "cuda" else "-1"],
        "--resume_dir": [os.path.join(ck, "no_init")], **(ete_over or {})})
    phase19_ete(ck, ete)


# ---------------------------------------------------------------- phase 20

# the edit: the points of a box on the +x wall, cropped out of the room scan
# and put back rotated 30 deg about z and moved inward, in view of the
# phase-8 export's views 0 and 3 (yaw 0 and pi)
EDIT_BOX = (np.array([1.9, -0.8, -0.4], np.float32),
            np.array([2.7, 0.8, 0.6], np.float32))
EDIT_DEG = 30.0
EDIT_SHIFT = (-0.6, 0.6, 0.0)
EDIT_VIEWS = ["0", "3"]
VID_FRAMES = 4
# LPIPS on the card (IEEE f32 convolutions) vs the CPU, random weights
LPIPS_TOL = 1e-4


def edit_transform():
    a = np.deg2rad(EDIT_DEG)
    T = np.eye(4)
    T[:3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                 [0, 0, 1]]
    T[:3, 3] = EDIT_SHIFT
    return T


def write_edit_parts(parts):
    """The editor's workflow on the phase-3 room scan: the box's points
    selected, cropped out of the scene (crop_point_cloud), both saved as
    reference .pth files; the transform file. Returns (points in the box,
    points left, crop s, save s)."""
    from sgnerf_tpu_torch.editor import NeuralPointCloudEdit, crop_point_cloud
    os.makedirs(parts, exist_ok=True)
    scene = NeuralPointCloudEdit.from_checkpoint(os.path.join(
        REPO, "build", "smoke", "0_net_ray_marching.npz"))
    lo, hi = EDIT_BOX
    box = scene.select(np.all((scene.xyz >= lo) & (scene.xyz <= hi), 1))
    t0 = time.perf_counter()
    rest = crop_point_cloud(box, scene)
    crop_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rest.to_checkpoint(os.path.join(parts, "rest.pth"))
    box.to_checkpoint(os.path.join(parts, "box.pth"))
    save_s = time.perf_counter() - t0
    np.savetxt(os.path.join(parts, "T.txt"), edit_transform())
    assert box.n + rest.n == scene.n and box.n > scene.n // 1000, box.n
    return box.n, rest.n, crop_s, save_s


def pixel_ray(item, xyz):
    """Index of the item's ray through the pixel where world point xyz
    projects."""
    c2w = item["c2w"].astype(np.float64)
    p = (np.asarray(xyz, np.float64) - c2w[:3, 3]) @ c2w[:3, :3]
    K = np.asarray(item["intrinsic"], np.float64)
    u = int(K[0, 0] * p[0] / p[2] + K[0, 2])
    v = int(K[1, 1] * p[1] / p[2] + K[1, 2])
    pix = item["pixel_idx"]
    hit = np.nonzero((pix[:, 0] == u) & (pix[:, 1] == v))[0]
    assert p[2] > 0 and len(hit) == 1, (u, v, p)
    return int(hit[0])


def write_lpips_weights(d, seed=0):
    """Random-valued AlexNet/VGG16 trunks and calibration heads in the
    files utils/lpips.py looks for (torchvision and lpips layouts)."""
    import torch
    from sgnerf_tpu_torch.utils.lpips import (_ALEX_CONVS, _ALEX_IDX,
                                              _VGG_CFG, _tv_vgg_conv_indices)
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)

    def conv(o, i, k):
        return torch.as_tensor(rng.normal(scale=0.05, size=(o, i, k, k))
                               .astype(np.float32))
    alex = {}
    for idx, (o, i, k, _, _, _) in zip(_ALEX_IDX, _ALEX_CONVS):
        alex[f"features.{idx}.weight"] = conv(o, i, k)
        alex[f"features.{idx}.bias"] = torch.zeros(o)
    vgg, cin = {}, 3
    for idx, v in zip(_tv_vgg_conv_indices(),
                      [c for c in _VGG_CFG if c != "M"]):
        vgg[f"features.{idx}.weight"] = conv(v, cin, 3)
        vgg[f"features.{idx}.bias"] = torch.zeros(v)
        cin = v

    def lin(chans):
        return {f"lin{i}.model.1.weight": torch.as_tensor(
            rng.uniform(0, 0.1, (1, c, 1, 1)).astype(np.float32))
            for i, c in enumerate(chans)}
    torch.save(alex, os.path.join(d, "alexnet-smoke.pth"))
    torch.save(lin([64, 192, 384, 256, 256]), os.path.join(d, "alex.pth"))
    torch.save(vgg, os.path.join(d, "vgg16-smoke.pth"))
    torch.save(lin([64, 128, 256, 512, 512]), os.path.join(d, "vgg.pth"))


def phase20_edit(flags, data):
    """Phase 20a: the editing CLI on the cropped and moved box, 2 test
    frames with the counters reset just before; then the edit frame's
    checks. Returns the edited model and the frame's item."""
    import torch
    from sgnerf_tpu_torch.data import create_dataset
    from sgnerf_tpu_torch.models import aggregator as agg_mod
    from sgnerf_tpu_torch.models import renderer as ren_mod
    from sgnerf_tpu_torch.models.aggregator import _rot_vec
    from sgnerf_tpu_torch.options import EditOptions
    from sgnerf_tpu_torch.run import editing

    opt = EditOptions().parse(flags)
    opt.split, opt.random_sample = "test", "no_crop"
    item = create_dataset(opt).get_item(0, full_img=True)
    centre = (EDIT_BOX[0] + EDIT_BOX[1]) / 2
    # where the box's centre moves (transform_point_cloud_global: x R + t)
    ray = pixel_ray(item, centre @ edit_transform()[:3, :3]
                    + np.asarray(EDIT_SHIFT))
    n_rays = len(item["raydir"])
    chunks = -(-n_rays // 9216)
    chunk = ray // 9216
    store = {}
    k2_fn = capture_first_call(agg_mod, "fused_block1_alpha", store,
                               call=chunk)
    ga_fn = capture_first_call(ren_mod, "gather_and_aggregate", store,
                               call=chunk)
    tee = Tee(sys.stdout)
    reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(tee):
            model = editing.main(flags)
        torch.cuda.synchronize()
    finally:
        agg_mod.fused_block1_alpha = k2_fn
        ren_mod.gather_and_aggregate = ga_fn
    cli_s = time.perf_counter() - t0
    launches = read_launches()
    frame_s = [float(l_.split("render time:")[1].split()[0])
               for l_ in tee.buf.getvalue().splitlines()
               if l_.startswith("edit frame")]
    cloud = model.cloud
    log(f"phase 20: editing CLI ({int(cloud.n_active)} points, rotation "
        f"table {tuple(cloud.Rw2c.shape)}) rendered {len(frame_s)} frames "
        f"of {n_rays} rays in {cli_s:.1f} s (frames {frame_s} s), launches "
        f"{launches} ({chunks} chunks a frame) [{SMI}]")
    assert len(frame_s) == len(EDIT_VIEWS) and cloud.Rw2c.shape[0] == 2
    assert launches["fused_knn_select"] == chunks * len(frame_s), launches
    assert launches["fused_block1_alpha"] == chunks * len(frame_s), launches
    assert sum(launches.values()) == 2 * chunks * len(frame_s), launches

    # the same camera, warm: the edited scene, then the default scene
    col = model.render_image(item)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    col = model.render_image(item)
    edit_ms = (time.perf_counter() - t0) * 1e3
    assert col.shape == (n_rays, 3) and np.isfinite(col).all()

    # the rotation on the captured chunk: its table's bytes, the gather
    # and the rotation of the offsets K2 takes, each timed alone
    args, kwargs = store["fused_block1_alpha"]
    pidx = store["gather_and_aggregate"][0][4]        # sample_pidx
    pid = pidx.clamp(0, cloud.capacity - 1).long()

    def gather():
        return cloud.Rw2c[cloud.rot_idx[pid].long()]
    rot = gather()
    d3 = args[1][..., :3].reshape(rot.shape[:-1])
    valid = pidx >= 0
    moved_nb = int(((rot - torch.eye(3, device=rot.device)).abs().amax(
        (-2, -1)) > 0)[valid].sum())
    g_ms, r_ms = cuda_ms(gather), cuda_ms(lambda: _rot_vec(d3, rot))
    # a yardstick: the same product by torch.einsum, as the JAX package
    # writes it
    alt = torch.einsum("...i,...ji->...j", d3, rot)
    e_ms = cuda_ms(lambda: torch.einsum("...i,...ji->...j", d3, rot))
    log(f"phase 20: rotation on edit chunk {chunk} of {chunks}: per-"
        f"neighbour table {tuple(rot.shape)} = {rot.numel() * 4 / 2**20:.1f}"
        f" MiB, {moved_nb} of {int(valid.sum())} neighbours in the moved "
        f"part; gather {g_ms:.3f} ms, the offsets' rotation {r_ms:.3f} ms "
        f"(torch.einsum {e_ms:.3f} ms, max |diff| "
        f"{float((alt - _rot_vec(d3, rot)).abs().max()):.1e})")
    del alt
    assert moved_nb > 0
    errs = hold_k2(args, kwargs, "phase 20 (edit chunk)")
    del store, args, kwargs, rot, d3, pid, pidx, valid

    # 512 rays about the moved box's centre, kernel path vs un-fused path
    sub = slice(ray - 256, ray + 256)
    dev = model.device

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)
    kw = dict(campos=t(item["campos"])[None],
              raydir=t(item["raydir"][sub])[None],
              camrotc2w=t(item["camrotc2w"])[None], near=float(item["near"]),
              far=float(item["far"]), bg_color=t(item["bg_color"]),
              table=model.table)
    plain_cfg = dataclasses.replace(
        model.cfg, knn_mode="exact",
        agg=dataclasses.replace(model.cfg.agg, fused_mlp="none"))
    with torch.inference_mode():
        a = ren_mod.render_rays(model.params, cloud, model.grid, model.cfg,
                                **kw)["coarse_raycolor"]
        b = ren_mod.render_rays(model.params, cloud, model.grid, plain_cfg,
                                **kw)["coarse_raycolor"]
    err = float((a - b).abs().max())
    log(f"phase 20: 512 edit rays about the moved box, kernel path vs "
        f"un-fused path: max |diff| {err:.3e} (tolerance {RENDER_ATOL})")
    assert torch.isfinite(a).all() and err <= RENDER_ATOL
    return model, item, kw, edit_ms, errs


def phase20_tools():
    """Phase 20: the tools at full width on the phase-3 room scan and the
    phase-8 export: editing, the edited scene's .pth round trip, test_edit
    with the label cloud and its IoU, render_vid, the viewer,
    vis_grow_train and evaluate with LPIPS."""
    import urllib.request

    import torch
    from sgnerf_tpu_torch.options import TestOptions
    from sgnerf_tpu_torch.run import (evaluate, gui, render_vid, result,
                                      test_edit, vis_grow_train)
    from sgnerf_tpu_torch.runtime.scene_model import (SceneModel,
                                                      factor_rotations)
    from sgnerf_tpu_torch.models.checkpoint_io import load_torch_state_dict
    from sgnerf_tpu_torch.utils import lpips as lpips_mod
    from sgnerf_tpu_torch.utils.ply import write_ply

    build = os.path.join(REPO, "build")
    base = os.path.join(build, "smoke_edit")
    parts = os.path.join(base, "parts")
    data = ["--data_root", os.path.join(build, "smoke_scans") + "/",
            "--scan", "scene_smoke", "--dataset_name", "scannet_ft",
            "--test_list"] + EDIT_VIEWS
    t0 = time.perf_counter()
    n_box, n_rest, crop_s, save_s = write_edit_parts(parts)
    log(f"phase 20: editor: {n_box} points in the box cropped from the "
        f"room scan ({n_rest} left) in {crop_s:.2f} s; both parts saved as "
        f".pth in {save_s:.2f} s")
    flags = with_flags(TEST_DEFAULT_FLAGS, {
        "--name": ["edit"], "--checkpoints_dir": [base]}) + data + [
        "--resume_dir", parts, "--neural_points_names", "rest.pth", "box.pth",
        "--Transformation_names", "identity", "T.txt"]
    model, item, kw, edit_ms, _ = phase20_edit(flags, data)

    # the default scene on the same camera, warm
    opt = TestOptions().parse(TEST_DEFAULT_FLAGS + data)
    default = SceneModel(opt)
    default.load_checkpoint(default.resolve_resume())
    default.render_image(item)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    default.render_image(item)
    default_ms = (time.perf_counter() - t1) * 1e3
    log(f"phase 20: warm frame of edit view 0: edited scene {edit_ms:.1f} "
        f"ms, default scene {default_ms:.1f} ms "
        f"({edit_ms / default_ms - 1:+.1%}) [{SMI}]")
    del default
    torch.cuda.empty_cache()

    # the edited scene's .pth round trip (a dense per-point Rw2c)
    t1 = time.perf_counter()
    model.export_reference(1)
    export_s = time.perf_counter() - t1
    pth = os.path.join(model.expr_dir, "1_net_ray_marching.pth")
    dense = load_torch_state_dict(pth)["neural_points.Rw2c"]
    t1 = time.perf_counter()
    table, rot_idx = factor_rotations(dense)
    unique_s = time.perf_counter() - t1
    opt = TestOptions().parse(with_flags(TEST_DEFAULT_FLAGS, {
        "--name": ["edit"], "--checkpoints_dir": [base],
        "--resume_iter": ["1"]}) + data)
    loaded = SceneModel(opt)
    t1 = time.perf_counter()
    loaded.load_checkpoint(loaded.resolve_resume())
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t1
    n = int(model.cloud.n_active)
    np.testing.assert_array_equal(table[rot_idx], dense)
    np.testing.assert_array_equal(
        loaded.cloud.Rw2c.cpu().numpy()[loaded.cloud.rot_idx.cpu().numpy()
                                        [:n]], dense)
    with torch.inference_mode():
        a, b = render_rays_of(loaded, kw), render_rays_of(model, kw)
    err = float((a - b).abs().max())
    log(f"phase 20: edited scene .pth round trip ({n} points, dense Rw2c "
        f"{tuple(dense.shape)}): export {export_s:.2f} s, np.unique factor "
        f"{unique_s:.2f} s of a load of {load_s:.2f} s -> table "
        f"{tuple(table.shape)}; 512 rays of the loaded scene vs the edited "
        f"one: max |diff| {err:.3e} [{SMI}]")
    assert table.shape[0] == 2 and err <= 1e-6
    del model, loaded, a, b, dense
    torch.cuda.empty_cache()

    # test_edit on the loaded .pth: 1 frame and the predicted-label cloud
    te_flags = with_flags(TEST_DEFAULT_FLAGS, {
        "--name": ["edit"], "--checkpoints_dir": [base],
        "--resume_iter": ["1"]}) + data + ["--save_predict_label", "1",
                                           "--test_num_step", "2"]
    reset_launches()
    t1 = time.perf_counter()
    psnrs = test_edit.main(te_flags)
    torch.cuda.synchronize()
    te_s = time.perf_counter() - t1
    launches = read_launches()
    log(f"phase 20: test_edit ({len(psnrs)} frame, PSNR {psnrs}) with the "
        f"{n}-point label cloud in {te_s:.1f} s, launches {launches}")
    assert len(psnrs) == 1 and np.isfinite(psnrs).all()
    assert launches["fused_knn_select"] > 0 and \
        launches["fused_block1_alpha"] > 0
    pred = os.path.join(base, "edit", "images", "pred_label_cloud.txt")
    xyz = np.loadtxt(pred, delimiter=";", usecols=(0, 1, 2)).astype(
        np.float32)
    # the labelled mesh: the room scan's surfaces as ScanNet-40 ids
    mesh = os.path.join(base, "gt.labels.ply")
    from sgnerf_tpu_torch.data.synthetic import room_scan
    room = room_scan(np.random.default_rng(0), N_POINTS)
    write_ply(mesh, {"x": room[:, 0], "y": room[:, 1], "z": room[:, 2],
                     "label": room_surface_ids(room).astype(np.uint8)})
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):       # 20 class lines
        miou = result.main(["--pred", pred, "--gt_labels_ply", mesh])
    log(f"phase 20: result (IoU of {len(xyz)} label points against a "
        f"{N_POINTS}-vertex mesh) {miou:.4f} in "
        f"{time.perf_counter() - t1:.1f} s")
    assert len(xyz) == n and 0.0 <= miou <= 1.0

    # render_vid: the SLERP path through the two test views
    reset_launches()
    t1 = time.perf_counter()
    vflags = TEST_DEFAULT_FLAGS + data + ["--render_stride",
                                          str(VID_FRAMES)]
    tee = Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        n_frames = render_vid.main(vflags)
    torch.cuda.synchronize()
    vid_ms = [float(l_.split("render time:")[1].split()[0]) * 1e3
              for l_ in tee.buf.getvalue().splitlines()
              if l_.startswith("frame ")]
    log(f"phase 20: render_vid {n_frames} frames in "
        f"{time.perf_counter() - t1:.1f} s (frames {vid_ms} ms), launches "
        f"{read_launches()} [{SMI}]")
    assert n_frames == VID_FRAMES == len(vid_ms)

    # one viewer render through its HTTP server
    viewer = gui.Viewer(TestOptions().parse(TEST_DEFAULT_FLAGS + data))
    server = gui.make_server(viewer, 0, "127.0.0.1")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = (f"http://127.0.0.1:{server.server_address[1]}/render?"
               f"az={np.pi / 2}&el=0&r=0.1")
        urllib.request.urlopen(url, timeout=120).read()
        t1 = time.perf_counter()
        jpeg = urllib.request.urlopen(url, timeout=120).read()
        view_ms = (time.perf_counter() - t1) * 1e3
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
    from PIL import Image
    with Image.open(io.BytesIO(jpeg)) as im:
        size = im.size
    # the same camera's pixels before the JPEG: most see the room
    hit = float((viewer.render_rgb(np.pi / 2, 0.0, 0.1, np.zeros(
        3, np.float32)) != 255).any(-1).mean())
    log(f"phase 20: viewer /render {size[0]}x{size[1]} JPEG ({len(jpeg)} "
        f"B) in {view_ms:.1f} ms warm, pixels off the background {hit:.3f}"
        f" [{SMI}]")
    assert jpeg[:2] == b"\xff\xd8" and size == (viewer.W, viewer.H)
    assert hit > 0.5, hit
    del viewer
    torch.cuda.empty_cache()

    # vis_grow_train: one probe frame (2304-ray chunks)
    reset_launches()
    t1 = time.perf_counter()
    counts = vis_grow_train.main(TEST_DEFAULT_FLAGS + data + [
        "--test_num", "1", "--prob_thresh", "0.0"])
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"phase 20: vis_grow_train 1 probe frame, {counts} probe points, "
        f"in {time.perf_counter() - t1:.1f} s, launches {launches} [{SMI}]")
    assert counts[0] > 0 and launches["fused_block1_alpha"] > 0

    # evaluate with LPIPS on the card, against the CPU
    weights = os.path.join(base, "lpips")
    write_lpips_weights(weights)
    os.environ["SGNERF_LPIPS"] = weights
    lpips_mod._load.cache_clear()
    imgs = os.path.join(base, "edit", "images", "test_edit")
    try:
        t1 = time.perf_counter()
        means = evaluate.main(["--gt_dir", imgs, "--img_dir", imgs,
                               "--gpu_ids", "0"])
        eval_s = time.perf_counter() - t1
        img = evaluate.load_image(os.path.join(
            imgs, "step-0000-coarse_raycolor.png"))
        gt = evaluate.load_image(os.path.join(imgs, "step-0000-gt_image.png"))
        for net in ("alex", "vgg"):
            card = lpips_mod.lpips_distance(img, gt, net, device="cuda:0")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            card = lpips_mod.lpips_distance(img, gt, net, device="cuda:0")
            card_ms = (time.perf_counter() - t1) * 1e3
            t1 = time.perf_counter()
            cpu = lpips_mod.lpips_distance(img, gt, net, device="cpu")
            cpu_ms = (time.perf_counter() - t1) * 1e3
            log(f"phase 20: LPIPS {net} at {img.shape[1]}x{img.shape[0]}: "
                f"card {card:.6f} in {card_ms:.1f} ms, CPU {cpu:.6f} in "
                f"{cpu_ms:.1f} ms, |diff| {abs(card - cpu):.3e} (tolerance "
                f"{LPIPS_TOL}) [{SMI}]")
            assert abs(card - cpu) <= LPIPS_TOL
            key = "lpips" if net == "alex" else "vgglpips"
            assert abs(means[key] - card) <= 1e-5, (means, card)
    finally:
        os.environ.pop("SGNERF_LPIPS")
        lpips_mod._load.cache_clear()
    log(f"phase 20: evaluate {means} in {eval_s:.1f} s; phase 20 "
        f"{time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------- phase 21

GATHER_VJPS = ("f32", "scatter", "sorted", "spread", "raydedup", "batchdedup")
GATHER_STEPS = 8
SR_DRAWS = 64
# the mean of SR_DRAWS stochastic roundings onto x's two bf16 neighbours:
# each draw is Bernoulli(p) on the ulp, so the mean's deviation has
# std sqrt(p (1 - p) / SR_DRAWS) <= 1/16 ulp; the RMS over the table of
# (mean - x) / ulp must lie below that (nearest rounding leaves ~0.29)
SR_RMS_LIMIT = 1 / 16


def bf16_limit(flat, rows, n):
    """The bf16 limit of two gather transposes' table gradients, per
    column: the largest count of one id's rows with a nonzero cotangent
    times one bf16 ulp of the largest sum of |cotangent| over an id's
    rows (a bf16 sum of d terms rounds d times, each by at most an ulp of
    the running sum). flat (M,) ids, rows (M, C) the cotangent rows."""
    import torch
    a = rows.float().abs()
    sums = torch.zeros((n, a.shape[1]), device=a.device).index_add_(
        0, flat, a).amax(0)
    dups = torch.zeros((n, a.shape[1]), device=a.device).index_add_(
        0, flat, (a > 0).float()).amax(0)
    e = torch.floor(torch.log2(torch.where(sums > 0, sums, 1.0)))
    return dups * torch.where(sums > 0, 2.0 ** (e - 7), 0.0)


def phase21_gathers(item, col):
    """Phase 21: the opt-in training gathers (ROADMAP queue 1 item 17) at
    full width: scene0113_00_default.sh's step on a bf16 attribute table
    under the six transposes (one step's losses bit-equal; point gradients
    within bf16_limit of the f32 transpose's; 8 steps each: median ms,
    peak GiB, K2/K3 launches, the overflow counts), stochastic rounding
    (on the bf16 grid, SR_DRAWS draws' mean within SR_RMS_LIMIT, 8 steps),
    the int8 gather (q, scale, zero on the card equal to the CPU's; 8
    steps), an eval frame with --knn_mode approx (ids equal to the exact
    select's, the frame within RENDER_ATOL of phase 4's), and 10 train_ft
    steps with --gather_dtype bfloat16 --gather_round stochastic
    --gather_vjp batchdedup on phase 8's export."""
    import torch
    from sgnerf_tpu_torch.models import renderer as ren
    from sgnerf_tpu_torch.models.train import loss_and_grads, trained_fields
    from sgnerf_tpu_torch.ops.quant import (quantize_table_int8,
                                            stochastic_round_bf16)
    from sgnerf_tpu_torch.options import TestOptions, TrainOptions
    from sgnerf_tpu_torch.run import train_ft
    from sgnerf_tpu_torch.runtime.scene_model import SceneModel
    t_phase = time.perf_counter()
    # what earlier phases leave behind moves the host-bound steps and the
    # peaks: collect it, and log the threads and Python objects that stay
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 21: live threads {[t.name for t in threading.enumerate()]}"
        f", Python objects {len(gc.get_objects())}, device memory "
        f"allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    build = os.path.join(REPO, "build")
    opt = TrainOptions().parse(TRAIN_FLAGS + [
        "--gather_dtype", "bfloat16", "--name", "smoke",
        "--checkpoints_dir", build])
    t0 = time.perf_counter()
    model = SceneModel(opt)
    model.load_checkpoint(model.resolve_resume())
    torch.cuda.synchronize()
    cfg = model.cfg
    assert (cfg.gather_dtype == "bfloat16" and cfg.agg.fused_mlp == "cuda"
            and cfg.agg.fused_bwd == "cuda"), cfg
    log(f"phase 21: train model, bf16 attribute table, loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    batch = train_batch(item, model.device)
    R = batch["raydir"].shape[1]
    dev = model.device
    n_rows = model.cloud.capacity
    F = model.cloud.embedding.shape[-1]
    cols = {"embedding": slice(3, 3 + F), "color": slice(3 + F, 6 + F),
            "conf": slice(9 + F, 10 + F)}
    fields = trained_fields(model.tcfg)
    T_rows = cfg.SR * cfg.K

    # one step's losses and point gradients under each transpose, from one
    # state and one noise draw
    seen = []
    orig = ren.gather_transpose

    def recording(c, rows):
        t = orig(c, rows)

        def run(flat, g, n):
            if not seen:
                seen.append((flat, g))
            return t(flat, g, n)
        return run
    gen = torch.Generator(device=dev).manual_seed(11)
    noise = ren.draw_render_noise(gen, cfg, 1, R)
    ren.gather_transpose = recording
    ref = losses = None
    worst = {}
    try:
        for v in GATHER_VJPS:
            c = dataclasses.replace(cfg, gather_vjp=v)
            if v == "raydedup":
                # at gvjp_U = SR*K no ray can overflow: the default's
                # dropped rows would make a difference of their own
                c = dataclasses.replace(c, gvjp_U=T_rows)
            loss, _, g_pts = loss_and_grads(model.state, model.grid, c,
                                            model.tcfg, batch, noise=noise)
            if ref is None:
                flat, g = seen[0]
                lim = bf16_limit(flat, g, n_rows)
                ref, losses = g_pts, loss
                continue
            assert set(loss) == set(losses) | (
                {"gvjp_overflow"} if v in ("raydedup", "batchdedup")
                else set()), (v, sorted(loss))
            for k in losses:
                assert torch.equal(loss[k], losses[k]), (v, k)
            worst[v] = {}
            for f, a, b in zip(fields, g_pts, ref):
                d = float((a - b).abs().max())
                L = float(lim[cols[f]].max())
                worst[v][f] = (d, L)
                assert d <= L, (v, f, d, L)
            del g_pts
    finally:
        ren.gather_transpose = orig
    log(f"phase 21: one step, the six transposes: losses bit-equal "
        f"(total {float(losses['total']):.6f}); point gradients vs the f32 "
        f"transpose, max |diff| (limit): "
        + "; ".join(f"{v} " + ", ".join(
            f"{f} {d:.3e} ({L:.3e})" for f, (d, L) in w.items())
            for v, w in worst.items()))
    del ref, seen[:], noise
    torch.cuda.empty_cache()

    def steps(c, what, n=GATHER_STEPS, profile=False):
        model.cfg = c
        model._table = None
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        ms, out = [], None
        for _ in range(n):
            t1 = time.perf_counter()
            out = model.optimize(batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
        over = (int(float(out["gvjp_overflow"])) if "gvjp_overflow" in out
                else None)
        log(f"phase 21: {n} steps, {what}: step ms "
            f"{[round(v, 1) for v in ms]}, median "
            f"{statistics.median(ms):.1f} ms, peak {peak:.2f} GiB, K2 "
            f"{launches['fused_block1_alpha']} K3 "
            f"{launches['fused_block1_alpha_bwd']}, loss "
            f"{float(out['total']):.6f}"
            + ("" if over is None else f", gvjp_overflow {over}")
            + f" [{SMI}]")
        assert np.isfinite(float(out["total"]))
        assert launches == {"fused_knn_select": 0, "fused_block1_alpha": n,
                            "fused_block1_alpha_bwd": n,
                            "fused_block1_alpha_color": 0,
                            "fused_block1_alpha_color_march": 0,
                            "fused_knn_select_tiled": 0, **NO_GATHER}, \
            launches
        if profile:
            profile_call(f"phase 21: profiled step, {what}:",
                         lambda: model.optimize(batch))
        return over

    for v in GATHER_VJPS:
        over = steps(dataclasses.replace(cfg, gather_vjp=v),
                     f"bf16 table, --gather_vjp {v}",
                     profile=v in ("scatter", "sorted"))
        if v == "batchdedup":
            assert over == 0, over
        if v == "raydedup":
            log(f"phase 21: raydedup at gvjp_U {cfg.gvjp_U}: {over} of "
                f"{R * T_rows} neighbour rows dropped in the last step "
                f"({over / (R * T_rows):.3%})")

    # stochastic rounding: the draws land on the bf16 grid, and average to
    # the master
    with torch.no_grad():
        table = ren.attribute_table(model.cloud, "float32")
        b = table.view(torch.int32)
        down = (b & -65536).view(torch.float32)
        up = ((b & -65536) + 65536).view(torch.float32)
        acc = torch.zeros_like(table, dtype=torch.float64)
        sr_cfg = dataclasses.replace(cfg, gather_round="stochastic")
        gen = torch.Generator(device=dev).manual_seed(21)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SR_DRAWS):
            bits = ren.draw_render_noise(
                gen, sr_cfg, 1, R, table_shape=tuple(table.shape))["sr_bits"]
            r = stochastic_round_bf16(table, bits).float()
            assert bool(((r == down) | (r == up)).all())
            acc += r
        torch.cuda.synchronize()
        draw_ms = (time.perf_counter() - t0) * 1e3 / SR_DRAWS
        ulp = (up - down).double()
        err = (acc / SR_DRAWS - table.double()) / ulp
        rms, bias = float(err.pow(2).mean().sqrt()), float(err.mean())
        near = float(((table.to(torch.bfloat16).double() - table.double())
                      / ulp).pow(2).mean().sqrt())
    log(f"phase 21: stochastic rounding of the {tuple(table.shape)} table: "
        f"every draw on x's bf16 neighbours; {SR_DRAWS} draws' mean, RMS of "
        f"(mean - x) / ulp {rms:.4f} (limit {SR_RMS_LIMIT:.4f}; nearest "
        f"{near:.4f}), mean {bias:.2e}; a draw and its rounding "
        f"{draw_ms:.2f} ms [{SMI}]")
    assert rms <= SR_RMS_LIMIT and near > SR_RMS_LIMIT
    del acc, err, ulp, down, up, r, bits, b
    torch.cuda.empty_cache()
    steps(sr_cfg, "bf16 table, --gather_round stochastic")

    # int8: the quantization on the card is the CPU's
    with torch.no_grad():
        q, scale, zero = quantize_table_int8(table, model.cloud.active)
        cq, cscale, czero = quantize_table_int8(table.cpu(),
                                                model.cloud.active.cpu())
    assert torch.equal(q.cpu(), cq) and torch.equal(scale.cpu(), cscale)
    assert torch.equal(zero.cpu(), czero)
    log(f"phase 21: int8 quantization of the table on the card equals the "
        f"CPU's (q {tuple(q.shape)}, scale, zero); q range "
        f"[{int(q.min())}, {int(q.max())}]")
    del table, q, scale, zero, cq, cscale, czero
    torch.cuda.empty_cache()
    steps(dataclasses.replace(cfg, gather_dtype="int8"),
          "--gather_dtype int8", profile=True)
    del model, batch
    torch.cuda.empty_cache()

    # --knn_mode approx: an eval frame through the exact select
    topt = TestOptions().parse(TEST_DEFAULT_FLAGS + ["--knn_mode", "approx"])
    model = SceneModel(topt)
    model.load_checkpoint(model.resolve_resume())
    assert model.cfg.knn_mode == "approx"
    store = {}
    qfn = capture_first_call(ren, "query_neighbors", store)
    torch.cuda.synchronize()
    reset_launches()
    try:
        t0 = time.perf_counter()
        col_a = model.render_image(item)
        frame_s = time.perf_counter() - t0
    finally:
        ren.query_neighbors = qfn
    launches = read_launches()
    args, kw = store["query_neighbors"]
    with torch.no_grad():
        a = qfn(*args, **kw).sample_pidx
        e = qfn(*args, **dict(kw, knn_mode="exact")).sample_pidx
    diff = float(np.abs(col_a - col).max())
    chunks = -(-len(item["raydir"]) // 9216)
    log(f"phase 21: --knn_mode approx frame {W_IMG}x{H_IMG} in "
        f"{frame_s * 1e3:.1f} ms, launches {launches}; first chunk's ids "
        f"equal the exact select's ({int((a >= 0).sum())} neighbours); max "
        f"|diff| to the phase-4 frame {diff:.3e} [{SMI}]")
    assert torch.equal(a, e)
    assert launches["fused_knn_select"] == 0, launches
    assert launches["fused_block1_alpha"] == chunks, launches
    assert diff <= RENDER_ATOL, diff
    del model
    torch.cuda.empty_cache()

    # train_ft through the CLI with the opt-in gathers
    ck = os.path.join(build, "smoke_gathers")
    expr = os.path.join(ck, "ft")
    os.makedirs(expr, exist_ok=True)
    for ext in ("", ".meta.json"):
        shutil.copy(os.path.join(build, "smoke", "0_net_ray_marching.npz"
                                 + ext),
                    os.path.join(expr, "0_net_ray_marching.npz" + ext))
    flags = TRAIN_FLAGS + [
        "--gather_dtype", "bfloat16", "--gather_round", "stochastic",
        "--gather_vjp", "batchdedup",
        "--name", "ft", "--checkpoints_dir", ck,
        "--data_root", os.path.join(build, "smoke_scans") + "/",
        "--scan", "scene_smoke", "--maximum_step", "10",
        "--save_iter_freq", "10", "--test_num", "1", "--test_freq", "0",
        "--print_freq", "5"]
    reset_launches()
    tee = Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        train_ft.main(flags)
    torch.cuda.synchronize()
    out = tee.buf.getvalue()
    launches = read_launches()
    log(f"phase 21: train_ft (bf16, stochastic, batchdedup) ran 10 steps, "
        f"saved, exported and tested in {time.perf_counter() - t0:.1f} s; "
        f"launches {launches}")
    for f in ("10_net_ray_marching.npz", "10_net_ray_marching.pth"):
        assert os.path.exists(os.path.join(expr, f)), f
    assert "training from step 0 to 10" in out
    over = [l_ for l_ in out.splitlines() if "gvjp_overflow" in l_]
    assert over and all("gvjp_overflow: 0.000" in l_ for l_ in over), over
    psnr_lines = [l_ for l_ in out.splitlines() if "psnr:" in l_]
    assert psnr_lines and all(np.isfinite(float(
        l_.split("psnr:")[1].split()[0])) for l_ in psnr_lines), psnr_lines
    assert launches["fused_block1_alpha_bwd"] == 10, launches
    log(f"phase 21: {time.perf_counter() - t_phase:.1f} s")


def phase21_alone():
    """Phase 21 on its own (`python -c "import chip_smoke as cs;
    cs.phase21_alone()"`): the card, the kernels, phase 3's scene and
    phase 4's frame, phase 8's export, then phase 21."""
    import torch
    from sgnerf_tpu_torch.ops import _cuda
    from sgnerf_tpu_torch.options import TestOptions
    global SMI
    SMI = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(SMI)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build = os.path.join(REPO, "build")
    for d in ("smoke", "smoke_scans", "smoke_gathers"):
        shutil.rmtree(os.path.join(build, d), ignore_errors=True)
    log(f"kernels built in {_cuda.build_all():.1f} s")
    model, _ = build_scene(TestOptions().parse(TEST_DEFAULT_FLAGS), N_POINTS)
    item = frame_item()
    col = model.render_image(item)
    del model
    torch.cuda.empty_cache()
    write_scannet_export(os.path.join(build, "smoke_scans"))
    phase21_gathers(item, col)

# ------------------------------------------------- 22. multi-device paths
SHARDS = ["--gpu_ids", "0,0"]          # two shards on card 0


def shard_tables_line(model):
    """Bytes of each slab's cloud rows and grid tables against the whole
    scene's (MiB)."""
    def mib(b):
        return round(b / 2**20, 1)

    def tables(cloud, g):
        return {"cloud": nbytes(*(getattr(cloud, f.name) for f in
                                  dataclasses.fields(cloud))),
                "occ_mask": nbytes(g.occ_mask),
                "dil_slot": nbytes(g.dil_slot),
                "nbr_packed": nbytes(g.nbr_packed)}
    whole = tables(model.cloud, model.grid)
    shards = [tables(s.cloud, s) for s in model.sharded_scene.shards]
    return (f"whole scene MiB {({k: mib(v) for k, v in whole.items()})}, "
            f"each slab {[{k: mib(v) for k, v in b.items()} for b in shards]}"
            f" ({[s.n_rows for s in model.sharded_scene.shards]} point rows, "
            f"halo {model.sspec.halo} voxels)")


def host_syncs(fn):
    """fn() under torch.cuda's sync debug mode: the messages of the
    operations in it that made the host wait for the card."""
    import warnings
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return [str(w.message).split("\n")[0][:120] for w in caught
            if "synchroniz" in str(w.message)
            and "prototype feature" not in str(w.message)]


def chunk_syncs(model, item):
    """Host syncs inside one 9216-ray chunk render of the model's mode
    (the frame's shared tables and grids built before)."""
    import torch
    dev = model.device

    def t(k):
        return torch.as_tensor(np.asarray(item[k], np.float32), device=dev)
    with torch.inference_mode():
        render = model._chunk_renderer(t("campos")[None], t("camrotc2w")[None],
                                       float(item["near"]), float(item["far"]),
                                       t("bg_color"))
        rd = t("raydir")[None, :9216]
        return host_syncs(lambda: render(rd))


def shard_frame(opt, item, col, label, chunks):
    """Load phase 3's checkpoint under `opt` (shard flags), render phase 4's
    frame with the counters reset just before: K1 and K2 once a chunk a
    shard, nothing else, the frame within RENDER_ATOL of phase 4's."""
    import torch
    from sgnerf_tpu_torch.runtime.scene_model import SceneModel
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        model = SceneModel(opt)
        model.load_checkpoint(model.resolve_resume())
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    reset_launches()
    got = model.render_image(item)
    launches = read_launches()
    t0 = time.perf_counter()
    again = model.render_image(item)
    warm_ms = (time.perf_counter() - t0) * 1e3
    diff = float(np.abs(got - col).max())
    n = len(item["raydir"])
    syncs = chunk_syncs(model, item)
    log(f"phase 22: {label}: loaded in {load_s:.1f} s; frame warm "
        f"{warm_ms:.1f} ms ({n / warm_ms * 1e3:.0f} rays/s), launches "
        f"{launches}; max |diff| to phase 4's frame {diff:.3e} (tolerance "
        f"{RENDER_ATOL}), bit-equal {bool(np.array_equal(got, col))}, "
        f"rerun bit-equal {bool(np.array_equal(got, again))}; host syncs "
        f"in one chunk {len(syncs)} {syncs[:3]}")
    assert launches == {"fused_knn_select": chunks,
                        "fused_block1_alpha": chunks,
                        "fused_block1_alpha_bwd": 0,
                        "fused_block1_alpha_color": 0,
                        "fused_block1_alpha_color_march": 0,
                        "fused_knn_select_tiled": 0, **NO_GATHER}, launches
    assert np.isfinite(got).all() and diff <= RENDER_ATOL, diff
    return model


def shard_step(model, batch, label):
    """One train step's losses and gradients over the shards against the
    unsharded step on the same state and noise (phase 6's check): losses
    within 1e-4 relative, every gradient within K3_TOL of the unsharded
    one's largest magnitude; K2 and K3 once a shard. Then 4 steps, timed."""
    import torch
    from sgnerf_tpu_torch.models.renderer import draw_render_noise
    from sgnerf_tpu_torch.models.train import loss_and_grads, trained_fields
    R = batch["raydir"].shape[1]
    gen = torch.Generator(device=model.device).manual_seed(11)
    noise = draw_render_noise(gen, model.cfg, 1, R)
    ref_l, ref_net, ref_pts = loss_and_grads(model.state, model.grid,
                                             model.cfg, model.tcfg, batch,
                                             noise=noise)
    reset_launches()
    if model.sharded_scene is not None:
        from sgnerf_tpu_torch.parallel.spatial import spatial_train_step
        _, got_l, (g_net, per) = spatial_train_step(
            model._spatial_state(), model.sspec, model.cfg, model.tcfg,
            batch, noise=noise, return_grads=True)
        model.state.step = model._spatial_tstate.step
        model._spatial_dirty = True
        # each slab row against the unsharded gradient of its point
        g_pts = [[g[k][:s.n_rows] for g, s in
                  zip(per, model.sharded_scene.shards)]
                 for k in range(len(trained_fields(model.tcfg)))]
        rows = [s.gid[:s.n_rows] for s in model.sharded_scene.shards]
        ref_pts = [[r[i] for i in rows] for r in ref_pts]
        got, ref = g_net + sum(g_pts, []), ref_net + sum(ref_pts, [])
    else:
        got_l, g_net, g_pts = loss_and_grads(
            model.state, model.grid, model.cfg, model.tcfg, batch,
            noise=noise, ray_mesh=model.ray_mesh)
        got, ref = g_net + g_pts, ref_net + ref_pts
    launches = read_launches()
    syncs = host_syncs(lambda: model.optimize(batch))
    loss_err = max(abs(float(got_l[k]) - float(ref_l[k]))
                   / max(abs(float(ref_l[k])), 1e-12) for k in ref_l)
    grad_err = max(float((a - b).abs().max()) / float(b.abs().max())
                   for a, b in zip(got, ref) if float(b.abs().max()) > 0)
    n = model.mesh.size if model.mesh is not None else model.ray_mesh.size
    torch.cuda.synchronize()
    step_ms = []
    for _ in range(4):
        t0 = time.perf_counter()
        out = model.optimize(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"phase 22: {label}: one step of {R} rays against the unsharded "
        f"step: worst loss rel diff {loss_err:.3e} (tolerance 1e-4), worst "
        f"gradient max|diff| / max|ref| {grad_err:.3e} (tolerance "
        f"{K3_TOL[False]}), launches {launches}; 4 more steps ms "
        f"{[round(v, 1) for v in step_ms]}, loss {float(out['total']):.6f}, "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"host syncs in a step {len(syncs)} {syncs[:3]}")
    assert loss_err <= 1e-4 and grad_err <= K3_TOL[False]
    assert launches == {"fused_knn_select": 0, "fused_block1_alpha": n,
                        "fused_block1_alpha_bwd": n,
                        "fused_block1_alpha_color": 0,
                        "fused_block1_alpha_color_march": 0,
                        "fused_knn_select_tiled": 0, **NO_GATHER}, launches
    assert np.isfinite(float(out["total"]))


def shard_clis(flag, steps=2):
    """train_ft then test_ft with `flag` 2 on two shards of card 0, on phase
    8's export, resuming phase 3's checkpoint: the shard line printed, K3
    once a step a shard, finite test PSNRs."""
    from sgnerf_tpu_torch.ops.fused_agg import (fused_block1_alpha,
                                                fused_block1_alpha_bwd)
    from sgnerf_tpu_torch.run import test_ft, train_ft
    build = os.path.join(REPO, "build")
    root = os.path.join(build, "smoke_shards")
    expr = os.path.join(root, flag[2:])
    os.makedirs(expr, exist_ok=True)
    for ext in ("", ".meta.json"):
        shutil.copy(os.path.join(build, "smoke", "0_net_ray_marching.npz"
                                 + ext),
                    os.path.join(expr, "0_net_ray_marching.npz" + ext))
    flags = TRAIN_FLAGS + [
        "--name", flag[2:], "--checkpoints_dir", root,
        "--data_root", os.path.join(build, "smoke_scans") + "/",
        "--scan", "scene_smoke", "--maximum_step", str(steps),
        "--save_iter_freq", str(steps), "--test_num", "1", "--test_freq",
        "0", "--print_freq", "1", flag, "2"] + SHARDS
    tee = Tee(sys.stdout)
    out, k3 = [], []
    for main, extra in ((train_ft.main, []),
                        (test_ft.main, ["--resume_iter", "latest"])):
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            main(flags + extra)
        k3.append(fused_block1_alpha_bwd.launches)
        log(f"phase 22: {main.__module__.split('.')[-1]} {flag} 2 "
            f"{' '.join(SHARDS)} in {time.perf_counter() - t0:.1f} s, "
            f"launches K2 {fused_block1_alpha.launches} K3 {k3[-1]}")
    out = tee.buf.getvalue()
    assert f"[{flag[2:]}]" in out, out[-2000:]
    assert f"training from step 0 to {steps}" in out
    assert k3 == [2 * steps, 0], k3
    psnr = [float(l_.split("psnr:")[1].split()[0])
            for l_ in out.splitlines() if "psnr:" in l_]
    assert len(psnr) >= 2 and np.isfinite(psnr).all(), psnr
    assert os.path.exists(os.path.join(expr,
                                       f"{steps}_net_ray_marching.npz"))


def phase22_shards(item, col):
    """Phase 22: --ray_shards 2 and --scene_shards 2 on two shards of card 0
    (and, with more cards, the ray-DP frame over two of them): phase 4's
    frame and phase 6's step through each, the perspective frame of phase
    18's scene on two slabs."""
    import torch
    from sgnerf_tpu_torch.data import create_dataset
    from sgnerf_tpu_torch.options import TestOptions, TrainOptions
    from sgnerf_tpu_torch.runtime.scene_model import SceneModel
    t_phase = time.perf_counter()
    chunks = -(-len(item["raydir"]) // 9216)
    torch.cuda.reset_peak_memory_stats()
    model = shard_frame(TestOptions().parse(
        TEST_DEFAULT_FLAGS + ["--ray_shards", "2"] + SHARDS), item, col,
        "ray-DP frame, 2 shards", 2 * chunks)
    del model
    model = shard_frame(TestOptions().parse(
        TEST_DEFAULT_FLAGS + ["--scene_shards", "2"] + SHARDS), item, col,
        "scene-shard frame, 2 slabs", 2 * chunks)
    log(f"phase 22: scene shards (bf16 cache): {shard_tables_line(model)}")
    del model
    torch.cuda.empty_cache()
    if torch.cuda.device_count() > 1:
        shard_frame(TestOptions().parse(
            TEST_DEFAULT_FLAGS + ["--ray_shards", "2", "--gpu_ids", "0,1"]),
            item, col, "ray-DP frame on cards 0 and 1", 2 * chunks)
        torch.cuda.empty_cache()

    for flag, label in (("--ray_shards", "ray-DP step, 2 shards"),
                        ("--scene_shards", "scene-shard step, 2 slabs")):
        opt = TrainOptions().parse(TRAIN_FLAGS + [
            "--name", "smoke", "--checkpoints_dir",
            os.path.join(REPO, "build"), flag, "2"] + SHARDS)
        with contextlib.redirect_stdout(io.StringIO()):
            model = SceneModel(opt)
            model.load_checkpoint(model.resolve_resume())
        torch.cuda.reset_peak_memory_stats()
        shard_step(model, train_batch(item, model.device), label)
        if model.sharded_scene is not None:
            log(f"phase 22: scene shards (f32 cache): "
                f"{shard_tables_line(model)}")
        del model
        torch.cuda.empty_cache()

    # the CLIs with each flag
    for flag in ("--ray_shards", "--scene_shards"):
        shard_clis(flag)
        torch.cuda.empty_cache()

    # the perspective frame of phase 18's scene, unsharded then on 2 slabs
    build = os.path.join(REPO, "build")
    root = os.path.join(build, "smoke_nerf")
    frames = []
    for extra in ([], ["--scene_shards", "2"] + SHARDS):
        opt = TrainOptions().parse(nerf_flags(
            root, "pers22", os.path.join(build, "smoke_pers22")) + extra)
        opt.split = "train"
        dataset = create_dataset(opt)
        with contextlib.redirect_stdout(io.StringIO()):
            model = SceneModel(opt)
            xyz, feats, labels = dataset.load_init_points()
            model.setup_from_points(xyz, feats, labels, dataset=dataset)
        opt.split, opt.random_sample = "test", "no_crop"
        titem = create_dataset(opt).get_item(0)
        reset_launches()
        with contextlib.redirect_stdout(io.StringIO()):
            got = model.render_image(titem)
        launches = read_launches()
        t0 = time.perf_counter()
        model.render_image(titem)
        frames.append((got, launches, (time.perf_counter() - t0) * 1e3))
        if extra:
            sizes = shard_tables_line(model)
        del model
        torch.cuda.empty_cache()
    (ref, _, ref_ms), (got, launches, ms) = frames
    diff = float(np.abs(got - ref).max())
    n_chunks = -(-len(ref) // 9216)
    log(f"phase 22: perspective frame {NERF_W}x{NERF_W} on 2 slabs: warm "
        f"{ms:.1f} ms (unsharded {ref_ms:.1f}), launches {launches}; max "
        f"|diff| to the unsharded frame {diff:.3e} (tolerance "
        f"{RENDER_ATOL}); {sizes}")
    assert diff <= RENDER_ATOL and np.isfinite(got).all(), diff
    assert launches["fused_block1_alpha"] == 2 * n_chunks, launches
    assert sum(launches.values()) == 2 * n_chunks, launches
    log(f"phase 22: {time.perf_counter() - t_phase:.1f} s")


def phase22_alone():
    """Phase 22 on its own (`python -c "import chip_smoke as cs;
    cs.phase22_alone()"`): the card, the kernels, phase 3's scene and
    phase 4's frame, phase 8's ScanNet export, phase 18's NeRF-synthetic
    export, then phase 22."""
    import torch
    from sgnerf_tpu_torch.ops import _cuda
    from sgnerf_tpu_torch.options import TestOptions
    global SMI
    SMI = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(SMI)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build = os.path.join(REPO, "build")
    for d in ("smoke", "smoke_scans", "smoke_nerf", "smoke_pers22",
              "smoke_shards"):
        shutil.rmtree(os.path.join(build, d), ignore_errors=True)
    log(f"kernels built in {_cuda.build_all():.1f} s")
    model, _ = build_scene(TestOptions().parse(TEST_DEFAULT_FLAGS), N_POINTS)
    item = frame_item()
    col = model.render_image(item)
    del model
    torch.cuda.empty_cache()
    write_scannet_export(os.path.join(build, "smoke_scans"))
    write_nerf_export(os.path.join(build, "smoke_nerf"))
    phase22_shards(item, col)


def render_rays_of(model, kw):
    """coarse_raycolor of model on phase20_edit's 512 rays."""
    from sgnerf_tpu_torch.models.renderer import render_rays
    return render_rays(model.params, model.cloud, model.grid, model.cfg,
                       **dict(kw, table=model.table))["coarse_raycolor"]


if __name__ == "__main__":
    main()
